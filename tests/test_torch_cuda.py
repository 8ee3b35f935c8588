"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions: the min-plus kernel bit for bit (float32 values, int32
argmins); the flash-attention forward at rtol = atol = 2e-5 for float32 and
2e-2 for bfloat16 I/O (the reference's forward tolerances), and its bfloat16
tensor-core route within the limit its roundings give; the dQ and dK/dV
kernels at the reference's gradient tolerance (rtol 3e-4, atol 3e-5) for
float32 and, on the tensor cores, within 2^-8 relative of the plain
version's float32 gradients for bfloat16 I/O; the prefill and a training
step of a SMOKE model on the kernel route against the plain route, and the
launches of a step.

Every test here needs a CUDA card and ``nvcc`` (the kernel has no CPU mode),
is marked ``cuda`` and skips without them. The file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ProblemBatch, random_problem, remove_lower_limits
from repro_torch.core.torch_dp import pack_problem, solve_fused_batch_torch, solve_schedule_dp_batch
from repro_torch.kernels import BIG, minplus_cuda_batch, minplus_step_ref_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import minplus as mp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def band_inputs(rng, B, Tp, W, device):
    kprev = rng.uniform(0, 100, (B, Tp)).astype(np.float32)
    kprev[rng.random((B, Tp)) < 0.3] = float(BIG)
    kprev[:, 0] = 0.0
    cost = rng.uniform(0, 10, (B, W)).astype(np.float32)
    cost[rng.random((B, W)) < 0.2] = float(BIG)
    return torch.from_numpy(kprev).to(device), torch.from_numpy(cost).to(device)


def assert_bit_identical(got, want):
    (gv, gi), (wv, wi) = got, want
    assert gv.dtype == wv.dtype == torch.float32 and gi.dtype == wi.dtype == torch.int32
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(gi, wi)


@pytest.mark.parametrize("B,Tp,W,BT,BW", [
    (3, 1, 1, None, None),
    (3, 1500, 700, None, None),
    (3, 10001, 1001, None, None),
    (2, 1500, 700, 33, 7),
    (2, 1500, 700, 600, 100),
    (2, 1500, 700, 2048, 256),
])
def test_cuda_kernel_matches_plain(cuda, B, Tp, W, BT, BW):
    kprev, cost = band_inputs(np.random.default_rng(Tp + W), B, Tp, W, cuda)
    before = mp.launches
    got = minplus_cuda_batch(kprev, cost, BT=BT, BW=BW)
    torch.cuda.synchronize()
    assert mp.launches == before + 1
    assert_bit_identical(got, minplus_step_ref_batch(kprev, cost))


def test_cuda_solve_matches_plain_path(cuda):
    rng = np.random.default_rng(0)
    batch = ProblemBatch.from_problems(
        [random_problem(rng, n=12, T=500, regime="arbitrary", max_upper=100) for _ in range(4)]
    )
    before = mp.launches
    X = solve_schedule_dp_batch(batch, device="cuda")
    assert mp.launches == before + batch.n
    np.testing.assert_array_equal(X, solve_schedule_dp_batch(batch, device="cpu"))
    b0 = remove_lower_limits(batch)
    costs = pack_problem(b0, cuda)
    t_star = torch.from_numpy(b0.T).to(cuda)
    Xc, Kc = solve_fused_batch_torch(costs, t_star, int(b0.T.max()), backend="cuda")
    Xr, Kr = solve_fused_batch_torch(costs, t_star, int(b0.T.max()), backend="ref")
    assert torch.equal(Xc, Xr) and torch.equal(Kc.view(torch.int32), Kr.view(torch.int32))


@pytest.mark.parametrize("B,H,Hkv,S,D,kind,window,softcap,dtype", [
    (2, 4, 4, 128, 64, "causal", 0, 0.0, torch.float32),
    (1, 4, 2, 200, 128, "sliding", 37, 50.0, torch.float32),
    (1, 8, 1, 640, 256, "causal", 0, 50.0, torch.float32),
    (2, 4, 1, 200, 64, "bidirectional", 0, 0.0, torch.float32),
    (1, 8, 4, 1024, 256, "sliding", 300, 50.0, torch.bfloat16),
    (1, 4, 4, 640, 128, "causal", 0, 0.0, torch.bfloat16),
])
def test_cuda_flash_matches_plain(cuda, B, H, Hkv, S, D, kind, window, softcap, dtype):
    rng = np.random.default_rng(S + D)
    q, k, v = ((torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(np.float32)) * 0.5).to(cuda, dtype)
               for h in (H, Hkv, Hkv))
    before = fa.launches
    o, lse = fa.flash_attention(q, k, v, kind, window, softcap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, kind, window, softcap)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=tol, atol=tol)


def test_cuda_flash_takes_strided_views_and_ragged_kv(cuda):
    """(B, S, H, D) tensors seen through transpose(1, 2), as attention()
    passes them, and Sq != Sk with rows that have no key in their window."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 150, 4, 64)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.normal(size=(2, 70, 2, 64)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(2, 70, 2, 64)).astype(np.float32)).to(cuda)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), "sliding", 16, 0.0)
    o, lse = fa.flash_attention(*args)
    o_ref, lse_ref = fa.flash_attention_ref(*args)
    torch.testing.assert_close(o, o_ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-5, atol=2e-5)


def _tc_forward_within_limit(q, k, v, o, lse, kind, window, softcap):
    """bfloat16 I/O on the tensor-core route: o within 2^-8 |o32| + 2^-8
    (P|V|)/l + 2e-5 of the plain version's float32 o32 (o and P each rounded
    to bfloat16 once; chip_smoke.py's limit), lse within 2e-5."""
    o32, lse32 = fa.flash_attention_ref(q.float(), k.float(), v.float(), kind, window, softcap)
    pv_abs = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(), kind, window, softcap)[0]
    limit = 2.0 ** -8 * (o32.abs() + pv_abs) + 2e-5
    assert bool(((o.float() - o32).abs() <= limit).all()), float(((o.float() - o32).abs() / limit).max())
    torch.testing.assert_close(lse, lse32, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("S,kind,window,softcap,H,Hkv", [
    (200, "causal", 0, 50.0, 4, 2), (640, "sliding", 37, 50.0, 4, 1), (333, "bidirectional", 0, 0.0, 2, 2),
])
def test_cuda_tc_forward_matches_plain(cuda, D, S, kind, window, softcap, H, Hkv):
    """The bfloat16 tensor-core forward (wgmma, TMA) at every head dimension
    it is built for, ragged lengths included."""
    rng = np.random.default_rng(S + D + 7)
    q, k, v = ((torch.from_numpy(rng.normal(size=(1, h, S, D)).astype(np.float32)) * 0.5).to(cuda, torch.bfloat16)
               for h in (H, Hkv, Hkv))
    before = (fa.launches, fa.launches_fwd_tc)
    o, lse = fa.flash_attention(q, k, v, kind, window, softcap)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_fwd_tc) == (before[0] + 1, before[1] + 1)
    assert o.dtype == torch.bfloat16
    _tc_forward_within_limit(q, k, v, o, lse, kind, window, softcap)


@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("S,kind,window,softcap,H,Hkv", [
    (200, "causal", 0, 50.0, 4, 2), (640, "sliding", 37, 50.0, 4, 1), (333, "bidirectional", 0, 0.0, 2, 2),
])
def test_cuda_tc_dq_matches_plain(cuda, D, S, kind, window, softcap, H, Hkv):
    """The bfloat16 tensor-core dQ kernel within 2^-8 relative + 1e-5 of the
    largest entry of the plain version's float32 dq."""
    rng = np.random.default_rng(S + D + 8)
    q, k, v, o, lse, do = _bwd_inputs(rng, 1, H, Hkv, S, D, torch.bfloat16, cuda, kind, window, softcap)
    before = (fa.launches_dq, fa.launches_dq_tc, fa.launches_dkv)
    dq, _, _ = fa.flash_attention_bwd(q, k, v, o, lse, do, kind, window, softcap)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dq_tc, fa.launches_dkv) == (before[0] + 1, before[1] + 1, before[2] + 1)
    want = fa.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, o)), lse, do.float(), kind, window, softcap)[0]
    assert dq.dtype == torch.bfloat16
    torch.testing.assert_close(dq.float(), want, rtol=2.0 ** -8, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("S,kind,window,softcap,H,Hkv", [
    (200, "causal", 0, 50.0, 4, 2), (640, "sliding", 37, 50.0, 4, 1), (333, "bidirectional", 0, 0.0, 2, 2),
])
def test_cuda_tc_dkv_matches_plain(cuda, D, S, kind, window, softcap, H, Hkv):
    """The bfloat16 tensor-core dK/dV kernel within 2^-8 relative + 1e-5 of
    the largest entry of the plain version's float32 dk and dv, at every head
    dimension it is built for."""
    rng = np.random.default_rng(S + D + 10)
    q, k, v, o, lse, do = _bwd_inputs(rng, 1, H, Hkv, S, D, torch.bfloat16, cuda, kind, window, softcap)
    before = (fa.launches_dkv, fa.launches_dkv_tc)
    _, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, kind, window, softcap)
    torch.cuda.synchronize()
    assert (fa.launches_dkv, fa.launches_dkv_tc) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, o)), lse, do.float(), kind, window, softcap)[1:]
    for g, w in zip((dk, dv), want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w, rtol=2.0 ** -8, atol=1e-5 * w.abs().max().item())


def test_cuda_tc_dkv_takes_ragged_kv_and_a_misaligned_lse(cuda):
    """bfloat16 (B, S, H, D) views through transpose(1, 2), Sq != Sk, rows
    with no key in their window (every q tile reaches every key tile), and
    an lse whose base is not 16-byte aligned (copied before TMA reads it)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, h, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
               .transpose(1, 2) for S, h in ((150, 4), (70, 2), (70, 2)))
    o, lse = fa.flash_attention(q, k, v, "sliding", 16, 0.0)
    lse = torch.cat([torch.zeros(1, device=cuda), lse.flatten()])[1:].view(lse.shape)
    assert lse.data_ptr() % fa.TMA_ALIGN
    do = torch.from_numpy(rng.normal(size=(2, 4, 150, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = fa.launches_dkv_tc
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, "sliding", 16, 0.0)[1:]
    assert fa.launches_dkv_tc == before + 1
    want = fa.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, o)), lse, do.float(), "sliding", 16, 0.0)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=2.0 ** -8, atol=1e-5 * w.abs().max().item())


def test_cuda_float32_dkv_stays_on_the_cuda_cores(cuda):
    """float32 I/O keeps the CUDA-core dK/dV kernel, at the reference's
    gradient tolerance: no tensor-core launch."""
    rng = np.random.default_rng(12)
    q, k, v, o, lse, do = _bwd_inputs(rng, 1, 4, 2, 200, 128, torch.float32, cuda, "causal", 0, 50.0)
    before = (fa.launches_dkv, fa.launches_dkv_tc, fa.launches_dq_tc)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, "causal", 0, 50.0)
    torch.cuda.synchronize()
    assert (fa.launches_dkv, fa.launches_dkv_tc, fa.launches_dq_tc) == (before[0] + 1, before[1], before[2])
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, "causal", 0, 50.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-5)


def test_cuda_tc_takes_strided_views_and_ragged_kv(cuda):
    """bfloat16 (B, S, H, D) views seen through transpose(1, 2), as
    attention() passes them, Sq != Sk and rows with no key in their window,
    forward and dQ on the tensor cores."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, h, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
               .transpose(1, 2) for S, h in ((150, 4), (70, 2), (70, 2)))
    o, lse = fa.flash_attention(q, k, v, "sliding", 16, 0.0)
    _tc_forward_within_limit(q, k, v, o, lse, "sliding", 16, 0.0)
    do = torch.from_numpy(rng.normal(size=(2, 4, 64, 150)).astype(np.float32)).to(cuda, torch.bfloat16).transpose(2, 3)
    dq = fa.flash_attention_bwd(q, k, v, o, lse, do, "sliding", 16, 0.0)[0]
    want = fa.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, o)), lse, do.float(), "sliding", 16, 0.0)[0]
    torch.testing.assert_close(dq.float(), want, rtol=2.0 ** -8, atol=1e-5 * want.abs().max().item())


def test_cuda_tc_rejects_what_tma_cannot_read(cuda):
    q = torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16, device=cuda)[..., :16]  # rows 40 bytes apart
    k = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16, device=cuda)
    before = fa.launches
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, k, k, "causal")
    assert fa.launches == before


def test_cuda_smoke_prefill_kernel_route_matches_plain_route(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_dummy_batch, prefill_fn

    cfg = get_config("gemma2-2b", smoke=True).replace(attn_impl="flash")
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 2, 256, "prefill", np.random.default_rng(0), device="cuda")
    before = fa.launches
    got = prefill_fn(params, cfg, batch)
    assert fa.launches == before + cfg.num_layers
    want = prefill_fn(params, cfg.replace(attn_impl="plain"), batch)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cuda_ragged_prefill_launches_the_kernel_once_per_layer(cuda):
    """A prompt length that is no multiple of any tile (S = 200) still goes
    through the kernel at every layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_dummy_batch, prefill_fn

    cfg = get_config("gemma2-2b", smoke=True).replace(attn_impl="flash")
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 2, 200, "prefill", np.random.default_rng(1), device="cuda")
    before = fa.launches
    got = prefill_fn(params, cfg, batch)
    assert fa.launches == before + cfg.num_layers
    want = prefill_fn(params, cfg.replace(attn_impl="plain"), batch)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _bwd_inputs(rng, B, H, Hkv, S, D, dtype, device, kind, window, softcap):
    q, k, v = ((torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(np.float32)) * 0.5).to(device, dtype)
               for h in (H, Hkv, Hkv))
    o, lse = fa.flash_attention(q, k, v, kind, window, softcap)
    do = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).to(device, dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("B,H,Hkv,S,D,kind,window,softcap,dtype", [
    (2, 4, 4, 128, 64, "causal", 0, 0.0, torch.float32),
    (1, 4, 2, 200, 128, "sliding", 37, 50.0, torch.float32),
    (1, 8, 2, 640, 256, "causal", 0, 50.0, torch.float32),
    (2, 4, 1, 200, 64, "bidirectional", 0, 0.0, torch.float32),
    (1, 4, 1, 150, 16, "sliding", 16, 20.0, torch.float32),
    (1, 8, 4, 1024, 256, "sliding", 300, 50.0, torch.bfloat16),
    (1, 4, 4, 640, 128, "causal", 0, 0.0, torch.bfloat16),
])
def test_cuda_flash_bwd_matches_plain(cuda, B, H, Hkv, S, D, kind, window, softcap, dtype):
    rng = np.random.default_rng(S + D + 1)
    q, k, v, o, lse, do = _bwd_inputs(rng, B, H, Hkv, S, D, dtype, cuda, kind, window, softcap)
    before = (fa.launches_dq, fa.launches_dkv)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, kind, window, softcap)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, o)), lse, do.float(), kind, window, softcap)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-5)
        else:
            torch.testing.assert_close(g.float(), w, rtol=2.0 ** -8, atol=1e-5 * w.abs().max().item())


def test_cuda_flash_bwd_takes_strided_views_and_ragged_kv(cuda):
    """(B, S, H, D) views as attention() passes them, a cotangent without a
    contiguous last axis, Sq != Sk and rows with no key in their window."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 150, 4, 64)).astype(np.float32)).to(cuda).transpose(1, 2)
    k = torch.from_numpy(rng.normal(size=(2, 70, 2, 64)).astype(np.float32)).to(cuda).transpose(1, 2)
    v = torch.from_numpy(rng.normal(size=(2, 70, 2, 64)).astype(np.float32)).to(cuda).transpose(1, 2)
    o, lse = fa.flash_attention(q, k, v, "sliding", 16, 0.0)
    do = torch.from_numpy(rng.normal(size=(2, 4, 64, 150)).astype(np.float32)).to(cuda).transpose(2, 3)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, "sliding", 16, 0.0)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, "sliding", 16, 0.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-5)


def _smoke_train(cuda, attn_impl, remat="none"):
    from repro_torch.configs import get_config
    from repro_torch.launch import build_train_step
    from repro_torch.models import init_params, make_dummy_batch

    cfg = get_config("gemma2-2b", smoke=True).replace(attn_impl=attn_impl, remat=remat)
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 2, 200, "train", np.random.default_rng(2), device="cuda")
    step, opt = build_train_step(cfg)
    return cfg, params, opt.init(params), batch, step


def test_cuda_smoke_train_step_kernel_route_matches_plain_route(cuda):
    """The loss and gradients a gemma2-2b SMOKE training step takes
    (float32, S = 200, ragged), kernel route against plain route, at the
    reference's dense-model tolerance (loss 2e-5; gradients rtol 2e-3, atol
    2e-5). The updated parameters are not compared: Adam's first step is
    lr * sign(g), which a gradient near 0 can flip."""
    from repro_torch.launch import value_and_grad
    from repro_torch.optim import tree_leaves

    cfg, params, _, batch, _ = _smoke_train(cuda, "flash")
    loss, grads = value_and_grad(params, cfg, batch)
    loss_p, grads_p = value_and_grad(params, cfg.replace(attn_impl="plain"), batch)
    assert abs(loss.item() - loss_p.item()) < 2e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-5)


def test_cuda_train_step_launches_with_remat(cuda):
    """With remat="full" a step runs each layer's forward kernel twice (the
    forward and its recompute) and each backward kernel once."""
    cfg, params, state, batch, step = _smoke_train(cuda, "flash", remat="full")
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    params, state, loss = step(params, state, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == (before[0] + 2 * L, before[1] + L, before[2] + L)
    assert torch.isfinite(loss)
