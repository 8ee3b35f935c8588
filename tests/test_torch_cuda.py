"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions: the min-plus row kernel bit for bit (float32 values, int32
argmins), the class scan in one host call (last row and argmin slab) and the
backtrack kernel exactly, the device pack bit for bit against the host's,
and the launch counters of one solve; the flash-attention forward at rtol = atol = 2e-5 for float32 and
2e-2 for bfloat16 I/O (the reference's forward tolerances), and its bfloat16
tensor-core route within the limit its roundings give; the dQ and dK/dV
kernels at the reference's gradient tolerance (rtol 3e-4, atol 3e-5) for
float32 and, on the tensor cores, within 2^-8 relative of the plain
version's float32 gradients for bfloat16 I/O; the prefill and a training
step of a SMOKE model on the kernel route against the plain route, and the
launches of a step; the sweep engine's bucket plans (eager first call, then
CUDA-graph replays) against the CPU engine bit for bit, with shared static
buffers under interleaved and concurrent dispatches, and the launches a
replay counts; the selection's signed-zero order and the facade's regime
split against the CPU.

Every test here needs a CUDA card and ``nvcc`` (the kernel has no CPU mode),
is marked ``cuda`` and skips without them. The file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Problem, ProblemBatch, random_problem, remove_lower_limits
from repro_torch.core.torch_dp import (
    _backtrack_batch,
    dp_tables_batch,
    pack_batch,
    pack_problem,
    solve_fused_batch_torch,
    solve_schedule_dp_batch,
)
from repro_torch.kernels import BIG, minplus_cuda_batch, minplus_scan_ref, minplus_step_ref_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import minplus as mp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def band_inputs(rng, B, Tp, W, device, ties=False):
    """A DP row + cost stack with BIG sprinkled in both; with ``ties`` the
    values are small integers, so many candidates tie."""
    if ties:
        kprev = rng.integers(0, 8, (B, Tp)).astype(np.float32)
        cost = rng.integers(0, 4, (B, W)).astype(np.float32)
    else:
        kprev = rng.uniform(0, 100, (B, Tp)).astype(np.float32)
        cost = rng.uniform(0, 10, (B, W)).astype(np.float32)
    kprev[rng.random((B, Tp)) < 0.3] = float(BIG)
    kprev[:, 0] = 0.0
    cost[rng.random((B, W)) < 0.2] = float(BIG)
    return torch.from_numpy(kprev).to(device), torch.from_numpy(cost).to(device)


def assert_bit_identical(got, want):
    (gv, gi), (wv, wi) = got, want
    assert gv.dtype == wv.dtype == torch.float32 and gi.dtype == wi.dtype == torch.int32
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(gi, wi)


@pytest.mark.parametrize("B,Tp,W,BT,BW,ties", [
    (3, 1, 1, None, None, False),
    (3, 1500, 700, None, None, False),
    (3, 10001, 1001, None, None, False),
    (2, 1500, 700, 33, 7, False),
    (2, 1500, 700, 600, 100, False),
    (2, 1500, 700, 1024, 256, False),
    (4, 3000, 400, None, None, True),
    (2, 1500, 700, 33, 7, True),
    (3, 10001, 5000, None, None, True),
])
def test_cuda_kernel_matches_plain(cuda, B, Tp, W, BT, BW, ties):
    kprev, cost = band_inputs(np.random.default_rng(Tp + W), B, Tp, W, cuda, ties=ties)
    before = mp.launches
    got = minplus_cuda_batch(kprev, cost, BT=BT, BW=BW)
    torch.cuda.synchronize()
    assert mp.launches == before + 1
    assert_bit_identical(got, minplus_step_ref_batch(kprev, cost))


@pytest.mark.parametrize("BT,BW", [(None, None), (8, 3), (512, 64)])
def test_cuda_kernel_keeps_big_and_argmin_zero_on_all_big_rows(cuda, BT, BW):
    kprev = torch.full((2, 37), BIG, dtype=torch.float32, device=cuda)
    cost = torch.full((2, 11), BIG, dtype=torch.float32, device=cuda)
    got = minplus_cuda_batch(kprev, cost, BT=BT, BW=BW)
    assert_bit_identical(got, minplus_step_ref_batch(kprev, cost))
    assert bool((got[0] == BIG).all()) and bool((got[1] == 0).all())


@pytest.mark.parametrize("W", [1, 5, 1001])
@pytest.mark.parametrize("Tp", [1, 7, 1500, 10001])
@pytest.mark.parametrize("B", [1, 3, 16, 17])
@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_cuda_scan_and_backtrack_match_plain(cuda, n, B, Tp, W):
    """One host call: the last row and the whole argmin slab against the
    plain scan, the costs read through a (B, n, W) view of an (n, B, W)
    array, then the backtrack kernel the same call launches against the
    plain backtrack from ragged starting points."""
    rng = np.random.default_rng(n * 1000 + B * 100 + Tp + W)
    k0 = band_inputs(rng, B, Tp, 1, cuda)[0]
    by_class = rng.uniform(0, 10, (n, B, W)).astype(np.float32)
    by_class[rng.random(by_class.shape) < 0.2] = float(BIG)
    costs = torch.from_numpy(by_class).to(cuda).transpose(0, 1)
    t_star = torch.from_numpy(rng.integers(0, Tp, B)).to(cuda)
    I = torch.empty((n, B, Tp), dtype=torch.int32, device=cuda)
    before = (mp.launches, mp.launches_scan, mp.launches_backtrack)
    k_last, X = mp.minplus_scan_cuda(k0.clone(), costs, I, t_star=t_star)
    torch.cuda.synchronize()
    assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == (before[0] + n, before[1] + 1, before[2] + 1)
    I_ref = torch.empty_like(I)
    k_ref = minplus_scan_ref(k0.clone(), costs, I_ref)
    assert torch.equal(k_last.view(torch.int32), k_ref.view(torch.int32))
    assert torch.equal(I, I_ref)
    X_ref = _backtrack_batch(I_ref, t_star)
    assert torch.equal(X, X_ref)


def test_cuda_device_pack_matches_host_pack(cuda):
    rng = np.random.default_rng(3)
    probs = [random_problem(rng, n=int(rng.integers(1, 30)), T=int(rng.integers(1, 900)), max_upper=200,
                            regime=("arbitrary", "linear", "increasing", "decreasing")[b % 4]) for b in range(9)]
    batch = ProblemBatch.from_problems(probs)
    got = pack_batch(batch, cuda)
    want = pack_problem(remove_lower_limits(batch), cuda)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_solve_matches_plain_path(cuda):
    rng = np.random.default_rng(0)
    batch = ProblemBatch.from_problems(
        [random_problem(rng, n=12, T=500, regime="arbitrary", max_upper=100) for _ in range(4)]
    )
    before = (mp.launches, mp.launches_scan, mp.launches_backtrack)
    X = solve_schedule_dp_batch(batch, device="cuda")
    # one host call into the scan (n row launches) and one backtrack launch
    assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == (before[0] + batch.n, before[1] + 1, before[2] + 1)
    np.testing.assert_array_equal(X, solve_schedule_dp_batch(batch, device="cpu"))
    b0 = remove_lower_limits(batch)
    costs = pack_problem(b0, cuda)
    t_star = torch.from_numpy(b0.T).to(cuda)
    Xc, Kc = solve_fused_batch_torch(costs, t_star, int(b0.T.max()), backend="cuda")
    Xr, Kr = solve_fused_batch_torch(costs, t_star, int(b0.T.max()), backend="ref")
    assert torch.equal(Xc, Xr) and torch.equal(Kc.view(torch.int32), Kr.view(torch.int32))
    Kc, Ic = dp_tables_batch(costs, int(b0.T.max()), backend="cuda")
    Kr, Ir = dp_tables_batch(costs, int(b0.T.max()), backend="ref")
    assert torch.equal(Ic, Ir) and torch.equal(Kc.view(torch.int32), Kr.view(torch.int32))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_dim_80_runs_the_flash_kernels(cuda, dtype):
    """D = 80 (hubert-xlarge, zamba2-2.7b) lies between the head dims the
    flash kernels are built for: attention(impl="flash") runs the D = 128
    forward, dQ and dK/dV kernels on zero-padded inputs, and o and the
    gradients match the plain version at the built head dims' tolerances
    (float32: the reference's; bfloat16: chip_smoke.py's limits)."""
    from repro_torch.models.layers import attention

    rng = np.random.default_rng(80)
    S, D, kind, window, softcap = 256, 80, "sliding", 100, 30.0
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, h, D)).astype(np.float32) * 0.5).to(cuda, dtype)
               .requires_grad_() for h in (4, 2, 2))
    do = torch.from_numpy(rng.normal(size=(2, S, 4, D)).astype(np.float32)).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc)
    got = attention(q, k, v, q_pos=pos, kv_pos=pos, kind=kind, window=window, attn_softcap=softcap, impl="flash")
    grads = torch.autograd.grad(got, (q, k, v), do)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + tc)
    assert got.shape == (2, S, 4, D) and got.dtype == dtype
    q32, k32, v32, do32 = (x.detach().float().transpose(1, 2) for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention_ref(q32, k32, v32, kind, window, softcap)
    o = got.detach().transpose(1, 2)
    want = fa.flash_attention_bwd_ref(q32, k32, v32, o.float(), lse32, do32, kind, window, softcap)
    if dtype == torch.float32:
        torch.testing.assert_close(o, o32, rtol=2e-5, atol=2e-5)
    else:
        pv_abs = fa.flash_attention_ref(q32, k32, v32.abs(), kind, window, softcap)[0]
        limit = 2.0 ** -8 * (o32.abs() + pv_abs) + 2e-5
        assert bool(((o.float() - o32).abs() <= limit).all()), float(((o.float() - o32).abs() / limit).max())
    for g, w in zip(grads, want):
        g = g.transpose(1, 2)
        assert g.shape == w.shape and g.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-5)
        else:
            torch.testing.assert_close(g.float(), w, rtol=2.0 ** -8, atol=1e-5 * w.abs().max().item())


# ---------------------------------------------------------------------------
# the sweep engine on the card: one CUDA graph per bucket
# ---------------------------------------------------------------------------


def engine_batch(seed, B=4, n=12, T=500, regime="arbitrary"):
    rng = np.random.default_rng(seed)
    return ProblemBatch.from_problems([random_problem(rng, n=n, T=T, regime=regime, max_upper=100) for _ in range(B)])


def test_cuda_engine_replay_matches_eager_and_plain(cuda):
    """The plan's first call (eager) and its replays give the same X and
    K_last bits as the CPU engine's plain path."""
    from repro_torch.core.sweep import SweepEngine

    eng, ref = SweepEngine(device="cuda"), SweepEngine(device="cpu")
    assert eng.backend == "cuda"
    batch = engine_batch(0)
    want = ref.dispatch(batch)
    for _ in range(3):  # eager warm-up and capture, then two replays
        h = eng.dispatch(batch)
        np.testing.assert_array_equal(h.result(), want.result())
        np.testing.assert_array_equal(h.k_last().view(np.int32), want.k_last().view(np.int32))
        assert h.done()
    s = eng.cache_stats()
    assert (s["compiles"], s["hits"], s["misses"]) == (1, 2, 1)
    assert eng._cache[next(iter(eng._cache))].graph is not None


def test_cuda_engine_interleaved_dispatches_keep_separate_answers(cuda):
    """Two dispatches to one bucket share its static buffers; each handle
    keeps its own batch's answer, whichever is read first."""
    from repro_torch.core.sweep import SweepEngine

    eng = SweepEngine(device="cuda")
    a, b = engine_batch(1), engine_batch(2)
    from repro_torch.core.sweep import request_bucket

    assert request_bucket(a) == request_bucket(b)
    want_a, want_b = (solve_schedule_dp_batch(x, device="cpu") for x in (a, b))
    eng.dispatch(a).result()  # the bucket is warm: later calls replay
    ha, hb = eng.dispatch(a), eng.dispatch(b)
    np.testing.assert_array_equal(hb.result(), want_b)
    np.testing.assert_array_equal(ha.result(), want_a)
    hb2, ha2 = eng.dispatch(b), eng.dispatch(a)
    np.testing.assert_array_equal(ha2.result(), want_a)
    np.testing.assert_array_equal(hb2.result(), want_b)
    assert eng.cache_stats()["compiles"] == 1


def test_cuda_engine_replay_counts_its_row_and_backtrack_launches(cuda):
    """A replay adds the n_b row launches and the backtrack launch the graph
    holds to the counters; the capture itself launches and counts nothing."""
    from repro_torch.core.sweep import SweepEngine, request_bucket

    eng, batch = SweepEngine(device="cuda"), engine_batch(3)
    nb = request_bucket(batch)[0]
    before = (mp.launches, mp.launches_scan, mp.launches_backtrack)
    eng.dispatch(batch).result()  # warm-up (one eager scan) and capture
    assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == (before[0] + nb, before[1] + 1, before[2] + 1)
    eng.dispatch(batch).result()  # one replay: no host call into the scan
    assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == (before[0] + 2 * nb, before[1] + 1, before[2] + 2)


def test_cuda_engine_eight_producers_on_one_bucket(cuda):
    import threading

    from repro_torch.core.sweep import SweepEngine

    eng = SweepEngine(device="cuda")
    batches = [engine_batch(10 + i) for i in range(8)]
    wants = [solve_schedule_dp_batch(x, device="cpu") for x in batches]
    eng.dispatch(batches[0]).result()
    errors = []

    def producer(i):
        try:
            for _ in range(4):
                assert np.array_equal(eng.dispatch(batches[i]).result(), wants[i]), i
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert eng.cache_stats()["compiles"] == 1


def test_cuda_marginal_select_keeps_the_heap_order_on_signed_zeros(cuda):
    """The card's sort orders the float's bits; the selection's + 0.0 turns
    every -0.0 marginal into +0.0, so ties keep the lower resource first."""
    from repro_torch.core.marginal_torch import marginal_select

    neg = np.array([0.0, -0.0, -0.0, 3.0])
    pos = np.array([0.0, 0.0, 0.0, 3.0])
    probs = [Problem(T=T, lower=[0, 0, 0], upper=[3, 3, 3], cost_tables=(pos, neg, pos.copy())) for T in (1, 2, 3, 7)]
    b0 = remove_lower_limits(ProblemBatch.from_problems(probs))
    got = marginal_select(pack_problem(b0, cuda), torch.from_numpy(b0.upper).to(cuda), torch.from_numpy(b0.T).to(cuda))
    want = marginal_select(pack_problem(b0, "cpu"), torch.from_numpy(b0.upper), torch.from_numpy(b0.T))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert got[0][:, 0].tolist() == [1, 2, 2, 3]


def test_cuda_solver_mixed_batch_matches_the_cpu(cuda):
    """The facade's regime split on the card (DP plan, selection plan, host
    MarDecUn/MarDec) gives the CPU's schedules and algorithms; selection
    objectives within rtol 1e-6."""
    from repro_torch.core.solver import Solver
    from repro_torch.core.sweep import SweepEngine

    rng = np.random.default_rng(4)
    probs = [random_problem(rng, n=10, T=200, regime=r, max_upper=60)
             for r in ("increasing", "linear", "decreasing", "arbitrary") for _ in range(2)]
    got = Solver(engine=SweepEngine(device="cuda")).solve(probs)
    want = Solver(engine=SweepEngine(device="cpu")).solve(probs)
    for x, y in zip(got.schedules, want.schedules):
        np.testing.assert_array_equal(x, y)
    assert got.algorithms == want.algorithms
    np.testing.assert_array_equal(got.objectives, want.objectives)
    hg = SweepEngine(device="cuda").dispatch(probs, split_regimes=True)
    hw = SweepEngine(device="cpu").dispatch(probs, split_regimes=True)
    np.testing.assert_allclose(hg.objectives(), hw.objectives(), rtol=1e-6)
