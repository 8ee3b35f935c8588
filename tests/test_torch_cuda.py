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
replay counts; the backtrack launched alone, the class ring and the batch
mesh over four positions of the card; the selection's signed-zero order and the facade's regime
split against the CPU; the scheduling service and the fleet solve over a
card engine against the CPU's; a toy-LM FL campaign trained and planned on
the card against the CPU's, and pipelined against serial; SMOKE decode of a
dense and two MoE archs on the card against the CPU, and the cache written
in place; SMOKE xlstm and zamba2 prefill and decode against the CPU, and
zamba2's and hubert's float32 full-width cuts (D = 80) on the flash route
against the plain route, hubert's bidirectional D = 80 launch and its SMOKE
prefill on the kernel route.

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


def test_cuda_train_step_launches_with_remat_dots(cuda):
    """With remat="dots" the projections' outputs are saved and attention is
    recomputed: each layer's forward kernel runs twice, each backward kernel
    once, as under "full", and the loss and gradients agree with those of
    no remat (the recompute runs the same kernels on the same inputs; the
    limits leave room for the card's scatter-adds, which may sum in another
    order from one run to the next)."""
    from repro_torch.launch import value_and_grad
    from repro_torch.optim import tree_leaves

    cfg, params, state, batch, step = _smoke_train(cuda, "flash", remat="dots")
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    loss, grads = value_and_grad(params, cfg, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == (before[0] + 2 * L, before[1] + L, before[2] + L)
    loss0, grads0 = value_and_grad(params, cfg.replace(remat="none"), batch)
    torch.testing.assert_close(loss, loss0, rtol=1e-6, atol=0)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads0)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-8)
    params, state, loss = step(params, state, batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_dim_80_runs_the_flash_kernels(cuda, dtype):
    """D = 80 (hubert-xlarge, zamba2-2.7b) lies between the head dims the
    flash kernels are built for: attention(impl="flash") runs the D = 128
    forward, dQ and dK/dV kernels on zero-padded inputs, and o and the
    gradients match the plain version at the built head dims' tolerances
    (float32: the reference's; bfloat16: chip_smoke.py's limits)."""
    _head_dim_80_matches_plain(cuda, dtype, 4, 2, 256, "sliding", 100, 30.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_dim_80_bidirectional_at_hubert_heads(cuda, dtype):
    """hubert-xlarge's attention: H = Hkv = 16, D = 80, bidirectional, no
    softcap, on the D = 128 kernels, as the D = 80 test above holds it."""
    _head_dim_80_matches_plain(cuda, dtype, 16, 16, 640, "bidirectional", 0, 0.0)


def _head_dim_80_matches_plain(cuda, dtype, H, Hkv, S, kind, window, softcap):
    from repro_torch.models.layers import attention

    rng = np.random.default_rng(80)
    D = 80
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, h, D)).astype(np.float32) * 0.5).to(cuda, dtype)
               .requires_grad_() for h in (H, Hkv, Hkv))
    do = torch.from_numpy(rng.normal(size=(2, S, H, D)).astype(np.float32)).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc)
    got = attention(q, k, v, q_pos=pos, kv_pos=pos, kind=kind, window=window, attn_softcap=softcap, impl="flash")
    grads = torch.autograd.grad(got, (q, k, v), do)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + tc)
    assert got.shape == (2, S, H, D) and got.dtype == dtype
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
    (plan,) = eng._cache[next(iter(eng._cache))]  # one position: one plan
    assert plan.graph is not None


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


@pytest.mark.parametrize("n,B,Tp", [(1, 1, 1), (7, 3, 1500), (32, 16, 10001), (0, 4, 9)])
def test_cuda_backtrack_launch_matches_plain(cuda, n, B, Tp):
    """The backtrack launched alone (the class ring's reverse walk) against
    the plain backtrack, from ragged starting points; one launch counted
    (none for n = 0)."""
    rng = np.random.default_rng(n + B + Tp)
    I = torch.from_numpy(rng.integers(0, 5, (n, B, Tp)).astype(np.int32)).to(cuda)
    t = torch.from_numpy(rng.integers(0, Tp, B)).to(cuda)
    before = mp.launches_backtrack
    X = mp.minplus_backtrack_cuda(I, t)
    torch.cuda.synchronize()
    assert mp.launches_backtrack == before + (n > 0)
    assert X.shape == (B, n) and torch.equal(X, _backtrack_batch(I, t))


def test_cuda_ring_over_four_positions_of_the_card(cuda):
    """The class ring over the card repeated 4 times: the fused ring solve
    and the ring engine (eager first call, then one graph replay) give the
    unsharded solve's X and K_last bits, with n row launches and 4
    backtracks per solve."""
    from repro_torch.core.sweep import SweepEngine, SweepMesh, request_bucket
    from repro_torch.core.torch_dp import solve_fused_batch_ring

    ring = SweepMesh(["cuda"] * 4)
    batch = engine_batch(5, n=12)
    b0 = remove_lower_limits(batch)
    costs, t_star, T = pack_problem(b0, cuda), torch.from_numpy(b0.T).to(cuda), int(b0.T.max())
    Xw, Kw = solve_fused_batch_torch(costs, t_star, T, backend="cuda")
    before = (mp.launches, mp.launches_scan, mp.launches_backtrack)
    X, K = solve_fused_batch_ring(costs, t_star, T, "cuda", ring, "sweep")
    assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == (before[0] + 12, before[1] + 4, before[2] + 4)
    assert torch.equal(X, Xw) and torch.equal(K.view(torch.int32), Kw.view(torch.int32))

    eng, one = SweepEngine(ring_mesh=ring), SweepEngine(device="cuda")
    want = one.dispatch(batch)
    nb = request_bucket(batch)[0]
    for k in range(3):  # eager warm-up and capture, then two replays
        before = (mp.launches, mp.launches_scan, mp.launches_backtrack)
        h = eng.dispatch(batch)
        np.testing.assert_array_equal(h.result(), want.result())
        np.testing.assert_array_equal(h.k_last().view(np.int32), want.k_last().view(np.int32))
        scans = 4 if k == 0 else 0
        assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == (before[0] + nb, before[1] + scans,
                                                                          before[2] + 4)
    s = eng.cache_stats()
    assert (s["compiles"], s["hits"], s["misses"]) == (1, 2, 1) and list(eng._cache) == list(one._cache)
    (plan,) = eng._cache[next(iter(eng._cache))]
    assert plan.graph is not None


def test_cuda_batch_mesh_over_four_positions_of_the_card(cuda):
    """The batch axis over the card repeated 4 times: one graph per
    position on its own stream, the rows gathered in order, bit for bit the
    unsharded engine's."""
    from repro_torch.core.sweep import SweepEngine, SweepMesh, request_bucket

    eng, one = SweepEngine(mesh=SweepMesh(["cuda"] * 4)), SweepEngine(device="cuda")
    batch = engine_batch(6, B=6)
    want = one.dispatch(batch)
    nb = request_bucket(batch)[0]
    for _ in range(3):
        before = (mp.launches, mp.launches_backtrack)
        h = eng.dispatch(batch)
        np.testing.assert_array_equal(h.result(), want.result())
        np.testing.assert_array_equal(h.k_last().view(np.int32), want.k_last().view(np.int32))
        assert (mp.launches, mp.launches_backtrack) == (before[0] + 4 * nb, before[1] + 4)
    (key, plans), = eng._cache.items()
    assert key[1] == 8 and len(plans) == 4 and all(p.graph is not None for p in plans)
    assert len({p.streams[0] for p in plans}) == 4


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


# ---------------------------------------------------------------------------
# the scheduling service and the fleet solve on the card
# ---------------------------------------------------------------------------


def test_cuda_service_matches_the_cpu_service(cuda):
    """Coalesced requests over a card engine: schedules, k_last and
    objectives bit-identical to the same stream over a CPU engine; no plan
    build after warm(), no degraded or failed flush."""
    from repro_torch.core.sweep import SweepEngine, request_bucket
    from repro_torch.serve import SchedulerService

    rng = np.random.default_rng(5)
    probs = [random_problem(rng, n=12, T=300, regime="arbitrary", max_upper=60) for _ in range(12)]
    batches = [ProblemBatch.from_problems([p]) for p in probs]
    got, want = [], []
    for dev, out in (("cuda", got), ("cpu", want)):
        eng = SweepEngine(device=dev)
        svc = SchedulerService(engine=eng, max_batch=4, max_delay_s=0.002)
        try:
            svc.warm(sorted({request_bucket(b) for b in batches}))
            before = eng.cache_stats()["compiles"]
            futs = [svc.submit(b) for b in batches]
            out.extend((f.result(timeout=120), f.k_last(timeout=120), f.objectives(timeout=120)) for f in futs)
            assert eng.cache_stats()["compiles"] == before
            st = svc.stats()
            assert st["flush_failures"] == st["degraded_flushes"] == st["retries"] == 0
        finally:
            svc.close(timeout=60)
    for (x, k, o), (xw, kw, ow) in zip(got, want):
        np.testing.assert_array_equal(x, xw)
        np.testing.assert_array_equal(k.view(np.int32), kw.view(np.int32))
        np.testing.assert_array_equal(o, ow)


def test_cuda_solve_fleet_matches_the_cpu(cuda):
    """k-means on the card labels as on the CPU; the whole fleet solution
    (labels, allocations, schedule, curves, gap_bound) is the CPU's, and
    through a card service too."""
    from repro_torch.core import Solver, cluster_clients
    from repro_torch.core.sweep import SweepEngine
    from repro_torch.serve import SchedulerService

    p = random_problem(np.random.default_rng(42), n=256, T=1024, max_upper=64)
    np.testing.assert_array_equal(cluster_clients(p, seed=0, device="cuda"), cluster_clients(p, seed=0, device="cpu"))
    got = Solver(engine=SweepEngine(device="cuda")).solve_fleet(p)
    want = Solver(engine=SweepEngine(device="cpu")).solve_fleet(p)
    svc = SchedulerService(engine=SweepEngine(device="cuda"), max_batch=16, max_delay_s=0.002)
    try:
        served = svc.submit_fleet(p).result(timeout=300)
    finally:
        svc.close(timeout=60)
    for sol in (got, served):
        for f in ("labels", "allocations", "schedule"):
            np.testing.assert_array_equal(getattr(sol, f), getattr(want, f))
        np.testing.assert_array_equal(np.asarray(sol.curves).view(np.int32), np.asarray(want.curves).view(np.int32))
        assert sol.gap_bound == want.gap_bound and sol.objective == want.objective


def _toy_fl_server(device):
    """``(server, examples, rng, T)``: a toy-LM FL server with what-if
    scenarios (5 clients) training on ``device`` and planning on an engine
    there, from weights drawn on the CPU."""
    from repro_torch.core.sweep import SweepEngine
    from repro_torch.data import client_corpora, make_lm_examples
    from repro_torch.fl import EnergyEstimator, FederatedServer, PlanPolicy, make_fleet
    from repro_torch.fl.toy import make_tiny_lm
    from repro_torch.optim import sgd

    init, loss = make_tiny_lm(64, 16)
    rng = np.random.default_rng(0)
    fleet = make_fleet(rng, 5, max_batches=8)
    est = EnergyEstimator(fleet)
    est.calibrate(rng)
    examples = [make_lm_examples(c, 8) for c in client_corpora(rng, 5, 400, 64)]
    T = sum(d.max_batches for d in fleet) // 2
    params = {k: v.to(device) for k, v in init(0, device="cpu").items()}
    policy = PlanPolicy(engine=SweepEngine(device=device), scenario_T_candidates=[T // 2, T],
                        scenario_dropouts=[[0], [1]])
    return FederatedServer(loss, params, sgd(0.3), est, policy=policy), examples, rng, T


def _toy_fl_campaign(device, pipelined=False, rounds=3):
    from repro_torch.fl import run_campaign

    server, examples, rng, T = _toy_fl_server(device)
    return server, run_campaign(server, examples, rounds, round_T=T, batch_size=4, rng=rng, pipelined=pipelined)


def test_cuda_fl_campaign_matches_the_cpu(cuda):
    """Clients trained and rounds planned on the card: schedules, energies
    and scenario reports as on the CPU, losses within rtol 1e-5, parameters
    within atol 1e-5; the scenario solves launch the min-plus kernels."""
    mp.launches = mp.launches_backtrack = 0
    server, h = _toy_fl_campaign(cuda)
    launches = (mp.launches, mp.launches_backtrack)
    server_c, h_c = _toy_fl_campaign(torch.device("cpu"))
    assert launches[0] > 0 and launches[1] > 0
    for a, b in zip(h.rounds, h_c.rounds):
        np.testing.assert_array_equal(a.assignments, b.assignments)
        assert (a.energy_joules, a.estimated_joules, a.makespan_joules) == (
            b.energy_joules, b.estimated_joules, b.makespan_joules)
        np.testing.assert_array_equal(a.scenarios.assignments, b.scenarios.assignments)
        np.testing.assert_array_equal(a.scenarios.energies, b.scenarios.energies)
    np.testing.assert_allclose(h.losses, h_c.losses, rtol=1e-5, atol=0)
    for k in server.params:
        assert server.params[k].device.type == "cuda"
        torch.testing.assert_close(server.params[k].cpu(), server_c.params[k], rtol=0, atol=1e-5)


def test_cuda_fl_pipelined_campaign_is_bit_identical_to_serial(cuda):
    server_s, h_s = _toy_fl_campaign(cuda)
    server_p, h_p = _toy_fl_campaign(cuda, pipelined=True)
    for a, b in zip(h_s.rounds, h_p.rounds):
        np.testing.assert_array_equal(a.assignments, b.assignments)
        assert a.mean_loss == b.mean_loss and a.energy_joules == b.energy_joules
        np.testing.assert_array_equal(a.scenarios.assignments, b.scenarios.assignments)
    for k in server_s.params:
        assert torch.equal(server_s.params[k], server_p.params[k])


def test_cuda_plan_capture_beside_client_training(cuda):
    """A fresh engine's first plan (eager call, then CUDA-graph capture on the
    engine's stream) built on another thread while the main thread launches
    a round of client training: the schedules are the CPU engine's and the
    round is bit-identical to the same round trained alone."""
    import threading

    from repro_torch.core.sweep import SweepEngine
    from repro_torch.data import lm_round_batches

    runs = []
    for concurrent in (True, False):
        server, examples, _, T = _toy_fl_server(cuda)
        problems, _ = server.build_scenarios(T)
        plan = server.plan_round(0, T)
        batches = lm_round_batches(examples, 8, 4, 0)
        out = {}
        thread = threading.Thread(target=lambda: out.update(X=server.engine.dispatch(problems, True).result()))
        if concurrent:
            thread.start()
        loss = server.train_round(plan, batches)
        if not concurrent:
            thread.start()
        thread.join(timeout=120)
        assert not thread.is_alive() and "X" in out
        runs.append((float(loss), {k: v.clone() for k, v in server.params.items()}, out["X"]))
    want = SweepEngine(device="cpu").dispatch(problems, True).result()
    (loss_c, params_c, x_c), (loss_a, params_a, x_a) = runs
    np.testing.assert_array_equal(x_c, want)
    np.testing.assert_array_equal(x_a, want)
    assert loss_c == loss_a
    for k in params_c:
        assert torch.equal(params_c[k], params_a[k])


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "deepseek-v3-671b"])
def test_cuda_smoke_decode_matches_the_cpu(cuda, arch):
    """Teacher-forced SMOKE decode (float32, einsum dispatch for MoE) of 12
    positions on the card against the same weights on the CPU, at the
    reference's decode tolerance (2e-3), and the greedy serve step's tokens
    where the CPU's top-2 gap exceeds twice the largest deviation. The
    decode step launches no flash kernel (Sq = 1)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_serve_step
    from repro_torch.models import decode_fn, init_cache, init_params

    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(moe_impl="einsum") if cfg.num_experts else cfg
    params = init_params(cfg, 0, device="cpu")
    params_d = _to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        cache = init_cache(cfg, 2, 12, device=dev)
        toks = tokens.to(dev)
        before = fa.launches
        out[dev] = torch.cat([decode_fn(p, cfg, cache, toks[:, t:t + 1], t)[0] for t in range(12)], dim=1).cpu()
        assert fa.launches == before
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=2e-3, atol=2e-3)
    step, cache = build_serve_step(cfg), init_cache(cfg, 2, 12, device="cuda")
    got = torch.cat([step(params_d, cache, tokens[:, t:t + 1].to(cuda), t)[0] for t in range(12)], dim=1).cpu()
    top2 = out["cpu"].topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * (out["cuda"] - out["cpu"]).abs().amax(dim=-1)
    assert bool(((got == out["cpu"].argmax(dim=-1)) | ~decided).all())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
def test_cuda_decode_writes_the_cache_in_place(cuda, arch):
    """On the card a decode step keeps the cache's tensors and storage
    (``data_ptr`` unchanged) and writes only the slot at ``pos``, given as a
    device tensor (no host sync in the step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_fn, init_cache, init_params

    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, 0, device="cuda")
    cache = init_cache(cfg, 2, 8, device="cuda")
    tensors = [t for pair in (cache.values() if isinstance(cache, dict) else [cache]) for t in pair]
    ptrs = [t.data_ptr() for t in tensors]
    before = [t.clone() for t in tensors]
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 1))).to(cuda)
    _, new = decode_fn(params, cfg, cache, tok, torch.tensor(5, device=cuda))
    new_tensors = [t for pair in (new.values() if isinstance(new, dict) else [new]) for t in pair]
    assert all(a is b for a, b in zip(new_tensors, tensors))
    assert [t.data_ptr() for t in tensors] == ptrs
    for t, b in zip(tensors, before):
        written = (t != b).movedim(2, 0).reshape(t.shape[2], -1).any(dim=1)
        assert written.nonzero().flatten().tolist() == [5]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_cuda_smoke_ssm_prefill_and_decode_match_the_cpu(cuda, arch):
    """SMOKE xlstm and zamba2 (float32) on the card against the same weights
    on the CPU: the prefill within 1e-4 (zamba2's shared block on the flash
    route, one launch per application) and 12 teacher-forced decode steps,
    the recurrent state carried and zamba2's KV cache written in place,
    within the reference's decode tolerance (2e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_fn, init_cache, init_params, prefill_fn

    cfg = get_config(arch, smoke=True).replace(attn_impl="flash")
    params = init_params(cfg, 0, device="cpu")
    params_d = _to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)))
    n_attn = cfg.num_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
    before = fa.launches
    got = prefill_fn(params_d, cfg, {"tokens": tokens.to(cuda)})
    assert fa.launches == before + n_attn
    torch.testing.assert_close(got.cpu(), prefill_fn(params, cfg, {"tokens": tokens}), rtol=1e-4, atol=1e-4)
    out = []
    for dev, p in ((torch.device("cpu"), params), (cuda, params_d)):
        cache, toks, steps = init_cache(cfg, 2, 12, device=dev), tokens.to(dev), []
        for t in range(12):
            lg, cache = decode_fn(p, cfg, cache, toks[:, t:t + 1], t)
            steps.append(lg)
        out.append(torch.cat(steps, dim=1).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=2e-3, atol=2e-3)


def test_cuda_zamba2_float32_cut_flash_route_matches_plain_route(cuda):
    """zamba2-2.7b at full width (H = Hkv = 32, D = 80: the D = 128 kernels on
    zero-padded inputs), float32, cut to 2 Mamba2 layers and one application
    of the shared block: the prefill and the loss and gradients of the flash
    route against the plain route, at chip_smoke.py's model limits (prefill
    1e-4; loss 2e-5, gradients rtol 2e-3, atol 2e-5), with one forward, dQ
    and dK/dV launch each."""
    from repro_torch.configs import get_config
    from repro_torch.launch import value_and_grad
    from repro_torch.models import init_params, make_dummy_batch, prefill_fn
    from repro_torch.optim import tree_leaves

    cfg = get_config("zamba2-2.7b").replace(num_layers=2, shared_attn_every=2, param_dtype="float32",
                                            compute_dtype="float32", attn_impl="flash", remat="none")
    assert (cfg.num_heads, cfg.hd, fa.kernel_head_dim(cfg.hd)) == (32, 80, 128)
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 1, 512, "train", np.random.default_rng(0), device="cuda")
    plain = cfg.replace(attn_impl="plain")
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    got = prefill_fn(params, cfg, {"tokens": batch["tokens"][:, :-1]})
    assert fa.launches == before[0] + 1
    want = prefill_fn(params, plain, {"tokens": batch["tokens"][:, :-1]})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    loss, grads = value_and_grad(params, cfg, batch)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == (before[0] + 2, before[1] + 1, before[2] + 1)
    loss_p, grads_p = value_and_grad(params, plain, batch)
    assert abs(float(loss) - float(loss_p)) < 2e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-5)


def test_cuda_smoke_hubert_prefill_kernel_route_matches_plain_route(cuda):
    """SMOKE hubert (float32, D = 64): one bidirectional flash launch per
    layer, the logits within 1e-4 of the plain route, and of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_dummy_batch, prefill_fn

    cfg = get_config("hubert-xlarge", smoke=True).replace(attn_impl="flash")
    params = init_params(cfg, 0, device="cpu")
    batch = make_dummy_batch(cfg, 2, 300, "prefill", np.random.default_rng(0), device="cpu")
    params_d, batch_d = _to(params, cuda), _to(batch, cuda)
    before = fa.launches
    got = prefill_fn(params_d, cfg, batch_d)
    assert fa.launches == before + cfg.num_layers
    torch.testing.assert_close(got, prefill_fn(params_d, cfg.replace(attn_impl="plain"), batch_d), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.cpu(), prefill_fn(params, cfg, batch), rtol=1e-4, atol=1e-4)


def test_cuda_hubert_float32_cut_flash_route_matches_plain_route(cuda):
    """hubert-xlarge at full width (H = Hkv = 16, D = 80: the D = 128
    kernels on zero-padded inputs, bidirectional), float32, cut to 2 layers:
    the masked-prediction loss and gradients of the flash route against the
    plain route at chip_smoke.py's model limits (loss 2e-5, gradients rtol
    2e-3, atol 2e-5), with 2 forward, dQ and dK/dV launches each."""
    from repro_torch.configs import get_config
    from repro_torch.launch import value_and_grad
    from repro_torch.models import init_params, make_dummy_batch
    from repro_torch.optim import tree_leaves

    cfg = get_config("hubert-xlarge").replace(num_layers=2, param_dtype="float32", compute_dtype="float32",
                                              attn_impl="flash", remat="none")
    assert (cfg.num_heads, cfg.hd, fa.kernel_head_dim(cfg.hd)) == (16, 80, 128)
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 1, 512, "train", np.random.default_rng(0), device="cuda")
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    loss, grads = value_and_grad(params, cfg, batch)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == (before[0] + 2, before[1] + 2, before[2] + 2)
    loss_p, grads_p = value_and_grad(params, cfg.replace(attn_impl="plain"), batch)
    assert abs(float(loss) - float(loss_p)) < 2e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-5)
