"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions: the min-plus kernel bit for bit (float32 values, int32
argmins); the flash-attention forward at rtol = atol = 2e-5 for float32 and
2e-2 for bfloat16 I/O (the reference's forward tolerances), and the prefill
of a SMOKE model on its kernel route against its plain route.

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
