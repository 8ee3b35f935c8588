"""The port's hand-written CUDA kernel on the card, against its plain PyTorch
version: bit-identical float32 values and identical int32 argmins.

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
