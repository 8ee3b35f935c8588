"""The exact solver's device path in one host call, on the CPU: the device
pack (``core/torch_dp.py::pack_batch``), the class scan
(``kernels/minplus.py::minplus_scan_cuda``), which also runs the backtrack
when given ``t_star``, against the JAX package.

On CPU tensors the wrappers run their plain versions (a Python loop of row
updates, ``n`` gather steps); the kernels themselves are held against those
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Inputs come
from numpy seeds and go to both packages as the same arrays. Every
comparison is exact: float32 bits, argmins and schedules.
"""

import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import jax_dp as jdp
from repro.core import problem as jprob
from repro_torch.core import problem as tprob
from repro_torch.core import torch_dp as tdp
from repro_torch.kernels import BIG, backtrack_ref
from repro_torch.kernels import minplus as mp

REGIMES = ("arbitrary", "linear", "increasing", "decreasing")


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def ragged_batch(seed, regime=None, B=4, n_max=9, T_max=200):
    """Reference instances, ragged in n, U and T; all four regimes unless
    ``regime`` names one."""
    rng = np.random.default_rng(seed)
    return [
        jcosts.random_problem(
            rng,
            n=int(rng.integers(1, n_max + 1)),
            T=int(rng.integers(1, T_max + 1)),
            regime=regime or REGIMES[b % len(REGIMES)],
        )
        for b in range(B)
    ]


def assert_packs_agree(jb):
    """The device pack on CPU tensors against the host pack and against the
    reference's pack of its own lower-limit removal."""
    tb = tprob.from_reference(jb)
    got = tdp.pack_batch(tb, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == jb.costs.shape
    assert_bits_equal(got.numpy(), tdp.pack_problem(tprob.remove_lower_limits(tb), device="cpu").numpy())
    assert_bits_equal(got.numpy(), jdp.pack_problem(jprob.remove_lower_limits(jb)))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("regime", REGIMES)
def test_device_pack_matches_host_and_reference(seed, regime):
    assert_packs_agree(jprob.ProblemBatch.from_problems(ragged_batch(seed, regime)))


def test_device_pack_of_a_mixed_ragged_batch():
    jb = jprob.ProblemBatch.from_problems(ragged_batch(11, B=6, n_max=12, T_max=400))
    assert len(set(jb.T.tolist())) > 1 and (jb.upper == 0).any()  # ragged, with padded resources
    assert_packs_agree(jb)


def test_device_pack_edge_limits_and_roundings():
    """L = U classes, L = 0, U = W - 1, costs at and above 1e30 (and inf),
    and float64 differences that fall exactly halfway between two float32
    values, so the cast rounds to even."""
    W = 6
    half = 2.0 ** -24  # half a float32 ulp at 1.0
    costs = np.full((2, 4, W), BIG, dtype=np.float64)
    costs[0, 0] = [0.5, 1.5 + half, 1.5 + 3 * half, -0.5 - half, 7.0, 1e30]  # L = 0, U = W - 1
    costs[0, 1, :3] = [3.0, 2.0, 9.0]  # L = U = 2
    costs[0, 2] = [1.0, 2.0, 1.0, 1e30 + 1e16, 2e30, np.inf]  # L = 1, at and above 1e30
    costs[0, 3, 0] = 0.0  # padded resource: L = U = 0
    costs[1, 0] = [4.0, 4.5, 5.0 + half, 1e31, 6.0, 0.25]  # L = 1, U = W - 1
    costs[1, 1, :2] = [0.0, 1.0 - half / 2]  # L = 0, U = 1
    costs[1, 2, :1] = [2.5]  # L = U = 0
    costs[1, 3, :4] = [1.0, 1.0 + half, 1.0 - half, 1.0 + 2 * half]  # L = 0, U = 3
    lower = np.array([[0, 2, 1, 0], [1, 0, 0, 0]])
    upper = np.array([[5, 2, 5, 0], [5, 1, 0, 3]])
    jb = jprob.ProblemBatch(T=np.array([9, 7]), lower=lower, upper=upper, costs=costs)
    assert_packs_agree(jb)
    got = tdp.pack_batch(tprob.from_reference(jb), device="cpu").numpy()
    assert got[0, 0, 1] == np.float32(1.0) and got[0, 0, 2] == np.float32(1.0 + 2 * 2.0 ** -23)  # ties to even
    assert got[0, 1, 0] == 0.0 and (got[0, 1, 1:] == np.float32(BIG)).all()  # L = U
    assert (got[0, 2, 2:] == np.float32(BIG)).all()  # 1e30 + 1e16, 2e30, inf saturate to BIG


def test_device_pack_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = tprob.from_reference(jprob.ProblemBatch.from_problems(ragged_batch(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.pack_batch(tb)


def dp_start(B, Tmax):
    k0 = torch.full((B, Tmax + 1), float(BIG), dtype=torch.float32)
    k0[:, 0] = 0.0
    return k0


@pytest.mark.parametrize("seed", range(4))
def test_scan_and_backtrack_wrappers_match_reference(seed):
    jb0 = jprob.remove_lower_limits(jprob.ProblemBatch.from_problems(ragged_batch(seed)))
    Tmax = int(jb0.T.max())
    packed = jdp.pack_problem(jb0)
    jK, jI = jdp.dp_tables_batch_jax(packed, Tmax, backend="ref")
    # the costs as a strided (B, n, W) view of an (n, B, W) array
    by_class = torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(packed), 0, 1)))
    costs = by_class.transpose(0, 1)
    B, n, _ = costs.shape
    before = (mp.launches, mp.launches_scan, mp.launches_backtrack)
    I = torch.empty((n, B, Tmax + 1), dtype=torch.int32)
    k_last, X = mp.minplus_scan_cuda(dp_start(B, Tmax), costs, I)
    assert X is None
    assert_bits_equal(k_last.numpy(), jK)
    np.testing.assert_array_equal(I.numpy(), np.asarray(jI))
    # ragged starting points: each instance's own T', then random ones
    rng = np.random.default_rng(seed)
    for t_np in (jb0.T, rng.integers(0, Tmax + 1, B)):
        jX = np.asarray(jdp.backtrack_batch_jax(jI, np.asarray(t_np, np.int32), Tmax))
        t_star = torch.from_numpy(np.asarray(t_np, np.int64))
        np.testing.assert_array_equal(backtrack_ref(I, t_star).numpy(), jX)
        I2 = torch.empty_like(I)
        k2, X2 = mp.minplus_scan_cuda(dp_start(B, Tmax), costs, I2, t_star=t_star.int())
        assert X2.dtype == torch.int32 and X2.shape == (B, n)
        np.testing.assert_array_equal(X2.numpy(), jX)
        assert_bits_equal(k2.numpy(), jK)
    # CPU tensors run the plain versions: no kernel was launched
    assert (mp.launches, mp.launches_scan, mp.launches_backtrack) == before


@pytest.mark.parametrize("seed", range(3))
def test_fused_solve_through_the_scan_matches_reference(seed):
    """``backend="cuda"`` routes the fused solve through one
    ``minplus_scan_cuda`` call, which on CPU tensors runs the plain scan and
    backtrack: schedules and ``K_last`` as the reference's fused solver."""
    jb0 = jprob.remove_lower_limits(jprob.ProblemBatch.from_problems(ragged_batch(seed + 20)))
    Tmax = int(jb0.T.max())
    jX, jK = jdp.solve_fused_batch_jax(jdp.pack_problem(jb0), np.asarray(jb0.T, np.int32), Tmax, backend="ref")
    tb = tprob.from_reference(jprob.ProblemBatch.from_problems(ragged_batch(seed + 20)))
    costs = tdp.pack_batch(tb, device="cpu")
    t_prime = tb.T - tb.lower.sum(axis=1)
    for backend in ("cuda", "ref", "blocked"):
        X, K = tdp.solve_fused_batch_torch(costs, torch.from_numpy(t_prime), Tmax, backend=backend)
        np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
        assert_bits_equal(K.numpy(), jK)
    got = tdp.solve_schedule_dp_batch(tb, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jX) + tb.lower)
    np.testing.assert_array_equal(got, jdp.solve_schedule_dp_batch(jprob.ProblemBatch.from_problems(ragged_batch(seed + 20))))


def test_scan_with_no_classes_returns_the_start_row():
    k0 = dp_start(3, 10)
    k_last, X = mp.minplus_scan_cuda(k0, torch.zeros((3, 0, 4)), torch.empty((0, 3, 11), dtype=torch.int32),
                                     t_star=torch.tensor([10, 3, 0]))
    assert torch.equal(k_last, k0) and X.shape == (3, 0)


def test_scan_wrappers_reject_bad_input():
    k0, costs = dp_start(2, 20), torch.zeros((2, 3, 5))
    I = torch.empty((3, 2, 21), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        mp.minplus_scan_cuda(k0.double(), costs, I)
    with pytest.raises(TypeError, match="float32"):
        mp.minplus_scan_cuda(k0, costs.double(), I)
    with pytest.raises(TypeError, match="int32"):
        mp.minplus_scan_cuda(k0, costs, I.long())
    with pytest.raises(ValueError, match="3-D"):
        mp.minplus_scan_cuda(k0, costs[0], I)
    with pytest.raises(ValueError, match="contiguous"):
        mp.minplus_scan_cuda(torch.zeros((21, 2)).t(), costs, I)
    with pytest.raises(ValueError, match="bad shapes"):
        mp.minplus_scan_cuda(k0, costs, I[:2])
    with pytest.raises(ValueError, match="bad shapes"):
        mp.minplus_scan_cuda(k0, costs[:1], I)
    buf = torch.empty(3 * 2 * 21, dtype=torch.int32)  # k0 over the slab's last class
    with pytest.raises(ValueError, match="overlap"):
        mp.minplus_scan_cuda(buf[2 * 2 * 21:].view(torch.float32).view(2, 21), costs, buf.view(3, 2, 21))
    with pytest.raises(ValueError, match="t_star"):
        mp.minplus_scan_cuda(k0, costs, I, t_star=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="integers"):
        mp.minplus_scan_cuda(k0, costs, I, t_star=torch.zeros(2))
    with pytest.raises(ValueError, match="exact float"):  # a band wider than 2^24, as a stride-0 view
        mp.minplus_scan_cuda(k0, torch.zeros((1, 1, 1)).expand(2, 3, mp.MAX_W + 1), I)
    with pytest.raises(ValueError, match="t_star"):
        mp.minplus_scan_cuda(k0, costs, I, t_star=torch.zeros((2, 1), dtype=torch.int64))
    # t_star outside [0, T] is refused on the host, before the card would walk out of the row
    for t_star in ([21, 0], np.array([-1, 3]), torch.tensor([0, 25])):
        with pytest.raises(ValueError, match=r"\[0, T=20\]"):
            tdp.solve_fused_batch_torch(costs, t_star, 20, backend="cuda")
