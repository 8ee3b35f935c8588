"""The port's exact solver (``repro_torch.core``) against the JAX package, on
the CPU.

Instances are built by the JAX package from a seed and carried across with
``from_reference``, so both packages solve the identical input. Schedules
must be identical and DP rows bit-identical in float32.
"""

import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import jax_dp as jdp
from repro.core import mc2mkp as jmc
from repro.core import problem as jprob
from repro_torch.core import costs as tcosts
from repro_torch.core import mc2mkp as tmc
from repro_torch.core import problem as tprob
from repro_torch.core import torch_dp as tdp

REGIMES = ("arbitrary", "linear", "increasing", "decreasing")


def paper_problem(mod, T):
    # paper §3.1: R = {1,2,3}; U = {6,6,5}; L = {1,0,0}
    c1 = np.array([0.0, 2, 3.5, 5.5, 8, 10, 12])  # C1(0) unused (L1=1)
    c2 = np.array([0.0, 1.5, 2.5, 4, 7, 9, 11])
    c3 = np.array([0.0, 3, 4, 5, 6, 7])
    return mod.Problem(T=T, lower=[1, 0, 0], upper=[6, 6, 5], cost_tables=(c1, c2, c3))


def random_batch(seed, B=4, n_max=12, T_max=300):
    """Reference instances of all four regimes, ragged in n and T."""
    rng = np.random.default_rng(seed)
    return [
        jcosts.random_problem(
            rng,
            n=int(rng.integers(1, n_max + 1)),
            T=int(rng.integers(1, T_max + 1)),
            regime=REGIMES[b % len(REGIMES)],
        )
        for b in range(B)
    ]


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_from_reference_copies_the_instance():
    jp = jcosts.random_problem(np.random.default_rng(0), n=5, T=40, regime="arbitrary")
    tp = tprob.from_reference(jp)
    assert isinstance(tp, tprob.Problem) and tp.T == jp.T
    np.testing.assert_array_equal(tp.lower, jp.lower)
    np.testing.assert_array_equal(tp.upper, jp.upper)
    for a, b in zip(tp.cost_tables, jp.cost_tables):
        assert a.dtype == np.float64 and a is not b
        np.testing.assert_array_equal(a, b)
    jb = jprob.ProblemBatch.from_problems(random_batch(1))
    tb = tprob.from_reference(jb)
    assert isinstance(tb, tprob.ProblemBatch)
    for f in ("T", "lower", "upper", "costs"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert tb.lower.dtype == np.int64 and tb.costs.dtype == np.float64
    with pytest.raises(TypeError):
        tprob.from_reference(object())


def test_generators_match_reference():
    for regime in REGIMES:
        jp = jcosts.random_problem(np.random.default_rng(7), n=6, T=90, regime=regime)
        tp = tcosts.random_problem(np.random.default_rng(7), n=6, T=90, regime=regime)
        assert tp.T == jp.T
        np.testing.assert_array_equal(tp.lower, jp.lower)
        np.testing.assert_array_equal(tp.upper, jp.upper)
        for a, b in zip(tp.cost_tables, jp.cost_tables):
            np.testing.assert_array_equal(a, b)
    classes = ["phone_lo", "tablet", "edge_tpu", "workstation"]
    jp = jcosts.device_fleet_problem(50, classes, upper=[20, 30, 40, 50], flops_scale=1.5)
    tp = tcosts.device_fleet_problem(50, classes, upper=[20, 30, 40, 50], flops_scale=1.5)
    for a, b in zip(tp.cost_tables, jp.cost_tables):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_limit_removal_matches_reference(seed):
    jb = jprob.ProblemBatch.from_problems(random_batch(seed))
    tb = tprob.from_reference(jb)
    j0, t0 = jprob.remove_lower_limits(jb), tprob.remove_lower_limits(tb)
    for f in ("T", "lower", "upper", "costs"):
        np.testing.assert_array_equal(getattr(t0, f), getattr(j0, f))
    jp = jb.instance(0)
    tp = tprob.from_reference(jp)
    jp0, tp0 = jprob.remove_lower_limits(jp), tprob.remove_lower_limits(tp)
    assert tp0.T == jp0.T
    np.testing.assert_array_equal(tp0.upper, jp0.upper)
    for a, b in zip(tp0.cost_tables, jp0.cost_tables):
        np.testing.assert_array_equal(a, b)
    X = np.minimum(tb.upper - tb.lower, 1)
    np.testing.assert_array_equal(
        tprob.restore_lower_limits(tb, X), jprob.restore_lower_limits(jb, X)
    )
    np.testing.assert_array_equal(tb.regimes(), jb.regimes())


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_problem_matches_reference(seed):
    jb = jprob.remove_lower_limits(jprob.ProblemBatch.from_problems(random_batch(seed)))
    got = tdp.pack_problem(tprob.from_reference(jb), device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert_bits_equal(got.numpy(), jdp.pack_problem(jb))
    jp = jprob.remove_lower_limits(jb.instance(1))
    assert_bits_equal(tdp.pack_problem(tprob.from_reference(jp), device="cpu").numpy(), jdp.pack_problem(jp))


@pytest.mark.parametrize("T,want_x,want_cost", [(5, [2, 3, 0], 7.5), (8, [1, 2, 5], 11.5)])
def test_paper_example(T, want_x, want_cost):
    p = paper_problem(tprob, T)
    x = tdp.solve_schedule_dp_torch(p, device="cpu")
    assert list(x) == want_x
    assert tprob.total_cost(p, x) == pytest.approx(want_cost)
    X = tdp.solve_schedule_dp_batch([p, p], device="cpu")
    np.testing.assert_array_equal(X, [want_x, want_x])
    np.testing.assert_array_equal(x, jdp.solve_schedule_dp_jax(paper_problem(jprob, T)))
    np.testing.assert_array_equal(x, tmc.solve_schedule_dp(p))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "port_backend,jax_backend", [("ref", "ref"), ("blocked", "blocked"), ("cuda", "ref")]
)
def test_fused_solver_matches_jax(seed, port_backend, jax_backend):
    jb0 = jprob.remove_lower_limits(jprob.ProblemBatch.from_problems(random_batch(seed)))
    Tmax = int(jb0.T.max())
    jX, jK = jdp.solve_fused_batch_jax(
        jdp.pack_problem(jb0), np.asarray(jb0.T, np.int32), Tmax, backend=jax_backend
    )
    # the port starts from the reference instance, not from its packed form
    tb0 = tprob.remove_lower_limits(
        tprob.from_reference(jprob.ProblemBatch.from_problems(random_batch(seed)))
    )
    costs = tdp.pack_problem(tb0, device="cpu")
    X, K = tdp.solve_fused_batch_torch(costs, torch.from_numpy(tb0.T), Tmax, backend=port_backend)
    assert X.dtype == torch.int32 and X.shape == (tb0.B, tb0.n)
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    assert_bits_equal(K.numpy(), jK)


def test_dp_tables_match_jax():
    jb0 = jprob.remove_lower_limits(jprob.ProblemBatch.from_problems(random_batch(2, B=3, T_max=120)))
    Tmax = int(jb0.T.max())
    jK, jI = jdp.dp_tables_batch_jax(jdp.pack_problem(jb0), Tmax, backend="ref")
    K, I = tdp.dp_tables_batch(tdp.pack_problem(tprob.from_reference(jb0), device="cpu"), Tmax)
    assert I.dtype == torch.int32 and I.shape == (jb0.n, jb0.B, Tmax + 1)
    np.testing.assert_array_equal(I.numpy(), np.asarray(jI))
    assert_bits_equal(K.numpy(), jK)


@pytest.mark.parametrize("seed", [3, 4])
def test_solve_schedule_dp_batch_matches_reference(seed):
    probs = random_batch(seed)
    want = jdp.solve_schedule_dp_batch(probs)
    tprobs = [tprob.from_reference(p) for p in probs]
    got = tdp.solve_schedule_dp_batch(tprobs, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    tb = tprob.ProblemBatch.from_problems(tprobs)
    tprob.validate_schedule_batch(tb, got)
    np.testing.assert_array_equal(
        tprob.total_cost_batch(tb, got), jprob.total_cost_batch(jprob.ProblemBatch.from_problems(probs), want)
    )


def test_single_instance_matches_reference():
    jp = jcosts.random_problem(np.random.default_rng(9), n=9, T=150, regime="arbitrary")
    tp = tprob.from_reference(jp)
    x = tdp.solve_schedule_dp_torch(tp, device="cpu")
    np.testing.assert_array_equal(x, jdp.solve_schedule_dp_jax(jp))
    tprob.validate_schedule(tp, x)
    assert tprob.total_cost(tp, x) == pytest.approx(tprob.total_cost(tp, tmc.solve_schedule_dp(tp)), rel=1e-5)


def test_host_dp_matches_reference_and_brute_force():
    rng = np.random.default_rng(12)
    for b in range(4):
        jp = jcosts.random_problem(rng, n=4, T=9, regime=REGIMES[b], max_upper=5)
        tp = tprob.from_reference(jp)
        x = tmc.solve_schedule_dp(tp)
        np.testing.assert_array_equal(x, jmc.solve_schedule_dp(jp))
        assert tprob.total_cost(tp, x) == pytest.approx(tprob.total_cost(tp, tmc.brute_force_schedule(tp)))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = paper_problem(tprob, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.solve_schedule_dp_torch(p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.solve_schedule_dp_batch([p, p])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.pack_problem(tprob.remove_lower_limits(p))
