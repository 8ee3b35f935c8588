"""The port's fault injection and device energy model (``fl/faults.py``,
``fl/energy.py``) against the JAX package's, on the CPU.

Both are numpy in the reference and numpy copies in the port: the same
seeds and generators must give equal plans, round faults, residual
instances, fallback schedules, fleets, estimates and persisted state.
"""

import numpy as np
import pytest

from repro.core import Problem as JProblem
from repro.fl import energy as jenergy
from repro.fl import faults as jfaults
from repro_torch.core import problem as tprob
from repro_torch.core import sweep as tsweep
from repro_torch.core.resilience import TransientEngineError
from repro_torch.fl import (
    ClientFault,
    EnergyEstimator,
    FaultInjector,
    FaultPlan,
    FlakyEngine,
    make_fleet,
    proportional_greedy,
    residual_problem,
)

PLAN_KW = dict(num_rounds=6, n_clients=8, p_crash=0.3, p_straggle=0.3, engine_fault_rounds=0.5, p_burst=0.4)


def _instance(rng, n=5, u=9, P=tprob.Problem):
    tables = tuple(np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, u))]) for _ in range(n))
    return P(T=2 * n, lower=np.zeros(n, dtype=np.int64), upper=np.full(n, u, dtype=np.int64), cost_tables=tables)


def _same_problem(a, b):
    assert a.T == b.T
    np.testing.assert_array_equal(a.lower, b.lower)
    np.testing.assert_array_equal(a.upper, b.upper)
    assert len(a.cost_tables) == len(b.cost_tables)
    for x, y in zip(a.cost_tables, b.cost_tables):
        np.testing.assert_array_equal(x, y)


def _plan_fields(plan):
    faults = [(f.round_index, f.client, f.kind, f.severity) for f in plan.client_faults]
    return plan.seed, faults, plan.engine_faults, plan.overload_bursts


# ---------------------------------------------------------------------------
# the plan: one integer seed -> one immutable fault schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 12, 40])
def test_fault_plan_generation_is_deterministic(seed):
    a = FaultPlan.generate(seed, **PLAN_KW)
    assert a == FaultPlan.generate(seed, **PLAN_KW)
    assert a != FaultPlan.generate(seed + 1, **PLAN_KW)
    assert a.client_faults  # with these rates the plan is non-trivial
    for r in range(6):  # the per-round cap guarantees a surviving cohort
        assert len([f for f in a.client_faults if f.round_index == r]) <= 4
    assert _plan_fields(a) == _plan_fields(jfaults.FaultPlan.generate(seed, **PLAN_KW))


def test_client_fault_validation():
    for mod in (jfaults, None):
        cls = ClientFault if mod is None else mod.ClientFault
        with pytest.raises(ValueError, match="unknown fault kind"):
            cls(0, 0, "melt", 0.5)
        with pytest.raises(ValueError, match="completed fraction"):
            cls(0, 0, "crash", 1.5)
        with pytest.raises(ValueError, match="slowdown factor"):
            cls(0, 0, "straggle", 0.5)


def test_round_faults_semantics():
    faults = ((0, 0, "crash", 0.5), (0, 1, "straggle", 2.0), (1, 2, "crash", 0.0))
    inj = FaultInjector(FaultPlan(seed=0, client_faults=tuple(ClientFault(*f) for f in faults)))
    ref = jfaults.FaultInjector(jfaults.FaultPlan(seed=0, client_faults=tuple(jfaults.ClientFault(*f) for f in faults)))
    x = np.array([7, 5, 4], dtype=np.int64)
    rf = inj.round_faults(0, x)
    assert rf.crashed == (0,) and rf.stragglers == (1,)
    np.testing.assert_array_equal(rf.completed, [3, 2, 4])
    assert rf.lost_clients == (0, 1)
    want = ref.round_faults(0, x)
    np.testing.assert_array_equal(rf.completed, want.completed)
    assert (rf.crashed, rf.stragglers, rf.lost_clients) == (want.crashed, want.stragglers, want.lost_clients)
    # a clean round reports None; so does a fault against an x_i = 0 client
    assert inj.round_faults(2, x) is None and ref.round_faults(2, x) is None
    assert inj.round_faults(1, np.array([3, 3, 0])) is None


def test_burst_schedule_is_deterministic():
    plan = FaultPlan(seed=5, overload_bursts=((1, 3),))
    inj = FaultInjector(plan)
    assert inj.burst(0) == 0 and inj.burst(1) == 3
    ref = jfaults.FaultInjector(jfaults.FaultPlan(seed=5, overload_bursts=((1, 3),)))
    for i in range(3):
        p = inj.burst_problem(1, i)
        _same_problem(p, FaultInjector(plan).burst_problem(1, i))
        _same_problem(p, ref.burst_problem(1, i))


# ---------------------------------------------------------------------------
# the recovery math: exact residual instance + guaranteed-feasible fallback
# ---------------------------------------------------------------------------


def test_residual_problem_is_exact_marginal():
    p = _instance(np.random.default_rng(0))
    jp = _instance(np.random.default_rng(0), P=JProblem)
    completed = np.array([2, 0, 3, 1, 0], dtype=np.int64)
    res = residual_problem(p, completed, lost=(1,))
    assert res.T == p.T - int(completed.sum())
    np.testing.assert_array_equal(res.lower, 0)
    assert res.upper[1] == 0  # lost client takes no recovery work
    for i in (0, 2, 3, 4):
        c = int(completed[i])
        np.testing.assert_allclose(res.cost_tables[i], p.cost_tables[i][c : int(p.upper[i]) + 1] - p.cost_tables[i][c])
    _same_problem(res, jfaults.residual_problem(jp, completed, lost=(1,)))
    # the residual instance is feasible by construction, even fleet-wide
    res2 = residual_problem(p, completed, lost=(0, 1, 2, 3))
    assert res2.T <= int(res2.upper.sum())
    _same_problem(res2, jfaults.residual_problem(jp, completed, lost=(0, 1, 2, 3)))


def test_proportional_greedy_is_feasible_and_deterministic():
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(10):
        n = int(rng.integers(2, 7))
        assert n == int(jrng.integers(2, 7))
        p, jp = _instance(rng, n=n), _instance(jrng, n=n, P=JProblem)
        x = proportional_greedy(p)
        tprob.validate_schedule(p, x)
        np.testing.assert_array_equal(x, proportional_greedy(p))
        np.testing.assert_array_equal(x, jfaults.proportional_greedy(jp))
    with pytest.raises(ValueError, match="infeasible fallback"):
        proportional_greedy(
            tprob.Problem(T=5, lower=np.zeros(2, dtype=np.int64), upper=np.ones(2, dtype=np.int64),
                          cost_tables=(np.array([0.0, 1.0]), np.array([0.0, 1.0])))
        )


def test_flaky_engine_raises_at_its_ordinals_and_delegates_otherwise():
    p = _instance(np.random.default_rng(4))
    eng = tsweep.SweepEngine(device="cpu")
    flaky = FaultInjector(FaultPlan(seed=0, engine_faults=(1, 2))).wrap_engine(eng)
    assert isinstance(flaky, FlakyEngine)
    want = eng.solve([p])
    np.testing.assert_array_equal(flaky.solve([p]), want)  # ordinal 0
    for _ in range(2):  # ordinals 1 and 2
        with pytest.raises(TransientEngineError, match="injected engine fault"):
            flaky.dispatch([p])
    np.testing.assert_array_equal(flaky.dispatch([p]).result(), want)
    assert flaky.fault_stats() == {"dispatches": 4, "injected_failures": 2}
    assert flaky.max_entries == eng.max_entries and flaky.device == eng.device  # delegated


# ---------------------------------------------------------------------------
# the device energy model: fleets, estimates and persisted state
# ---------------------------------------------------------------------------


def _both_estimators(seed, n=6, **kw):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    fleet, jfleet = make_fleet(rng, n, **kw), jenergy.make_fleet(jrng, n, **kw)
    est, jest = EnergyEstimator(fleet), jenergy.EnergyEstimator(jfleet)
    est.calibrate(rng)
    jest.calibrate(jrng)
    return est, jest, rng, jrng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_fleet_matches_reference(seed):
    kw = dict(max_batches=12, min_batches=1)
    got = make_fleet(np.random.default_rng(seed), 9, **kw)
    want = jenergy.make_fleet(np.random.default_rng(seed), 9, **kw)
    assert [(d.name, d.device_class, d.max_batches, d.min_batches) for d in got] == [
        (d.name, d.device_class, d.max_batches, d.min_batches) for d in want
    ]
    for d, w in zip(got, want):
        np.testing.assert_array_equal(d.true_table(), w.true_table())
        d.drift_scale = w.drift_scale = 1.3
        np.testing.assert_array_equal(d.true_table(), w.true_table())


@pytest.mark.parametrize("seed", [0, 5])
def test_energy_estimator_matches_reference(seed):
    est, jest, rng, jrng = _both_estimators(seed, max_batches=10)
    T = sum(d.max_batches for d in est.fleet) // 2
    _same_problem(est.problem(T), jest.problem(T))
    _same_problem(est.true_problem(T), jest.true_problem(T))
    # in-band, out-of-band (huber), non-finite and non-positive observations
    for i, dev in enumerate(est.fleet):
        for j in (1, dev.max_batches // 2, dev.max_batches):
            m = dev.measure(j, rng)
            assert m == jest.fleet[i].measure(j, jrng)
            est.observe(i, j, m)
            jest.observe(i, j, m)
        for m in (3.0 * float(est.problem(T).cost_tables[i][1]), np.nan, -1.0):
            est.observe(i, 1, m)
            jest.observe(i, 1, m)
    est.record_round_outcome(range(6), faulty=(1, 4))
    jest.record_round_outcome(range(6), faulty=(1, 4))
    w = est.reliability_weights()
    np.testing.assert_array_equal(w, jest.reliability_weights())
    _same_problem(est.problem(T), jest.problem(T))
    _same_problem(est.problem(T, reliability=w), jest.problem(T, reliability=w))
    _same_problem(est.predict_problem(T, 3), jest.predict_problem(T, 3))
    assert est.uncertainty(2) == jest.uncertainty(2)
    assert est.point_uncertainty(0, 1) == jest.point_uncertainty(0, 1)
    assert est.drain_innovations() == jest.drain_innovations()
    state, jstate = est.state_dict(), jest.state_dict()
    assert sorted(state) == sorted(jstate)
    for k in state:
        np.testing.assert_array_equal(state[k], jstate[k])
        assert np.asarray(state[k]).dtype == np.asarray(jstate[k]).dtype
    # the state round-trips into a fresh estimator of the same fleet
    fresh = EnergyEstimator(est.fleet)
    fresh.load_state_dict(state)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v, state[k])
