"""The port's fault injection and device energy model (``fl/faults.py``,
``fl/energy.py``) against the JAX package's, on the CPU; and mid-round
recovery and chaos campaigns through the FL server (the cases of the
reference's ``tests/test_faults.py``).

Both modules are numpy in the reference and numpy copies in the port: the
same seeds and generators must give equal plans, round faults, residual
instances, fallback schedules, fleets, estimates and persisted state.
Campaigns against the reference: schedules, energies and recoveries
exactly, losses within rtol 1e-5, parameters within atol 1e-5; a campaign
checkpoint the reference wrote resumes in the port.
"""

import numpy as np
import pytest
from _torch_fl import (
    assert_histories_equal,
    assert_matches_reference,
    assert_params_equal,
    build_port,
    build_ref,
)

import repro.fl as jfl
from repro.core import Problem as JProblem
from repro.fl import energy as jenergy
from repro.fl import faults as jfaults
from repro_torch.core import problem as tprob
from repro_torch.core import sweep as tsweep
from repro_torch.core.resilience import TransientEngineError
from repro_torch.core import Solver, total_cost, validate_schedule
from repro_torch.fl import (
    ClientFault,
    EnergyEstimator,
    FaultInjector,
    FaultPlan,
    FlakyEngine,
    make_fleet,
    proportional_greedy,
    residual_problem,
    run_campaign,
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


# ---------------------------------------------------------------------------
# mid-round recovery through the server
# ---------------------------------------------------------------------------


def _cpu_solver():
    return Solver(engine=tsweep.SweepEngine(device="cpu"))


def test_recover_round_matches_fault_free_replan_of_survivors():
    """The recovered assignment is bit-identical to an INDEPENDENT
    fault-free solve of the exact residual instance, and to the
    reference's recovery of the same round."""
    server, examples, rng, T = build_port(seed=2)
    plan = FaultPlan(seed=0, client_faults=(ClientFault(0, 0, "crash", 0.3), ClientFault(0, 2, "straggle", 2.5)))
    inj = FaultInjector(plan)
    est_problem = server.build_problem(T)
    rp = server.plan_round(0, T, est_problem)
    rf = inj.round_faults(0, rp.assignments)
    rec = server.recover_round(rp, rf)
    ri = rec.recovery
    assert ri is not None and not ri.fallback and ri.attempts == 1
    y_ref = np.asarray(_cpu_solver().solve([ri.residual_problem]).schedules[0], np.int64)
    np.testing.assert_array_equal(ri.recovery_assignments, y_ref)
    np.testing.assert_array_equal(rec.assignments, ri.completed + y_ref)
    for i in ri.failed_clients + ri.straggler_clients:
        assert ri.recovery_assignments[i] == 0
    assert (rec.assignments <= est_problem.upper).all()
    assert rec.est_cost == pytest.approx(float(total_cost(est_problem, rec.assignments)))
    assert rec.est_cost - ri.est_cost_original == pytest.approx(ri.est_overhead_J)

    jserver, _, _, _ = build_ref(seed=2)
    jrp = jserver.plan_round(0, T, jserver.build_problem(T))
    np.testing.assert_array_equal(jrp.assignments, rp.assignments)
    jrec = jserver.recover_round(jrp, jfl.FaultInjector(jfl.FaultPlan(
        seed=0, client_faults=(jfl.ClientFault(0, 0, "crash", 0.3), jfl.ClientFault(0, 2, "straggle", 2.5))
    )).round_faults(0, jrp.assignments))
    np.testing.assert_array_equal(jrec.assignments, rec.assignments)
    assert jrec.est_cost == rec.est_cost
    _same_problem(ri.residual_problem, jrec.recovery.residual_problem)


def test_recover_round_persistent_solver_failure_falls_back():
    flaky = FlakyEngine(tsweep.SweepEngine(device="cpu"), fail_ordinals=range(100))
    server, examples, rng, T = build_port(seed=2, engine=flaky)
    est_problem = server.build_problem(T)
    rp = server.plan_round(0, T, est_problem)  # plain plan: host path, no engine
    victim = int(np.argmax(rp.assignments))
    rf = FaultInjector(FaultPlan(seed=0, client_faults=(ClientFault(0, victim, "crash", 0.2),))).round_faults(
        0, rp.assignments)
    rec = server.recover_round(rp, rf)
    ri = rec.recovery
    assert ri.fallback and ri.attempts == 3
    np.testing.assert_array_equal(ri.recovery_assignments, proportional_greedy(ri.residual_problem))
    validate_schedule(ri.residual_problem, ri.recovery_assignments)
    assert flaky.fault_stats()["injected_failures"] == 3


# ---------------------------------------------------------------------------
# campaign-level chaos
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_zero_fault_plan_is_fully_inert():
    server_a, ex_a, rng_a, T = build_port(seed=0)
    h_a = run_campaign(server_a, ex_a, 3, round_T=T, batch_size=4, rng=rng_a)
    server_b, ex_b, rng_b, _ = build_port(seed=0)
    h_b = run_campaign(server_b, ex_b, 3, round_T=T, batch_size=4, rng=rng_b, faults=FaultPlan(seed=0))
    assert_histories_equal(h_a, h_b)
    assert_params_equal(server_a.params, server_b.params)
    assert "recovered_rounds" not in h_b.summary()


@pytest.mark.chaos
def test_serial_and_pipelined_chaos_campaigns_are_bit_identical():
    """Serial against pipelined bit for bit; the serial campaign against the
    JAX package's."""
    kw = dict(seed=13, num_rounds=4, n_clients=5, p_crash=0.4, p_straggle=0.3)
    plan = FaultPlan.generate(**kw)
    assert plan.client_faults
    server_s, ex_s, rng_s, T = build_port(seed=1)
    h_s = run_campaign(server_s, ex_s, 4, round_T=T, batch_size=4, rng=rng_s, faults=plan)
    server_p, ex_p, rng_p, _ = build_port(seed=1)
    h_p = run_campaign(server_p, ex_p, 4, round_T=T, batch_size=4, rng=rng_p, faults=plan, pipelined=True)
    assert_histories_equal(h_s, h_p)
    assert_params_equal(server_s.params, server_p.params)
    rec_s = [r.round_index for r in h_s.rounds if r.recovery is not None]
    rec_p = [r.round_index for r in h_p.rounds if r.recovery is not None]
    assert rec_s == rec_p and rec_s

    server_j, ex_j, rng_j, _ = build_ref(seed=1)
    h_j = jfl.run_campaign(server_j, ex_j, 4, round_T=T, batch_size=4, rng=rng_j,
                           faults=jfl.FaultPlan.generate(**kw))
    assert_matches_reference(h_j, h_s, server_j.params, server_s.params)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [3, 17])
def test_seeded_chaos_campaigns_complete_with_valid_recoveries(seed):
    plan = FaultPlan.generate(seed=seed, num_rounds=4, n_clients=6, p_crash=0.35, p_straggle=0.25)
    server, examples, rng, T = build_port(seed=seed, n_clients=6)
    h = run_campaign(server, examples, 4, round_T=T, batch_size=4, rng=rng, faults=plan)
    assert len(h.rounds) == 4
    recovered = [r for r in h.rounds if r.recovery is not None]
    assert recovered
    ref = _cpu_solver()
    for r in recovered:
        ri = r.recovery
        y_ref = np.asarray(ref.solve([ri.residual_problem]).schedules[0], np.int64)
        np.testing.assert_array_equal(ri.recovery_assignments, y_ref)
        np.testing.assert_array_equal(r.assignments, ri.completed + y_ref)
    summ = h.summary()
    assert summ["recovered_rounds"] == len(recovered)
    assert summ["recovery_fallbacks"] == 0


@pytest.mark.chaos
def test_transient_engine_faults_leave_campaign_bit_identical():
    server_a, ex_a, rng_a, T = build_port(seed=4)
    h_a = run_campaign(server_a, ex_a, 3, round_T=T, batch_size=4, rng=rng_a)
    inj = FaultInjector(FaultPlan(seed=0, engine_faults=(0, 2)))
    flaky = inj.wrap_engine(tsweep.SweepEngine(device="cpu"))
    server_b, ex_b, rng_b, _ = build_port(seed=4, engine=flaky)
    h_b = run_campaign(server_b, ex_b, 3, round_T=T, batch_size=4, rng=rng_b, faults=inj)
    assert_histories_equal(h_a, h_b)
    assert_params_equal(server_a.params, server_b.params)


@pytest.mark.chaos
def test_frontier_campaign_replans_through_transient_engine_fault():
    """Frontier-mode planning dispatches through the engine, so an injected
    fault hits the plan itself; the runner's re-plan recovers bit-identically,
    and the campaign equals the reference's."""

    def time_tables(seed):
        rng = np.random.default_rng(seed)
        fleet = make_fleet(rng, 4, max_batches=8)
        return [np.sort(rng.uniform(0.1, 2.0, d.max_batches + 1)) for d in fleet]

    def build(engine, ref=False):
        # the reference test draws the time tables between the fleet and the
        # estimator's calibration; here they come from a separate draw
        return (build_ref if ref else build_port)(
            seed=6, n_clients=4, engine=engine,
            policy_kwargs=dict(frontier_mode="knee", time_tables=time_tables(6)))

    server_a, ex_a, rng_a, T = build(tsweep.SweepEngine(device="cpu"))
    h_a = run_campaign(server_a, ex_a, 3, round_T=T, batch_size=4, rng=rng_a)
    inj = FaultInjector(FaultPlan(seed=0, engine_faults=(0,)))
    server_b, ex_b, rng_b, _ = build(inj.wrap_engine(tsweep.SweepEngine(device="cpu")))
    h_b = run_campaign(server_b, ex_b, 3, round_T=T, batch_size=4, rng=rng_b, faults=inj)
    assert server_b.engine.fault_stats()["injected_failures"] == 1
    assert_histories_equal(h_a, h_b)

    server_j, ex_j, rng_j, _ = build(None, ref=True)
    h_j = jfl.run_campaign(server_j, ex_j, 3, round_T=T, batch_size=4, rng=rng_j)
    assert_matches_reference(h_j, h_a, server_j.params, server_a.params)


class _Kill(Exception):
    pass


def _killer(res):
    if res.round_index == 2:
        raise _Kill()


@pytest.mark.chaos
def test_killed_campaign_resumes_bit_identically(tmp_path):
    plan = FaultPlan.generate(seed=23, num_rounds=5, n_clients=5, p_crash=0.3, p_straggle=0.2)
    server_a, ex_a, rng_a, T = build_port(seed=5)
    h_a = run_campaign(server_a, ex_a, 5, round_T=T, batch_size=4, rng=rng_a, faults=plan)

    ckpt = str(tmp_path / "campaign")
    server_b, ex_b, rng_b, _ = build_port(seed=5)
    with pytest.raises(_Kill):
        run_campaign(server_b, ex_b, 5, round_T=T, batch_size=4, rng=rng_b, faults=plan, checkpoint_dir=ckpt,
                     on_round=_killer)
    server_c, ex_c, rng_c, _ = build_port(seed=5)
    h_c = run_campaign(server_c, ex_c, 5, round_T=T, batch_size=4, rng=rng_c, faults=plan, checkpoint_dir=ckpt)
    assert_histories_equal(h_a, h_c)
    assert_params_equal(server_a.params, server_c.params)
    for ra, rc in zip(h_a.rounds, h_c.rounds):
        assert (ra.recovery is None) == (rc.recovery is None)
        if ra.recovery is not None:
            np.testing.assert_array_equal(ra.recovery.recovery_assignments, rc.recovery.recovery_assignments)
            assert ra.recovery.fallback == rc.recovery.fallback
    sa, sc = h_a.summary(), h_c.summary()
    for key in ("rounds", "final_loss", "total_energy_J", "recovered_rounds", "recovery_fallbacks",
                "recovery_overhead_J", "recovery_shortfall"):
        assert sa[key] == sc[key], key


@pytest.mark.chaos
def test_reference_campaign_checkpoint_resumes_in_the_port(tmp_path):
    """A chaos campaign the JAX package checkpointed and killed after round
    2 resumes in the port's ``run_campaign`` from the same directory; the
    continuation equals the reference's uninterrupted campaign."""
    kw = dict(seed=23, num_rounds=5, n_clients=5, p_crash=0.3, p_straggle=0.2)
    server_a, ex_a, rng_a, T = build_ref(seed=5)
    h_a = jfl.run_campaign(server_a, ex_a, 5, round_T=T, batch_size=4, rng=rng_a, faults=jfl.FaultPlan.generate(**kw))

    ckpt = str(tmp_path / "campaign")
    server_b, ex_b, rng_b, _ = build_ref(seed=5)
    with pytest.raises(_Kill):
        jfl.run_campaign(server_b, ex_b, 5, round_T=T, batch_size=4, rng=rng_b, faults=jfl.FaultPlan.generate(**kw),
                         checkpoint_dir=ckpt, on_round=_killer)
    server_c, ex_c, rng_c, _ = build_port(seed=5, params_seed=99)  # the checkpoint's parameters replace these
    h_c = run_campaign(server_c, ex_c, 5, round_T=T, batch_size=4, rng=rng_c, faults=FaultPlan.generate(**kw),
                       checkpoint_dir=ckpt)
    assert_matches_reference(h_a, h_c, server_a.params, server_c.params)
    assert [r.recovery is not None for r in h_c.rounds] == [r.recovery is not None for r in h_a.rounds]
