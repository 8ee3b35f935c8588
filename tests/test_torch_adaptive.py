"""The port's adaptive planning under drift (``fl/adaptive.py``) on the CPU:
the cases of the reference's ``tests/test_adaptive.py`` and their parity
with the JAX package.

``fl/adaptive.py`` is a numpy copy, so drift plans, detector decisions,
reliability scores and watermark splits must equal the reference's bit for
bit. Campaigns against the reference: schedules, energies and adaptive
telemetry exactly, losses within rtol 1e-5, parameters within atol 1e-5.
"""

import math

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # clean container: deterministic fallback sampler
    from _hypothesis_fallback import given, settings, st

from _torch_fl import (
    CPU,
    assert_histories_equal,
    assert_matches_reference,
    assert_params_equal,
    build_port,
    build_ref,
)

import repro.fl as jfl
from repro.fl import adaptive as jadaptive
from repro_torch.core.sweep import SweepEngine
from repro_torch.fl import (
    ClientFault,
    DriftDetector,
    DriftInjector,
    DriftPlan,
    EnergyEstimator,
    FaultPlan,
    PlanPolicy,
    RoundFaults,
    make_fleet,
    run_campaign,
    watermark_split,
)

ADAPTIVE_POLICY = dict(lookahead=3, drift_tolerance=0.1, watermark_quantile=0.5, reliability=0.25)


def _build(seed=0, n_clients=5, engine=None, policy_kwargs=None):
    return build_port(seed=seed, n_clients=n_clients, engine=engine, policy_kwargs=policy_kwargs)


# ---------------------------------------------------------------------------
# the calibrator: robust observe + persistence
# ---------------------------------------------------------------------------


def _estimator(seed=0, n=4, **kwargs):
    rng = np.random.default_rng(seed)
    fleet = make_fleet(rng, n, max_batches=8)
    est = EnergyEstimator(fleet, **kwargs)
    est.calibrate(rng)
    return est, rng


def test_observe_survives_adversarial_spikes():
    est, _ = _estimator(seed=1)
    before = est._tables[0].copy()
    for bad in (float("nan"), float("inf"), -5.0, 0.0):
        est.observe(0, 3, bad)
        np.testing.assert_array_equal(est._tables[0], before)
    assert est._dropped == 4
    est.observe(0, 3, float(before[3]) * 1000.0)
    after = est._tables[0]
    assert np.all(np.isfinite(after))
    assert float(after[3] / before[3]) <= est.clip + 1e-12
    for _ in range(8):
        est.observe(0, 3, float(before[3]))
    assert abs(float(est._tables[0][3]) - float(before[3])) / float(before[3]) < 0.25


def test_observe_in_band_is_bit_identical_to_legacy_ema():
    est_new, _ = _estimator(seed=2)
    legacy = [t.copy() for t in est_new._tables]
    ema = est_new.ema
    rng = np.random.default_rng(7)
    for _ in range(20):
        i = int(rng.integers(0, len(legacy)))
        j = int(rng.integers(1, len(legacy[i])))
        m = float(legacy[i][j]) * float(1.0 + 0.1 * rng.uniform(-1, 1))
        est_new.observe(i, j, m)
        blended = (1 - ema) * legacy[i][j] + ema * m
        legacy[i] = legacy[i] * (blended / legacy[i][j])
    for a, b in zip(est_new._tables, legacy):
        np.testing.assert_array_equal(a, b)


def test_state_dict_roundtrip_and_legacy_layout():
    est, rng = _estimator(seed=3)
    for _ in range(12):
        i = int(rng.integers(0, 4))
        dev = est.fleet[i]
        j = int(rng.integers(1, dev.max_batches + 1))
        est.observe(i, j, dev.measure(j, rng))
    est.record_round_outcome([0, 1, 2], faulty=[2])
    state = est.state_dict()
    for i in range(4):
        np.testing.assert_array_equal(state[f"{i:04d}"], est._tables[i])
    est2, _ = _estimator(seed=99)
    est2.load_state_dict(state)
    for a, b in zip(est2._tables, est._tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(est2._trend, est._trend)
    np.testing.assert_array_equal(est2._reliability, est._reliability)
    assert est2._point_stats == est._point_stats
    assert est2._dropped == est._dropped
    est3, _ = _estimator(seed=99)
    est3.load_state_dict({f"{i:04d}": est._tables[i] for i in range(4)})
    for a, b in zip(est3._tables, est._tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(est3._reliability, np.ones(4))
    assert est3._point_stats == {}


def test_reliability_downweights_planning_problem_only():
    est, _ = _estimator(seed=4)
    T = sum(d.max_batches for d in est.fleet) // 2
    baseline = est.problem(T)
    truth_before = est.true_problem(T)
    for _ in range(6):
        est.record_round_outcome([0, 1, 2, 3], faulty=[1])
    w = est.reliability_weights()
    assert w[1] < 1.0 and all(w[i] == 1.0 for i in (0, 2, 3))
    p = est.problem(T, reliability=w)
    p.validate()
    assert p.upper[1] < baseline.upper[1]
    assert len(p.cost_tables[1]) == p.upper[1] + 1
    np.testing.assert_array_equal(p.cost_tables[1], baseline.cost_tables[1][: p.upper[1] + 1])
    truth_after = est.true_problem(T)
    np.testing.assert_array_equal(truth_after.upper, truth_before.upper)
    for a, b in zip(truth_after.cost_tables, truth_before.cost_tables):
        np.testing.assert_array_equal(a, b)


def test_predict_problem_extrapolates_trend():
    est, _ = _estimator(seed=5)
    dev = est.fleet[0]
    for _ in range(10):
        est.observe(0, dev.max_batches, float(est._tables[0][dev.max_batches]) * 1.1)
    assert est._trend[0] > 1.0
    T = sum(d.max_batches for d in est.fleet) // 2
    p0, p2 = est.problem(T), est.predict_problem(T, steps=2)
    np.testing.assert_array_equal(p0.upper, p2.upper)
    np.testing.assert_allclose(p2.cost_tables[0], p0.cost_tables[0] * est._trend[0] ** 2)
    for a, b in zip(est.predict_problem(T, steps=0).cost_tables, p0.cost_tables):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# drift plan + detector: deterministic pure functions of (seed, telemetry)
# ---------------------------------------------------------------------------


def test_drift_plan_generation_is_deterministic():
    kw = dict(num_rounds=8, n_clients=6, p_event=0.5)
    a = DriftPlan.generate(11, **kw)
    b = DriftPlan.generate(11, **kw)
    np.testing.assert_array_equal(a.scales, b.scales)
    assert a.events == b.events and a.events
    assert not np.array_equal(a.scales, DriftPlan.generate(12, **kw).scales)
    assert (a.scales > 0).all()


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_drift_plans_and_injection_match_the_reference(seed):
    kw = dict(num_rounds=6, n_clients=5, p_event=0.4)
    a, b = DriftPlan.generate(seed, **kw), jadaptive.DriftPlan.generate(seed, **kw)
    np.testing.assert_array_equal(a.scales, b.scales)
    assert a.events == b.events
    s = DriftPlan.step(num_rounds=6, n_clients=5, round_index=2, clients=(0, 3), factor=3.0)
    t = jadaptive.DriftPlan.step(num_rounds=6, n_clients=5, round_index=2, clients=(0, 3), factor=3.0)
    np.testing.assert_array_equal(s.scales, t.scales)
    assert s.events == t.events
    rng = np.random.default_rng(seed)
    fleet_t = make_fleet(rng, 5, max_batches=8)
    fleet_j = jfl.make_fleet(np.random.default_rng(seed), 5, max_batches=8)
    for r in range(6):
        DriftInjector(a).apply(r, fleet_t)
        jadaptive.DriftInjector(b).apply(r, fleet_j)
        assert [d.drift_scale for d in fleet_t] == [d.drift_scale for d in fleet_j]


def test_drift_detector_flags_step_and_stays_quiet_in_band():
    det = DriftDetector(tolerance=0.1)
    rng = np.random.default_rng(0)
    for _ in range(30):
        assert not det.update(float(rng.normal(0.0, 0.01)))
    assert det.alarms == 0
    flagged = [det.update(0.3) for _ in range(5)]
    assert any(flagged)
    assert det.alarms >= 1


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_drift_detector_is_a_pure_function_of_telemetry(seed):
    """Same telemetry -> same classifications and state as the reference's
    detector, and a state round-trip mid-stream continues identically."""
    rng = np.random.default_rng(seed)
    signal = [float(v) for v in rng.normal(0.0, 0.08, size=40)]
    a, b = DriftDetector(tolerance=0.1), DriftDetector(tolerance=0.1)
    ref = jadaptive.DriftDetector(tolerance=0.1)
    out_a = [a.update(v) for v in signal]
    assert out_a == [ref.update(v) for v in signal]
    assert a.state() == ref.state()
    c = DriftDetector(tolerance=0.1)
    out_b = []
    for t, v in enumerate(signal):
        out_b.append(b.update(v))
        if t == len(signal) // 2:
            c.load_state(b.state())
            b = c
    assert out_a == out_b
    assert a.state() == b.state()


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_reliability_scores_are_a_pure_function_of_outcomes(seed):
    rng = np.random.default_rng(seed)
    est_a, _ = _estimator(seed=6)
    est_b, _ = _estimator(seed=6)
    for _ in range(15):
        part = [int(i) for i in np.nonzero(rng.random(4) < 0.8)[0]]
        faulty = [int(i) for i in part if rng.random() < 0.3]
        est_a.record_round_outcome(part, faulty)
        est_b.record_round_outcome(part, faulty)
    np.testing.assert_array_equal(est_a.reliability_scores(), est_b.reliability_scores())
    np.testing.assert_array_equal(est_a.reliability_weights(), est_b.reliability_weights())


# ---------------------------------------------------------------------------
# the watermark split
# ---------------------------------------------------------------------------


def test_watermark_split_classifies_early_vs_late():
    x = np.array([8, 6, 4, 2], dtype=np.int64)
    faults = RoundFaults(round_index=0, completed=np.array([1, 6, 2, 2], dtype=np.int64), crashed=(0,),
                         stragglers=(2,))
    early, late, wm = watermark_split(faults, x, quantile=0.5)
    assert wm.t_barrier == 8.0 and wm.t_watermark == 5.0
    assert early.crashed == (0,) and early.stragglers == (2,)
    assert late == ()
    np.testing.assert_array_equal(early.completed, [1, 6, 2, 2])
    assert wm.early_detected == (0, 2)
    # the reference splits the same way
    je, jl, jwm = jadaptive.watermark_split(
        jfl.RoundFaults(round_index=0, completed=faults.completed, crashed=(0,), stragglers=(2,)), x, quantile=0.5)
    assert (je.crashed, je.stragglers, jl) == (early.crashed, early.stragglers, late)
    assert jwm.as_dict() == wm.as_dict()

    faults_late = RoundFaults(round_index=0, completed=np.array([7, 6, 4, 2], dtype=np.int64), crashed=(0,),
                              stragglers=())
    early2, late2, wm2 = watermark_split(faults_late, x, quantile=0.5)
    assert early2 is None and late2 == (0,)
    assert wm2.late_detected == (0,)


def test_plan_policy_validates_adaptive_knobs():
    with pytest.raises(ValueError, match="lookahead"):
        PlanPolicy(lookahead=-1)
    with pytest.raises(ValueError, match="drift_tolerance"):
        PlanPolicy(drift_tolerance=0.0)
    with pytest.raises(ValueError, match="reliability"):
        PlanPolicy(reliability=1.5)
    with pytest.raises(ValueError, match="watermark_quantile"):
        PlanPolicy(watermark_quantile=1.0)
    with pytest.raises(ValueError, match="min-energy planning path"):
        PlanPolicy(lookahead=2, frontier_mode="knee", time_tables=())


# ---------------------------------------------------------------------------
# campaign-level: speculation, drift, watermark, chaos
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_stationary_speculation_commits_with_zero_extra_solves():
    R, k = 6, 3
    engine = SweepEngine(device=CPU)
    server, examples, rng, T = _build(seed=2, engine=engine, policy_kwargs=dict(lookahead=k))
    before = engine.cache_stats()
    h = run_campaign(server, examples, R, round_T=T, batch_size=4, rng=rng)
    after = engine.cache_stats()
    dispatches = (after["hits"] + after["misses"]) - (before["hits"] + before["misses"])
    assert dispatches == math.ceil(R / k)
    stats = h.adaptive_stats
    assert stats["speculation_batches"] == math.ceil(R / k)
    assert stats["speculation_hits"] == R - math.ceil(R / k)
    assert stats["speculation_misses"] == 0
    assert stats["speculation_hit_rate"] == 1.0
    assert h.summary()["replan_rate"] == 0.0
    for r in h.rounds:
        assert int(np.asarray(r.assignments).sum()) == T
        if r.adaptive is not None and r.adaptive.speculation == "hit":
            assert r.estimated_joules > 0


@pytest.mark.chaos
def test_abrupt_drift_invalidates_speculation():
    R, k = 6, 3
    drift = DriftPlan.step(num_rounds=R, n_clients=5, round_index=2, clients=(0, 1), factor=3.0)
    server, examples, rng, T = _build(seed=3, policy_kwargs=dict(lookahead=k))
    h = run_campaign(server, examples, R, round_T=T, batch_size=4, rng=rng, drift=drift)
    stats = h.adaptive_stats
    assert stats["drift_rounds"] >= 1
    assert stats["speculation_misses"] >= 1
    drifted = [r.round_index for r in h.rounds if r.adaptive and r.adaptive.drifted]
    assert drifted and min(drifted) >= 2


@pytest.mark.chaos
def test_serial_and_pipelined_adaptive_campaigns_are_bit_identical():
    """The full adaptive policy (speculation, drift, chaos, watermark,
    reliability): serial against pipelined bit for bit, and the serial one
    against the JAX package's."""
    drift = DriftPlan.generate(seed=7, num_rounds=4, n_clients=5, p_event=0.3)
    faults = FaultPlan.generate(seed=13, num_rounds=4, n_clients=5, p_crash=0.4, p_straggle=0.3)
    server_s, ex_s, rng_s, T = _build(seed=1, policy_kwargs=ADAPTIVE_POLICY)
    h_s = run_campaign(server_s, ex_s, 4, round_T=T, batch_size=4, rng=rng_s, faults=faults, drift=drift)
    server_p, ex_p, rng_p, _ = _build(seed=1, policy_kwargs=ADAPTIVE_POLICY)
    h_p = run_campaign(server_p, ex_p, 4, round_T=T, batch_size=4, rng=rng_p, faults=faults, drift=drift,
                       pipelined=True)
    assert_histories_equal(h_s, h_p)
    assert_params_equal(server_s.params, server_p.params)

    server_j, ex_j, rng_j, _ = build_ref(seed=1, policy_kwargs=ADAPTIVE_POLICY)
    h_j = jfl.run_campaign(
        server_j, ex_j, 4, round_T=T, batch_size=4, rng=rng_j,
        faults=jfl.FaultPlan.generate(seed=13, num_rounds=4, n_clients=5, p_crash=0.4, p_straggle=0.3),
        drift=jfl.DriftPlan.generate(seed=7, num_rounds=4, n_clients=5, p_event=0.3),
    )
    assert_matches_reference(h_j, h_s, server_j.params, server_s.params)


@pytest.mark.chaos
def test_killed_adaptive_campaign_resumes_bit_identically(tmp_path):
    drift = DriftPlan.generate(seed=7, num_rounds=5, n_clients=5)
    faults = FaultPlan.generate(seed=23, num_rounds=5, n_clients=5, p_crash=0.3, p_straggle=0.2)
    server_a, ex_a, rng_a, T = _build(seed=5, policy_kwargs=ADAPTIVE_POLICY)
    h_a = run_campaign(server_a, ex_a, 5, round_T=T, batch_size=4, rng=rng_a, faults=faults, drift=drift)

    class _Kill(Exception):
        pass

    def killer(res):
        if res.round_index == 2:
            raise _Kill()

    ckpt = str(tmp_path / "campaign")
    server_b, ex_b, rng_b, _ = _build(seed=5, policy_kwargs=ADAPTIVE_POLICY)
    with pytest.raises(_Kill):
        run_campaign(server_b, ex_b, 5, round_T=T, batch_size=4, rng=rng_b, faults=faults, drift=drift,
                     checkpoint_dir=ckpt, on_round=killer)
    server_c, ex_c, rng_c, _ = _build(seed=5, policy_kwargs=ADAPTIVE_POLICY)
    h_c = run_campaign(server_c, ex_c, 5, round_T=T, batch_size=4, rng=rng_c, faults=faults, drift=drift,
                       checkpoint_dir=ckpt)
    assert_histories_equal(h_a, h_c)
    assert_params_equal(server_a.params, server_c.params)


@pytest.mark.chaos
def test_watermark_recovery_matches_reactive_and_saves_barrier_wait():
    faults = FaultPlan.generate(seed=31, num_rounds=4, n_clients=5, p_crash=0.0, p_straggle=0.6)
    assert faults.client_faults
    server_r, ex_r, rng_r, T = _build(seed=8)
    h_r = run_campaign(server_r, ex_r, 4, round_T=T, batch_size=4, rng=rng_r, faults=faults)
    server_w, ex_w, rng_w, _ = _build(seed=8, policy_kwargs=dict(watermark_quantile=0.5))
    h_w = run_campaign(server_w, ex_w, 4, round_T=T, batch_size=4, rng=rng_w, faults=faults)
    for rr, rw in zip(h_r.rounds, h_w.rounds):
        np.testing.assert_array_equal(rr.assignments, rw.assignments)
        assert rr.mean_loss == rw.mean_loss
        assert rr.energy_joules == rw.energy_joules
    assert_params_equal(server_r.params, server_w.params)
    stats = h_w.adaptive_stats
    assert stats["early_replans"] >= 1
    assert stats["barrier_wait_saved"] > 0.0
    wm_rounds = [r for r in h_w.rounds if r.adaptive and r.adaptive.watermark]
    assert wm_rounds
    for r in wm_rounds:
        wm = r.adaptive.watermark
        assert wm.early_finish <= wm.reactive_finish
        assert wm.late_detected == ()


@pytest.mark.chaos
def test_watermark_late_crash_takes_second_pass():
    server, examples, rng, T = _build(seed=9, policy_kwargs=dict(watermark_quantile=0.2))
    faults = FaultPlan(seed=0, client_faults=(ClientFault(1, 3, "crash", 0.9), ClientFault(1, 1, "straggle", 2.0)))
    h = run_campaign(server, examples, 3, round_T=T, batch_size=4, rng=rng, faults=faults)
    wm = h.rounds[1].adaptive.watermark
    assert wm is not None
    assert 3 in wm.late_detected
    assert 1 in wm.early_detected
    assert wm.saved == 0.0
    assert h.rounds[1].recovery is not None
    assert int(np.asarray(h.rounds[1].assignments).sum()) == T


@pytest.mark.chaos
def test_reliability_downweighting_shrinks_flaky_clients_share():
    faults = FaultPlan(seed=0, client_faults=tuple(ClientFault(r, 0, "crash", 0.3) for r in range(5)))
    server, examples, rng, T = _build(seed=10, policy_kwargs=dict(reliability=0.5))
    truth_before = server.estimator.true_problem(T)
    h = run_campaign(server, examples, 5, round_T=T, batch_size=4, rng=rng, faults=faults)
    w = server.estimator.reliability_weights()
    assert w[0] < 1.0 and all(w[i] == 1.0 for i in range(1, 5))
    assert server.build_problem(T).upper[0] < truth_before.upper[0]
    for r in h.rounds:
        assert int(np.asarray(r.assignments).sum()) == T
    truth_after = server.estimator.true_problem(T)
    np.testing.assert_array_equal(truth_after.upper, truth_before.upper)
    for a, b in zip(truth_after.cost_tables, truth_before.cost_tables):
        np.testing.assert_array_equal(a, b)
