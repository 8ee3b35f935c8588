"""The port's two-level fleet solve (``core/fleet.py``) on the CPU: the
cases of the reference's ``tests/test_fleet.py`` (exactness, the certified
gap against the flat DP, determinism, the facade, the service front-end,
``PlanPolicy``, the FL server's legacy kwargs and fleet-mode round
planning), and parity with the JAX package.

The JAX package seeds k-means with ``jax.random.choice``, the port with
numpy (``_initial_centres``), so the same ``seed`` clusters differently.
Given the same initial centres — the parity tests monkeypatch
``_initial_centres`` to return the indices JAX draws — labels, allocations,
schedules, curves, ``gap_bound`` and the objective must equal the
reference's. Client features must be bit-identical.
"""

from __future__ import annotations

import warnings

import jax
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - clean container
    from _hypothesis_fallback import given, settings, st

from repro.core import SweepEngine as JSweepEngine
from repro.core import fleet as jfleet
from repro.core import random_problem as jrandom_problem
from repro_torch.core import (
    Problem,
    Solver,
    SweepEngine,
    cluster_clients,
    from_reference,
    random_problem,
    solve_fleet,
    total_cost,
    validate_schedule,
)
from repro_torch.core import fleet as tfleet
from repro_torch.core import sweep as tsweep
from repro_torch.core._deprecation import reset_deprecation_warnings
from repro_torch.core.fleet import FleetSolution, PlanPolicy

CPU = "cpu"
REGIMES = ("arbitrary", "linear", "increasing", "decreasing")
# benchmarks/bench_fleet.py's gap cases: (seed, n, T, clusters, quantum)
GAP_CASES = (
    (0, 16, 40, 16, 1),
    (1, 32, 80, None, None),
    (2, 48, 120, 6, 2),
    (3, 64, 160, None, None),
    (4, 64, 192, 8, 3),
)
# random_problem seeds 0-4, regimes cycling, a few clusters and quanta
SEED_CASES = tuple((s, 20 + 6 * s, 3 * (20 + 6 * s), 3 + s, 1 + s % 3, REGIMES[s % 4]) for s in range(5))


@pytest.fixture(autouse=True)
def _quiet_shims():
    reset_deprecation_warnings()
    tsweep.reset_default_engines()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield
    reset_deprecation_warnings()
    tsweep.reset_default_engines()


@pytest.fixture(scope="module")
def jengine():
    """One reference engine for the module: its compiled buckets are shared."""
    return JSweepEngine()


def _jax_centres(n: int, k: int, seed: int) -> np.ndarray:
    return np.asarray(jax.random.choice(jax.random.PRNGKey(int(seed)), n, shape=(k,), replace=False))


def _engine():
    return SweepEngine(device=CPU)


def _flat_objective(problem: Problem, engine) -> float:
    return float(Solver(engine=engine).solve([problem], algorithm="dp_batch").objectives[0])


def _rand(seed: int, n: int, T: int, regime: str = "arbitrary") -> Problem:
    return random_problem(np.random.default_rng(seed), n=n, T=T, regime=regime)


# ---------------------------------------------------------------------------
# exactness
# ---------------------------------------------------------------------------


def test_singleton_clusters_match_flat_dp_exactly():
    p = _rand(0, n=16, T=40)
    eng = _engine()
    fsol = solve_fleet(p, engine=eng, clusters=16, quantum=1)
    assert fsol.num_clusters == 16
    assert fsol.gap_bound <= 1e-6
    assert fsol.objective == pytest.approx(_flat_objective(p, eng), rel=1e-9)
    validate_schedule(p, np.asarray(fsol.schedule))
    assert int(np.sum(fsol.schedule)) == p.T


@pytest.mark.parametrize("k", [2, 4, 7])
def test_quantum_one_is_exact_for_any_clustering(k):
    p = _rand(k, n=24, T=60)
    eng = _engine()
    fsol = solve_fleet(p, engine=eng, clusters=k, quantum=1)
    assert fsol.quantum == 1
    assert fsol.objective == pytest.approx(_flat_objective(p, eng), rel=1e-9)
    assert fsol.gap_bound <= 1e-6
    validate_schedule(p, np.asarray(fsol.schedule))


# ---------------------------------------------------------------------------
# certified gap vs flat DP (hypothesis parity sweep, n <= 64)
# ---------------------------------------------------------------------------


@st.composite
def _fleet_cases(draw):
    return (
        draw(st.integers(min_value=0, max_value=10_000)),  # seed
        draw(st.integers(min_value=4, max_value=24)),  # n
        draw(st.integers(min_value=1, max_value=6)),  # k
        draw(st.integers(min_value=1, max_value=4)),  # q
        draw(st.sampled_from(["arbitrary", "increasing", "decreasing", "linear"])),
    )


@settings(max_examples=12, deadline=None)
@given(_fleet_cases())
def test_fleet_within_certified_gap_of_flat_dp(case):
    seed, n, k, q, regime = case
    p = _rand(seed, n=n, T=max(2 * n, 12), regime=regime)
    eng = _engine()
    fsol = solve_fleet(p, engine=eng, clusters=min(k, n), quantum=q)
    flat = _flat_objective(p, eng)
    scale = max(abs(flat), 1.0)
    assert fsol.objective >= flat - 1e-6 * scale  # the flat DP is optimal
    assert fsol.objective <= flat * (1.0 + fsol.gap_bound) + 1e-6 * scale
    X = np.asarray(fsol.schedule)
    validate_schedule(p, X)
    assert int(X.sum()) == p.T
    assert fsol.objective == pytest.approx(total_cost(p, X), rel=1e-9)


def test_auto_parameters_and_solver_facade_agree():
    p = _rand(3, n=36, T=90)
    via_solver = Solver(engine=_engine()).solve_fleet(p)
    direct = solve_fleet(p, engine=_engine())
    assert via_solver.objective == pytest.approx(direct.objective, rel=1e-12)
    assert np.array_equal(via_solver.schedule, direct.schedule)
    assert via_solver.num_clusters == max(1, round(np.sqrt(36)))
    # without an engine the shared default on the asked device runs it
    np.testing.assert_array_equal(solve_fleet(p, device=CPU).schedule, direct.schedule)


def test_solve_fleet_via_policy_defaults():
    p = _rand(9, n=20, T=50)
    pol = PlanPolicy(fleet_clusters=5, fleet_quantum=2, fleet_seed=7)
    a = Solver(engine=_engine()).solve_fleet(p, policy=pol)
    b = solve_fleet(p, engine=_engine(), clusters=5, quantum=2, seed=7)
    assert a.objective == pytest.approx(b.objective, rel=1e-12)
    assert np.array_equal(a.schedule, b.schedule)


# ---------------------------------------------------------------------------
# k-means determinism
# ---------------------------------------------------------------------------


def test_cluster_labels_deterministic_and_canonical():
    p = _rand(11, n=40, T=100)
    l1 = cluster_clients(p, clusters=6, seed=3, device=CPU)
    l2 = cluster_clients(p, clusters=6, seed=3, device=CPU)
    assert np.array_equal(l1, l2)
    seen = []  # first-appearance canonical numbering
    for lab in l1:
        if lab not in seen:
            seen.append(int(lab))
    assert seen == sorted(seen) and seen[0] == 0
    assert np.array_equal(cluster_clients(p, clusters=40, seed=3, device=CPU), np.arange(40))


def test_fleet_solution_deterministic_under_fixed_seed():
    p = _rand(21, n=48, T=120)
    a = solve_fleet(p, engine=_engine(), seed=5)
    b = solve_fleet(p, engine=_engine(), seed=5)
    assert np.array_equal(a.schedule, b.schedule)
    assert np.array_equal(a.labels, b.labels)
    assert a.objective == b.objective and a.gap_bound == b.gap_bound


def test_initial_centres_are_distinct_seeded_clients():
    a = tfleet._initial_centres(40, 6, 3)
    assert len(set(a.tolist())) == 6 and a.min() >= 0 and a.max() < 40
    np.testing.assert_array_equal(a, tfleet._initial_centres(40, 6, 3))
    assert not np.array_equal(a, tfleet._initial_centres(40, 6, 4))


# ---------------------------------------------------------------------------
# serve-layer front-end
# ---------------------------------------------------------------------------


def test_service_submit_fleet_matches_engine_path():
    from repro_torch.serve import SchedulerService

    p = _rand(17, n=18, T=44)
    svc = SchedulerService(engine=_engine(), max_batch=16, max_delay_s=0.001)
    try:
        fut = svc.submit_fleet(p, clusters=4, quantum=2)
        fsol = fut.result(timeout=120)
        assert fut.done()
    finally:
        svc.close(timeout=30)
    ref = solve_fleet(p, engine=_engine(), clusters=4, quantum=2)
    assert fsol.objective == pytest.approx(ref.objective, rel=1e-9)
    assert np.array_equal(fsol.schedule, ref.schedule)


def test_plan_policy_validation():
    with pytest.raises(ValueError, match="frontier_mode requires time_tables"):
        PlanPolicy(frontier_mode="knee")
    bad = (
        (dict(lookahead=-1), "lookahead must be >= 0"),
        (dict(lookahead=1, fleet_clusters=3), "lookahead speculation requires"),
        (dict(drift_tolerance=0.0), "drift_tolerance must be > 0"),
        (dict(reliability=1.5), "reliability is an EWMA decay"),
        (dict(watermark_quantile=1.0), "watermark_quantile must be in"),
    )
    for kw, msg in bad:
        for cls in (PlanPolicy, jfleet.PlanPolicy):
            with pytest.raises(ValueError, match=msg):
                cls(**kw)
    pol = PlanPolicy(scenario_T_candidates=[3, 4], scenario_dropouts=[[0], [1, 2]], time_tables=[[0, 1]])
    assert pol.scenario_T_candidates == (3, 4) and pol.scenario_dropouts == ((0,), (1, 2))
    assert pol.time_tables[0].dtype == np.float64
    assert PlanPolicy(scenario_dropouts=[[0]]) == PlanPolicy(scenario_dropouts=((0,),))


# ---------------------------------------------------------------------------
# PlanPolicy: legacy FederatedServer kwargs are bit-identical warn-once shims
# ---------------------------------------------------------------------------


def _make_server(**kwargs):
    import torch

    from repro_torch.fl import EnergyEstimator, FederatedServer, make_fleet
    from repro_torch.optim import sgd

    if "policy" not in kwargs:
        kwargs.setdefault("engine", _engine())  # the default engine is the card's
    est = EnergyEstimator(make_fleet(np.random.default_rng(0), 6))
    est.calibrate(np.random.default_rng(1))
    loss = lambda params, batch: torch.mean((params["w"] - batch) ** 2)  # noqa: E731
    return FederatedServer(loss, {"w": torch.ones(())}, sgd(1e-2), est, **kwargs)


def _make_ref_server(**kwargs):
    import jax.numpy as jnp

    from repro.fl import EnergyEstimator, FederatedServer, make_fleet
    from repro.optim.optimizers import sgd

    est = EnergyEstimator(make_fleet(np.random.default_rng(0), 6))
    est.calibrate(np.random.default_rng(1))
    loss = lambda params, batch: jnp.mean((params["w"] - batch) ** 2)  # noqa: E731
    return FederatedServer(loss, {"w": jnp.ones(())}, sgd(1e-2), est, **kwargs)


def test_legacy_server_kwargs_bit_identical_to_policy():
    s_old = _make_server(round_T=12, algorithm="auto")
    s_new = _make_server(policy=PlanPolicy(round_T=12, algorithm="auto", engine=_engine()))
    po, pn = s_old.plan_round(0, 12), s_new.plan_round(0, 12)
    assert np.array_equal(po.assignments, pn.assignments)
    assert po.est_cost == pn.est_cost
    pj = _make_ref_server(round_T=12, algorithm="auto").plan_round(0, 12)
    assert np.array_equal(po.assignments, pj.assignments) and po.est_cost == pj.est_cost


def test_legacy_server_kwargs_warn_once_per_kwarg():
    reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _make_server(round_T=12, algorithm="auto")
        _make_server(round_T=12)  # second use: already warned
    msgs = [str(w.message) for w in rec if issubclass(w.category, DeprecationWarning)]
    # round_T, algorithm and the CPU engine each warn once
    assert len(msgs) == 3
    assert any("FederatedServer(round_T=...)" in m for m in msgs)
    assert any("FederatedServer(algorithm=...)" in m for m in msgs)
    assert any("FederatedServer(engine=...)" in m for m in msgs)
    assert all("PlanPolicy" in m and m.startswith("repro_torch.fl.") for m in msgs)


def test_policy_and_legacy_kwargs_are_mutually_exclusive():
    with pytest.raises(ValueError, match="not both"):
        _make_server(policy=PlanPolicy(), round_T=5)


def test_fleet_mode_round_plan_is_a_valid_schedule(monkeypatch):
    s = _make_server(policy=PlanPolicy(fleet_clusters=3, round_T=12, engine=_engine()))
    plan = s.plan_round(0, 12)
    assert int(plan.assignments.sum()) == 12
    assert plan.est_cost >= 0.0
    # under JAX's initial k-means centres, the reference's round plan
    monkeypatch.setattr(tfleet, "_initial_centres", _jax_centres)
    got = _make_server(policy=PlanPolicy(fleet_clusters=3, round_T=12, engine=_engine())).plan_round(0, 12)
    want = _make_ref_server(policy=jfleet.PlanPolicy(fleet_clusters=3, round_T=12)).plan_round(0, 12)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert got.est_cost == want.est_cost


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_client_features_bit_identical_to_reference(seed):
    jp = jrandom_problem(np.random.default_rng(seed), n=30, T=70, regime=REGIMES[seed % 4])
    p = from_reference(jp)
    np.testing.assert_array_equal(tfleet._client_features(p), jfleet._client_features(jp))
    rng = np.random.default_rng(seed + 100)
    tt = [np.sort(rng.uniform(0.05, 1.0, int(u) + 1)) for u in p.upper]
    np.testing.assert_array_equal(tfleet._client_features(p, tt), jfleet._client_features(jp, tt))


def _assert_fleet_equal(got: FleetSolution, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.allocations, want.allocations)
    np.testing.assert_array_equal(got.schedule, want.schedule)
    curves, wcurves = np.asarray(got.curves), np.asarray(want.curves)
    assert curves.dtype == wcurves.dtype == np.float32 and curves.shape == wcurves.shape
    np.testing.assert_array_equal(curves.view(np.int32), wcurves.view(np.int32))
    assert got.gap_bound == want.gap_bound and got.objective == want.objective
    assert (got.num_clusters, got.quantum) == (want.num_clusters, want.quantum)
    assert got.cluster_stats == want.cluster_stats


@pytest.mark.parametrize("case", GAP_CASES + SEED_CASES, ids=[f"gap{c[0]}" for c in GAP_CASES] + [
    f"seed{c[0]}" for c in SEED_CASES])
def test_fleet_matches_reference_under_the_same_initial_centres(case, jengine, monkeypatch):
    seed, n, T, k, q = case[:5]
    regime = case[5] if len(case) > 5 else "arbitrary"
    jp = jrandom_problem(np.random.default_rng(seed), n=n, T=T, regime=regime)
    monkeypatch.setattr(tfleet, "_initial_centres", _jax_centres)
    got = solve_fleet(from_reference(jp), engine=_engine(), clusters=k, quantum=q, seed=seed)
    want = jfleet.solve_fleet(jp, engine=jengine, clusters=k, quantum=q, seed=seed)
    _assert_fleet_equal(got, want)
    tt = [np.linspace(0.0, 1.0 + 0.1 * i, int(u) + 1) for i, u in enumerate(jp.upper)]
    np.testing.assert_array_equal(
        cluster_clients(from_reference(jp), clusters=5, seed=seed, time_tables=tt, device=CPU),
        jfleet.cluster_clients(jp, clusters=5, seed=seed, time_tables=tt),
    )


def test_numpy_seeding_diverges_from_jax_but_keeps_the_certificate(jengine):
    """Without the patch the same seed starts from other centres than JAX's
    (a known divergence): the clusters may differ, the certificate holds."""
    jp = jrandom_problem(np.random.default_rng(3), n=64, T=160)
    p = from_reference(jp)
    assert not np.array_equal(tfleet._initial_centres(64, 8, 0), _jax_centres(64, 8, 0))
    eng = _engine()
    fsol = solve_fleet(p, engine=eng, clusters=8, quantum=2)
    flat = _flat_objective(p, eng)
    assert flat * (1 - 1e-9) <= fsol.objective <= flat * (1.0 + fsol.gap_bound) + 1e-6
    assert fsol.objective == total_cost(p, fsol.schedule)
