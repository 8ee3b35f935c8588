"""The port's ``Solver`` facade, its deprecated shims, the resilience
policies and the Pareto frontiers (``core/solver.py``, ``core/scheduler.py``,
``core/resilience.py``, ``core/pareto.py``, ``core/costs.py``'s
``CostWindows``) against the JAX package, on the CPU.

Schedules, resolved algorithms (the DP names translated: ``dp_torch`` for
``dp_jax``, ``dp_torch_cuda`` for ``dp_jax_pallas``), regimes and Pareto
points must be identical, ``k_last`` rows bit-identical float32 and
``Solution.objective`` an equal float64. What waits for later slices
(``service=``, ``solve_fleet``) must raise ``NotImplementedError``.
"""

import itertools
import warnings

import numpy as np
import pytest

from repro.core import Solver as JSolver
from repro.core import SweepEngine as JSweepEngine
from repro.core import costs as jcosts
from repro.core import pareto as jpareto
from repro.core import problem as jprob
from repro.core import resilience as jres
from repro.core import scheduler as jsched
from repro.core import sweep as jsweep
from repro_torch.core import costs as tcosts
from repro_torch.core import pareto as tpareto
from repro_torch.core import problem as tprob
from repro_torch.core import resilience as tres
from repro_torch.core import scheduler as tsched
from repro_torch.core import sweep as tsweep
from repro_torch.core import torch_dp as tdp
from repro_torch.core._deprecation import reset_deprecation_warnings
from repro_torch.core.mc2mkp import solve_schedule_dp
from repro_torch.core.solver import Solution, SolutionBatch, Solver

CPU = "cpu"
REGIMES = ("arbitrary", "linear", "increasing", "decreasing")


@pytest.fixture(autouse=True)
def _quiet_shims():
    """Each test sees fresh warn-once state and never fails on the shims'
    own DeprecationWarnings; the port's shared engines start empty."""
    reset_deprecation_warnings()
    tsweep.reset_default_engines()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield
    reset_deprecation_warnings()
    tsweep.reset_default_engines()


def mixed_problems(seed=0, B=6, n=5, T=14):
    rng = np.random.default_rng(seed)
    return [jcosts.random_problem(rng, n=n, T=T, regime=REGIMES[b % len(REGIMES)], max_upper=8) for b in range(B)]


def time_tables_for(p, seed=1):
    rng = np.random.default_rng(seed)
    tt = [np.sort(rng.uniform(0.1, 2.0, int(u) + 1)) for u in p.upper]
    for t in tt:
        t[0] = 0.0
    return tt


def port(obj):
    if isinstance(obj, list):
        return [tprob.from_reference(p) for p in obj]
    return tprob.from_reference(obj)


def cpu_solver(**kw):
    return Solver(device=CPU, **kw)


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def assert_batches_equal(got: SolutionBatch, want):
    assert len(got) == len(want)
    for xg, xw in zip(got.schedules, want.schedules):
        np.testing.assert_array_equal(xg, xw)
    np.testing.assert_array_equal(got.objectives, want.objectives)
    assert got.algorithms == want.algorithms and got.regimes == want.regimes


# ---------------------------------------------------------------------------
# the facade and its shims against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alg", ["auto", "dp", "dp_torch"])
def test_solve_one_instance_matches_shim_and_reference(alg):
    jalg = {"dp_torch": "dp_jax"}.get(alg, alg)
    for jp in mixed_problems():
        p = port(jp)
        old = tsched.schedule(p, algorithm=alg, device=CPU)
        new = cpu_solver().solve(p, algorithm=alg)
        ref = JSolver().solve(jp, algorithm=jalg)
        assert isinstance(new, Solution)
        np.testing.assert_array_equal(new.schedule, old)
        np.testing.assert_array_equal(new.schedule, ref.schedule)
        assert new.algorithm != "auto" and new.algorithm == {"dp_jax": "dp_torch"}.get(ref.algorithm, ref.algorithm)
        assert new.objective == tprob.total_cost(p, old) == ref.objective
        assert new.regime == p.regime() == ref.regime


@pytest.mark.parametrize("alg", ["auto", "dp_batch", "marin", "olar"])
def test_schedule_batch_shim_matches_facade_and_reference(alg):
    jprobs = mixed_problems(seed=2)
    if alg == "marin":
        jprobs = [p for p in jprobs if p.regime() == "increasing"]
    probs = port(jprobs)
    eng = tsweep.SweepEngine(device=CPU)
    old = tsched.schedule_batch(probs, algorithm=alg, engine=eng)
    new = cpu_solver(engine=eng).solve(probs, algorithm=alg)
    ref = JSolver(engine=JSweepEngine()).solve(jprobs, algorithm=alg)
    for xo, xn in zip(old, new.schedules):
        np.testing.assert_array_equal(xo, xn)
    assert_batches_equal(new, ref)
    if alg == "dp_batch":  # DP-name solves carry the free final rows
        assert_bits_equal(new.k_last, ref.k_last)
    else:
        assert new.k_last is None and ref.k_last is None


def test_dp_torch_cuda_forces_the_cuda_backend():
    """``dp_torch_cuda`` (the reference's ``dp_jax_pallas``) runs on the
    shared engine of backend "cuda" whatever the solver's engine; on CPU
    tensors the kernels' wrappers run their plain versions."""
    jprobs = mixed_problems(seed=3, B=4)
    eng = tsweep.SweepEngine(device=CPU)
    sol = cpu_solver(engine=eng).solve(port(jprobs), algorithm="dp_torch_cuda")
    assert eng.cache_stats()["misses"] == 0
    assert tsweep.default_engine("cuda", CPU).cache_stats()["misses"] == 1
    ref = JSolver().solve(jprobs, algorithm="dp_batch")
    assert_batches_equal(sol, ref)
    assert_bits_equal(sol.k_last, ref.k_last)


def test_schedule_with_deadline_shim_bit_identity():
    jp = mixed_problems(seed=4, B=1)[0]
    p = port(jp)
    tt = time_tables_for(p)
    D = float(max(t[-1] for t in tt))  # loosest: always feasible
    old = tsched.schedule_with_deadline(p, tt, D, device=CPU)
    new = cpu_solver().solve(p, deadline=D, time_tables=tt)
    np.testing.assert_array_equal(old, new.schedule)
    np.testing.assert_array_equal(new.schedule, JSolver().solve(jp, deadline=D, time_tables=tt).schedule)
    assert new.deadline == D
    with pytest.raises(ValueError):
        cpu_solver().solve(p, deadline=D)  # time_tables go with deadline


def test_deadline_sweep_shim_matches_facade_and_reference():
    jp = mixed_problems(seed=5, B=1)[0]
    p = port(jp)
    tt = time_tables_for(p, seed=6)
    hi = float(max(t[-1] for t in tt))
    deadlines = np.linspace(0.7 * hi, hi, 5)
    eng = tsweep.SweepEngine(device=CPU)
    old = tsched.deadline_sweep(p, tt, deadlines, engine=eng)
    new = cpu_solver(engine=eng).sweep(p, tt, deadlines)
    ref = JSolver(engine=JSweepEngine()).sweep(jp, tt, deadlines)
    np.testing.assert_array_equal(old, np.stack(new.schedules))
    np.testing.assert_array_equal(new.deadlines, deadlines)
    assert_batches_equal(new, ref)
    assert_bits_equal(new.k_last, ref.k_last)
    assert eng.cache_stats()["hits"] == 1 and eng.cache_stats()["compiles"] == 1
    with pytest.raises(ValueError, match="sweep point"):
        cpu_solver(engine=eng).sweep(p, tt, [1e-9])
    with pytest.raises(ValueError, match="deadline_sweep point"):
        tsched.deadline_sweep(p, tt, [1e-9], engine=eng)


def test_cached_solve_shims_bit_identity():
    jprobs = mixed_problems(seed=7)
    probs = port(jprobs)
    eng = tsweep.SweepEngine(device=CPU)
    old_dp = tsweep.solve_dp_batch_cached(probs, engine=eng)
    new_dp = cpu_solver(engine=eng).solve(probs, algorithm="dp_batch")
    np.testing.assert_array_equal(old_dp, jsweep.solve_dp_batch_cached(jprobs, engine=JSweepEngine()))
    for b, p in enumerate(probs):
        np.testing.assert_array_equal(old_dp[b, : p.n], new_dp.schedules[b])
    old_split = tsweep.solve_schedule_batch_cached(probs, engine=eng)
    new_split = cpu_solver(engine=eng).solve(probs)  # auto = regime-split path
    np.testing.assert_array_equal(old_split, jsweep.solve_schedule_batch_cached(jprobs, engine=JSweepEngine()))
    for b, p in enumerate(probs):
        np.testing.assert_array_equal(old_split[b, : p.n], new_split.schedules[b])


def test_shims_warn_exactly_once():
    p = port(mixed_problems(seed=8, B=1)[0])
    tt = time_tables_for(p, seed=8)
    reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tsched.schedule(p, device=CPU)
        tsched.schedule(p, device=CPU)  # second call: silent
        tsched.deadline_sweep(p, tt, [float(max(t[-1] for t in tt))], device=CPU)
        tsched.deadline_sweep(p, tt, [float(max(t[-1] for t in tt))], device=CPU)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 2  # one per distinct shim, not per call
    assert any("repro_torch.core.schedule is deprecated" in str(w.message) for w in dep)
    assert all("Solver" in str(w.message) for w in dep)
    with warnings.catch_warnings(record=True) as rec:  # the facade never warns
        warnings.simplefilter("always")
        cpu_solver().solve(p)
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]


def test_solution_batch_roundtrip():
    jprobs = mixed_problems(seed=9)
    probs = port(jprobs)
    sol = cpu_solver(engine=tsweep.SweepEngine(device=CPU)).solve(tprob.ProblemBatch.from_problems(probs))
    assert_batches_equal(sol, JSolver(engine=JSweepEngine()).solve(jprob.ProblemBatch.from_problems(jprobs)))
    assert len(sol) == len(probs)
    for b, s in enumerate(sol):
        np.testing.assert_array_equal(s.schedule, sol.schedules[b])
        assert s.objective == float(sol.objectives[b])
        assert s.regime == probs[b].regime() and s.algorithm == sol.algorithms[b]
    np.testing.assert_array_equal(sol[-1].schedule, sol.schedules[-1])
    assert sol.cache_stats is not None and "hits" in sol.cache_stats


def test_substrate_conflicts_raise():
    eng = tsweep.SweepEngine(backend="ref", device=CPU)
    with pytest.raises(ValueError, match="conflicts"):
        Solver(engine=eng, backend="blocked")
    assert Solver(engine=eng, backend="ref").engine is eng
    assert cpu_solver().engine is tsweep.default_engine("auto", CPU)


def test_solution_objective_is_exact_float64():
    tables = (np.array([0.0, 0.1, 0.2, 0.3]), np.array([0.0, 0.15, 0.25, 0.35]))
    p = tprob.Problem(T=3, lower=[0, 0], upper=[3, 3], cost_tables=tables)
    sol = cpu_solver().solve(p)
    assert sol.objective == tprob.total_cost(p, sol.schedule)
    assert sol.objective == JSolver().solve(jprob.Problem(T=3, lower=[0, 0], upper=[3, 3], cost_tables=tables)).objective


def test_service_and_fleet_raise_not_implemented():
    p = port(mixed_problems(seed=10, B=1)[0])
    tt = time_tables_for(p)
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        Solver(service=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
        cpu_solver().solve_fleet(p)
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        tpareto.pareto_frontier(p, tt, service=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        tpareto.frontier_by_window(p, tt, tcosts.CostWindows(("a",), np.ones((1, p.n))), service=object(), device=CPU)


def test_solver_without_a_card_raises_by_default():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        Solver()


# ---------------------------------------------------------------------------
# resilience: retries, backoff from one seed, the breaker
# ---------------------------------------------------------------------------


def test_retry_delays_match_reference_from_one_seed():
    def run(mod):
        delays, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise mod.TransientEngineError("flaky")
            return len(calls)

        pol = mod.RetryPolicy(max_attempts=5, base_delay_s=0.01, jitter=0.5, seed=3)
        out = mod.retry_call(flaky, pol, rng=pol.make_rng(), sleep=delays.append)
        return out, delays

    got, want = run(tres), run(jres)
    assert got == want and got[0] == 4 and len(got[1]) == 3


def test_retry_gives_up_and_fails_fast_like_the_reference():
    for mod in (tres, jres):
        pol = mod.RetryPolicy(max_attempts=2, base_delay_s=0.0)
        with pytest.raises(mod.TransientEngineError):
            mod.retry_call(lambda: (_ for _ in ()).throw(mod.TransientEngineError("x")), pol, sleep=lambda s: None)
        calls = []

        def bug():
            calls.append(1)
            raise KeyError("not transient")

        with pytest.raises(KeyError):
            mod.retry_call(bug, pol, sleep=lambda s: None)
        assert len(calls) == 1
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=0)
    assert tres.is_transient(type("E", (Exception,), {"transient": True})())


def test_solver_retries_a_flaky_engine():
    class FlakyEngine(tsweep.SweepEngine):
        def __init__(self, fails, **kw):
            super().__init__(**kw)
            self.fails = fails

        def dispatch(self, problems, split_regimes=False):
            if self.fails:
                self.fails -= 1
                raise tres.TransientEngineError("injected")
            return super().dispatch(problems, split_regimes=split_regimes)

    probs = port(mixed_problems(seed=11, B=4))
    want = cpu_solver(engine=tsweep.SweepEngine(device=CPU)).solve(probs, algorithm="dp_batch")
    pol = tres.RetryPolicy(max_attempts=3, base_delay_s=0.0005)
    got = cpu_solver(engine=FlakyEngine(2, device=CPU), retry=pol).solve(probs, algorithm="dp_batch")
    assert_batches_equal(got, want)
    with pytest.raises(tres.TransientEngineError):
        cpu_solver(engine=FlakyEngine(3, device=CPU), retry=pol).solve(probs, algorithm="dp_batch")
    with pytest.raises(tres.TransientEngineError):  # no policy: no retries
        cpu_solver(engine=FlakyEngine(1, device=CPU)).solve(probs, algorithm="dp_batch")


def test_circuit_breaker_matches_reference():
    def run(mod):
        now = [0.0]
        br = mod.CircuitBreaker(failure_threshold=2, cooldown_s=1.0, clock=lambda: now[0])
        trace = []
        for step in ("f", "s", "f", "f", "a", "t1.5", "a", "a", "f", "t3", "a", "s", "a"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "a":
                trace.append(br.allow())
            else:
                now[0] = float(step[1:])
            trace.append(br.state)
        return trace, br.stats()

    assert run(tres) == run(jres)


# ---------------------------------------------------------------------------
# Pareto frontiers
# ---------------------------------------------------------------------------


def small_instance(seed=3, n=4, T=10):
    """Instance tiny enough to enumerate every feasible schedule."""
    rng = np.random.default_rng(seed)
    p = jcosts.random_problem(rng, n=n, T=T, regime="arbitrary", max_upper=6)
    tt = [np.sort(rng.uniform(0.1, 2.0, int(u) + 1)) for u in p.upper]
    for t in tt:
        t[0] = 0.0
    return p, tt


def enumerate_pareto(p, tt):
    times, energies = [], []
    for x in itertools.product(*[range(int(lo), int(hi) + 1) for lo, hi in zip(p.lower, p.upper)]):
        if sum(x) != p.T:
            continue
        times.append(max(float(tt[i][j]) for i, j in enumerate(x)))
        energies.append(float(tprob.total_cost(p, np.asarray(x))))
    times, energies = np.asarray(times), np.asarray(energies)
    idx = tpareto.pareto_indices(times, energies)
    return times[idx], energies[idx]


def assert_fronts_equal(got, want):
    assert len(got) == len(want) and got.num_swept == want.num_swept
    for a, b in zip(got, want):
        assert (a.time, a.energy, a.deadline, a.label) == (b.time, b.energy, b.deadline, b.label)
        np.testing.assert_array_equal(a.schedule, b.schedule)


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_frontier_matches_reference_and_full_enumeration(seed):
    jp, tt = small_instance(seed=seed)
    p = port(jp)
    front = tpareto.pareto_frontier(p, tt, device=CPU)
    assert_fronts_equal(front, jpareto.pareto_frontier(jp, tt))
    bt, be = enumerate_pareto(p, tt)
    np.testing.assert_array_equal(front.times, bt)
    np.testing.assert_array_equal(front.energies, be)
    for pt in front:
        assert pt.schedule.sum() == p.T and pt.time <= pt.deadline
        assert pt.energy == tprob.total_cost(p, pt.schedule)
    assert np.all(np.diff(front.times) > 0) and np.all(np.diff(front.energies) < 0)


def test_weighted_sum_optima_lie_on_the_frontier():
    jp, tt = small_instance(seed=5, n=5, T=12)
    p = port(jp)
    solver = cpu_solver()
    front = solver.frontier(p, tt)
    weights = [(w, 1.0 - w) for w in np.linspace(0.0, 1.0, 9)]
    pts = solver.solve_scalarized(p, tt, weights)
    ref = JSolver().solve_scalarized(jp, tt, weights)
    assert [(q.time, q.energy) for q in pts] == [(q.time, q.energy) for q in ref]
    pairs = {(q.time, q.energy) for q in front}
    assert all((pt.time, pt.energy) in pairs for pt in pts)
    assert front.scalarize(1.0, 0.0) is front.min_energy()
    assert front.scalarize(0.0, 1.0) is front.min_time()
    with pytest.raises(ValueError):
        front.scalarize(0.0, 0.0)


def test_epsilon_constraint_lookups():
    jp, tt = small_instance(seed=18, n=5, T=12)
    p = port(jp)
    solver = cpu_solver()
    front = solver.frontier(p, tt)
    assert len(front) >= 4
    mid_t = 0.5 * (front.times[0] + front.times[-1])
    pt = front.constrain(T_max=mid_t)
    assert pt.time <= mid_t and pt.energy == front.energies[front.times <= mid_t].min()
    mid_e = 0.5 * (front.energies[0] + front.energies[-1])
    qt = front.constrain(E_max=mid_e)
    assert qt.energy <= mid_e and qt.time == front.times[front.energies <= mid_e].min()
    assert solver.solve_constrained(p, tt, T_max=mid_t).energy == pt.energy
    assert solver.solve_constrained(p, tt, E_max=mid_e).time == qt.time
    assert JSolver().solve_constrained(jp, tt, T_max=mid_t).energy == pt.energy
    for kw in ({"T_max": front.times[0] * 0.5}, {"E_max": front.energies[-1] * 0.5}, {}, {"T_max": 1.0, "E_max": 1.0}):
        with pytest.raises(ValueError):
            front.constrain(**kw)
    assert front.select("min_time") is front.min_time()
    assert front.select("min_energy") is front.min_energy()
    assert front.select("knee") is front.knee()
    assert front.knee().time == jpareto.pareto_frontier(jp, tt).knee().time
    assert front.select(float(front.times[-1])) is front.min_energy()
    with pytest.raises(ValueError):
        front.select("fastest-ish")


@pytest.mark.parametrize("regime", ["increasing", "decreasing", "linear"])
def test_monotone_fast_path_frontier_matches_dp_and_reference(regime):
    rng = np.random.default_rng(41 + REGIMES.index(regime))
    jp = jcosts.random_problem(rng, n=5, T=14, regime=regime, max_upper=8)
    tt = [np.sort(rng.uniform(0.1, 2.0, int(u) + 1)) for u in jp.upper]
    for t in tt:
        t[0] = 0.0
    p = port(jp)
    fast = tpareto.pareto_frontier(p, tt, split_regimes=True, device=CPU)
    dp = tpareto.pareto_frontier(p, tt, split_regimes=False, device=CPU)
    np.testing.assert_array_equal(fast.times, dp.times)
    np.testing.assert_allclose(fast.energies, dp.energies, rtol=0, atol=1e-9)
    assert_fronts_equal(fast, jpareto.pareto_frontier(jp, tt, split_regimes=True))


def test_frontier_and_all_windows_are_one_dispatch():
    jp, tt = small_instance(seed=13, n=5, T=12)
    p = port(jp)
    eng = tsweep.SweepEngine(device=CPU)
    before = eng.cache_stats()
    front = tpareto.pareto_frontier(p, tt, engine=eng)
    after = eng.cache_stats()
    assert (after["hits"] + after["misses"]) - (before["hits"] + before["misses"]) == 1
    assert front.num_swept == len(tpareto.candidate_deadlines(p, tt))
    intens = np.asarray([[100.0] * p.n, [50.0] * p.n, [200.0] * p.n])
    windows = tcosts.CostWindows.from_carbon_intensities(("night", "midday", "evening"), intens)
    before = eng.cache_stats()
    fronts = cpu_solver(engine=eng).frontier(p, tt, windows=windows)
    after = eng.cache_stats()
    assert (after["hits"] + after["misses"]) - (before["hits"] + before["misses"]) == 1
    ref = jpareto.frontier_by_window(jp, tt, jcosts.CostWindows.from_carbon_intensities(("night", "midday", "evening"),
                                                                                        intens))
    assert set(fronts) == set(ref) == {"night", "midday", "evening"}
    for label, f in fronts.items():
        assert all(pt.label == label for pt in f)
        assert_fronts_equal(f, ref[label])
    np.testing.assert_array_equal(fronts["night"].times, fronts["evening"].times)
    np.testing.assert_allclose(fronts["evening"].energies, 2.0 * fronts["night"].energies, rtol=1e-12)


def test_cost_windows_validation_and_carbon_math():
    with pytest.raises(ValueError):
        tcosts.CostWindows(labels=("a",), multipliers=np.asarray([[1.0, -0.5]]))
    with pytest.raises(ValueError):
        tcosts.CostWindows(labels=("a", "b"), multipliers=np.asarray([[1.0, 1.0]]))
    w = tcosts.CostWindows.from_carbon_intensities(("w",), np.asarray([[360.0, 720.0]]))
    np.testing.assert_allclose(w.multipliers[0], [0.1, 0.2])  # g/kWh * mg/g / (J/kWh) = mg per J
    jw = jcosts.CostWindows.from_carbon_intensities(("w",), np.asarray([[360.0, 720.0]]))
    np.testing.assert_array_equal(w.multipliers, jw.multipliers)
    jp, _ = small_instance(seed=3, n=2, T=4)
    p = port(jp)
    (wp,) = w.apply(p)
    (jwp,) = jw.apply(jp)
    for a, b in zip(wp.cost_tables, jwp.cost_tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(wp.cost_tables[0], 0.1 * p.cost_tables[0])
    with pytest.raises(ValueError, match="multipliers cover"):
        tcosts.CostWindows(("a",), np.ones((1, 3))).apply(p)
    e = np.array([0.0, 3.6e6, 7.2e6])
    assert tcosts.JOULES_PER_KWH == jcosts.JOULES_PER_KWH == 3.6e6
    np.testing.assert_array_equal(tcosts.carbon_cost_table(e, 400.0), jcosts.carbon_cost_table(e, 400.0))
    np.testing.assert_allclose(tcosts.carbon_cost_table(e, 400.0), [0.0, 4e5, 8e5])


def test_candidate_deadlines_and_grid_match_reference():
    jp, tt = small_instance(seed=21, n=5, T=12)
    p = port(jp)
    cands = tpareto.candidate_deadlines(p, tt)
    np.testing.assert_array_equal(cands, jpareto.candidate_deadlines(jp, tt))
    assert tpareto.feasible_deadline_range(p, tt) == (cands[0], cands[-1]) == jpareto.feasible_deadline_range(jp, tt)
    assert np.all(np.diff(cands) > 0)
    assert all(float(d) in {float(v) for t in tt for v in t} for d in cands)
    grid = tpareto.deadline_grid(p, tt, points=4)
    np.testing.assert_array_equal(grid, jpareto.deadline_grid(jp, tt, 4))
    assert len(grid) <= 4 and grid[0] == cands[0] and grid[-1] == cands[-1]
    exact = tpareto.pareto_frontier(p, tt, device=CPU)
    sub = cpu_solver().frontier(p, tt, grid)
    pairs = {(q.time, q.energy) for q in exact}
    assert all((pt.time, pt.energy) in pairs for pt in sub)
    with pytest.raises(ValueError, match="frontier point"):
        tpareto.pareto_frontier(p, tt, [1e-9], device=CPU)


def test_sweep_handle_workload_frontier():
    jp, _ = small_instance(seed=7, n=4, T=8)
    handle = tsweep.SweepEngine(device=CPU).dispatch([port(jp)], split_regimes=False)
    idx, energies = handle.frontier(0)
    k_row = np.asarray(handle.k_last())[0]
    assert np.all(np.diff(idx) > 0) and np.all(np.diff(energies) > 0)
    np.testing.assert_array_equal(energies, k_row[idx])
    ref_idx, ref_e = jsweep.SweepEngine().dispatch([jp], split_regimes=False).frontier(0)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(energies, ref_e)


# ---------------------------------------------------------------------------
# schedule_batch dispatch + deadline_sweep (the batch-scheduling cases)
# ---------------------------------------------------------------------------


def random_mixed(rng, B, max_n=6, max_T=24):
    out = []
    for b in range(B):
        n = int(rng.integers(1, max_n + 1))
        out.append(jcosts.random_problem(rng, n=n, T=int(rng.integers(max(1, n), max_T + 1)), regime=REGIMES[b % 4]))
    return out


def test_schedule_batch_auto_dispatch_matches_reference_and_is_optimal():
    jprobs = random_mixed(np.random.default_rng(20), 12)
    probs = port(jprobs)
    xs = tsched.schedule_batch(probs, "auto", device=CPU)
    for x, xr in zip(xs, jsched.schedule_batch(jprobs, "auto")):
        np.testing.assert_array_equal(x, xr)
    for p, x in zip(probs, xs):
        tprob.validate_schedule(p, x)
        assert tprob.total_cost(p, x) == pytest.approx(tprob.total_cost(p, solve_schedule_dp(p)), rel=1e-5, abs=1e-9)


def test_schedule_batch_named_algorithms():
    rng = np.random.default_rng(21)
    probs = port([jcosts.random_problem(rng, n=4, T=15, regime="increasing") for _ in range(4)])
    for alg in ("dp_batch", "marin", "olar"):
        for p, x in zip(probs, tsched.schedule_batch(probs, alg, device=CPU)):
            tprob.validate_schedule(p, x)
    with pytest.raises(ValueError):
        tsched.schedule_batch(probs, "no_such_algorithm", device=CPU)
    assert tsched.schedule_batch([], device=CPU) == []


def test_deadline_sweep_matches_looped_and_is_monotone():
    rng = np.random.default_rng(22)
    n, T = 5, 30
    jp = jcosts.random_problem(rng, n=n, T=T, regime="increasing")
    p = port(jp)
    times = [np.arange(int(u) + 1) / s for u, s in zip(p.upper, rng.uniform(0.5, 3.0, size=n))]
    x_free = solve_schedule_dp(p)
    d_max = max(float(times[i][int(x_free[i])]) for i in range(n))
    deadlines = [d_max * f for f in (1.0, 1.5, 2.5, 10.0)]
    X = tsched.deadline_sweep(p, times, deadlines, device=CPU)
    assert X.shape == (len(deadlines), n)
    np.testing.assert_array_equal(X, jsched.deadline_sweep(jp, times, deadlines))
    prev = None
    for d, x in zip(deadlines, X):
        tprob.validate_schedule(p, x)
        assert all(times[i][int(x[i])] <= d + 1e-9 for i in range(n))
        x_loop = tsched.schedule_with_deadline(p, times, d, algorithm="dp_torch", device=CPU)
        assert tprob.total_cost(p, x) == pytest.approx(tprob.total_cost(p, x_loop), rel=1e-5)
        e = tprob.total_cost(p, x)
        assert prev is None or e <= prev + 1e-9
        prev = e
    with pytest.raises(ValueError, match="deadline_sweep point"):
        tsched.deadline_sweep(p, times, [100.0, 1e-9], device=CPU)


def test_solve_batch_on_the_cpu_takes_the_plain_dp():
    """The facade's DP dispatch on the CPU runs the plain path and agrees
    with the uncached solve."""
    probs = port(random_mixed(np.random.default_rng(23), 5))
    sol = cpu_solver().solve(probs, algorithm="dp")
    X = tdp.solve_schedule_dp_batch(probs, device=CPU)
    for b, p in enumerate(probs):
        np.testing.assert_array_equal(sol.schedules[b], X[b, : p.n])
    assert sol.algorithms == ["dp_batch"] * len(probs)


def test_public_facade_grows_toward_the_reference():
    """The port's ``__all__`` holds the reference facade's names this slice
    ported (the fleet, serving and FL-runtime names come with their
    slices), each defined in the port, plus the solver entry points."""
    import repro
    import repro_torch

    ported = {"CircuitBreaker", "ParetoFrontier", "Problem", "ProblemBatch", "RetryPolicy", "Solution",
              "SolutionBatch", "Solver", "TransientEngineError"}
    assert set(repro_torch.__all__) & set(repro.__all__) == ported
    assert set(repro_torch.__all__) - ported == {"solve_schedule_dp_batch", "solve_schedule_dp_torch"}
    assert sorted(repro_torch.__all__) == list(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name).__module__.startswith("repro_torch.")
    import repro_torch.core as tcore

    assert set(tcore.__all__) <= set(dir(tcore))
