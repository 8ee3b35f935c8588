"""The port's scheduling service (``serve/coalesce.py``,
``serve/service.py``) on the CPU: the cases of the reference's
``tests/test_serve.py`` (bit-identical coalesced results, batching,
max-delay flushes, backpressure, shutdown, failure propagation, ``warm``),
and parity with the JAX package: the coalescing primitives give the
reference's keys, batches and ladders, and served schedules, ``k_last``
rows and objectives equal the reference engine's on the same requests; an
FL campaign's scenario batch served through the service equals the direct
engine path and the reference's.

Every wait is bounded (``result(timeout=...)``, ``close(timeout=...)``).
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from repro.core import SweepEngine as JSweepEngine
from repro.core import random_problem as jrandom_problem
from repro.core.problem import ProblemBatch as JProblemBatch
from repro.core.sweep import request_bucket as jrequest_bucket
from repro.serve import coalesce as jcoalesce
from repro_torch.core import Problem, ProblemBatch, SweepEngine, from_reference, random_problem, solve_schedule_dp_batch
from repro_torch.core.costs import linear_cost, measured_cost, sublinear_cost, superlinear_cost
from repro_torch.core.sweep import request_bucket
from repro_torch.serve import (
    SchedulerService,
    ServiceClosed,
    ServiceOverloaded,
    coalesce_key,
    combine_batches,
    pow2_ladder,
    warm_batch,
)

CPU = "cpu"
REGIMES = ("arbitrary", "linear", "increasing", "decreasing")
# benchmarks/bench_serve.py's request families: one pow2 bucket each
FAMILIES = (
    dict(n=8, T_lo=65, T_hi=128, u_lo=16, u_hi=31),
    dict(n=16, T_lo=33, T_hi=64, u_lo=4, u_hi=15),
    dict(n=4, T_lo=65, T_hi=128, u_lo=32, u_hi=63),
)


def ragged_problems(rng, N, max_n=6, max_T=24, with_lower=True):
    return [
        random_problem(
            rng, n=int(rng.integers(1, max_n + 1)), T=int(rng.integers(1, max_T + 1)), regime=REGIMES[i % len(REGIMES)],
            with_lower=with_lower,
        )
        for i in range(N)
    ]


def family_problem(rng, fam, regime):
    """One request of a bench_serve.py family (the same draws)."""
    n = fam["n"]
    upper = rng.integers(fam["u_lo"], fam["u_hi"] + 1, size=n)
    upper[0] = fam["u_hi"]
    T = int(min(rng.integers(fam["T_lo"], fam["T_hi"] + 1), upper.sum()))
    tables = []
    for u in (int(v) for v in upper):
        if regime == "arbitrary":
            tables.append(measured_cost(u, rng))
        elif regime == "linear":
            tables.append(linear_cost(u, float(rng.uniform(0.2, 5.0))))
        elif regime == "increasing":
            tables.append(superlinear_cost(u, float(rng.uniform(0.2, 3.0)), float(rng.uniform(0.01, 0.6))))
        else:
            tables.append(sublinear_cost(u, float(rng.uniform(5.0, 40.0)), float(rng.uniform(2.0, 20.0))))
    return Problem(T=T, lower=np.zeros(n, dtype=np.int64), upper=upper, cost_tables=tuple(tables))


@contextlib.contextmanager
def serving(**kw):
    """A service that is closed with a bounded wait, whatever happens."""
    svc = SchedulerService(**kw)
    try:
        yield svc
    finally:
        svc.close(timeout=30)


def _engine(**kw):
    return SweepEngine(device=CPU, **kw)


def _ref_batch(batch):
    return JProblemBatch(T=batch.T, lower=batch.lower, upper=batch.upper, costs=batch.costs)


def _same_batch(a, b):
    for f in ("T", "lower", "upper", "costs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


# ---------------------------------------------------------------------------
# coalesce primitives, against the reference's
# ---------------------------------------------------------------------------


def test_coalesce_key_matches_engine_bucket_math():
    rng = np.random.default_rng(0)
    for p in ragged_problems(rng, 6):
        b = ProblemBatch.from_problems([p])
        nb, Tb, Wb = request_bucket(b)
        assert coalesce_key(b, False) == (nb, Tb, Wb, False)
        assert coalesce_key(b, True) == (nb, Tb, Wb, True)
        for v in (nb, Tb, Wb):  # pow2 axes
            assert v & (v - 1) == 0 and v >= 1
        for split in (False, True):
            assert coalesce_key(b, split) == jcoalesce.coalesce_key(_ref_batch(b), split)


def test_combine_batches_slices_and_padding_inert():
    rng = np.random.default_rng(1)
    groups = [ProblemBatch.from_problems(ragged_problems(rng, k)) for k in (1, 3, 2)]
    combined, slices = combine_batches(groups)
    assert combined.B == 6 and slices == [(0, 1), (1, 4), (4, 6)]
    want, wslices = jcoalesce.combine_batches([_ref_batch(g) for g in groups])
    assert slices == wslices
    _same_batch(combined, want)
    X_all = solve_schedule_dp_batch(combined, device=CPU)
    for g, (lo, hi) in zip(groups, slices):
        np.testing.assert_array_equal(X_all[lo:hi, : g.n], solve_schedule_dp_batch(g, device=CPU))
    one, s1 = combine_batches(groups[:1])
    assert one is groups[0] and s1 == [(0, 1)]


def test_pow2_ladder_and_warm_batch():
    assert pow2_ladder(1) == [1]
    assert pow2_ladder(5) == [1, 2, 4, 8]
    assert pow2_ladder(16) == [1, 2, 4, 8, 16]
    for m in (1, 3, 5, 16, 17):
        assert pow2_ladder(m) == jcoalesce.pow2_ladder(m)
    wb = warm_batch(4, 12, 8, B=3, regime="arbitrary")
    wb.validate()
    assert wb.B == 3
    assert request_bucket(wb) == (4, 16, 8)  # lands in the spec's bucket
    mono = warm_batch(4, 12, 8, B=2, regime="increasing")
    assert request_bucket(mono) == (4, 16, 8)
    solve_schedule_dp_batch(wb, device=CPU)  # feasible by construction
    for args, regime in (((4, 12, 8, 3), "arbitrary"), ((4, 12, 8, 2), "increasing"), ((100, 10000, 1001, 16), "arbitrary")):
        _same_batch(warm_batch(*args, regime=regime), jcoalesce.warm_batch(*args, regime=regime))
    for bad in ((2, 8, 1, 1, "arbitrary"), (1, 64, 3, 1, "arbitrary"), (2, 8, 8, 1, "flat")):
        with pytest.raises(ValueError) as got:
            warm_batch(*bad[:4], regime=bad[4])
        with pytest.raises(ValueError) as want:
            jcoalesce.warm_batch(*bad[:4], regime=bad[4])
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# service: correctness of served results
# ---------------------------------------------------------------------------


def test_served_results_bit_identical_mixed_regimes_and_shapes():
    rng = np.random.default_rng(2)
    probs = ragged_problems(rng, 10)
    eng = _engine()
    with serving(engine=eng, max_batch=4, max_delay_s=0.005) as svc:
        futs = [svc.submit(p) for p in probs]  # squeeze path
        multi = ProblemBatch.from_problems(probs[:3])
        f_multi = svc.submit(multi)
        f_split = [svc.submit(p, split_regimes=True) for p in probs[:4]]
        for p, f in zip(probs, futs):
            x = f.result(timeout=60)
            assert x.shape == (p.n,)
            np.testing.assert_array_equal(x, eng.solve([p])[0, : p.n])
        np.testing.assert_array_equal(f_multi.result(timeout=60)[:, : multi.n], eng.solve(probs[:3])[:, : multi.n])
        for p, f in zip(probs[:4], f_split):
            np.testing.assert_array_equal(f.result(timeout=60), eng.solve([p], split_regimes=True)[0, : p.n])
    s = svc.stats()
    assert s["completed_requests"] == s["requests"] == 15
    assert s["flushes"] < s["requests"], "nothing coalesced"
    assert s["inflight_rows"] == 0 and s["pending_rows"] == 0


def test_future_demuxes_k_last_and_objectives():
    rng = np.random.default_rng(3)
    probs = ragged_problems(rng, 5, with_lower=False)
    eng = _engine()
    with serving(engine=eng, max_batch=8, max_delay_s=0.005) as svc:
        futs = [svc.submit(p) for p in probs]
        f_split = svc.submit(probs[1], split_regimes=True)  # linear: the marginal path, no free-T row
        for p, f in zip(probs, futs):
            solo = eng.dispatch(ProblemBatch.from_problems([p]))
            np.testing.assert_array_equal(f.k_last(timeout=60), solo.k_last()[0])
            assert f.objectives() == pytest.approx(float(solo.objectives()[0]))
        want = eng.dispatch(ProblemBatch.from_problems([probs[1]]), split_regimes=True).objectives()[0]
        assert f_split.objectives(timeout=60) == pytest.approx(float(want))
        with pytest.raises(ValueError, match="only defined for pure-DP"):
            f_split.k_last()


def test_lone_request_flushes_on_max_delay():
    p = random_problem(np.random.default_rng(4), n=3, T=8, regime="linear")
    eng = _engine()
    eng.solve([p])  # build the plan outside the timed window
    with serving(engine=eng, max_batch=64, max_delay_s=0.05) as svc:
        t0 = time.monotonic()
        x = svc.submit(p).result(timeout=60)
        waited = time.monotonic() - t0
    np.testing.assert_array_equal(x, eng.solve([p])[0, : p.n])
    assert waited >= 0.04, f"flushed before the max-delay window ({waited:.3f}s)"
    assert svc.stats()["delay_flushes"] == 1 and svc.stats()["size_flushes"] == 0


@pytest.mark.parametrize("split", [False, True])
def test_served_stream_matches_the_reference_engine(split):
    """A stream of bench_serve.py's three families through the port's
    service equals the reference engine solving each request alone:
    schedules identical; DP objectives and ``k_last`` bit for bit, the
    selection path's float32 objectives within rtol 1e-6."""
    rng = np.random.default_rng(0)
    reqs = [family_problem(rng, FAMILIES[int(rng.integers(len(FAMILIES)))], REGIMES[i % 4]) for i in range(24)]
    batches = [ProblemBatch.from_problems([p]) for p in reqs]
    jeng = JSweepEngine()
    eng = _engine()
    with serving(engine=eng, max_batch=8, max_delay_s=0.002, max_pending=96) as svc:
        futs = [svc.submit(b, split_regimes=split) for b in batches]
        for b, f in zip(batches, futs):
            jb = _ref_batch(b)
            want = jeng.dispatch(jb, split_regimes=split)
            np.testing.assert_array_equal(f.result(timeout=60), np.asarray(want.result()))
            obj, wobj = f.objectives(timeout=60), np.asarray(want.objectives(), np.float64)
            if split:  # the selection's float32 sums add in another order: rtol 1e-6, as for the engine
                np.testing.assert_allclose(obj, wobj, rtol=1e-6)
            else:
                np.testing.assert_array_equal(obj, wobj)
                k, wk = f.k_last(), np.asarray(want.k_last())
                np.testing.assert_array_equal(k.view(np.int32), wk.view(np.int32))
    s = svc.stats()
    assert s["completed_requests"] == 24 and s["flushes"] < 24
    assert {request_bucket(b) for b in batches} == {jrequest_bucket(_ref_batch(b)) for b in batches}


def test_many_producers_under_a_short_switch_interval():
    """More producer threads than cores, switching threads every 10 µs: every
    request gets its own rows, and the service's counters balance."""
    import sys

    rng = np.random.default_rng(11)
    probs = [random_problem(rng, n=3, T=9, regime=REGIMES[i % 4]) for i in range(48)]
    eng = _engine()
    want = [eng.solve([p])[0, : p.n] for p in probs]
    got, errors = [None] * len(probs), []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serving(engine=eng, max_batch=4, max_delay_s=0.001, max_pending=8) as svc:

            def produce(k):
                try:
                    for i in range(k, len(probs), 16):
                        got[i] = svc.submit(probs[i], timeout=30).result(timeout=30)
                except BaseException as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

            threads = [threading.Thread(target=produce, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        sys.setswitchinterval(old)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    s = svc.stats()
    assert s["requests"] == s["completed_requests"] == s["rows"] == s["flushed_rows"] == len(probs)
    assert s["inflight_rows"] == s["pending_rows"] == 0


# ---------------------------------------------------------------------------
# backpressure + shutdown (stub engine: no solve in the loop)
# ---------------------------------------------------------------------------


class _GatedHandle:
    def __init__(self, gate, B, n):
        self._gate, self._B, self._n = gate, B, n

    def result(self):
        assert self._gate.wait(timeout=60), "test gate never opened"
        return np.zeros((self._B, self._n), dtype=np.int64)

    def objectives(self):
        return np.zeros(self._B)

    def k_last(self):
        return np.zeros((self._B, 1), dtype=np.int64)


class _GatedEngine:
    """Engine stand-in whose solves block until the test opens the gate."""

    def __init__(self):
        self.gate = threading.Event()
        self.dispatched_rows = []

    def dispatch(self, batch, split_regimes=False):
        self.dispatched_rows.append(batch.B)
        return _GatedHandle(self.gate, batch.B, batch.n)


def _tiny(rng):
    return random_problem(rng, n=2, T=4, regime="linear")


def test_backpressure_blocks_then_rejects_then_drains():
    rng = np.random.default_rng(5)
    eng = _GatedEngine()
    svc = SchedulerService(engine=eng, max_batch=2, max_delay_s=0.001, max_pending=4)
    try:
        held = [svc.submit(_tiny(rng)) for _ in range(4)]  # fills the bound
        deadline = time.monotonic() + 30  # flushed (inflight) but unfinished
        while svc.stats()["flushes"] < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        with pytest.raises(ServiceOverloaded):
            svc.submit(_tiny(rng), timeout=0.05)
        assert svc.stats()["rejected"] == 1
        late = {}  # a submitter ALREADY blocked on admission gets served on release
        t = threading.Thread(target=lambda: late.__setitem__("f", svc.submit(_tiny(rng), timeout=30)))
        t.start()
        time.sleep(0.05)
        assert "f" not in late  # still blocked: the bound is honest
        eng.gate.set()
        t.join(timeout=30)
        assert not t.is_alive()
        for f in held + [late["f"]]:
            assert f.result(timeout=30).shape == (2,)
    finally:
        eng.gate.set()
        svc.close(timeout=30)


def test_flushes_never_exceed_max_batch_rows():
    rng = np.random.default_rng(6)
    eng = _GatedEngine()
    eng.gate.set()
    svc = SchedulerService(engine=eng, max_batch=4, max_delay_s=0.5, max_pending=512)
    futs = [svc.submit(_tiny(rng)) for _ in range(37)]
    for f in futs:
        f.result(timeout=60)
    svc.close(timeout=30)
    assert max(eng.dispatched_rows) <= 4
    assert sum(eng.dispatched_rows) == 37


def test_close_serves_in_flight_then_refuses():
    rng = np.random.default_rng(7)
    eng = _GatedEngine()
    svc = SchedulerService(engine=eng, max_batch=64, max_delay_s=30.0, max_pending=512)
    futs = [svc.submit(_tiny(rng)) for _ in range(5)]  # parked: no trigger ripe
    assert not any(f.done() for f in futs)
    eng.gate.set()
    svc.close(timeout=60)  # close must flush + serve them, then stop
    for f in futs:
        assert f.result(timeout=1).shape == (2,)
    s = svc.stats()
    assert s["close_flushes"] >= 1 and s["completed_requests"] == 5
    with pytest.raises(ServiceClosed):
        svc.submit(_tiny(rng))
    svc.close(timeout=30)  # idempotent


def test_engine_failure_propagates_to_futures():
    class _BoomEngine:
        def dispatch(self, batch, split_regimes=False):
            raise RuntimeError("boom")

    svc = SchedulerService(engine=_BoomEngine(), max_batch=2, max_delay_s=0.001)
    f = svc.submit(_tiny(np.random.default_rng(8)))
    with pytest.raises(RuntimeError, match="boom"):
        f.result(timeout=30)
    svc.close(timeout=30)
    assert svc.stats()["inflight_rows"] == 0  # failed rows retire too


def test_default_engine_is_the_asked_device():
    with serving(device=CPU) as svc:
        assert svc.engine.device.type == "cpu"
        p = _tiny(np.random.default_rng(9))
        np.testing.assert_array_equal(svc.submit(p).result(timeout=30), svc.engine.solve([p])[0])


# ---------------------------------------------------------------------------
# warm(): steady state pays zero plan builds
# ---------------------------------------------------------------------------


def test_warm_covers_steady_state_zero_plan_builds():
    rng = np.random.default_rng(9)
    probs = [random_problem(rng, n=3, T=11, regime=REGIMES[i % 4], with_lower=False) for i in range(12)]
    batches = [ProblemBatch.from_problems([p]) for p in probs]
    buckets = sorted(set(request_bucket(b) for b in batches))
    eng = _engine()
    with serving(engine=eng, max_batch=4, max_delay_s=0.002) as svc:
        built = svc.warm(buckets)
        assert built == 3 * len(buckets)  # the ladder [1, 2, 4] per bucket, all cold
        assert svc.warm(buckets) == 0  # idempotent: everything warm
        before = eng.cache_stats()["compiles"]
        futs = [svc.submit(b) for b in batches]
        for b, f in zip(batches, futs):
            np.testing.assert_array_equal(f.result(timeout=60), eng.dispatch(b).result())
        assert eng.cache_stats()["compiles"] == before, "steady state paid a plan build"
        assert svc.stats()["warmed_executables"] == built
    per_bucket = eng.cache_stats()["per_bucket_hits"]
    assert sum(per_bucket.values()) > 0 and all(":T16:" in k for k in per_bucket)


def test_warm_split_regimes_builds_the_selection_buckets_too():
    eng = _engine()
    with serving(engine=eng, max_batch=2) as svc:  # ladder [1, 2]
        assert svc.warm([(3, 11, 8)], split_regimes=True) == 4  # 2 DP + 2 selection plans
    labels = set(eng.cache_stats()["per_bucket_hits"]) | {eng._bucket_label(k) for k in eng._cache}
    assert {"dp:B1:n4:T16:W8", "dp:B2:n4:T16:W8", "marginal:B1:n4:W8", "marginal:B2:n4:W8"} <= labels


def test_warm_refuses_plans_larger_than_the_lru():
    eng = _engine(max_entries=4)
    with serving(engine=eng, max_batch=4) as svc:  # ladder [1, 2, 4]
        with pytest.raises(ValueError, match="max_entries"):
            svc.warm([(2, 8, 8), (4, 16, 16)])  # 2 specs x 3 sizes = 6 > 4
        svc.warm([(2, 8, 8)])  # 3 plans: fits
    assert eng.cache_stats()["compiles"] == 3


def test_submit_frontier_matches_pareto_frontier():
    from repro_torch.core import pareto_frontier

    jp = jrandom_problem(np.random.default_rng(12), n=5, T=14, max_upper=8)
    p = from_reference(jp)
    rng = np.random.default_rng(13)
    tt = [np.concatenate([[0.0], np.sort(rng.uniform(0.1, 2.0, int(u)))]) for u in p.upper]
    eng = _engine()
    with serving(engine=eng, max_delay_s=0.001) as svc:
        fut = svc.submit_frontier(p, tt)
        front = fut.result(timeout=60)
        assert fut.done() and fut.result(timeout=1) is front
        assert fut.completed_at >= fut.submitted_at
    want = pareto_frontier(p, tt, engine=eng)
    assert [(q.time, q.energy, q.deadline) for q in front] == [(q.time, q.energy, q.deadline) for q in want]


# ---------------------------------------------------------------------------
# FL campaign planning through the service
# ---------------------------------------------------------------------------


def _scenario_server(est, cap, **policy):
    from repro_torch.fl import FederatedServer, PlanPolicy

    return FederatedServer(None, None, None, est, policy=PlanPolicy(
        round_T=cap // 2, scenario_T_candidates=[cap // 3, cap // 2], scenario_dropouts=[(0,), (1,)], **policy))


def test_campaign_scenarios_via_service_match_engine_path():
    import repro.fl as jfl
    from repro_torch.fl import EnergyEstimator, make_fleet

    rng = np.random.default_rng(10)
    fleet = make_fleet(rng, 4, max_batches=6)
    est = EnergyEstimator(fleet)
    est.calibrate(rng)
    cap = sum(d.max_batches for d in fleet)

    srv = _scenario_server(est, cap, engine=_engine())
    direct = srv.solve_scenarios(*srv.build_scenarios(cap // 2))
    with serving(engine=_engine(), max_batch=8, max_delay_s=0.005) as svc:
        srv2 = _scenario_server(est, cap, service=svc)
        assert srv2.engine is svc.engine  # the service's engine becomes the default
        served = srv2.solve_scenarios(*srv2.build_scenarios(cap // 2))
    np.testing.assert_array_equal(direct.assignments, served.assignments)
    np.testing.assert_array_equal(direct.energies, served.energies)
    assert svc.stats()["requests"] == 1 and svc.stats()["flushes"] == 1

    jrng = np.random.default_rng(10)
    jest = jfl.EnergyEstimator(jfl.make_fleet(jrng, 4, max_batches=6))
    jest.calibrate(jrng)
    jsrv = jfl.FederatedServer(None, None, None, jest, policy=jfl.PlanPolicy(
        round_T=cap // 2, scenario_T_candidates=[cap // 3, cap // 2], scenario_dropouts=[(0,), (1,)],
        engine=JSweepEngine()))
    want = jsrv.solve_scenarios(*jsrv.build_scenarios(cap // 2))
    assert want.labels == served.labels
    np.testing.assert_array_equal(want.assignments, served.assignments)
    np.testing.assert_allclose(served.energies, want.energies, rtol=1e-6)
