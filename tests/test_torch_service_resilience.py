"""Serving-layer resilience in the port (DESIGN.md §17), on the CPU, with
the port's ``FlakyEngine``: the cases of the reference's
``tests/test_service_resilience.py`` (flush retry with backoff, the circuit
breaker's closed → open → half-open life cycle and its degraded host path,
real deadlines on the staged futures), plus the rule that a CUDA error is
not transient: it reaches the futures and never the degraded path.

Every wait is bounded (``result(timeout=...)``, ``close(timeout=...)``).
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from repro.core import CircuitBreaker as JCircuitBreaker
from repro.core import SweepEngine as JSweepEngine
from repro.core import random_problem as jrandom_problem
from repro.serve import SchedulerService as JSchedulerService
from repro_torch.core import (
    CircuitBreaker,
    RetryPolicy,
    Solver,
    TransientEngineError,
    from_reference,
    is_transient,
    random_problem,
)
from repro_torch.core.sweep import SweepEngine
from repro_torch.fl.faults import FlakyEngine
from repro_torch.serve import SchedulerService, ServiceClosed

CPU = "cpu"


@contextlib.contextmanager
def serving(**kw):
    """A service that is closed with a bounded wait, whatever happens."""
    svc = SchedulerService(**kw)
    try:
        yield svc
    finally:
        svc.close(timeout=30)


def _engine():
    return SweepEngine(device=CPU)


def _probs(rng, k=4, n=6, T=24):
    return [random_problem(rng, n=n, T=T) for _ in range(k)]


def _baseline(probs, split=False):
    with serving(engine=_engine(), max_delay_s=0.001) as svc:
        return np.asarray(svc.submit(probs, split_regimes=split).result(timeout=60))


# ---------------------------------------------------------------------------
# flush retry / degraded serving
# ---------------------------------------------------------------------------


def test_transient_flush_failure_retries_bit_identically():
    probs = _probs(np.random.default_rng(0))
    want = _baseline(probs)
    flaky = FlakyEngine(_engine(), fail_ordinals=(0,))
    with serving(engine=flaky, max_delay_s=0.001, retry=RetryPolicy()) as svc:
        got = np.asarray(svc.submit(probs).result(timeout=60))
        st = svc.stats()
    np.testing.assert_array_equal(want, got)
    assert st["retries"] == 1 and st["flush_failures"] == 1
    assert st["degraded_flushes"] == 0
    assert flaky.fault_stats()["injected_failures"] == 1


def test_non_transient_failure_propagates_without_retry():
    class _BoomEngine:
        def dispatch(self, batch, split_regimes=False):
            raise RuntimeError("boom")

        def cache_stats(self):
            return {}

    with serving(engine=_BoomEngine(), max_delay_s=0.001, retry=RetryPolicy()) as svc:
        f = svc.submit(_probs(np.random.default_rng(1), k=2))
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=30)
        st = svc.stats()
    assert st["retries"] == 0  # non-transient: fail fast, never retried
    assert st["flush_failures"] == 1
    assert svc.stats()["inflight_rows"] == 0


class _CudaErrorHandle:
    def result(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


class _CudaErrorEngine:
    """An engine whose flushes fail the way a faulting kernel does: the
    dispatch returns and the error surfaces when the result is awaited."""

    def __init__(self):
        self.dispatched = 0

    def dispatch(self, batch, split_regimes=False):
        self.dispatched += 1
        return _CudaErrorHandle()

    def cache_stats(self):
        return {}


def test_cuda_error_reaches_the_futures_and_never_the_degraded_path():
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert not is_transient(err)
    eng = _CudaErrorEngine()
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=60.0)
    with serving(engine=eng, max_delay_s=0.001, retry=RetryPolicy(max_attempts=3), breaker=breaker) as svc:
        for k in (1, 2):  # a sticky fault: the second flush still reaches the engine
            f = svc.submit(_probs(np.random.default_rng(9), k=2))
            with pytest.raises(RuntimeError, match="CUDA error"):
                f.result(timeout=30)
            assert eng.dispatched == k  # never retried
        st = svc.stats()
    assert st["retries"] == 0 and st["flush_failures"] == 2
    assert st["degraded_flushes"] == 0 and st["degraded_rows"] == 0
    assert st["inflight_rows"] == 0
    assert breaker.state == "closed" and breaker.stats()["consecutive_failures"] == 0


class _TransientThenCudaErrorEngine(_CudaErrorEngine):
    """The first dispatch fails transiently; every later one fails the way a
    faulting kernel does."""

    def dispatch(self, batch, split_regimes=False):
        self.dispatched += 1
        if self.dispatched == 1:
            raise TransientEngineError("injected engine fault at dispatch 0")
        return _CudaErrorHandle()


def test_cuda_error_in_the_half_open_probe_frees_the_probe():
    eng = _TransientThenCudaErrorEngine()
    br = CircuitBreaker(failure_threshold=1, cooldown_s=0.15)
    probs = _probs(np.random.default_rng(10), k=2)
    with serving(engine=eng, max_delay_s=0.001, breaker=br) as svc:
        svc.submit(probs).result(timeout=60)  # transient: opens, served degraded
        assert br.state == "open" and svc.stats()["degraded_flushes"] == 1
        time.sleep(0.2)  # past the cooldown: the next flush is the probe
        for k in (2, 3):  # the probe and the flush after it both reach the engine
            with pytest.raises(RuntimeError, match="CUDA error"):
                svc.submit(probs).result(timeout=30)
            assert eng.dispatched == k
        st = svc.stats()
    assert st["degraded_flushes"] == 1 and st["flush_failures"] == 3
    assert br.stats()["opens"] == 1


def test_circuit_breaker_release_frees_the_probe_and_keeps_the_state():
    now = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=1.0, clock=lambda: now[0])
    br.record_failure()
    now[0] = 2.0
    assert br.allow() and not br.allow()  # one probe at a time
    br.release()
    assert br.state == "half-open" and br.stats()["consecutive_failures"] == 1
    assert br.allow()  # the freed probe slot is taken again
    br.record_success()
    br.release()  # closed: nothing to free, nothing changes
    assert br.state == "closed" and br.allow()


def test_retry_exhaustion_without_breaker_propagates():
    flaky = FlakyEngine(_engine(), fail_ordinals=range(50))
    with serving(engine=flaky, max_delay_s=0.001, retry=RetryPolicy(max_attempts=3)) as svc:
        f = svc.submit(_probs(np.random.default_rng(2), k=2))
        with pytest.raises(TransientEngineError):
            f.result(timeout=30)
    assert svc.stats()["inflight_rows"] == 0


@pytest.mark.parametrize("split", [False, True])
def test_open_breaker_serves_degraded_bit_identical_schedules(split):
    probs = _probs(np.random.default_rng(3))
    want = _baseline(probs, split=split)
    flaky = FlakyEngine(_engine(), fail_ordinals=range(50))
    with serving(
        engine=flaky,
        max_delay_s=0.001,
        retry=RetryPolicy(max_attempts=2),
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0),
    ) as svc:
        f = svc.submit(probs, split_regimes=split)
        np.testing.assert_array_equal(want, np.asarray(f.result(timeout=60)))
        if not split:  # the degraded path has no fused-DP row to expose
            with pytest.raises(ValueError, match="degraded"):
                f.k_last()
        st = svc.stats()
        assert st["breaker"]["state"] == "open"
        assert st["degraded_flushes"] == 1 and st["degraded_rows"] == len(probs)
        # while open, new flushes go straight to the degraded path
        calls_before = flaky.fault_stats()["dispatches"]
        got2 = np.asarray(svc.submit(probs, split_regimes=split).result(timeout=60))
        np.testing.assert_array_equal(want, got2)
        assert flaky.fault_stats()["dispatches"] == calls_before
        assert svc.stats()["degraded_flushes"] == 2


def test_degraded_flush_matches_the_reference_degraded_flush():
    """The degraded path runs the host algorithms, as the reference's does:
    same schedules and 0-lower-limit objectives under the same faults."""
    from repro.fl.faults import FlakyEngine as JFlakyEngine

    jprobs = [jrandom_problem(np.random.default_rng(30 + b), n=5, T=16) for b in range(3)]
    probs = [from_reference(p) for p in jprobs]
    kw = dict(max_delay_s=0.001, retry=None)
    got_svc = SchedulerService(engine=FlakyEngine(_engine(), range(10)), breaker=CircuitBreaker(1, 60.0), **kw)
    want_svc = JSchedulerService(engine=JFlakyEngine(JSweepEngine(), range(10)), breaker=JCircuitBreaker(1, 60.0), **kw)
    try:
        for split in (False, True):
            f, wf = got_svc.submit(probs, split_regimes=split), want_svc.submit(jprobs, split_regimes=split)
            np.testing.assert_array_equal(f.result(timeout=60), np.asarray(wf.result(timeout=60)))
            np.testing.assert_array_equal(f.objectives(timeout=60), np.asarray(wf.objectives(timeout=60)))
        assert got_svc.stats()["degraded_flushes"] == want_svc.stats()["degraded_flushes"] == 2
    finally:
        got_svc.close(timeout=30)
        want_svc.close(timeout=30)


def test_half_open_probe_closes_breaker_and_restores_engine_path():
    probs = _probs(np.random.default_rng(4), k=3)
    want = _baseline(probs)
    flaky = FlakyEngine(_engine(), fail_ordinals=(0,))  # heals after one
    br = CircuitBreaker(failure_threshold=1, cooldown_s=0.15)
    with serving(engine=flaky, max_delay_s=0.001, breaker=br) as svc:
        np.testing.assert_array_equal(want, np.asarray(svc.submit(probs).result(timeout=60)))
        assert br.state == "open"  # first flush failed, served degraded
        time.sleep(0.2)  # past the cooldown: next flush is the probe
        f = svc.submit(probs)
        np.testing.assert_array_equal(want, np.asarray(f.result(timeout=60)))
        assert br.state == "closed"
        _ = np.asarray(f.k_last())  # engine-served again: the DP row is back
        assert br.stats()["probes"] == 1 and br.stats()["opens"] == 1


def test_solver_retry_recovers_transient_direct_dispatch():
    probs = _probs(np.random.default_rng(5))
    want = Solver(engine=_engine()).solve(probs, algorithm="dp_batch")
    flaky = FlakyEngine(_engine(), fail_ordinals=(0,))
    got = Solver(engine=flaky, retry=RetryPolicy()).solve(probs, algorithm="dp_batch")
    for a, b in zip(want.schedules, got.schedules):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want.k_last, got.k_last)
    assert flaky.fault_stats()["injected_failures"] == 1
    with pytest.raises(TransientEngineError):  # without a policy the fault propagates
        Solver(engine=FlakyEngine(_engine(), fail_ordinals=(0,))).solve(probs, algorithm="dp_batch")


def test_solver_over_a_service_retries_a_transient_served_request():
    probs = _probs(np.random.default_rng(10))
    want = Solver(engine=_engine()).solve(probs, algorithm="dp_batch")
    flaky = FlakyEngine(_engine(), fail_ordinals=(0,))
    with serving(engine=flaky, max_delay_s=0.001) as svc:  # no retry in the service: the facade's
        got = Solver(service=svc, retry=RetryPolicy()).solve(probs, algorithm="dp_batch")
    for a, b in zip(want.schedules, got.schedules):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want.k_last, got.k_last)
    assert flaky.fault_stats()["injected_failures"] == 1


# ---------------------------------------------------------------------------
# future deadline semantics
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
        assert self._gate.wait(timeout=60)
        return np.zeros((self._B, 1))


class _GatedEngine:
    """Engine stand-in whose solves block until the test opens the gate."""

    def __init__(self):
        self.gate = threading.Event()
        self.dispatched = 0

    def dispatch(self, batch, split_regimes=False):
        self.dispatched += 1
        return _GatedHandle(self.gate, batch.B, batch.n)

    def cache_stats(self):
        return {}


def _tiny(rng):
    return random_problem(rng, n=2, T=4, regime="linear")


def test_schedule_future_timeout_then_retry_no_inflight_leak():
    eng = _GatedEngine()
    with serving(engine=eng, max_delay_s=0.001) as svc:
        f = svc.submit(_tiny(np.random.default_rng(6)))
        with pytest.raises(TimeoutError, match="not served"):
            f.result(timeout=0.05)
        assert svc.stats()["inflight_rows"] == 1  # still in flight, not leaked
        eng.gate.set()
        assert f.result(timeout=30).shape == (2,)  # the SAME future succeeds on retry
        deadline = time.monotonic() + 30
        while svc.stats()["inflight_rows"] and time.monotonic() < deadline:
            time.sleep(0.005)
    assert svc.stats()["inflight_rows"] == 0


def test_fleet_future_result_enforces_real_deadline():
    p = random_problem(np.random.default_rng(7), n=64, T=512)
    with serving(engine=_engine(), max_delay_s=0.001) as svc:
        fut = svc.submit_fleet(p, clusters=8)
        with pytest.raises(TimeoutError, match="fleet solve"):
            fut.result(timeout=1e-9)
        sol = fut.result(timeout=120)  # nothing cached on the timed-out pass
        want = Solver(engine=_engine()).solve_fleet(p, clusters=8)
        np.testing.assert_array_equal(sol.schedule, want.schedule)
        assert sol.objective == want.objective


def test_close_racing_blocked_submit_raises_service_closed():
    eng = _GatedEngine()
    rng = np.random.default_rng(8)
    svc = SchedulerService(engine=eng, max_delay_s=0.0005, max_pending=2)
    admitted = svc.submit([_tiny(rng), _tiny(rng)])  # fills the admission bound
    deadline = time.monotonic() + 30
    while eng.dispatched == 0 and time.monotonic() < deadline:
        time.sleep(0.005)  # wait until the filler flush is in flight
    errs = []

    def blocked_submit():
        try:
            svc.submit(_tiny(rng), timeout=30)
        except Exception as e:  # noqa: BLE001 - recorded for the assertion
            errs.append(e)

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.1)  # let it enter the backpressure wait
    closer = threading.Thread(target=lambda: svc.close(timeout=30))
    closer.start()
    time.sleep(0.1)
    eng.gate.set()  # let the in-flight flush finish so close() can drain
    t.join(timeout=30)
    closer.join(timeout=30)
    assert not t.is_alive() and not closer.is_alive()
    assert len(errs) == 1 and isinstance(errs[0], ServiceClosed)
    assert admitted.result(timeout=30).shape == (2, 2)  # admitted work drained through close
    assert svc.stats()["inflight_rows"] == 0
