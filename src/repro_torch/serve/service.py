"""Scheduler-as-a-service: coalescing request batcher over the sweep engine.

The engine (DESIGN.md §10–§13) already looks like an inference server —
shape-bucketed plan cache, a ``dispatch()`` that returns before the result
is on the host, regime-split routing. :class:`SchedulerService` finishes the job for heavy served
traffic (ROADMAP: "scheduler-as-a-service"): a persistent front-end that
admits a stream of heterogeneous :class:`~repro_torch.core.problem.Problem` /
:class:`~repro_torch.core.problem.ProblemBatch` requests and serves each from a
COALESCED dispatch instead of one kernel launch per request.

Pipeline (DESIGN.md §14)::

    submit() ──▶ admission (bounded, backpressure)
             ──▶ coalescer thread: group by pow2 bucket key, flush a bucket
                 as ONE SweepEngine.dispatch() on a max-batch or max-delay
                 trigger
             ──▶ completer thread: materialize the batched handle, demux
                 per-request rows into ScheduleFuture results

On the card a dispatch is partly synchronous: under the engine's run lock
the coalescer thread pads the flush on the host, copies it into the plan's
static buffers and queues the graph replay on the engine's stream; only the
replay itself runs behind the returned handle. The completer thread waits
on the handle's CUDA event and only then copies the schedules to the host.

  * **Admission** is bounded by ``max_pending`` rows admitted-but-not-yet-
    completed: overload blocks producers (or raises
    :class:`ServiceOverloaded` past their timeout) — latency degrades,
    memory does not.
  * **Coalescing** groups requests by :func:`~repro_torch.serve.coalesce.
    coalesce_key` — the engine's own bucket math — so merging requests
    never changes which plan solves them, and results stay bit-identical
    to solving each request alone (inert padding).
  * **Warmup**: :meth:`SchedulerService.warm` builds the hot buckets'
    plans over the whole pow2 batch-size ladder, so steady-state traffic
    never pays a plan build (on the card an eager warm-up and a CUDA-graph
    capture) no matter which trigger fires a flush.
  * **Demux**: each :class:`ScheduleFuture` slices its rows (and, for
    pure-DP flushes, ``k_last``/``objectives``) out of the shared batched
    handle; handle materialization is thread-safe (lock-guarded in
    ``core/sweep.py``), so many requesters can drain one flush at once.

The port of ``repro.serve.service``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from ..core.pareto import assemble_frontier, candidate_deadlines, tightened_instances
from ..core.problem import Problem, ProblemBatch, total_cost
from ..core.resilience import CircuitBreaker, RetryPolicy, is_transient
from ..core.scheduler import _schedule
from ..core.sweep import SweepEngine, _next_pow2, default_engine
from .coalesce import coalesce_key, combine_batches, pow2_ladder, warm_batch

__all__ = [
    "FleetFuture",
    "FrontierFuture",
    "ScheduleFuture",
    "SchedulerService",
    "ServiceClosed",
    "ServiceOverloaded",
]


class ServiceClosed(RuntimeError):
    """Raised by :meth:`SchedulerService.submit` after :meth:`close`."""


class ServiceOverloaded(RuntimeError):
    """The bounded admission queue stayed full past the submit timeout."""


class ScheduleFuture:
    """Per-request handle to an in-flight (possibly coalesced) solve.

    :meth:`result` blocks until the request's flush materialized and
    returns this request's schedule rows — ``(B, n)`` int64 for batch
    requests, ``(n,)`` for a single-:class:`Problem` submission —
    bit-identical to solving the request alone. :meth:`objectives` and
    (for ``split_regimes=False`` requests) :meth:`k_last` demux the same
    per-request views out of the batched handle with no extra dispatch.

    ``submitted_at`` / ``completed_at`` are ``time.monotonic()`` stamps set
    by the service (completion is stamped when the completer thread lands
    the flush) — the served-latency telemetry ``bench_serve.py`` reports.
    """

    def __init__(self, rows: int, n: int, squeeze: bool):
        self._rows = rows
        self._n = n
        self._squeeze = squeeze
        self._event = threading.Event()
        self._X: Optional[np.ndarray] = None
        self._handle = None  # the flush's SweepHandle / RegimeSplitHandle
        self._lo = self._hi = 0  # this request's rows in the flushed batch
        self._exc: Optional[BaseException] = None
        self.submitted_at: Optional[float] = None
        self.completed_at: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, X: np.ndarray, handle, lo: int, hi: int, t_done: float) -> None:
        self._X, self._handle, self._lo, self._hi = X, handle, lo, hi
        self.completed_at = t_done
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self.completed_at = time.monotonic()
        self._event.set()

    def _wait(self, timeout: Optional[float]):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self._exc is not None:
            raise self._exc

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """This request's schedule(s); blocks until served."""
        self._wait(timeout)
        return self._X[0] if self._squeeze else self._X

    def objectives(self, timeout: Optional[float] = None):
        """Per-instance 0-lower-limit objectives (float for a single-Problem
        request), demuxed from the batched handle — same convention as
        :meth:`repro_torch.core.sweep.SweepHandle.objectives`."""
        self._wait(timeout)
        obj = np.asarray(self._handle.objectives(), np.float64)[self._lo : self._hi]
        return float(obj[0]) if self._squeeze else obj

    def k_last(self, timeout: Optional[float] = None) -> np.ndarray:
        """This request's final DP row(s) — the free workload-Pareto curve.
        Only defined for ``split_regimes=False`` (pure-DP) requests; the
        regime-split handle raises, exactly as engine callers see."""
        self._wait(timeout)
        k = self._handle.k_last()[self._lo : self._hi]
        return k[0] if self._squeeze else k


class FrontierFuture:
    """A served Pareto-frontier request (DESIGN.md §15): wraps the
    underlying ε-constraint sweep's :class:`ScheduleFuture` and assembles
    the pruned :class:`~repro_torch.core.pareto.ParetoFrontier` on :meth:`result`.
    The sweep itself is ONE coalescable request — every tightened instance
    shares the base problem's bucket, so frontier traffic merges with any
    other same-bucket traffic exactly like plain solves do."""

    def __init__(self, future: ScheduleFuture, problem, time_tables, deadlines):
        self._future = future
        self._problem = problem
        self._time_tables = time_tables
        self._deadlines = deadlines
        self._frontier = None

    def done(self) -> bool:
        return self._future.done()

    @property
    def submitted_at(self):
        return self._future.submitted_at

    @property
    def completed_at(self):
        return self._future.completed_at

    def result(self, timeout: Optional[float] = None):
        """The :class:`~repro_torch.core.pareto.ParetoFrontier`; blocks until the
        sweep is served. Repeated calls return the same object."""
        if self._frontier is None:
            X = self._future.result(timeout)
            self._frontier = assemble_frontier(
                self._problem, self._time_tables, self._deadlines, X
            )
        return self._frontier


class FleetFuture:
    """A served two-level fleet solve (DESIGN.md §16): wraps a
    :class:`~repro_torch.core.fleet.FleetRun` whose stage-1 curve dispatch was
    admitted as ONE coalescable request at submit time. :meth:`result` runs
    the remaining stages — the top-level allocation and the per-cluster
    schedule batch also go through the service, merging with any same-bucket
    traffic — and returns the :class:`~repro_torch.core.fleet.FleetSolution`.
    Repeated calls return the same object."""

    def __init__(self, run):
        self._run = run

    def done(self) -> bool:
        """True once the stage-1 curve request has been served (the
        remaining stages are small and run inside :meth:`result`)."""
        return self._run.done()

    def result(self, timeout: Optional[float] = None):
        """The :class:`~repro_torch.core.fleet.FleetSolution`; ``timeout`` is a
        real deadline enforced across ALL remaining staged solves (each
        staged served request gets the budget left on the clock), raising
        :class:`TimeoutError` exactly like :meth:`ScheduleFuture.result`.
        A timed-out call may be retried — later stages re-run from the
        memoized stage-1 curves, and a completed solve is cached."""
        return self._run.finish(timeout=timeout)


class _DegradedHandle:
    """Stand-in flush handle for the circuit breaker's degraded direct-solve
    path (DESIGN.md §17): schedules were host-solved — bit-identical to the
    engine path — so ``result()``/``objectives()`` demux normally; only
    ``k_last()`` is unavailable (no fused-DP dispatch ran), and raises with
    the same flavor of error as a regime-split handle."""

    def __init__(self, X: np.ndarray, objectives: np.ndarray):
        self._X = X
        self._obj = objectives

    def done(self) -> bool:
        return True

    def result(self) -> np.ndarray:
        return self._X

    def objectives(self) -> np.ndarray:
        return self._obj

    def k_last(self) -> np.ndarray:
        raise ValueError(
            "k_last() is unavailable: this flush was served by the degraded "
            "direct-solve path (circuit breaker open) — no fused-DP row "
            "exists. Retry once the breaker closes, or solve directly "
            "against a healthy engine."
        )


class _Request:
    __slots__ = ("batch", "future", "t_submit")

    def __init__(self, batch: ProblemBatch, future: ScheduleFuture, t_submit: float):
        self.batch = batch
        self.future = future
        self.t_submit = t_submit


class SchedulerService:
    """Persistent coalescing front-end over one :class:`SweepEngine`.

    Args:
      engine: the engine all flushes dispatch through (``None``: the
        process-wide default on ``device`` — sharing it means FL campaign
        planning and external traffic warm ONE cache).
      max_batch: rows that trigger an immediate bucket flush. Requests are
        atomic (never split), so a flush can exceed this by the last
        request's rows.
      max_delay_s: oldest-request age that triggers a flush even when the
        bucket is not full — the latency bound under light traffic.
      max_pending: admission bound, in rows admitted but not yet completed.
        Full ⇒ ``submit`` blocks (backpressure); past its ``timeout`` ⇒
        :class:`ServiceOverloaded`. An oversize request (> ``max_pending``
        rows) is admitted only once the service is drained, alone.
      name: thread-name prefix (observability).
      retry: a :class:`~repro_torch.core.resilience.RetryPolicy` — flushes whose
        engine dispatch/materialization raises a TRANSIENT error
        (:func:`~repro_torch.core.resilience.is_transient`) are re-dispatched with
        exponential backoff + deterministic jitter. Non-transient errors
        always propagate to the affected futures unchanged.
      breaker: a :class:`~repro_torch.core.resilience.CircuitBreaker` — after K
        consecutive engine failures the breaker opens and flushes are served
        by the DEGRADED direct-solve path (host algorithms, bit-identical
        schedules, no ``k_last``) instead of hammering the engine, until a
        half-open probe succeeds. With a breaker configured, transient
        failures that exhaust their retries also degrade rather than fail.
        Only transient failures feed the breaker. A CUDA error is not
        transient: it reaches the futures, leaves the breaker as it was,
        and every later flush still goes to the engine.
      device: the default engine's device when ``engine`` is ``None``
        (``"cuda"``, which raises without a card, unless the caller asks
        for ``"cpu"``).
    """

    def __init__(
        self,
        engine: Optional[SweepEngine] = None,
        max_batch: int = 32,
        max_delay_s: float = 0.002,
        max_pending: int = 1024,
        name: str = "sched-serve",
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        device="cuda",
    ):
        if max_batch < 1 or max_pending < 1:
            raise ValueError("max_batch and max_pending must be >= 1")
        self.engine = engine if engine is not None else default_engine(device=device)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_pending = int(max_pending)
        self.retry = retry
        self.breaker = breaker
        self._retry_rng = retry.make_rng() if retry is not None else None
        self._cond = threading.Condition()
        self._pending: dict = {}  # coalesce key -> [_Request]
        self._pending_rows = 0  # admitted, not yet flushed
        self._inflight_rows = 0  # admitted, not yet completed (the bound)
        self._closed = False
        self._stats = {
            "requests": 0,
            "rows": 0,
            "completed_requests": 0,
            "flushes": 0,
            "flushed_rows": 0,
            "size_flushes": 0,
            "delay_flushes": 0,
            "close_flushes": 0,
            "rejected": 0,
            "warmed_executables": 0,
            "retries": 0,
            "flush_failures": 0,
            "degraded_flushes": 0,
            "degraded_rows": 0,
        }
        self._done_q: queue.SimpleQueue = queue.SimpleQueue()
        self._coalescer = threading.Thread(
            target=self._coalesce_loop, name=f"{name}-coalescer", daemon=True
        )
        self._completer = threading.Thread(
            target=self._complete_loop, name=f"{name}-completer", daemon=True
        )
        self._coalescer.start()
        self._completer.start()

    # ---- client API ----------------------------------------------------

    def submit(
        self,
        problems,
        split_regimes: bool = False,
        timeout: Optional[float] = None,
    ) -> ScheduleFuture:
        """Admits one request — a single :class:`Problem`, a sequence of
        them, or a prebuilt :class:`ProblemBatch` — and returns its
        :class:`ScheduleFuture`. ``split_regimes`` selects the regime-split
        solve path (DESIGN.md §13) and is part of the coalescing key: split
        and plain requests never share a flush. Blocks while the admission
        bound is full; ``timeout`` seconds later raises
        :class:`ServiceOverloaded` instead.
        """
        squeeze = isinstance(problems, Problem)
        if squeeze:
            batch = ProblemBatch.from_problems([problems])
        elif isinstance(problems, ProblemBatch):
            batch = problems
        else:
            batch = ProblemBatch.from_problems(problems)
        batch.validate()
        key = coalesce_key(batch, split_regimes)  # cheap numpy, outside the lock
        future = ScheduleFuture(batch.B, batch.n, squeeze)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise ServiceClosed("submit() after close()")
                if (
                    self._inflight_rows + batch.B <= self.max_pending
                    or self._inflight_rows == 0  # oversize request, alone
                ):
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self._stats["rejected"] += 1
                    raise ServiceOverloaded(
                        f"admission queue full ({self._inflight_rows}/"
                        f"{self.max_pending} rows in flight) past timeout"
                    )
                self._cond.wait(remaining)
            t_now = time.monotonic()
            future.submitted_at = t_now
            was_idle = not self._pending
            bucket = self._pending.setdefault(key, [])
            bucket.append(_Request(batch, future, t_now))
            self._pending_rows += batch.B
            self._inflight_rows += batch.B
            self._stats["requests"] += 1
            self._stats["rows"] += batch.B
            # Wake the coalescer only when this submit changes its schedule:
            # a new deadline (queue was idle) or a size-ripe bucket. A later
            # arrival never shortens an existing delay deadline, so skipping
            # the notify here avoids a context switch per request on the
            # saturated path (the coalescer wakes on its own timer).
            if was_idle or sum(r.batch.B for r in bucket) >= self.max_batch:
                self._cond.notify_all()
        return future

    def submit_frontier(
        self,
        problem: Problem,
        time_tables,
        deadlines=None,
        split_regimes: bool = True,
        timeout: Optional[float] = None,
    ) -> FrontierFuture:
        """Admits a Pareto-frontier request: the ε-constraint sweep of
        ``problem`` over ``deadlines`` (``None``: the exact candidate set —
        :func:`~repro_torch.core.pareto.candidate_deadlines`) as ONE coalescable
        request. Returns a :class:`FrontierFuture` whose ``result()`` is the
        pruned :class:`~repro_torch.core.pareto.ParetoFrontier`. Same admission /
        backpressure semantics as :meth:`submit`."""
        if deadlines is None:
            deadlines = candidate_deadlines(problem, time_tables)
        deadlines = np.asarray(list(deadlines), dtype=np.float64)
        tight = tightened_instances(problem, time_tables, deadlines)
        future = self.submit(tight, split_regimes=split_regimes, timeout=timeout)
        return FrontierFuture(future, problem, time_tables, deadlines)

    def submit_fleet(
        self,
        problem: Problem,
        *,
        clusters=None,
        quantum: Optional[int] = None,
        seed: int = 0,
        time_tables=None,
        check: bool = True,
    ) -> FleetFuture:
        """Admits a two-level fleet solve (DESIGN.md §16): clusters the
        clients on the calling thread (deterministic k-means), submits the
        per-cluster curve batch as ONE coalescable request, and returns a
        :class:`FleetFuture`. The top-level allocation and per-cluster
        schedule stages run through the service too when ``result()`` is
        called. Same knobs as
        :meth:`repro_torch.core.solver.Solver.solve_fleet`."""
        from ..core.fleet import FleetRun  # lazy: fleet sits above the engine

        return FleetFuture(
            FleetRun(
                problem,
                service=self,
                clusters=clusters,
                quantum=quantum,
                seed=seed,
                time_tables=time_tables,
                check=check,
            )
        )

    def warm(self, specs, batch_sizes=None, split_regimes: bool = False) -> int:
        """Ahead-of-time builds the plans that traffic of the given shapes
        will hit, so steady-state serving never pays a plan build (on the
        card: an eager warm-up and one CUDA-graph capture).

        ``specs``: iterable of ``(n, T, W)`` shapes — actual request shapes
        (``T`` in 0-lower-limit terms, i.e. ``T - sum(L)``) or bucket axes
        straight from :func:`~repro_torch.core.sweep.request_bucket`; both round
        to the same buckets. ``batch_sizes`` defaults to the full pow2
        ladder up to ``max_batch`` (:func:`~repro_torch.serve.coalesce.
        pow2_ladder`), covering every batch bucket a size- OR delay-
        triggered flush can produce. With ``split_regimes=True`` each spec
        additionally warms the ``("marginal", ...)`` selection bucket
        (best-effort: a mixed-regime flush splits into sub-batches of
        data-dependent size, so only full-batch buckets are guaranteed).

        Returns the number of fresh plan builds performed (the engine's
        ``compiles`` delta; 0 = everything was already warm). Runs synchronously on the caller's thread,
        directly against the engine — intended before opening the doors.

        Raises ``ValueError`` when the warm plan holds more executables
        than the engine's LRU (``max_entries``): warming past capacity
        would silently evict the oldest warm entries and steady-state
        traffic would pay cold plan builds anyway — construct the engine with a
        larger ``max_entries`` (or warm fewer buckets) instead.
        """
        sizes = list(batch_sizes) if batch_sizes is not None else pow2_ladder(self.max_batch)
        specs = [tuple(int(v) for v in spec) for spec in specs]
        planned = {
            ("dp", _next_pow2(B), _next_pow2(n), _next_pow2(T), _next_pow2(W))
            for n, T, W in specs
            for B in sizes
        }
        if split_regimes:
            planned |= {
                ("marginal", _next_pow2(B), _next_pow2(n), _next_pow2(W))
                for n, _T, W in specs
                for B in sizes
            }
        if len(planned) > self.engine.max_entries:
            raise ValueError(
                f"warm plan needs {len(planned)} executables but the engine LRU "
                f"holds max_entries={self.engine.max_entries} — the oldest warm "
                f"entries would be evicted before serving. Use "
                f"SweepEngine(max_entries>={len(planned)}) or warm fewer buckets."
            )
        before = self.engine.cache_stats()["compiles"]
        for n, T, W in specs:
            for B in sizes:
                wb = warm_batch(n, T, W, B, regime="arbitrary")
                self.engine.dispatch(wb, split_regimes=split_regimes).result()
                if split_regimes:
                    mono = warm_batch(n, T, W, B, regime="increasing")
                    self.engine.dispatch(mono, split_regimes=True).result()
        built = self.engine.cache_stats()["compiles"] - before
        with self._cond:
            self._stats["warmed_executables"] += built
        return built

    def stats(self) -> dict:
        """Service counters plus live queue depths (rows)."""
        with self._cond:
            out = dict(self._stats)
            out["pending_rows"] = self._pending_rows
            out["inflight_rows"] = self._inflight_rows
            out["mean_flush_rows"] = (
                out["flushed_rows"] / out["flushes"] if out["flushes"] else 0.0
            )
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        return out

    def close(self, timeout: Optional[float] = None) -> None:
        """Clean shutdown: flush everything pending, serve every in-flight
        request, then stop both threads. Idempotent; later submits raise
        :class:`ServiceClosed`."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._coalescer.join(timeout)
        self._completer.join(timeout)

    def __enter__(self) -> "SchedulerService":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # ---- coalescer thread ----------------------------------------------

    def _ripe(self, key, reqs, now: float) -> Optional[str]:
        """The flush trigger a bucket has hit, if any."""
        if sum(r.batch.B for r in reqs) >= self.max_batch:
            return "size"
        if now - reqs[0].t_submit >= self.max_delay_s:
            return "delay"
        return None

    def _coalesce_loop(self) -> None:
        while True:
            flushes = []
            with self._cond:
                while not self._closed:
                    now = time.monotonic()
                    if any(self._ripe(k, rs, now) for k, rs in self._pending.items()):
                        break
                    if self._pending:
                        oldest = min(rs[0].t_submit for rs in self._pending.values())
                        self._cond.wait(max(oldest + self.max_delay_s - now, 0.0))
                    else:
                        self._cond.wait()
                now = time.monotonic()
                for key in list(self._pending):
                    trigger = (
                        "close" if self._closed else self._ripe(key, self._pending[key], now)
                    )
                    if trigger is None:
                        continue
                    # Cap a flush at max_batch rows (requests stay atomic):
                    # rows that arrived since the bucket went ripe stay
                    # pending, so the flushed batch-axis bucket never
                    # exceeds the pow2 ladder warm() built. A single
                    # oversize request still flushes alone. When closing,
                    # drain the bucket in capped chunks too.
                    while self._pending.get(key):
                        queued = self._pending[key]
                        take, rows = [], 0
                        for r in queued:
                            if take and rows + r.batch.B > self.max_batch:
                                break
                            take.append(r)
                            rows += r.batch.B
                        if len(take) == len(queued):
                            self._pending.pop(key)
                        else:
                            self._pending[key] = queued[len(take) :]
                        self._pending_rows -= rows
                        self._stats[f"{trigger}_flushes"] += 1
                        flushes.append((key, take))
                        if not self._closed:
                            break
                drained = self._closed and not self._pending
                self._cond.notify_all()
            for key, reqs in flushes:
                self._flush(key, reqs)
            if drained:
                self._done_q.put(None)  # completer: nothing further is coming
                return

    def _flush(self, key, reqs) -> None:
        """ONE engine dispatch for a ripe bucket (launched, not
        materialized: on the card the host pad, the copy in and the replay's
        launch run here, under the engine's run lock), handed to the
        completer. Failure
        handling (retry / breaker / degraded solve) runs on the completer
        thread so the coalescer's flush cadence never blocks on backoff."""
        split = key[3]
        combined, slices = combine_batches([r.batch for r in reqs])
        if self.breaker is not None and not self.breaker.allow():
            # breaker open: route straight to the degraded direct-solve path
            self._done_q.put(("degraded", None, reqs, slices, combined, split))
            return
        try:
            handle = self.engine.dispatch(combined, split_regimes=split)
        except BaseException as e:
            self._done_q.put(("failed", e, reqs, slices, combined, split))
            return
        with self._cond:
            self._stats["flushes"] += 1
            self._stats["flushed_rows"] += combined.B
        self._done_q.put(("ok", handle, reqs, slices, combined, split))

    # ---- completer thread ----------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            kind, payload, reqs, slices, combined, split = item
            if kind == "ok":
                try:
                    X = payload.result()  # waits on the flush's event, then copies
                except BaseException as e:
                    self._recover_flush(reqs, slices, combined, split, e)
                    continue
                if self.breaker is not None:
                    self.breaker.record_success()
                self._land(reqs, slices, payload, X)
            elif kind == "failed":
                self._recover_flush(reqs, slices, combined, split, payload)
            else:  # "degraded": breaker was open at flush time
                self._serve_degraded(reqs, slices, combined, split)

    def _recover_flush(self, reqs, slices, combined, split, exc) -> None:
        """A flush's engine attempt failed (at dispatch or materialization):
        retry transient errors under the policy, feed the breaker, and — with
        a breaker configured — serve exhausted-transient flushes from the
        degraded path instead of failing them. Non-transient errors always
        propagate to the futures unchanged (real bugs are not retried), and
        they do not feed the breaker: a sticky CUDA fault must keep failing
        every later flush, never open the breaker and send them all to the
        host algorithms."""
        with self._cond:
            self._stats["flush_failures"] += 1
        if self.breaker is not None:
            if is_transient(exc):
                self.breaker.record_failure()
            else:
                self.breaker.release()
        if is_transient(exc) and self.retry is not None:
            attempt = 1
            while attempt < self.retry.max_attempts:
                if self.breaker is not None and not self.breaker.allow():
                    break  # opened mid-retry: stop hammering, degrade below
                time.sleep(self.retry.delay(attempt, self._retry_rng))
                attempt += 1
                with self._cond:
                    self._stats["retries"] += 1
                try:
                    handle = self.engine.dispatch(combined, split_regimes=split)
                    X = handle.result()
                except BaseException as e:
                    exc = e
                    with self._cond:
                        self._stats["flush_failures"] += 1
                    if not is_transient(exc):
                        if self.breaker is not None:
                            self.breaker.release()
                        break
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    continue
                if self.breaker is not None:
                    self.breaker.record_success()
                with self._cond:
                    self._stats["flushes"] += 1
                    self._stats["flushed_rows"] += combined.B
                self._land(reqs, slices, handle, X)
                return
        if is_transient(exc) and self.breaker is not None:
            self._serve_degraded(reqs, slices, combined, split)
        else:
            self._abort(reqs, exc)

    def _serve_degraded(self, reqs, slices, combined, split) -> None:
        """The circuit breaker's fallback: solve every instance of the flush
        with the host algorithms (``auto`` regime dispatch for split flushes,
        the reference DP otherwise) — engine-free, slower, but bit-identical
        schedules (asserted in tests/test_service_resilience.py), so callers
        cannot tell a degraded flush from a served one except by latency and
        the absence of ``k_last``."""
        try:
            X = np.zeros((combined.B, combined.n), dtype=np.int64)
            obj = np.zeros(combined.B, dtype=np.float64)
            for b in range(combined.B):
                p = combined.instance(b)
                x, _ = _schedule(p, "auto" if split else "dp", check=False)
                X[b, : p.n] = x
                fixed = float(
                    sum(p.cost_tables[i][int(p.lower[i])] for i in range(p.n))
                )
                obj[b] = total_cost(p, x) - fixed  # 0-lower-limit convention
        except BaseException as e:
            self._abort(reqs, e)
            return
        with self._cond:
            self._stats["degraded_flushes"] += 1
            self._stats["degraded_rows"] += combined.B
        self._land(reqs, slices, _DegradedHandle(X, obj), X)

    def _land(self, reqs, slices, handle, X) -> None:
        t_done = time.monotonic()
        for r, (lo, hi) in zip(reqs, slices):
            # each request sees only ITS rows, trimmed to its own n
            r.future._resolve(X[lo:hi, : r.batch.n].copy(), handle, lo, hi, t_done)
        self._retire(reqs)

    def _abort(self, reqs, exc: BaseException) -> None:
        for r in reqs:
            r.future._fail(exc)
        self._retire(reqs)

    def _retire(self, reqs) -> None:
        with self._cond:
            self._inflight_rows -= sum(r.batch.B for r in reqs)
            self._stats["completed_requests"] += len(reqs)
            self._cond.notify_all()  # wake producers blocked on admission
