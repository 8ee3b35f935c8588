"""The ``Solver`` facade: one front door for every solve.

:class:`Solver` folds the six legacy entrypoints — ``schedule`` /
``schedule_batch`` / ``schedule_with_deadline`` / ``deadline_sweep`` /
``solve_dp_batch_cached`` / ``solve_schedule_batch_cached`` — into three
verbs:

  * :meth:`Solver.solve` — one instance or a batch, optional ε-constraint
    ``deadline``, returning :class:`Solution` / :class:`SolutionBatch`
    (schedule(s) + exact float64 objective(s) + resolved algorithm(s) +
    regime(s) + free ``k_last`` rows on pure-DP paths + engine cache stats).
  * :meth:`Solver.sweep` — a whole deadline grid in ONE batched dispatch.
  * :meth:`Solver.frontier` — the exact (energy, time) Pareto set
    (``repro_torch.core.pareto``), plus :meth:`Solver.solve_scalarized` /
    :meth:`Solver.solve_constrained` answering any number of weighted-sum /
    ε-constraint queries from that one dispatch.

Construction picks the execution substrate once — an explicit
:class:`~repro_torch.core.sweep.SweepEngine`, a ``backend`` name and a
``device`` (the shared default engine there; ``"cuda"`` unless the caller
asks for the CPU), or a :class:`~repro_torch.serve.service.SchedulerService`
(batch solves become coalescable served requests) — and every verb uses
it. The port of ``repro.core.solver``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .marginal_torch import select_algorithm_batch
from .problem import Problem, ProblemBatch, total_cost, validate_schedule
from .resilience import retry_call
from .scheduler import (
    _DP_ALGORITHMS,
    _schedule,
    _schedule_batch,
    tighten_for_deadline,
)
from .sweep import _resolve_engine

__all__ = ["Solution", "SolutionBatch", "Solver"]


@dataclasses.dataclass(frozen=True)
class Solution:
    """One solved instance.

    ``objective`` is the exact float64 energy of ``schedule`` under the
    ORIGINAL cost tables (host-evaluated — independent of device f32).
    ``algorithm`` is the resolved Table-2 algorithm ("auto" never leaks
    through). ``k_last`` is the final DP row (0-lower-limit terms, the free
    workload-Pareto curve) when the solve ran the fused DP; ``None`` on
    marginal fast paths and host algorithms. ``deadline`` records the
    ε-constraint the instance was tightened for, if any."""

    schedule: np.ndarray
    objective: float
    algorithm: str
    regime: str
    deadline: Optional[float] = None
    k_last: Optional[np.ndarray] = None
    cache_stats: Optional[dict] = None


class SolutionBatch:
    """``B`` solved instances from one facade call: per-instance schedules
    (each trimmed to its own ``n``), exact float64 ``objectives``, resolved
    ``algorithms`` and ``regimes``, the batched ``k_last`` rows (pure-DP
    dispatches only, else ``None``), the per-point ``deadlines`` for sweep
    results, and a post-solve engine ``cache_stats`` snapshot. Indexing
    yields per-instance :class:`Solution` views."""

    def __init__(
        self,
        schedules,
        objectives,
        algorithms,
        regimes,
        deadlines=None,
        k_last=None,
        cache_stats=None,
    ):
        self.schedules = list(schedules)
        self.objectives = np.asarray(objectives, dtype=np.float64)
        self.algorithms = list(algorithms)
        self.regimes = list(regimes)
        self.deadlines = None if deadlines is None else np.asarray(deadlines, np.float64)
        self.k_last = k_last
        self.cache_stats = cache_stats

    def __len__(self) -> int:
        return len(self.schedules)

    def __getitem__(self, b: int) -> Solution:
        b = range(len(self))[b]  # normalize negative indices
        return Solution(
            schedule=self.schedules[b],
            objective=float(self.objectives[b]),
            algorithm=self.algorithms[b],
            regime=self.regimes[b],
            deadline=None if self.deadlines is None else float(self.deadlines[b]),
            k_last=None if self.k_last is None else self.k_last[b],
            cache_stats=self.cache_stats,
        )

    def __iter__(self):
        return (self[b] for b in range(len(self)))


def _as_problem_list(problems):
    if isinstance(problems, ProblemBatch):
        return [problems.instance(b) for b in range(problems.B)]
    return list(problems)


class Solver:
    """One facade over every solve path.

    Args:
      engine: explicit :class:`~repro_torch.core.sweep.SweepEngine`;
        ``None`` uses the process-wide default for ``backend`` on
        ``device``.
      backend: kernel backend name ("auto" per-device dispatch when
        ``None``). Naming both an engine and a contradicting backend raises
        ValueError (same rule as the engine layer).
      service: a :class:`~repro_torch.serve.service.SchedulerService`; when
        set, batch solves and sweeps are submitted as served requests
        (coalescing with other same-bucket traffic) instead of direct engine
        dispatches. The service's engine supplies cache stats.
      retry: a :class:`~repro_torch.core.resilience.RetryPolicy`; when set,
        every engine-facing dispatch is retried with exponential backoff on
        TRANSIENT failures (``is_transient``) before the error propagates.
        Non-transient errors always fail fast. ``None`` (default) = no
        retries.
      device: the device of the default engine and of single-instance
        device solves (``"cuda"``, which raises without a card, unless the
        caller asks for ``"cpu"``); an explicit ``engine`` (or a service's)
        brings its own.
    """

    def __init__(
        self, engine=None, backend: Optional[str] = None, service=None, retry=None, device="cuda"
    ):
        self.service = service
        if service is not None and engine is None:
            engine = service.engine
        self.engine = _resolve_engine(backend, engine, device)
        if service is not None and service.engine is not self.engine:
            raise ValueError(
                "engine conflicts with service.engine; pass one or the other"
            )
        self.retry = retry
        self._retry_rng = None if retry is None else retry.make_rng()

    def _guard(self, fn):
        """Runs one dispatch closure under the retry policy (no-op when the
        solver was built without one)."""
        if self.retry is None:
            return fn()
        return retry_call(fn, self.retry, rng=self._retry_rng)

    # ---- solve ---------------------------------------------------------

    def solve(
        self,
        problems,
        *,
        deadline: Optional[float] = None,
        time_tables=None,
        algorithm: str = "auto",
        check: bool = True,
    ):
        """Solves one :class:`Problem` (→ :class:`Solution`) or a batch —
        a sequence of Problems or a :class:`ProblemBatch` (→
        :class:`SolutionBatch`).

        ``deadline`` (with ``time_tables``) applies the ε-constraint
        reduction first (:func:`~repro_torch.core.scheduler.tighten_for_deadline`)
        — to every instance of a batch. ``algorithm`` mirrors the historical
        dispatch: "auto" picks per-regime (batches take the regime-split
        engine path), DP names force the batched DP, other names run
        per-instance host algorithms. Schedules are bit-identical to the
        legacy entrypoints — same private implementations.
        """
        if (deadline is None) != (time_tables is None):
            raise ValueError("deadline and time_tables go together")
        if isinstance(problems, Problem):
            p = problems
            if deadline is not None:
                p = tighten_for_deadline(p, time_tables, float(deadline))
            x, alg = _schedule(p, algorithm, check, self.engine.device)
            return Solution(
                schedule=x,
                objective=float(total_cost(p, x)),
                algorithm=alg,
                regime=p.regime(),
                deadline=None if deadline is None else float(deadline),
                cache_stats=self.engine.cache_stats(),
            )
        plist = _as_problem_list(problems)
        if deadline is not None:
            plist = [
                tighten_for_deadline(p, time_tables, float(deadline)) for p in plist
            ]
        deadlines = None if deadline is None else [float(deadline)] * len(plist)
        return self._solve_batch(plist, algorithm, check, deadlines)

    @staticmethod
    def _trimmed(X, plist, check):
        """Each instance's schedule cut to its own ``n``, validated when asked."""
        schedules = [np.asarray(X[b, : p.n], np.int64) for b, p in enumerate(plist)]
        if check:
            for p, x in zip(plist, schedules):
                validate_schedule(p, x)
        return schedules

    def _dp_dispatch(self, plist, check, engine=None):
        """One pure-DP dispatch (not ``.solve()``, to keep the free
        ``k_last`` rows): a served request when the solver has a service,
        else straight through ``engine`` (the solver's own by default).
        Returns the trimmed schedules and the rows."""

        def _served_dp():
            fut = self.service.submit(plist, split_regimes=False)
            return np.asarray(fut.result()), np.asarray(fut.k_last())

        def _direct_dp():
            handle = (engine or self.engine).dispatch(plist, split_regimes=False)
            return handle.result(), handle.k_last()

        X, k_last = self._guard(_served_dp if self.service is not None else _direct_dp)
        return self._trimmed(X, plist, check), k_last

    def _solve_batch(self, plist, algorithm, check, deadlines) -> SolutionBatch:
        regimes = [p.regime() for p in plist]
        k_last = None
        if plist and algorithm == "auto" and self.service is not None:
            X = self._guard(
                lambda: self.service.submit(plist, split_regimes=True).result()
            )
            schedules = self._trimmed(np.asarray(X), plist, check)
            algorithms = list(select_algorithm_batch(plist))
        elif plist and algorithm in _DP_ALGORITHMS:
            engine = None
            if self.service is None and algorithm == "dp_torch_cuda":
                engine = _resolve_engine("cuda", None, self.engine.device)
            schedules, k_last = self._dp_dispatch(plist, check, engine)
            algorithms = ["dp_batch"] * len(plist)
        else:
            schedules = self._guard(
                lambda: _schedule_batch(
                    plist, algorithm, check, backend=None, engine=self.engine, device=self.engine.device
                )
            )
            algorithms = (
                list(select_algorithm_batch(plist))
                if algorithm == "auto" and plist
                else [algorithm] * len(plist)
            )
        objectives = [total_cost(p, x) for p, x in zip(plist, schedules)]
        return SolutionBatch(
            schedules=schedules,
            objectives=objectives,
            algorithms=algorithms,
            regimes=regimes,
            deadlines=deadlines,
            k_last=k_last,
            cache_stats=self.engine.cache_stats(),
        )

    # ---- sweep ---------------------------------------------------------

    def sweep(self, problem: Problem, time_tables, deadlines, check: bool = True) -> SolutionBatch:
        """The whole ε-constraint grid in ONE dispatch: tightens ``problem``
        per deadline (same ``(n, T, W)`` envelope → one plan bucket),
        solves the stack through the pure-DP path (so every point's
        ``k_last`` row comes back free), and returns a
        :class:`SolutionBatch` with per-point ``deadlines`` recorded.
        Infeasible points raise ValueError naming the offending deadline."""
        deadlines = [float(d) for d in deadlines]
        tight = []
        for d in deadlines:
            try:
                tight.append(tighten_for_deadline(problem, time_tables, d))
            except ValueError as e:
                raise ValueError(f"sweep point {d}: {e}") from e
        schedules, k_last = self._dp_dispatch(tight, check)
        return SolutionBatch(
            schedules=schedules,
            objectives=[total_cost(p, x) for p, x in zip(tight, schedules)],
            algorithms=["dp_batch"] * len(tight),
            regimes=[p.regime() for p in tight],
            deadlines=deadlines,
            k_last=k_last,
            cache_stats=self.engine.cache_stats(),
        )

    # ---- fleet ---------------------------------------------------------

    def solve_fleet(
        self,
        problem: Problem,
        *,
        clusters=None,
        quantum: Optional[int] = None,
        seed: Optional[int] = None,
        time_tables=None,
        policy=None,
        check: bool = True,
    ):
        """Two-level fleet solve (DESIGN.md §16): cluster the clients, solve
        every cluster's workload-Pareto curve in one batched dispatch, run an
        exact top-level (MC)²MKP over the curves, then one regime-split
        dispatch for the per-cluster schedules. Scales ``n`` into the
        thousands; returns a :class:`~repro_torch.core.fleet.FleetSolution`
        with a certified relative ``gap_bound`` (0 when ``quantum == 1`` —
        the decomposition is exact then).

        ``clusters``: cluster count (``None``/"auto" ≈ √n); ``quantum``:
        top-level curve sampling step (``None`` = auto, 1 = exact);
        ``seed``: k-means seed; ``time_tables``: optional per-client time
        tables folded into the clustering features. A
        :class:`~repro_torch.core.fleet.PlanPolicy` supplies defaults for any
        argument not given explicitly. Runs over this solver's substrate:
        direct engine dispatches, or coalescable served requests when the
        solver was built over a
        :class:`~repro_torch.serve.service.SchedulerService`.
        """
        from .fleet import FleetRun  # lazy: fleet imports sweep

        if policy is not None:
            clusters = clusters if clusters is not None else policy.fleet_clusters
            quantum = quantum if quantum is not None else policy.fleet_quantum
            seed = seed if seed is not None else policy.fleet_seed
            time_tables = (
                time_tables if time_tables is not None else policy.time_tables
            )
        return FleetRun(
            problem,
            engine=None if self.service is not None else self.engine,
            service=self.service,
            clusters=clusters,
            quantum=quantum,
            seed=0 if seed is None else int(seed),
            time_tables=time_tables,
            check=check,
        ).finish()

    # ---- frontier ------------------------------------------------------

    def frontier(
        self,
        problem: Problem,
        time_tables,
        deadlines=None,
        *,
        split_regimes: bool = True,
        windows=None,
    ):
        """The exact (energy, completion-time) Pareto frontier from ONE
        dispatch (:func:`repro_torch.core.pareto.pareto_frontier`): sweeping
        the full candidate-deadline set when ``deadlines`` is None, a
        bounded grid otherwise. ``windows`` (a
        :class:`~repro_torch.core.costs.CostWindows`) switches to
        per-window frontiers under time-varying costs — still one dispatch
        for all windows × points
        (:func:`~repro_torch.core.pareto.frontier_by_window`). Monotone-regime
        points ride the marginal fast path unless ``split_regimes=False``."""
        from . import pareto  # lazy: pareto imports sweep and scheduler

        kw = dict(
            engine=None if self.service is not None else self.engine,
            service=self.service,
            split_regimes=split_regimes,
        )
        if windows is not None:
            return pareto.frontier_by_window(problem, time_tables, windows, deadlines, **kw)
        return pareto.pareto_frontier(problem, time_tables, deadlines, **kw)

    def solve_scalarized(self, problem: Problem, time_tables, weights, deadlines=None):
        """Batched weighted-sum solves: ``weights`` is an iterable of
        ``(w_energy, w_time)`` pairs; ALL of them are answered from one
        frontier dispatch (a weighted-sum optimum always lies on the Pareto
        set). Returns a list of :class:`~repro_torch.core.pareto.ParetoPoint`,
        one per weight pair."""
        front = self.frontier(problem, time_tables, deadlines)
        return [front.scalarize(we, wt) for we, wt in weights]

    def solve_constrained(
        self,
        problem: Problem,
        time_tables,
        *,
        T_max: Optional[float] = None,
        E_max: Optional[float] = None,
        deadlines=None,
    ):
        """ε-constraint solve from the frontier: minimal energy under a
        completion-time budget ``T_max``, or minimal completion time under
        an energy budget ``E_max``. One frontier dispatch; returns a
        :class:`~repro_torch.core.pareto.ParetoPoint`."""
        front = self.frontier(problem, time_tables, deadlines)
        return front.constrain(T_max=T_max, E_max=E_max)

    # ---- telemetry -----------------------------------------------------

    def cache_stats(self) -> dict:
        """The underlying engine's plan-cache counters."""
        return self.engine.cache_stats()
