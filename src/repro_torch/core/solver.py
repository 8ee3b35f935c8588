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
:class:`~repro_torch.core.sweep.SweepEngine`, or a ``backend`` name and a
``device`` (the shared default engine there; ``"cuda"`` unless the caller
asks for the CPU) — and every verb uses it. The port of
``repro.core.solver``; the serving layer (``service=``) and the fleet solve
are not ported yet and raise ``NotImplementedError``.
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

_SERVICE = "the serving layer is not ported yet: ROADMAP Queue 1, item 4"
_FLEET = "the fleet solve is not ported yet: ROADMAP Queue 1, item 3 (fleet)"


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
      service: the serving layer; not ported, raises ``NotImplementedError``.
      retry: a :class:`~repro_torch.core.resilience.RetryPolicy`; when set,
        every engine-facing dispatch is retried with exponential backoff on
        TRANSIENT failures (``is_transient``) before the error propagates.
        Non-transient errors always fail fast. ``None`` (default) = no
        retries.
      device: the device of the default engine and of single-instance
        device solves (``"cuda"``, which raises without a card, unless the
        caller asks for ``"cpu"``); an explicit ``engine`` brings its own.
    """

    def __init__(
        self, engine=None, backend: Optional[str] = None, service=None, retry=None, device="cuda"
    ):
        if service is not None:
            raise NotImplementedError(_SERVICE)
        self.engine = _resolve_engine(backend, engine, device)
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

    def _dp_dispatch(self, engine, plist, check):
        """One pure-DP dispatch (not ``.solve()``, to keep the free
        ``k_last`` rows): schedules trimmed per instance, and the rows."""

        def _direct_dp():
            handle = engine.dispatch(plist, split_regimes=False)
            return handle.result(), handle.k_last()

        X, k_last = self._guard(_direct_dp)
        schedules = [np.asarray(X[b, : p.n], np.int64) for b, p in enumerate(plist)]
        if check:
            for p, x in zip(plist, schedules):
                validate_schedule(p, x)
        return schedules, k_last

    def _solve_batch(self, plist, algorithm, check, deadlines) -> SolutionBatch:
        regimes = [p.regime() for p in plist]
        k_last = None
        if plist and algorithm in _DP_ALGORITHMS:
            backend = "cuda" if algorithm == "dp_torch_cuda" else None
            engine = _resolve_engine(backend, None if backend else self.engine, self.engine.device)
            schedules, k_last = self._dp_dispatch(engine, plist, check)
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
        schedules, k_last = self._dp_dispatch(self.engine, tight, check)
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

    def solve_fleet(self, problem: Problem, **kwargs):
        """Two-level fleet solve: not ported yet."""
        raise NotImplementedError(_FLEET)

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

        kw = dict(engine=self.engine, split_regimes=split_regimes)
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
