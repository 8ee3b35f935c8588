"""Bicriteria energy × completion-time Pareto engine.

The paper minimizes energy for a FIXED deadline; real deployments trade
energy against wall-clock (Zhou et al., arXiv 2209.14900, jointly optimize
both). The deadline-constrained solve reduces to the SAME problem — a
deadline is just a tighter upper limit ``U_i' = max{j : time_i(j) <= D}``
(see :func:`repro_torch.core.scheduler.tighten_for_deadline`) — so the entire
(energy, completion-time) Pareto frontier is a *batch* of tightened
instances, and the sweep engine already solves whole batches in ONE
dispatch. This module turns that observation into a first-class capability:

  * :func:`pareto_frontier` — the EXACT Pareto set over
    ``(makespan, energy)`` from one
    :class:`~repro_torch.core.sweep.SweepEngine` dispatch (or one
    :class:`~repro_torch.serve.service.SchedulerService` request, which
    coalesces with other same-bucket traffic). Exactness: any
    schedule's makespan is ``max_i time_i(x_i)`` — some time-table entry —
    so sweeping the ε-constraint over every feasible table value
    (:func:`candidate_deadlines`) hits every attainable frontier time, and
    dominated-point pruning (:func:`pareto_indices`) keeps, for each energy
    level, the minimal achievable time and vice versa.
  * :class:`ParetoFrontier` — the pruned point set plus the decision rules
    operators actually use: weighted-sum scalarization (always lands ON the
    frontier), ε-constraint lookups (``T_max`` / ``E_max``), and the knee
    point.
  * :func:`frontier_by_window` — time-varying cost tables (carbon-intensity
    / tariff windows, :class:`repro_torch.core.costs.CostWindows`): one frontier
    per window, ALL windows × deadlines stacked into one dispatch (scaling
    tables by positive per-device multipliers preserves each instance's
    marginal regime, so monotone fleets still ride the marginal fast path).

Monotone-regime rows ride the marginal selection per frontier point
(``split_regimes=True``, the default); arbitrary-regime rows batch into the
fused DP. The facade entrypoint is
:meth:`repro_torch.core.solver.Solver.frontier`. The port of
``repro.core.pareto`` (numpy around the engine).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .problem import Problem, total_cost
from .scheduler import tighten_for_deadline
from .sweep import default_engine

__all__ = [
    "ParetoFrontier",
    "ParetoPoint",
    "assemble_frontier",
    "candidate_deadlines",
    "deadline_grid",
    "feasible_deadline_range",
    "frontier_by_window",
    "pareto_frontier",
    "pareto_indices",
    "tightened_instances",
    "workload_frontier",
]

_BIG_CUTOFF = 1e29  # anything above is an infeasible (BIG-saturated) DP entry


# ---------------------------------------------------------------------------
# pure frontier math (no engine, no threads)
# ---------------------------------------------------------------------------


def pareto_indices(times, energies) -> np.ndarray:
    """Indices of the non-dominated ``(time, energy)`` points (both
    minimized), sorted by time ascending / energy strictly descending.

    Strict dominance with exact float comparison: duplicate times keep the
    cheapest point, duplicate energies keep the fastest — the canonical
    staircase representation of the frontier.
    """
    times = np.asarray(times, dtype=np.float64)
    energies = np.asarray(energies, dtype=np.float64)
    order = np.lexsort((energies, times))  # time asc, then energy asc
    keep, best_e = [], np.inf
    for idx in order:
        if energies[idx] < best_e:
            keep.append(int(idx))
            best_e = energies[idx]
    return np.asarray(keep, dtype=np.int64)


def workload_frontier(k_row: np.ndarray):
    """The (workload, energy) Pareto set hiding in one final DP row.

    ``k_row[t]`` is the minimal cost of assigning EXACTLY ``t`` units
    (:meth:`repro_torch.core.sweep.SweepHandle.k_last`); the bicriterion here
    maximizes workload while minimizing energy. Returns ``(t, energy)``
    arrays, workload ascending with energy strictly increasing (a dominated
    entry — more work available at no extra cost — is pruned).
    """
    k_row = np.asarray(k_row, dtype=np.float64)
    ts = np.nonzero(k_row < _BIG_CUTOFF)[0]
    keep, best_e = [], np.inf
    for t in ts[::-1]:  # largest workload first
        if k_row[t] < best_e:
            keep.append(int(t))
            best_e = k_row[t]
    keep.reverse()
    idx = np.asarray(keep, dtype=np.int64)
    return idx, k_row[idx]


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One frontier point: the ε-constraint ``deadline`` that produced it,
    the schedule's ACHIEVED makespan ``time`` (≤ deadline), its exact
    ``energy`` under the original (float64) cost tables, and the schedule
    itself. ``label`` carries the cost window for time-varying solves."""

    time: float
    energy: float
    deadline: float
    schedule: np.ndarray
    label: Optional[str] = None


class ParetoFrontier:
    """The exact, pruned (time, energy) Pareto set of one instance.

    ``points`` are sorted by time ascending with strictly decreasing energy.
    ``num_swept`` records how many ε-constraint points the one dispatch
    solved (the pre-pruning batch size — frontier telemetry for benchmarks
    and the serve layer).
    """

    def __init__(self, points: Sequence[ParetoPoint], num_swept: int = 0):
        self.points = tuple(points)
        self.num_swept = int(num_swept)
        if not self.points:
            raise ValueError("a Pareto frontier needs at least one point")

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def __getitem__(self, i) -> ParetoPoint:
        return self.points[i]

    @property
    def times(self) -> np.ndarray:
        return np.array([p.time for p in self.points], dtype=np.float64)

    @property
    def energies(self) -> np.ndarray:
        return np.array([p.energy for p in self.points], dtype=np.float64)

    # ---- decision rules -------------------------------------------------

    def min_time(self) -> ParetoPoint:
        return self.points[0]

    def min_energy(self) -> ParetoPoint:
        return self.points[-1]

    def knee(self) -> ParetoPoint:
        """The balanced operating point: minimal Euclidean distance to the
        ideal corner ``(min time, min energy)`` after normalizing both axes
        to the frontier's own range."""
        t, e = self.times, self.energies
        t_span = max(t[-1] - t[0], 1e-300)
        e_span = max(e[0] - e[-1], 1e-300)
        d = ((t - t[0]) / t_span) ** 2 + ((e - e[-1]) / e_span) ** 2
        return self.points[int(np.argmin(d))]

    def scalarize(
        self, w_energy: float, w_time: float, normalize: bool = True
    ) -> ParetoPoint:
        """Weighted-sum solve ``min w_E * energy + w_T * time`` — evaluated
        over the frontier, so the optimum is exact (a weighted-sum optimum
        is always Pareto-optimal) and costs no extra dispatch. With
        ``normalize`` both axes are rescaled to the frontier range first, so
        weights express preference rather than unit conversion. Ties pick
        the faster point."""
        if w_energy < 0 or w_time < 0 or (w_energy == 0 and w_time == 0):
            raise ValueError("weights must be non-negative and not both zero")
        t, e = self.times, self.energies
        if normalize:
            t = (t - t[0]) / max(t[-1] - t[0], 1e-300)
            e = (e - e[-1]) / max(e[0] - e[-1], 1e-300)
        return self.points[int(np.argmin(w_energy * e + w_time * t))]

    def constrain(
        self, T_max: Optional[float] = None, E_max: Optional[float] = None
    ) -> ParetoPoint:
        """ε-constraint lookup: minimal energy subject to ``time <= T_max``,
        or minimal time subject to ``energy <= E_max`` (exactly one bound).
        Raises ValueError when no frontier point satisfies the bound."""
        if (T_max is None) == (E_max is None):
            raise ValueError("pass exactly one of T_max / E_max")
        if T_max is not None:
            ok = np.nonzero(self.times <= float(T_max))[0]
            if not len(ok):
                raise ValueError(
                    f"T_max={T_max} infeasible: fastest frontier point needs "
                    f"time {self.points[0].time:.6g}"
                )
            return self.points[int(ok[-1])]  # loosest feasible = min energy
        ok = np.nonzero(self.energies <= float(E_max))[0]
        if not len(ok):
            raise ValueError(
                f"E_max={E_max} infeasible: cheapest frontier point needs "
                f"energy {self.points[-1].energy:.6g}"
            )
        return self.points[int(ok[0])]  # tightest feasible = min time

    def select(self, mode) -> ParetoPoint:
        """Named operating-point policies (the ``frontier_mode`` knob of the
        FL server): ``"min_energy"`` |
        ``"min_time"`` | ``"knee"``, or a number — a round-time budget,
        resolved as ``constrain(T_max=mode)``."""
        if isinstance(mode, str):
            try:
                return {
                    "min_energy": self.min_energy,
                    "min_time": self.min_time,
                    "knee": self.knee,
                }[mode]()
            except KeyError:
                raise ValueError(
                    f"unknown frontier mode {mode!r}; options: min_energy, "
                    f"min_time, knee, or a numeric time budget"
                ) from None
        return self.constrain(T_max=float(mode))


# ---------------------------------------------------------------------------
# deadline candidates: the exact breakpoints of the energy(deadline) staircase
# ---------------------------------------------------------------------------


def _max_index_within(t: np.ndarray, deadlines: np.ndarray) -> np.ndarray:
    """``u[d] = max{j : t[j] <= d}`` (-1 when empty) for every deadline,
    vectorized. Works for arbitrary (non-monotone) time tables via suffix
    minima: ``max{j : t[j] <= d} = max{j : min(t[j:]) <= d}`` and suffix
    minima are non-decreasing, so searchsorted applies. Identical to the
    per-deadline rule in :func:`~repro_torch.core.scheduler.tighten_for_deadline`.
    """
    suff = np.minimum.accumulate(np.asarray(t, dtype=np.float64)[::-1])[::-1]
    return np.searchsorted(suff, deadlines, side="right") - 1


def _feasible_mask(problem: Problem, time_tables, deadlines: np.ndarray) -> np.ndarray:
    """Which deadlines admit a feasible tightened instance (every device can
    still meet its lower limit; fleet capacity still reaches ``T``)."""
    deadlines = np.asarray(deadlines, dtype=np.float64)
    ok = np.ones(len(deadlines), dtype=bool)
    cap = np.zeros(len(deadlines), dtype=np.int64)
    for i in range(problem.n):
        u = _max_index_within(np.asarray(time_tables[i]), deadlines)
        ok &= u >= int(problem.lower[i])
        cap += np.minimum(u, int(problem.upper[i])).clip(min=0)
    return ok & (cap >= problem.T)


def candidate_deadlines(problem: Problem, time_tables) -> np.ndarray:
    """Every deadline at which the optimal energy can change: the sorted
    unique time-table values ``time_i(j)`` over each device's feasible range
    ``[L_i, U_i]``, filtered to feasibility. Sweeping exactly these points
    yields the EXACT frontier — any schedule's makespan is one of them."""
    vals = np.unique(
        np.concatenate(
            [
                np.asarray(time_tables[i], dtype=np.float64)[
                    int(problem.lower[i]) : int(problem.upper[i]) + 1
                ]
                for i in range(problem.n)
            ]
        )
    )
    feasible = vals[_feasible_mask(problem, time_tables, vals)]
    if not len(feasible):
        raise ValueError("no feasible deadline: instance cannot be scheduled at all")
    return feasible


def feasible_deadline_range(problem: Problem, time_tables):
    """``(d_min, d_max)``: the tightest feasible ε-constraint and the value
    beyond which the constraint is vacuous (every device may run its full
    upper limit)."""
    cands = candidate_deadlines(problem, time_tables)
    return float(cands[0]), float(cands[-1])


def deadline_grid(problem: Problem, time_tables, points: int) -> np.ndarray:
    """An ``<= points``-sized subsample of the exact candidate set (first and
    last always kept): the cheap approximate sweep for live planning loops
    (the FL server's ``frontier_mode``) where a bounded batch size
    matters more than frontier completeness."""
    cands = candidate_deadlines(problem, time_tables)
    if len(cands) <= int(points):
        return cands
    idx = np.unique(np.linspace(0, len(cands) - 1, int(points)).round().astype(int))
    return cands[idx]


# ---------------------------------------------------------------------------
# frontier extraction: one engine dispatch (or one service request)
# ---------------------------------------------------------------------------


def tightened_instances(problem: Problem, time_tables, deadlines) -> list:
    """The ε-constraint batch: one deadline-tightened instance per point
    (same ``n``/``T``/``W`` envelope, so the whole batch lands in ONE engine
    plan bucket). Raises ValueError naming the offending deadline when a
    point is infeasible."""
    tight = []
    for d in deadlines:
        try:
            tight.append(tighten_for_deadline(problem, time_tables, float(d)))
        except ValueError as e:
            raise ValueError(f"frontier point {d}: {e}") from e
    return tight


def assemble_frontier(
    problem: Problem, time_tables, deadlines, X: np.ndarray, label: Optional[str] = None
) -> ParetoFrontier:
    """Prunes the solved ε-constraint sweep into a :class:`ParetoFrontier`.

    ``X`` holds the ``(B, n)`` schedules of :func:`tightened_instances`;
    energies are re-evaluated on the host against the ORIGINAL float64 cost
    tables (exact — independent of the f32 device arithmetic that picked the
    schedules), times are each schedule's achieved makespan.
    """
    X = np.asarray(X, dtype=np.int64)[:, : problem.n]
    energies = np.array([total_cost(problem, x) for x in X], dtype=np.float64)
    times = np.array(
        [
            max(float(time_tables[i][int(x[i])]) for i in range(problem.n))
            for x in X
        ],
        dtype=np.float64,
    )
    keep = pareto_indices(times, energies)
    points = [
        ParetoPoint(
            time=float(times[b]),
            energy=float(energies[b]),
            deadline=float(deadlines[b]),
            schedule=X[b].copy(),
            label=label,
        )
        for b in keep
    ]
    return ParetoFrontier(points, num_swept=len(X))


def _solve_sweep(tight, engine, backend, service, split_regimes, device) -> np.ndarray:
    """ONE dispatch for the whole tightened batch: through the serve layer
    when a service is given (the request coalesces with other same-bucket
    traffic), else straight through the engine (the given one, else the
    shared default for ``backend`` on ``device``)."""
    if service is not None:
        return np.asarray(service.submit(tight, split_regimes=split_regimes).result())
    if engine is None:
        engine = default_engine(backend or "auto", device)
    return engine.solve(tight, split_regimes=split_regimes)


def pareto_frontier(
    problem: Problem,
    time_tables,
    deadlines=None,
    *,
    engine=None,
    backend: Optional[str] = None,
    service=None,
    split_regimes: bool = True,
    device="cuda",
) -> ParetoFrontier:
    """The (energy, completion-time) Pareto frontier of one instance, from
    ONE batched dispatch.

    ``deadlines=None`` sweeps the exact candidate set
    (:func:`candidate_deadlines` — every point where the optimum can move),
    making the returned frontier the EXACT Pareto set; pass an explicit grid
    (e.g. :func:`deadline_grid`) to bound the batch size instead. With
    ``split_regimes=True`` (default) monotone-regime rows ride the marginal
    fast path; ``False`` forces every point through the fused DP.
    ``service`` routes the sweep through a
    :class:`~repro_torch.serve.service.SchedulerService` as one coalescable
    request; without it or an ``engine`` the shared default for ``backend``
    on ``device`` runs it.
    """
    problem.validate()
    if deadlines is None:
        deadlines = candidate_deadlines(problem, time_tables)
    deadlines = np.asarray(list(deadlines), dtype=np.float64)
    tight = tightened_instances(problem, time_tables, deadlines)
    X = _solve_sweep(tight, engine, backend, service, split_regimes, device)
    return assemble_frontier(problem, time_tables, deadlines, X)


def frontier_by_window(
    problem: Problem,
    time_tables,
    windows,
    deadlines=None,
    *,
    engine=None,
    backend: Optional[str] = None,
    service=None,
    split_regimes: bool = True,
    device="cuda",
) -> dict:
    """Per-window frontiers under time-varying costs — ALL windows and ALL
    deadline points solved in ONE dispatch.

    ``windows`` is a :class:`repro_torch.core.costs.CostWindows` (window-indexed
    per-device cost multipliers: carbon-intensity or tariff schedules). The
    candidate deadlines depend only on the time tables, so every window
    shares one sweep grid; the per-window tightened instances all share the
    ``(n, T, W)`` envelope and therefore one plan bucket. Returns
    ``{window label: ParetoFrontier}``.
    """
    problem.validate()
    if deadlines is None:
        deadlines = candidate_deadlines(problem, time_tables)
    deadlines = np.asarray(list(deadlines), dtype=np.float64)
    stacked, per_window = [], []
    for w, wp in enumerate(windows.apply(problem)):
        tight = tightened_instances(wp, time_tables, deadlines)
        stacked.extend(tight)
        per_window.append((windows.labels[w], wp))
    X = _solve_sweep(stacked, engine, backend, service, split_regimes, device)
    out, B = {}, len(deadlines)
    for w, (label, wp) in enumerate(per_window):
        out[label] = assemble_frontier(
            wp, time_tables, deadlines, X[w * B : (w + 1) * B], label=label
        )
    return out
