"""Baseline schedulers the paper positions itself against.

  - :func:`olar` — OLAR [26] (the author's earlier IPDPS'21 algorithm):
    assigns each next task to the resource whose *resulting* cost is minimal,
    which optimally minimizes the MAXIMUM cost (makespan/round duration) for
    increasing costs — but not the total (energy) cost this paper targets.
  - :func:`uniform` — equal split (FedAvg default behaviour).
  - :func:`proportional` — workload proportional to device efficiency
    (1 / marginal cost at 1 task), the common linear-cost heuristic
    of refs [16]-[22].
  - :func:`random_schedule` — random feasible assignment.
  - :func:`greedy_marginal` — MarIn's greedy rule applied regardless of
    regime (optimal when marginals are non-decreasing, unreliable otherwise;
    a "naive greedy" foil for the Section 3.1 insight that greedy fails in
    general).

Every baseline returns a *valid* schedule (respects limits, sums to T) so
energy comparisons are apples-to-apples.

A numpy copy of ``repro.core.baselines``.
"""

from __future__ import annotations

import heapq

import numpy as np

from .marginal import marin
from .problem import Problem, remove_lower_limits, restore_lower_limits

__all__ = ["olar", "uniform", "proportional", "random_schedule", "greedy_marginal"]


def olar(problem: Problem) -> np.ndarray:
    """OLAR: next task -> argmin_i C_i(x_i + 1) (minimizes max cost)."""
    problem.validate()
    p = remove_lower_limits(problem)
    n = p.n
    x = np.zeros(n, dtype=np.int64)
    heap = []
    for i in range(n):
        if p.upper[i] >= 1:
            heapq.heappush(heap, (float(p.cost_tables[i][1]), i))
    for _ in range(p.T):
        _, k = heapq.heappop(heap)
        x[k] += 1
        nxt = int(x[k]) + 1
        if nxt <= p.upper[k]:
            heapq.heappush(heap, (float(p.cost_tables[k][nxt]), k))
    return restore_lower_limits(problem, x)


def _distribute_respecting_limits(problem: Problem, weights: np.ndarray) -> np.ndarray:
    """Largest-remainder apportionment of T tasks ~ weights, clipped to
    [L_i, U_i] and repaired to feasibility."""
    problem.validate()
    n, T = problem.n, problem.T
    w = np.maximum(np.asarray(weights, dtype=np.float64), 0.0)
    if w.sum() <= 0:
        w = np.ones(n)
    raw = w / w.sum() * T
    x = np.clip(np.floor(raw).astype(np.int64), problem.lower, problem.upper)
    # distribute remainder by largest fractional part, then repair
    order = np.argsort(-(raw - np.floor(raw)))
    deficit = T - int(x.sum())
    idx = 0
    while deficit != 0:
        k = int(order[idx % n])
        if deficit > 0 and x[k] < problem.upper[k]:
            x[k] += 1
            deficit -= 1
        elif deficit < 0 and x[k] > problem.lower[k]:
            x[k] -= 1
            deficit += 1
        idx += 1
        if idx > 4 * n * (abs(deficit) + 1) + 16:  # pragma: no cover
            raise RuntimeError("apportionment repair failed")
    return x


def uniform(problem: Problem) -> np.ndarray:
    return _distribute_respecting_limits(problem, np.ones(problem.n))


def proportional(problem: Problem) -> np.ndarray:
    """Tasks proportional to device efficiency = 1 / M_i(1)."""
    eff = []
    for i in range(problem.n):
        tbl = problem.cost_tables[i]
        lo = int(problem.lower[i])
        if int(problem.upper[i]) > lo:
            m1 = float(tbl[lo + 1] - tbl[lo])
        else:
            m1 = np.inf
        eff.append(1.0 / max(m1, 1e-12))
    return _distribute_respecting_limits(problem, np.asarray(eff))


def random_schedule(problem: Problem, rng: np.random.Generator) -> np.ndarray:
    return _distribute_respecting_limits(problem, rng.random(problem.n) + 1e-3)


def greedy_marginal(problem: Problem) -> np.ndarray:
    """The naive-greedy baseline: MarIn's smallest-next-marginal rule applied
    unconditionally, with NO regime check.

    Guaranteed optimal only when every marginal-cost function is
    non-decreasing (the MarIn regime, paper Theorem 2 — where it IS MarIn);
    on other instances it may coincidentally land on an optimum but can be
    arbitrarily bad (the Section 3.1 counterexamples). Kept as a named
    baseline so benchmarks can show greedy failing where the DP does not —
    ``schedule(algorithm="auto")`` never dispatches here, it routes through
    the shared regime detector (:func:`repro_torch.core.scheduler.select_algorithm`).
    """
    return marin(problem)
