"""(MC)^2MKP — Multiple-Choice Minimum-Cost Maximal Knapsack Packing.

Paper Section 4: Definition 2, recurrences (3)-(5), Algorithm 1, and the
scheduling<->knapsack transformation of Section 4.1.1.

Two layers:
  * A faithful general solver over arbitrary disjoint item classes
    (`solve_mc2mkp`), matching Algorithm 1 line by line (with the vectorized
    inner relaxation over ``t`` for speed — semantics identical).
  * The scheduling entry point (`solve_schedule_dp`) that maps a
    :class:`~repro_torch.core.problem.Problem` onto classes ``N_i = {L_i..U_i}``
    (after the Section 5.2 lower-limit removal) and translates the packing
    back into a schedule.

Complexities match the paper: space O(Tn), time O(T * sum_i |N_i|), i.e.
O(T^2 n) for the scheduling case.

A numpy copy of ``repro.core.mc2mkp``: it is the port's float64 host oracle,
on machines that have no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .problem import Problem, remove_lower_limits, restore_lower_limits

__all__ = [
    "ItemClass",
    "MC2MKPSolution",
    "solve_mc2mkp",
    "mc2mkp_matrices",
    "solve_schedule_dp",
    "brute_force_schedule",
]

INF = np.inf


@dataclasses.dataclass(frozen=True)
class ItemClass:
    """A disjoint class N_i: parallel arrays of item weights and costs."""

    weights: np.ndarray  # (m_i,) int
    costs: np.ndarray  # (m_i,) float

    def __post_init__(self):
        object.__setattr__(self, "weights", np.asarray(self.weights, dtype=np.int64))
        object.__setattr__(self, "costs", np.asarray(self.costs, dtype=np.float64))
        if self.weights.shape != self.costs.shape:
            raise ValueError("weights/costs length mismatch")


@dataclasses.dataclass(frozen=True)
class MC2MKPSolution:
    total_cost: float  # ΣC
    used_capacity: int  # T*
    items: np.ndarray  # (n,) chosen item INDEX per class (into the class arrays)


def mc2mkp_matrices(classes: Sequence[ItemClass], T: int):
    """Algorithm 1 lines 1-19: fills the K (min cost) and I (chosen item)
    matrices for all partial problems Z_r(t), r=1..n, t=0..T.

    Returns (K, I): K float (n, T+1), I int (n, T+1) holding the item index
    within each class (-1 where no solution exists).
    """
    n = len(classes)
    K = np.full((n, T + 1), INF, dtype=np.float64)
    I = np.full((n, T + 1), -1, dtype=np.int64)

    # Z_1: only the items of the first class (lines 7-9).
    c0 = classes[0]
    for j in range(len(c0.weights)):
        w, c = int(c0.weights[j]), float(c0.costs[j])
        if w <= T and c < K[0, w]:
            K[0, w] = c
            I[0, w] = j
    # Z_i from Z_{i-1} (lines 10-19). The loop over t is vectorized: for a
    # fixed item j, K[i][w_ij:] <- min(K[i][w_ij:], K[i-1][:-w_ij or all]+c).
    for i in range(1, n):
        ci = classes[i]
        for j in range(len(ci.weights)):
            w, c = int(ci.weights[j]), float(ci.costs[j])
            if w > T:
                continue
            prev = K[i - 1, : T + 1 - w] + c
            better = prev < K[i, w:]
            K[i, w:][better] = prev[better]
            I[i, w:][better] = j
    return K, I


def solve_mc2mkp(classes: Sequence[ItemClass], T: int) -> MC2MKPSolution:
    """Algorithm 1 in full: DP fill + T* search (lines 20-23) + backtrack
    (lines 25-28)."""
    n = len(classes)
    K, I = mc2mkp_matrices(classes, T)
    t_star = T
    while t_star > 0 and not np.isfinite(K[n - 1, t_star]):
        t_star -= 1
    if not np.isfinite(K[n - 1, t_star]):
        raise ValueError("no feasible packing (some class has no item of weight <= T)")
    total = float(K[n - 1, t_star])
    items = np.zeros(n, dtype=np.int64)
    t = t_star
    for i in range(n - 1, -1, -1):
        j = int(I[i, t])
        items[i] = j
        t -= int(classes[i].weights[j])
    return MC2MKPSolution(total_cost=total, used_capacity=t_star, items=items)


# ---------------------------------------------------------------------------
# Scheduling entry point (Section 4.1.1 transformation)
# ---------------------------------------------------------------------------


def _classes_from_problem(p: Problem) -> list:
    """N_i = {L_i, ..., U_i}; c_ij = C_i(j); w_ij = j. Expects L_i == 0
    (call after remove_lower_limits)."""
    out = []
    for i in range(p.n):
        u = int(p.upper[i])
        w = np.arange(0, u + 1, dtype=np.int64)
        out.append(ItemClass(weights=w, costs=p.cost_tables[i][: u + 1]))
    return out


def solve_schedule_dp(problem: Problem) -> np.ndarray:
    """Optimal schedule via (MC)^2MKP (paper Theorem 1).

    Applies the Section 5.2 lower-limit removal first, so the DP runs on the
    0-based equivalent instance; the result is shifted back via eq. (11).
    For valid scheduling instances the packing always uses full capacity
    (T* == T), per Section 4.1.1.
    """
    problem.validate()
    p0 = remove_lower_limits(problem)
    classes = _classes_from_problem(p0)
    sol = solve_mc2mkp(classes, p0.T)
    assert sol.used_capacity == p0.T, "scheduling instances always fill the knapsack"
    # item index == number of tasks here (weights are 0..U_i)
    x_prime = sol.items.astype(np.int64)
    return restore_lower_limits(problem, x_prime)


def brute_force_schedule(problem: Problem) -> np.ndarray:
    """Exhaustive optimal schedule (tests only; exponential)."""
    problem.validate()
    n, T = problem.n, problem.T
    best = (INF, None)

    def rec(i: int, remaining: int, acc: float, xs: list):
        nonlocal best
        if acc >= best[0]:
            return
        if i == n:
            if remaining == 0 and acc < best[0]:
                best = (acc, list(xs))
            return
        lo, up = int(problem.lower[i]), int(problem.upper[i])
        # prune by feasibility of the suffix
        suffix_lo = int(problem.lower[i + 1 :].sum())
        suffix_up = int(problem.upper[i + 1 :].sum())
        for j in range(lo, up + 1):
            r = remaining - j
            if r < suffix_lo or r > suffix_up:
                continue
            xs.append(j)
            rec(i + 1, r, acc + problem.cost(i, j), xs)
            xs.pop()

    rec(0, T, 0.0, [])
    if best[1] is None:
        raise ValueError("infeasible instance")
    return np.asarray(best[1], dtype=np.int64)
