"""Optimal schedulers for monotone marginal-cost regimes (paper Section 5).

All four algorithms operate on the 0-lower-limit equivalent instance
(Section 5.2); the public functions accept any valid instance and apply the
removal/restore transparently.

  - :func:`marin`     — increasing marginals, Θ(n + T log n) (Alg. 2).
  - :func:`marco`     — constant marginals, Θ(n log n) (Alg. 3).
  - :func:`mardecun`  — decreasing marginals, no upper limits, Θ(n) (Alg. 4).
  - :func:`mardec`    — decreasing marginals with upper limits, O(T n^2)
                        (Alg. 5, using Algs. 6-7 and (MC)^2MKP-matrices).

A numpy copy of ``repro.core.marginal`` on the port's own
:mod:`~repro_torch.core.mc2mkp` and :mod:`~repro_torch.core.problem`: the
serial float64 oracles the batched algorithms
(:mod:`~repro_torch.core.marginal_torch`) are held to.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from .mc2mkp import INF, ItemClass, mc2mkp_matrices
from .problem import Problem, remove_lower_limits, restore_lower_limits

__all__ = ["marin", "marco", "mardecun", "mardec"]


def _with_lower_limit_removal(fn):
    def wrapped(problem: Problem) -> np.ndarray:
        problem.validate()
        p0 = remove_lower_limits(problem)
        x0 = fn(p0)
        return restore_lower_limits(problem, x0)

    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


# ---------------------------------------------------------------------------
# MarIn — Algorithm 2 (adapted from OLAR: pick minimal *marginal* cost)
# ---------------------------------------------------------------------------


@_with_lower_limit_removal
def marin(p: Problem) -> np.ndarray:
    """Increasing marginal costs: repeatedly assign the next task to the
    resource with the smallest next marginal cost (min binomial/binary heap:
    insertion amortized O(1)-ish, pop O(log n); total Θ(n + T log n))."""
    n = len(p.cost_tables)
    x = np.zeros(n, dtype=np.int64)
    heap = []
    for i in range(n):
        if p.upper[i] >= 1:
            # marginal of assigning task #1 to i: C_i(1) - C_i(0)
            heapq.heappush(heap, (p.cost_tables[i][1] - p.cost_tables[i][0], i))
    for _ in range(p.T):
        m, k = heapq.heappop(heap)
        x[k] += 1
        nxt = x[k] + 1
        if nxt <= p.upper[k]:
            heapq.heappush(
                heap, (p.cost_tables[k][nxt] - p.cost_tables[k][nxt - 1], k)
            )
    return x


# ---------------------------------------------------------------------------
# MarCo — Algorithm 3
# ---------------------------------------------------------------------------


@_with_lower_limit_removal
def marco(p: Problem) -> np.ndarray:
    """Constant marginal costs: sort resources by per-task marginal M_i(1)
    and fill each to its upper limit (or the remaining tasks). Θ(n log n)."""
    n = len(p.cost_tables)
    x = np.zeros(n, dtype=np.int64)
    # M_i(1) = C_i(1) - C_i(0); resources with U_i == 0 can't take tasks.
    order = sorted(
        (i for i in range(n) if p.upper[i] >= 1),
        key=lambda i: p.cost_tables[i][1] - p.cost_tables[i][0],
    )
    t = 0
    for k in order:
        if t >= p.T:
            break
        take = int(min(p.upper[k], p.T - t))
        x[k] = take
        t += take
    return x


# ---------------------------------------------------------------------------
# MarDecUn — Algorithm 4
# ---------------------------------------------------------------------------


@_with_lower_limit_removal
def mardecun(p: Problem) -> np.ndarray:
    """Decreasing marginals, no (binding) upper limits: all tasks go to the
    single resource with minimal C_i(T). Θ(n).

    Zero-capacity resources (``U_i == 0`` after lower-limit removal — e.g.
    dropped-out clients, or inert batch padding) can never take a task, so
    they neither trigger the guard nor join the argmin; this keeps the
    dispatch rule padding-invariant and identical to the batched
    :func:`repro_torch.core.marginal_torch.mardecun_batch`."""
    if np.any((p.upper > 0) & (p.upper < p.T)):
        raise ValueError("MarDecUn requires U_i >= T for all resources with capacity")
    n = len(p.cost_tables)
    x = np.zeros(n, dtype=np.int64)
    k = min((i for i in range(n) if p.upper[i] >= p.T), key=lambda i: p.cost_tables[i][p.T])
    x[k] = p.T
    return x


# ---------------------------------------------------------------------------
# MarDec — Algorithm 5 (+ Prepare/Translate, Algs. 6-7)
# ---------------------------------------------------------------------------


def _prepare(r_lim, upper, cost_tables):
    """Algorithm 6: two-item classes {0, U_r} for resources with upper
    limits. Returns (classes, gamma) with gamma[class_index] = resource."""
    classes = []
    gamma = []
    for r in r_lim:
        u = int(upper[r])
        classes.append(
            ItemClass(
                weights=np.array([0, u], dtype=np.int64),
                costs=np.array([0.0, float(cost_tables[r][u])]),
            )
        )
        gamma.append(r)
    return classes, gamma


def _translate(gamma, n, classes, I, t_prime):
    """Algorithm 7: backtracks the item matrix I from capacity t_prime into a
    partial schedule over all n resources."""
    x = np.zeros(n, dtype=np.int64)
    t = int(t_prime)
    for ci in range(len(classes) - 1, -1, -1):
        j = int(I[ci, t])
        w = int(classes[ci].weights[j])
        x[gamma[ci]] = w
        t -= w
    return x


@_with_lower_limit_removal
def mardec(p: Problem) -> np.ndarray:
    """Decreasing marginals with upper limits (Alg. 5).

    Optimal solutions have every resource either at 0, at full capacity, or
    exactly one at intermediary capacity (Lemma 6). Enumerates:
      (I)  a resource without upper limits holds t tasks (incl. t == T, the
           MarDecUn case), the rest is a minimal-cost full-capacity packing
           of limited resources over T - t;
      (II) one *limited* resource is the intermediary one: re-run the packing
           DP with that resource's class reduced to {0}.
    """
    n = len(p.cost_tables)
    T = p.T
    r_lim = [i for i in range(n) if p.upper[i] < T]
    r_unl = [i for i in range(n) if p.upper[i] >= T]
    n_lim = len(r_lim)

    best_cost = INF
    best_x: Optional[np.ndarray] = None

    classes, gamma = _prepare(r_lim, p.upper, p.cost_tables)

    # Boundary extension beyond the paper's Alg. 5: when T == sum(U_i) the
    # optimum can have EVERY resource at full capacity (no intermediary, no
    # zero) — the paper excludes this by assuming T strictly below sum(U_i).
    # Checking the unreduced full-capacity packing covers it.
    if n_lim and not r_unl:
        K_full, I_full = mc2mkp_matrices(classes, T)
        if np.isfinite(K_full[n_lim - 1, T]):
            best_cost = float(K_full[n_lim - 1, T])
            best_x = _translate(gamma, n, classes, I_full, T)

    if r_unl:
        if n_lim:
            K, I = mc2mkp_matrices(classes, T)
            last = K[n_lim - 1]
        else:
            last = np.full(T + 1, INF)
            last[0] = 0.0
        for t in range(T + 1):
            k = min(r_unl, key=lambda i: p.cost_tables[i][t])
            packed = last[T - t] if n_lim else (0.0 if t == T else INF)
            cand = float(p.cost_tables[k][t]) + float(packed)
            if cand < best_cost:
                best_cost = cand
                if n_lim:
                    x = _translate(gamma, n, classes, I, T - t)
                else:
                    x = np.zeros(n, dtype=np.int64)
                x[k] = t
                best_x = x

    for ci in range(n_lim):
        k = gamma[ci]
        # Replace class ci with {0}: resource k becomes the intermediary one.
        reduced = list(classes)
        reduced[ci] = ItemClass(weights=np.array([0]), costs=np.array([0.0]))
        if n_lim:
            K, I = mc2mkp_matrices(reduced, T)
            last = K[n_lim - 1]
        else:  # pragma: no cover - n_lim >= 1 in this loop
            continue
        for t in range(int(p.upper[k])):  # t = 0 .. U_k - 1 (strictly below cap)
            if T - t < 0:
                break
            packed = last[T - t]
            if not np.isfinite(packed):
                continue
            cand = float(p.cost_tables[k][t]) + float(packed)
            if cand < best_cost:
                best_cost = cand
                x = _translate(gamma, n, reduced, I, T - t)
                x[k] = t
                best_x = x

    if best_x is None:
        raise ValueError("MarDec found no feasible solution (invalid instance?)")
    return best_x
