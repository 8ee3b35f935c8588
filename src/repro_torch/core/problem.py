"""Minimal Cost FL Schedule problem (paper Definition 1).

An instance ``(R, T, U, L, C)``:
  - ``n`` heterogeneous resources,
  - workload of ``T`` identical, independent, atomic tasks,
  - per-resource lower/upper limits ``L_i <= x_i <= U_i``,
  - per-resource cost functions ``C_i : [L_i, U_i] -> R>=0``.

Goal: schedule ``X = (x_1..x_n)`` with ``sum x_i == T`` minimizing
``sum_i C_i(x_i)``.

Cost functions are represented as dense tables over ``[0, U_i]`` (entries
below ``L_i`` are present but never selected) so that all algorithms —
including the (MC)^2MKP dynamic program and the CUDA min-plus kernel —
can consume them as arrays.

This module is numpy only. It mirrors ``repro.core.problem`` so that the
PyTorch port never imports the JAX package; :func:`from_reference` carries an
instance built by the JAX package across, so both solve the same input.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "Problem",
    "ProblemBatch",
    "Schedule",
    "classify_regimes",
    "from_reference",
    "remove_lower_limits",
    "restore_lower_limits",
    "total_cost",
    "total_cost_batch",
    "validate_schedule",
    "validate_schedule_batch",
]

# Large-but-finite stand-in for +inf in dense packed tables (mirrors
# repro_torch.kernels.ref.BIG; duplicated here so core carries no kernel import).
PACK_BIG = 1e30


def classify_regimes(costs, lower, upper, atol: float = 1e-9) -> np.ndarray:
    """Vectorized marginal-cost regime classification (paper Definition 3).

    THE single source of truth for regime detection: ``Problem.regime``,
    ``ProblemBatch.regimes``, and the scheduler's serial AND batched
    algorithm dispatch all route through here, so the two dispatch paths can
    never disagree (DESIGN.md §13).

    Args:
      costs: ``(B, n, W)`` dense packed tables (entries beyond each ``U_i``
        may hold anything — they are masked out).
      lower/upper: ``(B, n)`` limits.

    Returns a ``(B,)`` array of ``'increasing' | 'constant' | 'decreasing' |
    'arbitrary'`` strings. A resource contributes the marginal comparisons
    ``M_i(j)`` vs ``M_i(j+1)`` for ``j`` in ``[L_i+1, U_i-1]``; resources
    with fewer than two marginals (``U_i - L_i < 2`` — including padded
    phantom resources) contribute nothing, so classification is invariant
    under the inert batch padding of :meth:`ProblemBatch.pad_to`.
    """
    costs = np.asarray(costs, dtype=np.float64)
    lower = np.asarray(lower, dtype=np.int64)
    upper = np.asarray(upper, dtype=np.int64)
    B, n, W = costs.shape
    if W < 3:  # no resource can have two marginals
        return np.full(B, "constant", dtype=object)
    d1 = costs[:, :, 1:] - costs[:, :, :-1]  # d1[..., j-1] = M(j)
    d2 = d1[:, :, 1:] - d1[:, :, :-1]  # d2[..., j-1] = M(j+1) - M(j)
    j = np.arange(1, W - 1)[None, None, :]
    valid = (j >= lower[:, :, None] + 1) & (j + 1 <= upper[:, :, None])
    d2 = np.where(valid, d2, 0.0)
    inc = ~np.any(d2 < -atol, axis=(1, 2))
    con = ~np.any(np.abs(d2) > atol, axis=(1, 2))
    dec = ~np.any(d2 > atol, axis=(1, 2))
    out = np.full(B, "arbitrary", dtype=object)
    out[dec] = "decreasing"
    out[inc] = "increasing"
    out[con] = "constant"  # constant wins over increasing/decreasing
    return out


@dataclasses.dataclass(frozen=True)
class Problem:
    """A Minimal Cost FL Schedule instance.

    Attributes:
      T: number of tasks to schedule.
      lower: ``(n,)`` int array of lower limits ``L_i``.
      upper: ``(n,)`` int array of upper limits ``U_i``.
      cost_tables: list of ``(U_i + 1,)`` float arrays; ``cost_tables[i][j]``
        is ``C_i(j)``. Values for ``j < L_i`` exist but are never selected.
    """

    T: int
    lower: np.ndarray
    upper: np.ndarray
    cost_tables: tuple

    def __post_init__(self):
        object.__setattr__(self, "lower", np.asarray(self.lower, dtype=np.int64))
        object.__setattr__(self, "upper", np.asarray(self.upper, dtype=np.int64))
        object.__setattr__(
            self,
            "cost_tables",
            tuple(np.asarray(c, dtype=np.float64) for c in self.cost_tables),
        )

    @property
    def n(self) -> int:
        return len(self.cost_tables)

    def cost(self, i: int, j: int) -> float:
        return float(self.cost_tables[i][j])

    def validate(self) -> None:
        """Checks the instance is valid & non-trivial (paper Section 3)."""
        if self.n == 0:
            raise ValueError("need at least one resource")
        if len(self.lower) != self.n or len(self.upper) != self.n:
            raise ValueError("limits and cost tables disagree on n")
        if np.any(self.lower < 0):
            raise ValueError("lower limits must be non-negative")
        if np.any(self.upper < self.lower):
            raise ValueError("upper limit below lower limit")
        for i, tbl in enumerate(self.cost_tables):
            if len(tbl) != self.upper[i] + 1:
                raise ValueError(
                    f"cost table {i} has {len(tbl)} entries, expected U_i+1="
                    f"{self.upper[i] + 1}"
                )
        if not (int(self.lower.sum()) <= self.T <= int(self.upper.sum())):
            raise ValueError(
                f"T={self.T} outside feasible range "
                f"[{int(self.lower.sum())}, {int(self.upper.sum())}]"
            )

    # ---- constructors -------------------------------------------------

    @staticmethod
    def from_functions(
        T: int,
        lower: Sequence[int],
        upper: Sequence[int],
        fns: Sequence[Callable[[int], float]],
    ) -> "Problem":
        """Tabulates callables ``C_i`` over ``[0, U_i]``."""
        tables = [
            np.array([float(f(j)) for j in range(int(u) + 1)]) for f, u in zip(fns, upper)
        ]
        return Problem(T=T, lower=np.asarray(lower), upper=np.asarray(upper), cost_tables=tuple(tables))

    def marginal_costs(self, i: int) -> np.ndarray:
        """Marginal cost function M_i over [L_i, U_i] (paper eq. 6).

        ``M_i(L_i) = 0`` by definition; ``M_i(j) = C_i(j) - C_i(j-1)``.
        Returned array is indexed by absolute j in ``[0, U_i]`` with entries
        below ``L_i`` set to 0 (never used).
        """
        tbl = self.cost_tables[i]
        m = np.zeros_like(tbl)
        lo = int(self.lower[i])
        if lo + 1 <= int(self.upper[i]):
            m[lo + 1 :] = tbl[lo + 1 :] - tbl[lo:-1]
        return m

    def regime(self, atol: float = 1e-9) -> str:
        """Classifies marginal-cost behaviour: 'increasing' | 'constant' |
        'decreasing' | 'arbitrary' (paper Definition 3). Delegates to the
        vectorized :func:`classify_regimes` — the same code the batched
        dispatch runs, so serial and batched regime detection agree by
        construction."""
        W = int(self.upper.max()) + 1
        costs = np.full((1, self.n, W), PACK_BIG, dtype=np.float64)
        for i, tbl in enumerate(self.cost_tables):
            costs[0, i, : len(tbl)] = tbl
        return str(classify_regimes(costs, self.lower[None], self.upper[None], atol)[0])


@dataclasses.dataclass(frozen=True)
class ProblemBatch:
    """A stack of ``B`` Minimal Cost FL Schedule instances in one dense,
    batch-first representation (DESIGN.md §9).

    Ragged instances are padded to common ``n`` (resource axis) and ``W``
    (cost-table width, ``max_i U_i + 1``):

      * padded *resources* get ``L = U = 0`` and cost table ``[0, BIG, ...]``
        so the DP assigns them exactly 0 tasks at 0 cost;
      * padded *table entries* beyond each ``U_i`` are ``BIG`` so those item
        sizes are never selected.

    Attributes:
      T: ``(B,)`` int array of per-instance workloads.
      lower: ``(B, n)`` int array of lower limits.
      upper: ``(B, n)`` int array of upper limits.
      costs: ``(B, n, W)`` float array; ``costs[b, i, j] = C_i(j)`` for
        instance ``b``, ``BIG``-padded beyond ``U_i``.
    """

    T: np.ndarray
    lower: np.ndarray
    upper: np.ndarray
    costs: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "T", np.asarray(self.T, dtype=np.int64))
        object.__setattr__(self, "lower", np.asarray(self.lower, dtype=np.int64))
        object.__setattr__(self, "upper", np.asarray(self.upper, dtype=np.int64))
        object.__setattr__(self, "costs", np.asarray(self.costs, dtype=np.float64))
        if self.costs.ndim != 3:
            raise ValueError(f"costs must be (B, n, W), got {self.costs.shape}")
        B, n, W = self.costs.shape
        if self.T.shape != (B,) or self.lower.shape != (B, n) or self.upper.shape != (B, n):
            raise ValueError("T/lower/upper shapes disagree with costs")
        if W < int(self.upper.max()) + 1:
            raise ValueError("cost tables narrower than max upper limit + 1")

    @property
    def B(self) -> int:
        return self.costs.shape[0]

    @property
    def n(self) -> int:
        return self.costs.shape[1]

    @property
    def W(self) -> int:
        return self.costs.shape[2]

    @staticmethod
    def from_problems(problems: Sequence["Problem"]) -> "ProblemBatch":
        """Stacks (possibly ragged) instances; each is validated first."""
        if not problems:
            raise ValueError("need at least one problem")
        for p in problems:
            p.validate()
        B = len(problems)
        n = max(p.n for p in problems)
        W = max(int(p.upper.max()) for p in problems) + 1
        T = np.array([p.T for p in problems], dtype=np.int64)
        lower = np.zeros((B, n), dtype=np.int64)
        upper = np.zeros((B, n), dtype=np.int64)
        costs = np.full((B, n, W), PACK_BIG, dtype=np.float64)
        costs[:, :, 0] = 0.0  # padded resources: only x=0, at zero cost
        for b, p in enumerate(problems):
            lower[b, : p.n] = p.lower
            upper[b, : p.n] = p.upper
            for i, tbl in enumerate(p.cost_tables):
                costs[b, i, : len(tbl)] = tbl
                costs[b, i, len(tbl) :] = PACK_BIG
        return ProblemBatch(T=T, lower=lower, upper=upper, costs=costs)

    def pad_to(self, B=None, n=None, W=None) -> "ProblemBatch":
        """Embeds the batch in a larger ``(B, n, W)`` envelope (sweep-engine
        shape bucketing, DESIGN.md §10).

        Phantom instances get ``T = 0`` with all-phantom resources; phantom
        resources get ``L = U = 0`` and cost table ``[0, BIG, ...]``; extra
        table entries are BIG. All padding is therefore inert: the DP assigns
        phantoms exactly 0 tasks at 0 cost and real rows/columns solve
        bit-identically to the unpadded batch (argmin ties resolve to the
        same ``j`` because BIG candidates never win and all-BIG ties pick
        ``j = 0`` with or without padding).
        """
        B2 = self.B if B is None else int(B)
        n2 = self.n if n is None else int(n)
        W2 = self.W if W is None else int(W)
        if (B2, n2, W2) == (self.B, self.n, self.W):
            return self
        if B2 < self.B or n2 < self.n or W2 < self.W:
            raise ValueError(
                f"pad_to target ({B2}, {n2}, {W2}) smaller than batch "
                f"({self.B}, {self.n}, {self.W})"
            )
        T = np.zeros(B2, dtype=np.int64)
        T[: self.B] = self.T
        lower = np.zeros((B2, n2), dtype=np.int64)
        lower[: self.B, : self.n] = self.lower
        upper = np.zeros((B2, n2), dtype=np.int64)
        upper[: self.B, : self.n] = self.upper
        costs = np.full((B2, n2, W2), PACK_BIG, dtype=np.float64)
        costs[:, :, 0] = 0.0  # phantoms: only x=0, at zero cost
        costs[: self.B, : self.n, : self.W] = self.costs
        return ProblemBatch(T=T, lower=lower, upper=upper, costs=costs)

    def regimes(self, atol: float = 1e-9) -> np.ndarray:
        """Per-instance marginal-cost regimes, ``(B,)`` strings — the batched
        counterpart of :meth:`Problem.regime` (same :func:`classify_regimes`
        core, so ``batch.regimes()[b] == batch.instance(b).regime()``)."""
        return classify_regimes(self.costs, self.lower, self.upper, atol)

    def instance(self, b: int) -> "Problem":
        """Materializes instance ``b`` as a standalone :class:`Problem`
        (padded resources are kept, as 0-task-only classes)."""
        tables = tuple(
            self.costs[b, i, : int(self.upper[b, i]) + 1] for i in range(self.n)
        )
        return Problem(T=int(self.T[b]), lower=self.lower[b], upper=self.upper[b], cost_tables=tables)

    def validate(self) -> None:
        if np.any(self.lower < 0):
            raise ValueError("lower limits must be non-negative")
        if np.any(self.upper < self.lower):
            raise ValueError("upper limit below lower limit")
        lo_sum = self.lower.sum(axis=1)
        up_sum = self.upper.sum(axis=1)
        if np.any(self.T < lo_sum) or np.any(self.T > up_sum):
            bad = np.nonzero((self.T < lo_sum) | (self.T > up_sum))[0]
            raise ValueError(f"instances {bad.tolist()} have T outside the feasible range")


Schedule = np.ndarray  # (n,) int array of assignments x_i


def total_cost(problem: Problem, x: Schedule) -> float:
    return float(sum(problem.cost(i, int(x[i])) for i in range(problem.n)))


def validate_schedule(problem: Problem, x: Schedule) -> None:
    x = np.asarray(x)
    if x.shape != (problem.n,):
        raise ValueError(f"schedule shape {x.shape} != ({problem.n},)")
    if int(x.sum()) != problem.T:
        raise ValueError(f"schedule assigns {int(x.sum())} tasks, T={problem.T}")
    if np.any(x < problem.lower) or np.any(x > problem.upper):
        raise ValueError("schedule violates limits")


def total_cost_batch(batch: ProblemBatch, X: np.ndarray) -> np.ndarray:
    """(B,) total cost of each row of ``X`` ((B, n) assignments) under its
    instance's packed cost tables."""
    X = np.asarray(X, dtype=np.int64)
    picked = np.take_along_axis(batch.costs, X[:, :, None], axis=2)[:, :, 0]
    return picked.sum(axis=1)


def validate_schedule_batch(batch: ProblemBatch, X: np.ndarray) -> None:
    X = np.asarray(X)
    if X.shape != (batch.B, batch.n):
        raise ValueError(f"schedule shape {X.shape} != ({batch.B}, {batch.n})")
    if np.any(X.sum(axis=1) != batch.T):
        bad = np.nonzero(X.sum(axis=1) != batch.T)[0]
        raise ValueError(f"instances {bad.tolist()}: task totals != T")
    if np.any(X < batch.lower) or np.any(X > batch.upper):
        raise ValueError("batched schedule violates limits")


def from_reference(obj):
    """A port :class:`Problem` or :class:`ProblemBatch` holding the same
    instance as ``obj``, which may come from any package with the same
    fields (duck-typed, so this module never imports the other package).

    An object with ``.cost_tables`` becomes a :class:`Problem`; one with
    ``.costs`` becomes a :class:`ProblemBatch`. Arrays are copied as
    float64 costs and int64 limits.
    """
    if hasattr(obj, "cost_tables"):
        return Problem(
            T=int(obj.T),
            lower=np.array(obj.lower, dtype=np.int64),
            upper=np.array(obj.upper, dtype=np.int64),
            cost_tables=tuple(np.array(c, dtype=np.float64) for c in obj.cost_tables),
        )
    if hasattr(obj, "costs"):
        return ProblemBatch(
            T=np.array(obj.T, dtype=np.int64),
            lower=np.array(obj.lower, dtype=np.int64),
            upper=np.array(obj.upper, dtype=np.int64),
            costs=np.array(obj.costs, dtype=np.float64),
        )
    raise TypeError(f"{type(obj).__name__} has neither .cost_tables nor .costs")


def remove_lower_limits(problem):
    """Equivalent instance(s) with all lower limits shifted to zero.

    Paper Section 5.2, eqs. (8)-(10):
      T' = T - sum L_i;  U'_i = U_i - L_i;  C'_i(j) = C_i(j + L_i) - C_i(L_i).

    Accepts a :class:`Problem` or a :class:`ProblemBatch` (the shift is
    applied per instance, vectorized over the whole batch).
    """
    if isinstance(problem, ProblemBatch):
        return _remove_lower_limits_batch(problem)
    Tp = problem.T - int(problem.lower.sum())
    upper = problem.upper - problem.lower
    tables = tuple(
        tbl[int(lo) :] - tbl[int(lo)]
        for tbl, lo in zip(problem.cost_tables, problem.lower)
    )
    return Problem(T=Tp, lower=np.zeros(problem.n, dtype=np.int64), upper=upper, cost_tables=tables)


def _remove_lower_limits_batch(batch: ProblemBatch) -> ProblemBatch:
    """Vectorized eqs. (8)-(10) over a ``(B, n, W)`` stack: each cost row is
    left-shifted by its ``L`` and rebased to ``C(L) = 0``; vacated tail
    entries become BIG."""
    B, n, W = batch.costs.shape
    Tp = batch.T - batch.lower.sum(axis=1)
    upper = batch.upper - batch.lower
    j = np.arange(W)[None, None, :]  # (1, 1, W)
    src = j + batch.lower[:, :, None]  # (B, n, W) source index C(j + L)
    valid = src <= batch.upper[:, :, None]
    base = np.take_along_axis(batch.costs, batch.lower[:, :, None], axis=2)  # C(L)
    shifted = np.take_along_axis(batch.costs, np.minimum(src, W - 1), axis=2) - base
    costs = np.where(valid, shifted, PACK_BIG)
    return ProblemBatch(T=Tp, lower=np.zeros((B, n), dtype=np.int64), upper=upper, costs=costs)


def restore_lower_limits(problem, x_prime):
    """Paper eq. (11): x_i = x'_i + L_i. Batch-aware: with a
    :class:`ProblemBatch` and ``(B, n)`` assignments, adds each instance's
    lower limits row-wise."""
    return np.asarray(x_prime) + problem.lower
