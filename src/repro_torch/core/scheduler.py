"""Regime detection + algorithm dispatch (the facade's solve internals).

Table 2 of the paper maps each marginal-cost regime to its lowest-complexity
optimal algorithm:

  regime      | no binding upper limits | with upper limits
  ------------|-------------------------|-------------------
  increasing  | MarIn                   | MarIn
  constant    | MarDecUn*               | MarCo
  decreasing  | MarDecUn                | MarDec
  arbitrary   | (MC)^2MKP DP            | (MC)^2MKP DP

(*constant marginals without upper limits: MarDecUn's Θ(n) single-resource
assignment is optimal there too, per Table 2.)

The supported entrypoint is the :class:`repro_torch.core.solver.Solver`
facade — ``solve`` / ``sweep`` / ``frontier`` — which calls the private
``_schedule`` / ``_schedule_batch`` / ``_deadline_sweep`` implementations
here. The old module-level names (``schedule``, ``schedule_batch``,
``schedule_with_deadline``, ``deadline_sweep``) remain as bit-identical
deprecated shims. Every batch solve routes through the
:class:`~repro_torch.core.sweep.SweepEngine` plan cache, and the
single-instance path delegates to the per-algorithm callables in
``ALGORITHMS``.

The DP names translate those of the JAX package: ``"dp_torch"`` for
``"dp_jax"`` and ``"dp_torch_cuda"`` (which forces the kernel backend
``"cuda"``) for ``"dp_jax_pallas"``. Solves that run on a device take
``device`` (``"cuda"`` by default, which raises without a card).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np

from . import baselines
from ._deprecation import warn_deprecated
from .marginal import marco, mardec, mardecun, marin
from .marginal_torch import select_algorithm_batch
from .mc2mkp import solve_schedule_dp
from .problem import Problem, validate_schedule
from .sweep import _solve_cached
from .torch_dp import solve_schedule_dp_torch

__all__ = [
    "schedule",
    "schedule_batch",
    "deadline_sweep",
    "ALGORITHMS",
    "select_algorithm",
    "select_algorithm_batch",
]

# algorithm names that run the (MC)^2MKP DP — in the batched entry point all
# of these route through the one batched min-plus plan
_DP_ALGORITHMS = {"dp", "dp_torch", "dp_batch", "dp_torch_cuda"}
# single-instance algorithms that run on a device, and so take ``device``
_DEVICE_ALGORITHMS = {"dp_torch", "dp_torch_cuda"}

ALGORITHMS: Dict[str, Callable] = {
    "dp": solve_schedule_dp,
    "dp_torch": solve_schedule_dp_torch,
    "dp_torch_cuda": functools.partial(solve_schedule_dp_torch, backend="cuda"),
    "marin": marin,
    "marco": marco,
    "mardecun": mardecun,
    "mardec": mardec,
    # baselines (not total-cost-optimal in general; for comparison)
    "olar": baselines.olar,
    "uniform": baselines.uniform,
    "proportional": baselines.proportional,
    "greedy_marginal": baselines.greedy_marginal,
}


def select_algorithm(problem: Problem) -> str:
    """Lowest-complexity optimal algorithm for ``problem``'s regime (paper
    Table 2). The ``B = 1`` slice of
    :func:`~repro_torch.core.marginal_torch.select_algorithm_batch` — one
    shared regime-detection + dispatch rule, so serial and batched "auto"
    can never disagree."""
    return select_algorithm_batch([problem])[0]


# ---------------------------------------------------------------------------
# private implementations — the Solver facade's solve internals. The public
# module-level names below are deprecated warn-once shims over these; keeping
# one body per behavior is what makes the shims bit-identical by construction.
# ---------------------------------------------------------------------------


def _schedule(problem: Problem, algorithm: str = "auto", check: bool = True, device="cuda"):
    """Single-instance solve; returns ``(x, resolved_algorithm)`` so the
    facade can report which Table-2 algorithm "auto" picked."""
    if algorithm == "auto":
        algorithm = select_algorithm(problem)
    try:
        fn = ALGORITHMS[algorithm]
    except KeyError:
        raise ValueError(f"unknown algorithm {algorithm!r}; options: auto, {sorted(ALGORITHMS)}")
    x = fn(problem, device=device) if algorithm in _DEVICE_ALGORITHMS else fn(problem)
    if check:
        validate_schedule(problem, x)
    return x, algorithm


def _schedule_batch(
    problems,
    algorithm: str = "auto",
    check: bool = True,
    backend=None,
    engine=None,
    device="cuda",
):
    """Batched solve: every DP-shaped solve goes through the sweep engine's
    shape-bucketed plan cache; "auto" takes the regime-split path. Returns
    a list of ``(n_b,)`` int64 schedules."""
    problems = list(problems)
    if not problems:
        return []
    out = [None] * len(problems)
    dp_idx = []
    if algorithm == "auto":
        X = _solve_cached(problems, backend, engine, True, device)
        for b, p in enumerate(problems):
            out[b] = np.asarray(X[b, : p.n], dtype=np.int64)
    elif algorithm in _DP_ALGORITHMS:
        dp_idx = list(range(len(problems)))
        if algorithm == "dp_torch_cuda":
            backend = "cuda"
    else:
        for b, p in enumerate(problems):
            out[b] = _schedule(p, algorithm, check=False, device=device)[0]
    if dp_idx:
        X = _solve_cached([problems[b] for b in dp_idx], backend, engine, False, device)
        for row, b in zip(X, dp_idx):
            out[b] = np.asarray(row[: problems[b].n], dtype=np.int64)
    if check:
        for p, x in zip(problems, out):
            validate_schedule(p, x)
    return out


def _schedule_with_deadline(
    problem: Problem,
    time_tables,
    deadline: float,
    algorithm: str = "auto",
    device="cuda",
) -> np.ndarray:
    """ε-constraint single solve: tighten, then :func:`_schedule`."""
    return _schedule(tighten_for_deadline(problem, time_tables, deadline), algorithm, device=device)[0]


def _deadline_sweep(
    problem: Problem,
    time_tables,
    deadlines,
    check: bool = True,
    backend=None,
    engine=None,
    device="cuda",
) -> np.ndarray:
    """Whole deadline grid in ONE batched DP solve; ``(B, n)`` int64, row
    ``b`` optimal for ``deadlines[b]``. Infeasible points raise ValueError
    naming the offending deadline."""
    deadlines = list(deadlines)
    tight = []
    for d in deadlines:
        try:
            tight.append(tighten_for_deadline(problem, time_tables, float(d)))
        except ValueError as e:
            raise ValueError(f"deadline_sweep point {d}: {e}") from e
    X = _solve_cached(tight, backend, engine, False, device)[:, : problem.n]
    if check:
        for p, x in zip(tight, X):
            validate_schedule(p, x)
    return X.astype(np.int64)


# ---------------------------------------------------------------------------
# deprecated shims — use repro_torch.core.solver.Solver
# ---------------------------------------------------------------------------


def schedule(problem: Problem, algorithm: str = "auto", check: bool = True, device="cuda") -> np.ndarray:
    """Deprecated shim: use ``Solver().solve(problem)`` (`.schedule` on the
    returned :class:`~repro_torch.core.solver.Solution`). Bit-identical —
    same regime dispatch, same per-algorithm callables."""
    warn_deprecated("schedule", "Solver().solve(problem).schedule")
    return _schedule(problem, algorithm, check, device)[0]


def schedule_batch(
    problems,
    algorithm: str = "auto",
    check: bool = True,
    backend=None,
    engine=None,
    device="cuda",
):
    """Deprecated shim: use ``Solver(engine=...).solve(problems)``
    (`.schedules` on the returned :class:`~repro_torch.core.solver.SolutionBatch`).

    Dispatch (unchanged, documented on the facade):
      * ``algorithm="auto"``: the engine's regime-split path — each
        instance's regime picks its algorithm (one shared rule with the
        serial dispatch), MarIn/MarCo instances ride the batched marginal
        selection, MarDecUn/MarDec solve on the host, and only the
        arbitrary-regime remainder pays the batched DP; results come back in
        original problem order.
      * any DP algorithm name (``dp``, ``dp_torch``, ``dp_batch``,
        ``dp_torch_cuda``): ALL instances go through the batched DP
        (``dp_torch_cuda`` selects the CUDA kernel backend).
      * any other named algorithm: a plain per-instance loop.

    ``engine``: an explicit :class:`~repro_torch.core.sweep.SweepEngine`;
    ``None`` uses the process-wide default for ``backend`` on ``device``.
    Requesting a backend that contradicts the given engine's raises
    ValueError. Returns a list of ``(n_b,)`` int64 schedules.
    """
    warn_deprecated("schedule_batch", "Solver(engine=...).solve(problems).schedules")
    return _schedule_batch(problems, algorithm, check, backend, engine, device)


def schedule_with_deadline(
    problem: Problem,
    time_tables,
    deadline: float,
    algorithm: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Deprecated shim: use ``Solver().solve(problem, deadline=D,
    time_tables=tt)``.

    Energy-minimal schedule subject to a round deadline (beyond-paper). The
    ε-constraint reduces cleanly to the SAME problem: a deadline on each
    device's computation time is just a tighter upper limit
    ``U_i' = max{j : time_i(j) <= deadline}`` — feasible sets stay
    intervals, so every optimal algorithm applies unchanged
    (:func:`tighten_for_deadline`). Raises ValueError if the deadline makes
    the instance infeasible.

    Args:
      time_tables: list of (U_i+1,) arrays; time_tables[i][j] = seconds for
        device i to train j batches (monotone non-decreasing).
      deadline: maximum allowed per-device time (the target round duration).
    """
    warn_deprecated(
        "schedule_with_deadline", "Solver().solve(problem, deadline=D, time_tables=tt)"
    )
    return _schedule_with_deadline(problem, time_tables, deadline, algorithm, device)


def tighten_for_deadline(problem: Problem, time_tables, deadline: float) -> Problem:
    """The deadline-tightened instance: ``U_i' = max{j : time_i(j) <= D}``
    (clipped to ``U_i``). Raises ValueError if infeasible — a device cannot
    meet its lower limit, or fleet capacity drops below ``T``.

    NOT deprecated: this is the ε-constraint reduction itself, shared by the
    facade's ``sweep``/``frontier`` paths and ``repro_torch.core.pareto``."""
    new_upper = []
    for i in range(problem.n):
        t = np.asarray(time_tables[i], dtype=np.float64)
        feas = np.nonzero(t <= deadline)[0]
        u = int(feas.max()) if len(feas) else -1
        if u < int(problem.lower[i]):
            raise ValueError(
                f"deadline {deadline} infeasible: device {i} cannot do its "
                f"lower limit {int(problem.lower[i])} batches in time"
            )
        new_upper.append(min(u, int(problem.upper[i])))
    if sum(new_upper) < problem.T:
        raise ValueError(
            f"deadline {deadline} infeasible: fleet capacity "
            f"{sum(new_upper)} < T={problem.T}"
        )
    return Problem(
        T=problem.T,
        lower=problem.lower,
        upper=np.asarray(new_upper),
        cost_tables=tuple(
            tbl[: u + 1] for tbl, u in zip(problem.cost_tables, new_upper)
        ),
    )


def deadline_sweep(
    problem: Problem,
    time_tables,
    deadlines,
    check: bool = True,
    backend=None,
    engine=None,
    device="cuda",
) -> np.ndarray:
    """Deprecated shim: use ``Solver(engine=...).sweep(problem, tt,
    deadlines)`` — or :meth:`~repro_torch.core.solver.Solver.frontier` for
    the pruned Pareto set.

    Energy-minimal schedules for a whole grid of deadlines in ONE batched DP
    solve: the ``B`` deadline-tightened instances (same ``n`` and ``T``,
    progressively looser ``U_i``) stack through the sweep engine, so the
    entire ε-constraint sweep is one plan run — and, once its shape bucket
    is warm, one graph replay on the card. Returns a ``(B, n)`` int64 array,
    row ``b`` optimal for ``deadlines[b]``; raises ValueError (naming the
    offending deadline) if any point is infeasible.
    """
    warn_deprecated("deadline_sweep", "Solver(engine=...).sweep(problem, tt, deadlines)")
    return _deadline_sweep(problem, time_tables, deadlines, check, backend, engine, device)
