"""Core library: the paper's contribution.

Minimal Cost FL Schedule problem (Def. 1), the (MC)^2MKP knapsack problem and
its DP solution (Alg. 1) on the host in float64 and on the device in float32,
the monotone-regime algorithms MarIn/MarCo/MarDecUn/MarDec (Algs. 2-7) and
their batched forms, cost-function families, baselines, the shape-bucketed
sweep engine and the Pareto frontiers.

The supported solve entrypoint is the :class:`Solver` facade:
``Solver().solve(...)`` / ``.sweep(...)`` / ``.frontier(...)``. The legacy
module-level entrypoints (``schedule``, ``schedule_batch``,
``schedule_with_deadline``, ``deadline_sweep``, ``solve_dp_batch_cached``,
``solve_schedule_batch_cached``) remain as bit-identical deprecated shims.
"""

from .baselines import greedy_marginal, olar, proportional, random_schedule, uniform
from .costs import (
    DEVICE_CLASSES,
    JOULES_PER_KWH,
    CostWindows,
    carbon_cost_table,
    device_fleet_problem,
    linear_cost,
    measured_cost,
    random_problem,
    sublinear_cost,
    superlinear_cost,
)
from .marginal import marco, mardec, mardecun, marin
from .marginal_torch import (
    marco_batch,
    mardec_batch,
    mardecun_batch,
    marin_batch,
    select_algorithm_batch,
)
from .mc2mkp import (
    ItemClass,
    MC2MKPSolution,
    brute_force_schedule,
    mc2mkp_matrices,
    solve_mc2mkp,
    solve_schedule_dp,
)
from .pareto import (
    ParetoFrontier,
    ParetoPoint,
    candidate_deadlines,
    deadline_grid,
    feasible_deadline_range,
    frontier_by_window,
    pareto_frontier,
)
from .problem import (
    Problem,
    ProblemBatch,
    classify_regimes,
    from_reference,
    remove_lower_limits,
    restore_lower_limits,
    total_cost,
    total_cost_batch,
    validate_schedule,
    validate_schedule_batch,
)
from .resilience import (
    CircuitBreaker,
    RetryPolicy,
    TransientEngineError,
    is_transient,
    retry_call,
)
from .scheduler import (
    ALGORITHMS,
    deadline_sweep,
    schedule,
    schedule_batch,
    schedule_with_deadline,
    select_algorithm,
    tighten_for_deadline,
)
from .solver import Solution, SolutionBatch, Solver
from .sweep import (
    SweepEngine,
    bucket_shape,
    default_engine,
    make_sweep_mesh,
    solve_dp_batch_cached,
    solve_schedule_batch_cached,
)
from .torch_dp import (
    solve_fused_batch_ring,
    solve_fused_batch_torch,
    solve_schedule_dp_batch,
    solve_schedule_dp_torch,
)

__all__ = [
    "ALGORITHMS",
    "CircuitBreaker",
    "CostWindows",
    "DEVICE_CLASSES",
    "ItemClass",
    "JOULES_PER_KWH",
    "MC2MKPSolution",
    "ParetoFrontier",
    "ParetoPoint",
    "Problem",
    "ProblemBatch",
    "RetryPolicy",
    "Solution",
    "SolutionBatch",
    "Solver",
    "SweepEngine",
    "TransientEngineError",
    "brute_force_schedule",
    "bucket_shape",
    "candidate_deadlines",
    "carbon_cost_table",
    "classify_regimes",
    "deadline_grid",
    "deadline_sweep",
    "default_engine",
    "device_fleet_problem",
    "feasible_deadline_range",
    "from_reference",
    "frontier_by_window",
    "greedy_marginal",
    "is_transient",
    "linear_cost",
    "make_sweep_mesh",
    "marco",
    "marco_batch",
    "mardec",
    "mardec_batch",
    "mardecun",
    "mardecun_batch",
    "marin",
    "marin_batch",
    "mc2mkp_matrices",
    "measured_cost",
    "olar",
    "pareto_frontier",
    "proportional",
    "random_problem",
    "random_schedule",
    "remove_lower_limits",
    "restore_lower_limits",
    "retry_call",
    "schedule",
    "schedule_batch",
    "schedule_with_deadline",
    "select_algorithm",
    "select_algorithm_batch",
    "solve_dp_batch_cached",
    "solve_fused_batch_ring",
    "solve_fused_batch_torch",
    "solve_mc2mkp",
    "solve_schedule_batch_cached",
    "solve_schedule_dp",
    "solve_schedule_dp_batch",
    "solve_schedule_dp_torch",
    "sublinear_cost",
    "superlinear_cost",
    "tighten_for_deadline",
    "total_cost",
    "total_cost_batch",
    "uniform",
    "validate_schedule",
    "validate_schedule_batch",
]
