"""Core library: the scheduling problem (paper Def. 1), its (MC)^2MKP dynamic
program on the host in float64 (Alg. 1) and on the device in float32, and the
cost-function families used to build instances."""

from .costs import (
    DEVICE_CLASSES,
    device_fleet_problem,
    linear_cost,
    measured_cost,
    random_problem,
    sublinear_cost,
    superlinear_cost,
)
from .mc2mkp import brute_force_schedule, solve_schedule_dp
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
from .torch_dp import (
    solve_fused_batch_torch,
    solve_schedule_dp_batch,
    solve_schedule_dp_torch,
)

__all__ = [
    "DEVICE_CLASSES",
    "Problem",
    "ProblemBatch",
    "brute_force_schedule",
    "classify_regimes",
    "device_fleet_problem",
    "from_reference",
    "linear_cost",
    "measured_cost",
    "random_problem",
    "remove_lower_limits",
    "restore_lower_limits",
    "solve_fused_batch_torch",
    "solve_schedule_dp",
    "solve_schedule_dp_batch",
    "solve_schedule_dp_torch",
    "sublinear_cost",
    "superlinear_cost",
    "total_cost",
    "total_cost_batch",
    "validate_schedule",
    "validate_schedule_batch",
]
