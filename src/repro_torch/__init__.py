"""PyTorch/CUDA port of the minimal-energy FL scheduling package ``repro``.

Laid out module for module like ``repro``; it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``. Importing the package builds no
kernel: ``kernels/csrc/*.cu`` are compiled by ``nvcc`` at their first launch.

The public facade grows toward the JAX package's slice by slice: the
:class:`Solver` verbs, their result types, the resilience policy types, the
fleet solve, the scheduling service and the fault injection are here; the
drift names come with the FL runtime's slice.
"""

from .core import (
    CircuitBreaker,
    FleetSolution,
    ParetoFrontier,
    PlanPolicy,
    Problem,
    ProblemBatch,
    RetryPolicy,
    Solution,
    SolutionBatch,
    Solver,
    TransientEngineError,
    solve_schedule_dp_batch,
    solve_schedule_dp_torch,
)
from .fl import FaultInjector, FaultPlan
from .serve import SchedulerService

__all__ = [
    "CircuitBreaker",
    "FaultInjector",
    "FaultPlan",
    "FleetSolution",
    "ParetoFrontier",
    "PlanPolicy",
    "Problem",
    "ProblemBatch",
    "RetryPolicy",
    "SchedulerService",
    "Solution",
    "SolutionBatch",
    "Solver",
    "TransientEngineError",
    "solve_schedule_dp_batch",
    "solve_schedule_dp_torch",
]
