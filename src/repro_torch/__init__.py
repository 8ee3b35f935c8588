"""PyTorch/CUDA port of the minimal-energy FL scheduling package ``repro``.

Laid out module for module like ``repro``; it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``. Importing the package builds no
kernel: ``kernels/csrc/*.cu`` are compiled by ``nvcc`` at their first launch.

The public facade holds every name of the JAX package's: the
:class:`Solver` verbs, their result types, the resilience policy types, the
fleet solve, the scheduling service, the fault injection and the drift
injection of the FL runtime; and the two solver entry points of the port.
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
from .fl import DriftInjector, DriftPlan, FaultInjector, FaultPlan
from .serve import SchedulerService

__all__ = [
    "CircuitBreaker",
    "DriftInjector",
    "DriftPlan",
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
