"""PyTorch/CUDA port of the minimal-energy FL scheduling package ``repro``.

Laid out module for module like ``repro``; it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``. Importing the package builds no
kernel: ``kernels/csrc/*.cu`` are compiled by ``nvcc`` at their first launch.

The public facade grows toward the JAX package's slice by slice: the
:class:`Solver` verbs, their result types and the resilience policy types
are here; the fleet, serving and FL-runtime names come with their slices.
"""

from .core import (
    CircuitBreaker,
    ParetoFrontier,
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

__all__ = [
    "CircuitBreaker",
    "ParetoFrontier",
    "Problem",
    "ProblemBatch",
    "RetryPolicy",
    "Solution",
    "SolutionBatch",
    "Solver",
    "TransientEngineError",
    "solve_schedule_dp_batch",
    "solve_schedule_dp_torch",
]
