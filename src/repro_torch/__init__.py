"""PyTorch/CUDA port of the minimal-energy FL scheduling package ``repro``.

Laid out module for module like ``repro``; it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``. Importing the package builds no
kernel: ``kernels/csrc/*.cu`` are compiled by ``nvcc`` at their first launch.
"""

from .core import Problem, ProblemBatch, solve_schedule_dp_batch, solve_schedule_dp_torch

__all__ = ["Problem", "ProblemBatch", "solve_schedule_dp_batch", "solve_schedule_dp_torch"]
