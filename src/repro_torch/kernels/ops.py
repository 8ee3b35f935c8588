"""Public entry points for the kernels package: per-device dispatch.

``minplus_step(kprev, cost, backend=...)`` / ``minplus_step_batch`` select
the min-plus implementation. ``backend="auto"`` resolves by the device of the
tensor it is given:

  device | backend     | implementation
  -------|-------------|---------------------------------------------------
  cuda   | ``cuda``    | hand-written Hopper kernel (`kernels/minplus.py`,
         |             | `kernels/csrc/minplus.cu`)
  cpu    | ``blocked`` | tiled PyTorch (`kernels/blocked.py`), bounded memory

Any other device raises. ``backend="ref"`` is the dense oracle every backend
is held against.
"""

from __future__ import annotations

import torch

from .blocked import minplus_blocked_batch
from .minplus import minplus_cuda_batch
from .ref import BIG, minplus_step_ref_batch

__all__ = [
    "minplus_step",
    "minplus_step_batch",
    "resolve_backend",
    "DISPATCH_TABLE",
    "BACKENDS",
    "BIG",
]

# torch device type -> kernel backend
DISPATCH_TABLE = {"cuda": "cuda", "cpu": "blocked"}

BACKENDS = ("ref", "blocked", "cuda")


def resolve_backend(backend: str | None, device) -> str:
    """Concrete backend name for ``backend`` on ``device`` (``None``/"auto"
    dispatch by the device's type)."""
    if backend is None or backend == "auto":
        kind = torch.device(device).type
        if kind not in DISPATCH_TABLE:
            raise ValueError(f"no min-plus backend for device {device!r}; devices: {tuple(DISPATCH_TABLE)}")
        return DISPATCH_TABLE[kind]
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: auto, {BACKENDS}")
    return backend


def minplus_step_batch(
    kprev: torch.Tensor,
    cost: torch.Tensor,
    backend: str = "auto",
    *,
    out: torch.Tensor | None = None,
    iout: torch.Tensor | None = None,
):
    """Batched row update: ``kprev (B, T+1)``, ``cost (B, W)``. With
    ``out``/``iout`` the results are written there (the CUDA kernel writes
    them directly; the other backends copy)."""
    backend = resolve_backend(backend, kprev.device)
    if backend == "cuda":
        return minplus_cuda_batch(kprev, cost, out=out, iout=iout)
    if backend == "ref":
        kout, idx = minplus_step_ref_batch(kprev, cost)
    else:
        kout, idx = minplus_blocked_batch(kprev, cost)
    if out is not None:
        kout = out.copy_(kout)
    if iout is not None:
        idx = iout.copy_(idx)
    return kout, idx


def minplus_step(kprev: torch.Tensor, cost: torch.Tensor, backend: str = "auto"):
    """One DP row update: ``kprev (T+1,)``, ``cost (W,)``."""
    kout, iout = minplus_step_batch(kprev[None], cost[None], backend=backend)
    return kout[0], iout[0]
