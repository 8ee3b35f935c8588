"""PyTorch implementation of the (MC)^2MKP dynamic program for scheduling
instances (contiguous classes), built on the min-plus row update.

The DP row update over classes is a Python loop of ``n`` steps; each step is
one banded min-plus convolution (``repro_torch.kernels``, ``backend="auto"``
dispatches by device) that writes its argmins straight into a preallocated
``(n, B, T+1)`` int32 slab. Backtracking walks that slab in reverse on the
same device. The fused solver (:func:`solve_fused_batch_torch`) returns only
the ``(B, n)`` schedules plus the final DP row ``K_last``, so nothing bigger
than the answer has to leave the device.

Inputs are the 0-lower-limit equivalent instance (Section 5.2) as dense
arrays: ``costs (n, W)`` padded with BIG beyond each ``U_i``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device they raise rather than run on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import BIG, minplus_step_batch
from .problem import (
    Problem,
    ProblemBatch,
    remove_lower_limits,
    restore_lower_limits,
)

__all__ = [
    "solve_schedule_dp_torch",
    "solve_schedule_dp_batch",
    "solve_fused_batch_torch",
    "dp_tables_batch",
    "pack_problem",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there
    (a run asked for the card never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def pack_problem(p0, device="cuda") -> torch.Tensor:
    """Dense BIG-padded float32 cost tensor for 0-lower-limit instance(s),
    on ``device``.

    A :class:`Problem` packs to ``(n, W)``; a :class:`ProblemBatch` packs to
    ``(B, n, W)``. Tables are saturated to BIG and downcast in numpy before
    they move, as the JAX package does. Entries beyond each ``U_i`` are BIG
    so those item sizes are never selected.
    """
    dev = resolve_device(device)
    if isinstance(p0, ProblemBatch):
        costs = np.minimum(p0.costs, float(BIG)).astype(np.float32)
    else:
        W = int(p0.upper.max()) + 1
        lens = p0.upper.astype(np.int64) + 1  # valid prefix per class: 0..U_i
        costs = np.full((p0.n, W), float(BIG), dtype=np.float32)
        mask = np.arange(W)[None, :] < lens[:, None]
        costs[mask] = np.concatenate(
            [np.asarray(t[:l], dtype=np.float32) for t, l in zip(p0.cost_tables, lens)]
        )
    return torch.from_numpy(costs).to(dev)


def _dp_scan_from(k0: torch.Tensor, costs: torch.Tensor, I: torch.Tensor, backend: str = "ref"):
    """Continues the class scan from the DP row ``k0 (B, T+1)`` over the
    classes in ``costs (B, n, W)``, writing step ``i``'s argmins into
    ``I[i]`` of the ``(n, B, T+1)`` int32 slab. ``k0`` is taken over as one
    half of the ping-pong pair of rows, so it is overwritten when ``n > 1``.
    Returns the final row."""
    n = costs.shape[1]
    by_class = costs.transpose(0, 1).contiguous()  # (n, B, W): each step's table contiguous
    rows = (k0, torch.empty_like(k0))
    for i in range(n):
        minplus_step_batch(rows[i % 2], by_class[i], backend=backend, out=rows[(i + 1) % 2], iout=I[i])
    return rows[n % 2]


def _dp_tables_batch(costs: torch.Tensor, T: int, backend: str = "ref"):
    """Scans the DP over classes for a whole batch: ``costs (B, n, W)`` ->
    ``(K_last (B, T+1), I (n, B, T+1) int32)``, both on ``costs``' device."""
    B, n, _ = costs.shape
    k0 = torch.full((B, T + 1), BIG, dtype=torch.float32, device=costs.device)
    k0[:, 0] = 0.0
    I = torch.empty((n, B, T + 1), dtype=torch.int32, device=costs.device)
    k_last = _dp_scan_from(k0, costs, I, backend=backend)
    return k_last, I


def dp_tables_batch(costs: torch.Tensor, T: int, backend: str = "auto"):
    """Public two-step form of the class scan: returns ``(K_last (B, T+1),
    I (n, B, T+1))``. Production solves use :func:`solve_fused_batch_torch`,
    which keeps ``I`` inside; this remains as the oracle the fused solver is
    held against."""
    return _dp_tables_batch(costs.to(torch.float32), int(T), backend=backend)


def _backtrack_batch(I: torch.Tensor, t_star: torch.Tensor) -> torch.Tensor:
    """Reverse walk: per instance, ``x_i = I[i, b, t_b]; t_b -= x_i``.
    Returns ``(B, n)`` int32 on ``I``'s device."""
    n, B, _ = I.shape
    X = torch.empty((B, n), dtype=torch.int32, device=I.device)
    t = t_star.to(device=I.device, dtype=torch.int64)  # gather wants int64 indices
    for i in range(n - 1, -1, -1):
        j = I[i].gather(1, t[:, None])[:, 0]
        X[:, i] = j
        t = t - j
    return X


def _solve_fused_batch(costs: torch.Tensor, t_star: torch.Tensor, T: int, backend: str = "ref"):
    k_last, I = _dp_tables_batch(costs, T, backend=backend)
    X = _backtrack_batch(I, t_star)
    return X, k_last


def solve_fused_batch_torch(costs: torch.Tensor, t_star, T: int, backend: str = "auto"):
    """Fused batched solver: class scan + reverse backtrack on ``costs``'
    device.

    Args:
      costs: ``(B, n, W)`` float32 packed tables (0-lower-limit instances).
      t_star: ``(B,)`` filled capacities to backtrack from.
      T: row width (max ``T'`` across the batch).

    Returns ``(X, K_last)``: ``(B, n)`` int32 schedules and the ``(B, T+1)``
    final DP row (``K_last[b, t]`` = minimal cost of assigning exactly ``t``
    units across instance ``b``). The ``(n, B, T+1)`` argmin slab is
    allocated, filled and read on the device and never returned.
    """
    t_star = torch.as_tensor(t_star, device=costs.device)
    return _solve_fused_batch(costs.to(torch.float32), t_star, int(T), backend=backend)


def solve_schedule_dp_torch(problem: Problem, backend: str = "auto", device="cuda") -> np.ndarray:
    """Optimal schedule of one instance (drop-in for
    :func:`repro_torch.core.mc2mkp.solve_schedule_dp`), solved on
    ``device``. Returns an ``(n,)`` int64 numpy schedule."""
    problem.validate()
    p0 = remove_lower_limits(problem)
    costs = pack_problem(p0, device)
    # Scheduling instances always fill the knapsack: T* == T.
    t_star = torch.tensor([p0.T], dtype=torch.int64, device=costs.device)
    X, _ = solve_fused_batch_torch(costs[None], t_star, int(p0.T), backend=backend)
    return restore_lower_limits(problem, X[0].cpu().numpy().astype(np.int64))


def solve_schedule_dp_batch(problems, backend: str = "auto", device="cuda") -> np.ndarray:
    """Solves ``B`` scheduling instances with one batched DP on ``device``.

    Accepts a sequence of :class:`Problem` (ragged ``n``/``U_i``/``T`` are
    padded into a dense stack) or a prebuilt :class:`ProblemBatch`. Returns a
    ``(B, n)`` int64 array of schedules — row ``b`` solves instance ``b``;
    columns past an instance's own ``n`` are 0. Only the ``(B, n)``
    schedules come back to the host.
    """
    batch = problems if isinstance(problems, ProblemBatch) else ProblemBatch.from_problems(problems)
    batch.validate()
    b0 = remove_lower_limits(batch)
    costs = pack_problem(b0, device)
    Tmax = int(b0.T.max())
    # Scheduling instances always fill the knapsack: T*_b == T'_b.
    t_star = torch.from_numpy(b0.T).to(costs.device)
    X, _ = solve_fused_batch_torch(costs, t_star, Tmax, backend=backend)
    return restore_lower_limits(batch, X.cpu().numpy().astype(np.int64))
