"""Dense PyTorch oracle for the banded min-plus (tropical) convolution.

The (MC)^2MKP relaxation for one contiguous class (paper eq. 4, with
``N_i = {0..U_i}``, ``w_ij = j``) is

    K_i[t]   = min_{0 <= j <= min(W-1, t)}  K_{i-1}[t - j] + C_i[j]
    I_i[t]   = argmin_j ...   (first minimum wins, matching Algorithm 1's
                               strict-improvement update over ascending j)

which is a min-plus convolution of the previous DP row with the class's cost
table, banded to width ``W = U_i + 1``. This module is the plain version the
CUDA kernel (``kernels/csrc/minplus.cu``) is held against, bit for bit, and
the CPU path of its wrapper. It materializes the whole ``(B, T+1, W)``
candidate tensor, so it is for small shapes and for checking.

``minplus_scan_ref`` and ``backtrack_ref`` are the plain versions of the
class scan and the backtrack kernel that ``minplus_scan_cuda`` launches: a
Python loop of ``n`` row updates, and ``n`` gather steps in reverse.
"""

from __future__ import annotations

import torch

__all__ = ["minplus_step_ref", "minplus_step_ref_batch", "minplus_scan_ref", "backtrack_ref", "BIG"]

# Large-but-finite stand-in for +inf: keeps arithmetic NaN-free in float32
# while dominating any real cost (energy values in this codebase are << 1e30).
# Every comparison against it happens in float32 (see ``_big``).
BIG = 1e30


def _big(device) -> torch.Tensor:
    """BIG as a float32 scalar tensor, so compares round it as float32."""
    return torch.tensor(BIG, dtype=torch.float32, device=device)


def minplus_step_ref_batch(kprev: torch.Tensor, cost: torch.Tensor):
    """Batched DP row update — ``B`` independent instances at once.

    Args:
      kprev: ``(B, T+1)`` previous rows ``Z_{i-1}`` (BIG where infeasible).
      cost:  ``(B, W)`` per-instance class cost tables ``C_i(0..U_i)``,
        padded with BIG.

    Returns:
      (kout, iout): ``(B, T+1)`` float32 new rows and ``(B, T+1)`` int32
      argmin item ``j`` (first minimum along ascending ``j`` wins), on the
      inputs' device.
    """
    kprev = kprev.to(torch.float32)
    cost = cost.to(device=kprev.device, dtype=torch.float32)
    Tp = kprev.shape[1]
    W = cost.shape[1]
    dev = kprev.device
    big = _big(dev)
    t = torch.arange(Tp, device=dev)[:, None]  # (Tp, 1)
    j = torch.arange(W, device=dev)[None, :]  # (1, W)
    src = t - j  # (Tp, W) index into each kprev row
    valid = src >= 0
    gathered = kprev[:, src.clamp(0, Tp - 1)]  # (B, Tp, W)
    cand = torch.where(valid[None], gathered + cost[:, None, :], big)
    # saturate: anything that touched BIG stays BIG (avoid BIG+x drift)
    cand = torch.where(cand >= big, big, cand)
    kout = cand.amin(dim=2)
    # argmin returns the first occurrence of the minimum, as jnp.argmin does
    iout = cand.argmin(dim=2).to(torch.int32)
    return kout, iout


def minplus_step_ref(kprev: torch.Tensor, cost: torch.Tensor):
    """One DP row update: the ``B = 1`` slice of the batched oracle.

    Args:
      kprev: ``(T+1,)`` previous row ``Z_{i-1}`` (BIG where infeasible).
      cost:  ``(W,)`` class cost table ``C_i(0..U_i)`` padded with BIG.

    Returns:
      (kout, iout): ``(T+1,)`` new row and ``(T+1,)`` int32 argmin item j.
    """
    kout, iout = minplus_step_ref_batch(kprev[None], cost[None])
    return kout[0], iout[0]


def minplus_scan_ref(k0: torch.Tensor, costs: torch.Tensor, I: torch.Tensor, step=minplus_step_ref_batch):
    """The class scan as a Python loop: from the DP row ``k0 (B, T+1)`` over
    the classes of ``costs (B, n, W)``, class ``i`` by ``step(row, costs[:,
    i])`` (a batched row update, the dense oracle by default), its argmins
    copied into ``I[i]`` of the ``(n, B, T+1)`` int32 slab. Returns the last
    row (``k0`` itself when ``n == 0``)."""
    k = k0
    for i in range(costs.shape[1]):
        k, idx = step(k, costs[:, i])
        I[i].copy_(idx)
    return k


def backtrack_ref(I: torch.Tensor, t_star: torch.Tensor) -> torch.Tensor:
    """Reverse walk through the argmin slab ``I (n, B, T+1)``: per instance,
    ``x_i = I[i, b, t_b]; t_b -= x_i`` from ``t_star (B,)``. Returns ``(B, n)``
    int32 on ``I``'s device; a ``t_b`` outside the row raises (the kernel
    gives ``x_i = 0`` there instead, so callers check the range)."""
    n, B, _ = I.shape
    X = torch.empty((B, n), dtype=torch.int32, device=I.device)
    t = t_star.to(device=I.device, dtype=torch.int64)  # gather wants int64 indices
    for i in range(n - 1, -1, -1):
        j = I[i].gather(1, t[:, None])[:, 0]
        X[:, i] = j
        t = t - j
    return X
