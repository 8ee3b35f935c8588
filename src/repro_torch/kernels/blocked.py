"""Blocked (tiled) PyTorch backend for the banded min-plus convolution.

The dense oracle (``kernels/ref.py``) materializes the full ``(B, T+1, W)``
candidate tensor per class step — ~640 MB at B=16, T=10k, W=1k. This
backend walks the *output* row in ``BT``-sized tiles and the band in
``BW``-sized chunks, so it never holds more than one ``(B, BT, BW)``
candidate block: memory is bounded by the block sizes, not by ``T·W``, with
the same O(B·T·W) arithmetic. It is the port's CPU backend.

Bit-identity with the oracle (asserted by ``tests/test_torch_kernels.py``):

* **values** — each candidate is the same float32 ``kprev[t-j] + cost[j]``
  followed by the same ``>= BIG -> BIG`` saturation; regrouping a min is
  exact, so tile values equal the dense values bit-for-bit.
* **argmins** — inside a chunk ``argmin`` returns the first minimum; chunks
  are merged in ascending ``j`` with *strict* improvement (``cand < best``),
  so the winner is the first minimum over the whole band: exactly
  Algorithm 1's ascending-``j`` strict-improvement update, and exactly the
  oracle's ``argmin``.
* **band edges / padding** — out-of-band reads land in a ``BIG`` prefix
  (``t - j < 0``) or a ``BIG`` cost tail (``j > U_i``); ``BIG + x``
  saturates back to exactly ``BIG``, and an all-BIG tile keeps the
  ``argmin = 0`` convention because nothing strictly improves the ``BIG``
  init carry.
"""

from __future__ import annotations

import torch

from .ref import BIG, _big

__all__ = [
    "auto_block_sizes",
    "minplus_blocked",
    "minplus_blocked_batch",
    "pad_band_inputs",
    "DEFAULT_BLOCK_BUDGET_BYTES",
]

# Nominal block budget: 4·B·BT·BW bytes, the size of one materialized
# (B, BT, BW) candidate block.
DEFAULT_BLOCK_BUDGET_BYTES = 2 << 20


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length() if v > 1 else 1


def pad_band_inputs(kprev: torch.Tensor, cost: torch.Tensor, BT: int, BW: int):
    """The blocked layout's shared padding: rows gain a ``Wpad``-entry BIG
    prefix (every banded read ``t - j``, including from the padded band, is
    an in-bounds slice) and a BIG tail to whole ``BT`` tiles; costs gain a
    BIG tail to whole ``BW`` chunks.

    Returns ``(kprev_pad (B, Wpad+Tpad), cost_pad (B, Wpad), Tpad, Wpad)``.
    """
    B, Tp = kprev.shape
    W = cost.shape[1]
    Wpad = _ceil_to(W, BW)
    Tpad = _ceil_to(Tp, BT)
    f32 = dict(dtype=torch.float32, device=kprev.device)
    kprev_pad = torch.cat(
        [torch.full((B, Wpad), BIG, **f32), kprev, torch.full((B, Tpad - Tp), BIG, **f32)],
        dim=1,
    )
    cost_pad = torch.cat([cost, torch.full((B, Wpad - W), BIG, **f32)], dim=1)
    return kprev_pad, cost_pad, Tpad, Wpad


def auto_block_sizes(
    B: int, Tp: int, W: int, budget_bytes: int = DEFAULT_BLOCK_BUDGET_BYTES
):
    """Deterministic (BT, BW) for a row-update shape.

    ``BW = min(128, ceil_pow2(W))``; the nominal ``4·B·BT·BW``-byte block
    budget then buys the widest output tile it can, clamped to [64, 2048]
    and never wider than the padded row. The same policy as the JAX
    package's blocked backend, so both walk the same tiles.
    """
    B, Tp, W = int(B), int(Tp), int(W)
    BW = min(128, _pow2_ceil(W))
    elems = max(1, int(budget_bytes) // (4 * max(1, B)))  # BT*BW float32s
    BT = max(64, min(2048, _pow2_ceil(elems // BW + 1) >> 1))
    BT = min(BT, _pow2_ceil(Tp))
    return BT, BW


def minplus_blocked_batch(
    kprev: torch.Tensor,
    cost: torch.Tensor,
    *,
    BT: int | None = None,
    BW: int | None = None,
):
    """Blocked batched DP row update. Same contract as
    :func:`repro_torch.kernels.ref.minplus_step_ref_batch`: ``kprev (B, T+1)``,
    ``cost (B, W)`` -> ``(B, T+1)`` float32 values + int32 first-min
    argmins, bit-identical to the oracle.

    ``BT``/``BW`` default to :func:`auto_block_sizes`; any sizes >= 1 are
    valid (ragged edges are BIG-padded).
    """
    kprev = kprev.to(torch.float32)
    cost = cost.to(device=kprev.device, dtype=torch.float32)
    B, Tp = kprev.shape
    W = cost.shape[1]
    bt, bw = auto_block_sizes(B, Tp, W)
    BT = int(BT) if BT is not None else bt
    BW = int(BW) if BW is not None else bw
    if BT < 1 or BW < 1:
        raise ValueError(f"block sizes must be >= 1, got BT={BT}, BW={BW}")

    kprev_pad, cost_pad, Tpad, Wpad = pad_band_inputs(kprev, cost, BT, BW)
    big = _big(kprev.device)
    kout = torch.empty((B, Tpad), dtype=torch.float32, device=kprev.device)
    iout = torch.empty((B, Tpad), dtype=torch.int32, device=kprev.device)
    for base in range(0, Tpad, BT):  # one BT-wide output tile at absolute t = base
        best = torch.full((B, BT), BIG, dtype=torch.float32, device=kprev.device)
        best_idx = torch.zeros((B, BT), dtype=torch.int64, device=kprev.device)
        for j0 in range(0, Wpad, BW):
            # seg[:, (BW-1) + dt - jj] = kprev_pad[:, Wpad + base + dt - (j0+jj)]
            start = Wpad + base - j0 - (BW - 1)
            seg = kprev_pad[:, start : start + BT + BW - 1]
            # block[:, dt, jj] = seg[:, (BW-1) + dt - jj]
            block = seg.unfold(1, BW, 1).flip(-1)  # (B, BT, BW)
            cand = block + cost_pad[:, None, j0 : j0 + BW]
            cand = torch.where(cand >= big, big, cand)  # the oracle's saturation
            cmin = cand.amin(dim=2)
            carg = cand.argmin(dim=2)  # first minimum inside the chunk
            improved = cmin < best  # strict: earlier chunks win ties
            best = torch.where(improved, cmin, best)
            best_idx = torch.where(improved, carg + j0, best_idx)
        kout[:, base : base + BT] = best
        iout[:, base : base + BT] = best_idx.to(torch.int32)
    return kout[:, :Tp].contiguous(), iout[:, :Tp].contiguous()



def minplus_blocked(kprev: torch.Tensor, cost: torch.Tensor, *, BT: int | None = None, BW: int | None = None):
    """One blocked DP row update: the ``B = 1`` slice of
    :func:`minplus_blocked_batch` (same contract as
    :func:`repro_torch.kernels.ref.minplus_step_ref`): ``kprev (T+1,)``,
    ``cost (W,)`` -> ``(T+1,)`` float32 values and int32 first-min argmins."""
    kprev = torch.as_tensor(kprev)
    kout, iout = minplus_blocked_batch(kprev[None], torch.as_tensor(cost, device=kprev.device)[None], BT=BT, BW=BW)
    return kout[0], iout[0]
