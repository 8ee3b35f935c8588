"""Request coalescing: the pure shape math behind the scheduler service.

A stream of heterogeneous scheduling requests coalesces along the batch
axis when — and only when — the requests land in the same engine plan
bucket: merging then changes WHICH rows one plan solves, never which plan
runs (padding is inert, :meth:`ProblemBatch.pad_to`). The bucket key
reuses :func:`repro_torch.core.sweep.request_bucket` — the exact math
:class:`~repro_torch.core.sweep.SweepEngine` buckets by — so there is one
source of truth for "do these shapes share a plan".

Everything here is deterministic numpy with no threads or clocks; the
queueing/flush-trigger machinery lives in :mod:`repro_torch.serve.service`.
A numpy copy of ``repro.serve.coalesce``.
"""

from __future__ import annotations

import numpy as np

from ..core.problem import ProblemBatch
from ..core.sweep import _next_pow2, request_bucket

__all__ = ["coalesce_key", "combine_batches", "pow2_ladder", "warm_batch"]


def coalesce_key(batch: ProblemBatch, split_regimes: bool) -> tuple:
    """``(n, T, W, split)`` — requests sharing this key flush as ONE
    dispatch. ``split`` is part of the key because regime-split and plain
    DP dispatches run different plans (DESIGN.md §13)."""
    nb, Tb, Wb = request_bucket(batch)
    return (nb, Tb, Wb, bool(split_regimes))


def combine_batches(batches):
    """Stacks request batches (which must share a coalesce key) into ONE
    :class:`ProblemBatch` along ``B``.

    Rows are padded to the group's max ``(n, W)`` envelope first — inert
    padding, so every row of the combined solve is bit-identical to solving
    its request alone. Returns ``(combined, slices)`` where ``slices[i] =
    (lo, hi)`` are request ``i``'s rows in the combined batch.
    """
    slices, lo = [], 0
    for b in batches:
        slices.append((lo, lo + b.B))
        lo += b.B
    if len(batches) == 1:
        return batches[0], slices
    n = max(b.n for b in batches)
    W = max(b.W for b in batches)
    padded = [b.pad_to(n=n, W=W) for b in batches]
    combined = ProblemBatch(
        T=np.concatenate([p.T for p in padded]),
        lower=np.concatenate([p.lower for p in padded], axis=0),
        upper=np.concatenate([p.upper for p in padded], axis=0),
        costs=np.concatenate([p.costs for p in padded], axis=0),
    )
    return combined, slices


def pow2_ladder(max_batch: int):
    """``[1, 2, 4, ..., next_pow2(max_batch)]`` — every batch-axis bucket a
    coalesced flush of up to ``max_batch`` rows can land in. Warming the
    whole ladder makes steady-state traffic free of plan builds regardless
    of whether flushes fire on the size or the delay trigger."""
    top = _next_pow2(int(max_batch))
    out, b = [], 1
    while b <= top:
        out.append(b)
        b *= 2
    return out


def warm_batch(n: int, T: int, W: int, B: int, regime: str = "arbitrary") -> ProblemBatch:
    """A deterministic feasible ``(B, n, W)`` batch with workload ``T``,
    built to land in the same engine bucket as real ``(n, T, W)`` traffic —
    the ahead-of-time plan-building vehicle for :meth:`SchedulerService.warm`.

    ``regime="arbitrary"`` builds zig-zag marginal tables (alternating
    ``+2/0``) so regime-split dispatches still route the warm batch to the
    DP plan (for ``W >= 4``; narrower tables cannot be non-monotone
    and may classify monotone — harmless for ``split_regimes=False``
    buckets, which ignore regimes entirely). ``regime="increasing"`` builds
    convex ``j^2`` tables that classify MarIn, warming the
    ``("marginal", ...)`` selection bucket instead.

    If ``T`` exceeds the envelope capacity ``n*(W-1)``, the workload is
    clamped — legal only while the pow2 bucket is preserved (a bucket real
    traffic in this envelope could actually produce); otherwise raises.
    """
    if W < 2:
        raise ValueError("warm shapes need W >= 2 (some assignable unit)")
    T_w = min(int(T), n * (W - 1))
    if T_w <= 0 or _next_pow2(T_w) != _next_pow2(int(T)):
        raise ValueError(
            f"warm shape (n={n}, T={T}, W={W}) is infeasible: capacity "
            f"{n * (W - 1)} cannot reach the T={_next_pow2(int(T))} bucket"
        )
    j = np.arange(W, dtype=np.float64)
    if regime == "increasing":
        tbl = j * j  # strictly increasing marginals -> MarIn
    elif regime == "arbitrary":
        tbl = j + (j % 2)  # marginals 2,0,2,0,... -> non-monotone for W >= 4
    else:
        raise ValueError(f"unknown warm regime {regime!r}")
    return ProblemBatch(
        T=np.full(B, T_w, dtype=np.int64),
        lower=np.zeros((B, n), dtype=np.int64),
        upper=np.full((B, n), W - 1, dtype=np.int64),
        costs=np.broadcast_to(tbl, (B, n, W)).copy(),
    )
