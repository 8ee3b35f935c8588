"""Batched monotone-cost fast path: vectorized marginal schedulers.

The paper's four monotone-regime algorithms (Section 5) avoid the
O(n·T·W) (MC)^2MKP table entirely. This module batches them:

  * **MarIn / MarCo** (:func:`marin_batch` / :func:`marco_batch`) — one
    *selection* (:func:`marginal_select`, torch ops on the tensors'
    device): build the ``(B, n, W-1)`` marginal-cost table from the packed
    cost tables, mask units beyond each upper limit to +inf, and take the
    ``T'_b`` globally cheapest marginal units per problem with a stable
    sort over the flattened ``(n·(W-1),)`` axis; per-resource task counts
    come back by a scatter-add over the sort permutation.
    O(B·nW·log(nW)) instead of O(B·n·T·W). MarCo is the constant-marginal
    special case of the same selection (constant marginals are
    non-decreasing), matching the serial MarCo's sort-and-fill bit for bit.
  * **MarDecUn** (:func:`mardecun_batch`) — vectorized argmin of
    ``C_i(T')`` over eligible resources; O(B·n) host numpy in float64
    (exactly the serial comparison semantics).
  * **MarDec** (:func:`mardec_batch`) — decreasing marginals WITH binding
    upper limits stay on the serial host path, looped over the batch: with
    upper limits the optimum has the Lemma-6 all-or-nothing structure and
    needs the (MC)^2MKP packing enumeration of Algorithm 5, so
    :func:`mardec_batch` reuses it verbatim (bit-identical by
    construction).

**Tie-breaking == the serial heap.** `marin` pops ``(marginal, resource)``
tuples from a binary heap, so for equal marginals the lowest resource index
wins, and within a resource units become available in ascending ``j`` order.
With per-resource non-decreasing marginals that pop order is exactly the
merge of n sorted streams, i.e. ascending ``(marginal, resource, j)``
lexicographic order — which is precisely a *stable* ascending sort of the
i-major flattened marginal table. Stability also makes the selection
invariant under inert batch padding (padded resources sit at higher flat
indices and are masked to +inf). A sort that orders the float's bits (the
card's radix sort) would put ``-0.0`` before ``+0.0``; comparison sorts
(the CPU's, and the JAX package's, which canonicalises zeros) treat them as
equal. Adding ``+0.0`` turns every ``-0.0`` marginal into ``+0.0`` first, so
both devices keep the heap's order.

**Precision.** The selection computes in float32 (same contract as the
batched DP: the pack saturates to float32). On float32-representable cost
tables the marginal ``fl(C(j) - C(j-1))`` is the correctly-rounded true
marginal and rounding is monotone, so batched schedules are bit-identical
to the float64 numpy oracles unless two *distinct* float64 marginals
collide in float32 exactly at the selection boundary (measure-zero for
continuous cost draws; exact for integer-valued tables). The selected
total is a float32 sum whose order is the device's.

:func:`select_algorithm_batch` is the shared dispatch rule (paper Table 2)
over :func:`~repro_torch.core.problem.classify_regimes`; the serial
``schedule(algorithm="auto")`` delegates here too, so the two paths cannot
disagree.

The port of ``repro.core.marginal_jax``; ``marginal_select`` there is plain
jnp, so here it is plain torch ops, with no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from .marginal import mardec
from .problem import (
    Problem,
    ProblemBatch,
    classify_regimes,
    remove_lower_limits,
    restore_lower_limits,
)
from .torch_dp import pack_problem

__all__ = [
    "marin_batch",
    "marco_batch",
    "mardecun_batch",
    "mardec_batch",
    "marginal_select",
    "select_algorithm_batch",
    "MARGINAL_BATCH_ALGORITHMS",
]


# ---------------------------------------------------------------------------
# dispatch rule (paper Table 2) — shared by serial and batched "auto"
# ---------------------------------------------------------------------------


def select_algorithm_batch(problems) -> list:
    """Per-instance algorithm names (paper Table 2) for a batch:
    ``marin | marco | mardecun | mardec | dp``.

    The "no binding upper limits" column of Table 2 is evaluated on the
    0-lower-limit instance and **ignores zero-capacity resources**
    (``U_i - L_i == 0``): they can never take a task, so whether they exist
    (genuinely, or as inert batch padding) must not change the dispatch —
    this is what keeps batched sub-batch dispatch identical to dispatching
    each instance alone, and serial identical to batched.
    """
    batch = (
        problems
        if isinstance(problems, ProblemBatch)
        else ProblemBatch.from_problems(problems)
    )
    regimes = classify_regimes(batch.costs, batch.lower, batch.upper)
    span = batch.upper - batch.lower  # U'_i of the 0-lower-limit instance
    Tp = batch.T - batch.lower.sum(axis=1)  # T'
    # unlimited: every resource that can take tasks at all can take ALL of them
    unlimited = np.all((span == 0) | (span >= Tp[:, None]), axis=1)
    out = []
    for b in range(batch.B):
        r = regimes[b]
        if r == "increasing":
            out.append("marin")
        elif r == "constant":
            out.append("mardecun" if unlimited[b] else "marco")
        elif r == "decreasing":
            out.append("mardecun" if unlimited[b] else "mardec")
        else:
            out.append("dp")
    return out


# ---------------------------------------------------------------------------
# the selection (MarIn / MarCo)
# ---------------------------------------------------------------------------


def marginal_select(costs: torch.Tensor, upper: torch.Tensor, t_star: torch.Tensor):
    """The MarIn/MarCo selection as torch ops on ``costs``' device (the
    sweep engine runs it inside its per-bucket plans).

    Args:
      costs: ``(B, n, W)`` float32 packed 0-lower-limit tables (BIG beyond
        each ``U_i`` — those units are masked again here anyway).
      upper: ``(B, n)`` integer upper limits of the 0-lower-limit instances.
      t_star: ``(B,)`` integer workloads ``T'``.

    Returns ``(X0, obj)``: ``(B, n)`` int32 per-resource task counts and the
    ``(B,)`` float32 selected-marginal totals (the optimal 0-lower-limit
    objective when marginals are non-decreasing).
    """
    B, n, W = costs.shape
    dev = costs.device
    # marginal unit (i, j) at [..., j-1]; + 0.0 makes every -0.0 a +0.0
    m = (costs[:, :, 1:] - costs[:, :, :-1]) + 0.0
    j = torch.arange(1, W, device=dev)[None, None, :]
    m = torch.where(j <= upper[:, :, None], m, float("inf"))
    flat = m.reshape(B, n * (W - 1))
    # stable ascending sort == the serial heap's (marginal, resource, j) order
    sorted_m, order = torch.sort(flat, dim=1, stable=True)
    picked = torch.arange(n * (W - 1), device=dev)[None, :] < t_star[:, None]
    resource = order // (W - 1)
    x = torch.zeros((B, n), dtype=torch.int32, device=dev)
    x.scatter_add_(1, resource, picked.to(torch.int32))
    obj = torch.where(picked, sorted_m, 0.0).sum(dim=1)
    return x, obj


def _as_batch(problems) -> ProblemBatch:
    batch = (
        problems
        if isinstance(problems, ProblemBatch)
        else ProblemBatch.from_problems(problems)
    )
    batch.validate()
    return batch


def marin_batch(problems, device="cuda") -> np.ndarray:
    """Batched MarIn (Alg. 2): ``B`` increasing-marginal instances in one
    selection on ``device``. Returns ``(B, n)`` int64 schedules,
    bit-identical to looping :func:`repro_torch.core.marginal.marin` (see the
    module docstring for the tie-break/precision contract)."""
    batch = _as_batch(problems)
    b0 = remove_lower_limits(batch)
    if b0.W < 2:  # every resource pinned to its lower limit
        return restore_lower_limits(batch, np.zeros((batch.B, batch.n), np.int64))
    costs = pack_problem(b0, device)
    x0, _ = marginal_select(
        costs,
        torch.from_numpy(b0.upper).to(costs.device),
        torch.from_numpy(b0.T).to(costs.device),
    )
    return restore_lower_limits(batch, x0.cpu().numpy().astype(np.int64))


def marco_batch(problems, device="cuda") -> np.ndarray:
    """Batched MarCo (Alg. 3). Constant marginals are non-decreasing, so the
    MarIn selection picks all of the cheapest resource's units before any of
    the next (stable sort, resource-major tie-break) — exactly the serial
    MarCo's sort-by-M(1)-and-fill, bit for bit."""
    return marin_batch(problems, device)


# ---------------------------------------------------------------------------
# MarDecUn / MarDec
# ---------------------------------------------------------------------------


def mardecun_batch(problems) -> np.ndarray:
    """Batched MarDecUn (Alg. 4): all ``T'`` tasks to the first-argmin
    ``C_i(T')`` resource per instance, vectorized over the batch (float64
    host numpy — the exact serial comparison). Zero-capacity resources
    (including inert batch padding) are ignored; a resource with
    ``0 < U'_i < T'`` raises, as in the serial guard."""
    batch = _as_batch(problems)
    b0 = remove_lower_limits(batch)
    span, Tp = b0.upper, b0.T
    if np.any((span > 0) & (span < Tp[:, None])):
        bad = np.nonzero(np.any((span > 0) & (span < Tp[:, None]), axis=1))[0]
        raise ValueError(
            f"MarDecUn requires U_i >= T for all resources with capacity; "
            f"instances {bad.tolist()} violate it"
        )
    idx = np.minimum(Tp[:, None], span)[:, :, None]
    at_T = np.take_along_axis(b0.costs, idx, axis=2)[:, :, 0]  # C_i(T')
    key = np.where(span >= Tp[:, None], at_T, np.inf)
    k = np.argmin(key, axis=1)  # first argmin, like the serial min()
    x0 = np.zeros((batch.B, batch.n), dtype=np.int64)
    x0[np.arange(batch.B), k] = Tp
    return restore_lower_limits(batch, x0)


def mardec_batch(problems) -> np.ndarray:
    """Batched MarDec (Alg. 5): the serial host solver looped over the
    batch (see module docstring — no sound selection reduction exists for
    decreasing marginals WITH binding upper limits). Accepts a sequence of
    Problems or a ProblemBatch; returns ``(B, n)`` int64.

    Padding-invariant: zero-capacity resources (``U_i = 0`` — phantom
    padding or genuine dropouts) provably take 0 tasks and only shift every
    packing candidate by the same fixed ``C_i(0)``, so they are stripped
    before solving rather than each paying a wasted O(n·T) leave-one-out
    pass inside Algorithm 5; the schedule is identical either way."""
    if isinstance(problems, ProblemBatch):
        problems.validate()
        insts = [problems.instance(b) for b in range(problems.B)]
        n = problems.n
    else:
        insts = list(problems)
        for p in insts:
            p.validate()
        n = max(p.n for p in insts)
    X = np.zeros((len(insts), n), dtype=np.int64)
    for b, p in enumerate(insts):
        keep = np.nonzero(p.upper > 0)[0]
        if len(keep) == 0:  # T == 0 (validated): nothing to assign
            continue
        if len(keep) == p.n:
            X[b, : p.n] = mardec(p)
        else:
            slim = Problem(
                T=p.T,
                lower=p.lower[keep],
                upper=p.upper[keep],
                cost_tables=tuple(p.cost_tables[i] for i in keep),
            )
            X[b, keep] = mardec(slim)
    return X


# algorithm name -> batched implementation (the regime-split sub-batch
# executors schedule_batch routes through; MarIn/MarCo take a device)
MARGINAL_BATCH_ALGORITHMS = {
    "marin": marin_batch,
    "marco": marco_batch,
    "mardecun": mardecun_batch,
    "mardec": mardec_batch,
}
