"""Mixture-of-Experts routing and dispatch, after the JAX package's
``models/moe_dispatch.py``.

  * ``dense``  — every expert on every token, combined by gate (the
                 reference's oracle; O(T·E) work, exact when nothing drops).
  * ``einsum`` — Mesh-TF-style one-hot capacity dispatch: exact up to
                 capacity drops; for small token counts (decode).
  * ``a2a``    — expert parallelism over the active mesh: tokens sharded
                 over all mesh axes, experts over the ``expert`` axes; two
                 sorts, an ``all_to_all`` exchange each way over the expert
                 axes' process group, per-expert padded products. The body
                 runs on each rank's shards under ``local_map`` (the
                 reference's ``shard_map``). Without an active mesh it runs
                 ``dense``, as the reference does.
  * ``held``   — one chip's share of expert parallelism, without the
                 exchange: the layer holds the weights of the experts
                 ``[first_expert_held, first_expert_held + num_experts_held)``
                 and routes over all ``num_experts``; the (token, choice)
                 pairs routed to its experts are sorted by expert and run
                 through one grouped gated-SiLU product
                 (``torch._grouped_mm``, each expert on exactly its rows,
                 the group offsets on the device), so no pair drops; pairs
                 routed to other experts add nothing here (their chips'
                 part). The number of held pairs, which sizes the rows, is
                 read on the host, one sync a forward pass: the counts' copy
                 starts right after the router and the host waits for it
                 only after queueing the shared expert, so the card keeps
                 working through the wait; remat's recompute takes the
                 forward pass's counts and checks them on the card. Not in
                 the JAX package.

All share the router: by default softmax, top-k, renormalise, and the
switch-style load-balance auxiliary loss. The top k come from a stable
descending sort, so among equal probabilities the lower expert index comes
first, as ``jax.lax.top_k`` orders them: ``torch.topk`` promises no order
for ties, and the order decides the einsum dispatch's slot positions and
with them which tokens the capacity drops. ``router_score="sigmoid"`` is
DeepSeek-V3's router instead (:func:`route`; not in the JAX package).

Counters of the ``held`` route, raised on every call (so a remat'd
layer's recompute counts as a forward pass), with the pattern of
:mod:`repro_torch.kernels.adamw`'s: ``pairs_held`` (pairs computed here),
``max_load`` (the most pairs one held expert got in a call) and
``dropped`` (held pairs left out: none, by construction, since the rows
are sized by the count). :func:`record_routing` keeps
each call's chosen experts while it is open; off, it costs nothing.
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..launch.sharding import current_mesh, linear, mesh_shape, no_batch_product, rules, whole_rows, whole_rows_grad
from ..spans import mark_backward, span

__all__ = ["dropped", "einsum_capacity", "max_load", "moe_ffn", "pairs_held", "record_routing", "route"]

pairs_held = 0  # (token, choice) pairs the held route computed, since import (or since a caller reset it)
max_load = 0  # the most pairs one held expert got in one call
dropped = 0  # held pairs the held route left out

# the held route's counts of a layer's forward pass under remat, by id of its
# router weight (held weakly: a step's aliases of the weights go with the step,
# and an entry counts only while its weight lives), until the backward pass's
# recompute of the layer takes them
_held_memo: dict = {}

# the chosen experts of each route call while record_routing() is open
_recorded: Optional[list] = None


@contextlib.contextmanager
def record_routing():
    """While open, every :func:`route` call of a forward pass appends its
    chosen experts ``gate_idx (T, k)`` (int64, on the router's device) to
    the list it yields, in call order; remat's recompute, which runs inside
    the backward pass, is not recorded again. Closed (the default), routing
    keeps nothing."""
    global _recorded
    saved, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = saved


def route(cfg: ModelConfig, x2d: torch.Tensor, router_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
          batch: int = 1):
    """x2d ``(T, d)`` -> ``(gate_w (T, k) float32, gate_idx (T, k) int64,
    aux)``, the router in float32. On DTensors the top k are taken on each
    rank's rows under ``local_map``, the experts whole (the sort is an
    index-style op: torch 2.11's DTensor cannot run its backward, whose
    scatter meets a plain tensor). ``bias`` and ``batch`` serve the sigmoid
    router (:func:`_route_sigmoid`) only."""
    logits = linear(x2d.float(), router_w.float())
    if cfg.router_score == "sigmoid":
        gate_w, gate_idx, aux = _route_sigmoid(cfg, logits, bias, batch)
    else:
        gate_w, gate_idx, aux = _route_softmax(cfg, logits)
    if _recorded is not None and torch._C._current_graph_task_id() == -1:  # not in a backward pass
        _recorded.append(gate_idx.detach())
    return gate_w, gate_idx, aux


def _route_softmax(cfg: ModelConfig, logits):
    """The reference's router: softmax, top k, renormalised; the aux
    ``E * sum_e f_e * P_e`` over the whole batch."""
    probs = torch.softmax(logits, dim=-1)
    top_k = functools.partial(_top_k, k=cfg.top_k)
    if isinstance(probs, DTensor):
        pl = [Replicate() if p.is_partial() or p == Shard(1) else p for p in probs.placements]
        top_k = local_map(top_k, out_placements=(pl, pl), in_placements=(pl,), device_mesh=probs.device_mesh,
                          redistribute_inputs=True)
    gate_w, gate_idx = top_k(probs)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux: E * sum_e f_e * P_e
    E = cfg.num_experts
    f_e = F.one_hot(gate_idx, E).float().mean(dim=(0, 1))  # fraction routed, slot-averaged
    aux = E * torch.sum(f_e * probs.mean(dim=0))
    return gate_w, gate_idx, aux


def _route_sigmoid(cfg: ModelConfig, logits, bias, batch: int):
    """DeepSeek-V3's router (arXiv:2412.19437 §2.1.2-2.1.3), in float32:
    affinities ``s = sigmoid(x W_r)`` over all ``num_experts``; the experts
    chosen on ``s + bias`` (``bias (E,)``, a selection-only bias that no
    gradient reaches; none where ``None``) among the ``router_groups_kept``
    groups whose two largest biased scores sum highest (:func:`_select`);
    the gates the unbiased ``s`` of the chosen experts over their sum, times
    ``routed_scale``. The balance term is sequence-wise: for each of the
    ``batch`` sequences of the ``T`` rows, ``E * sum_e f_e * P_e`` with
    ``f_e`` the share of its (token, choice) pairs routed to ``e`` and
    ``P_e`` the mean of ``s_e / sum_j s_j`` over its tokens; the mean over
    the sequences."""
    if isinstance(logits, DTensor):
        raise ValueError("the sigmoid router runs on one device's tokens: no DTensor route")
    s = torch.sigmoid(logits)
    with torch.no_grad():
        gate_idx = _select(cfg, s if bias is None else s + bias.float())
    gate_w = s.gather(1, gate_idx)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True) * cfg.routed_scale
    T, E = s.shape
    f_e = F.one_hot(gate_idx, E).float().reshape(batch, T // batch, -1, E).mean(dim=(1, 2))
    p_e = (s / s.sum(-1, keepdim=True)).reshape(batch, T // batch, E).mean(dim=1)
    aux = (E * (f_e * p_e).sum(-1)).mean()
    return gate_w, gate_idx, aux


def _select(cfg: ModelConfig, scores):
    """The ``top_k`` experts of each row of ``scores (T, E)`` (:func:`_top_k`'s
    order), among the ``router_groups_kept`` of ``router_groups`` groups of
    consecutive experts whose two largest scores sum highest (ties to the
    lower group), or among all experts where ``router_groups`` is 0."""
    G = cfg.router_groups
    if G:
        T, E = scores.shape
        top2 = scores.reshape(T, G, E // G).topk(2, dim=-1).values.sum(-1)  # (T, G)
        kept = _top_k(top2, cfg.router_groups_kept)[1]
        keep = torch.zeros((T, G), dtype=torch.bool, device=scores.device).scatter_(1, kept, True)
        scores = scores.masked_fill(~keep.repeat_interleave(E // G, dim=1), float("-inf"))
    return _top_k(scores, cfg.top_k)[1]


def _top_k(probs, k):
    """The ``k`` largest probabilities of each row and their experts, from
    a stable descending sort (``jax.lax.top_k``'s order among ties)."""
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate_w[:, :k], gate_idx[:, :k]


def _expert_mlp(experts, xs):
    """xs ``(E, C, d)`` grouped per expert: the gated-SiLU MLP of each
    expert on its rows."""
    h = F.silu(torch.bmm(xs, experts["w_gate"])) * torch.bmm(xs, experts["w_in"])
    return torch.bmm(h, experts["w_out"])


def _moe_dense(cfg: ModelConfig, x2d, experts, gate_w, gate_idx):
    """Every expert on every token, ``(E, T, d)``, combined by the gates
    cast to the activations' dtype. The tokens' products with the stacked
    weights have no batch dims (the reference's ``td,edf->etf``; ``matmul``
    runs them as ``bmm`` on the tokens broadcast over the experts)."""
    with no_batch_product():
        h_gate, h_in = torch.matmul(x2d, experts["w_gate"]), torch.matmul(x2d, experts["w_in"])
    h = F.silu(h_gate) * h_in  # (E, T, f)
    y_all = torch.bmm(h, experts["w_out"])  # (E, T, d)
    onehot = F.one_hot(gate_idx, cfg.num_experts).to(x2d.dtype)  # (T, k, E)
    w = (gate_w.to(x2d.dtype)[..., None] * onehot).sum(1)  # (T, E)
    return torch.einsum("te,etd->td", w, y_all)


def einsum_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert of the einsum dispatch for ``tokens`` tokens."""
    return max(8, int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 8)


def _moe_einsum(cfg: ModelConfig, x2d, experts, gate_w, gate_idx, capacity: int):
    """One-hot capacity dispatch: the (t, slot) pairs of each expert take
    its ``capacity`` slots in t-major order, the rest are dropped. On
    DTensors it runs under ``local_map`` (:func:`_moe_einsum_sharded`)."""
    if isinstance(x2d, DTensor):
        return _moe_einsum_sharded(cfg, x2d, experts, gate_w, gate_idx, capacity)
    ys = _einsum_local(x2d, experts["w_gate"], experts["w_in"], experts["w_out"], gate_w, gate_idx, cfg=cfg,
                       capacity=capacity)
    return ys.to(x2d.dtype)


def _slots(gate_w, gate_idx, *, cfg, capacity, e0=0, e_n=None, rows=None):
    """``(dispatch, combine)`` of the einsum dispatch, each ``(T, e_n, C)``
    float32: the 0/1 slot of each token at the experts ``[e0, e0 + e_n)``
    (default: all), and the same weighted by the token's gate (``None``
    without ``gate_w``). Slot positions are counted over all tokens and all
    experts, so a (token, choice) pair takes the slot, or is dropped, as in
    the dispatch over every expert at once; ``rows`` (a slice) keeps the
    tokens of one rank's rows after the count."""
    T = gate_idx.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    onehot = F.one_hot(gate_idx, E).float()  # (T, k, E)
    flat = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flat, dim=0) - flat) * flat  # position within the expert if routed
    pos = pos.sum(-1).reshape(T, k).long()
    if rows is not None:
        onehot, pos = onehot[rows], pos[rows]
        gate_w = None if gate_w is None else gate_w[rows]
    # a dropped pair gets the one-hot of slot `capacity`, which is cut off
    pos_oh = F.one_hot(pos.clamp_max(capacity), capacity + 1)[..., :capacity].float()  # (T, k, C)
    if e_n is not None and e_n != E:
        onehot = onehot[..., e0:e0 + e_n]  # the local experts' columns
    dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)  # (T, E, C) 0/1
    combine = None if gate_w is None else torch.einsum("tk,tke,tkc->tec", gate_w.float(), onehot, pos_oh)
    return dispatch, combine


def _gather(dispatch, x):
    """The experts' float32 inputs ``(E, C, d)`` of the tokens ``x``: a
    product with no batch dims (an einsum's ``bmm`` of batch one)."""
    with no_batch_product():
        return torch.einsum("tec,td->ecd", dispatch, x.float())


def _scatter(combine, ys):
    """The tokens' float32 ``(T, d)`` from the experts' outputs, weighted by
    the gates: a product with no batch dims."""
    with no_batch_product():
        return torch.einsum("tec,ecd->td", combine, ys.float())


def _einsum_local(x2d, w_gate, w_in, w_out, gate_w, gate_idx, *, cfg, capacity):
    """The einsum dispatch of all ``T`` tokens to all experts on one
    device: the float32 ``(T, d)`` output."""
    dispatch, combine = _slots(gate_w, gate_idx, cfg=cfg, capacity=capacity)
    xs = _gather(dispatch, x2d).to(x2d.dtype)
    return _scatter(combine, _expert_mlp({"w_gate": w_gate, "w_in": w_in, "w_out": w_out}, xs))


def _moe_einsum_sharded(cfg: ModelConfig, x2d, experts, gate_w, gate_idx, capacity: int):
    """The einsum dispatch on DTensors, in two ``local_map`` bodies. The
    experts are split as the parameters are placed (``Shard(0)`` on the
    ``expert`` rule's axes, data major, or ``Replicate()`` where those axes
    do not divide the experts); the tokens keep ``x2d``'s row split on the
    other mesh dims and are whole on the expert dims; the gates and the
    experts' choices are whole on every rank, so slot positions are counted
    over all tokens (the same pairs drop). The first body gathers each
    rank's tokens into its experts' slots, a float32 partial sum over the
    token split, which is reduced before the cast (each slot holds one
    token, so the sum is exact); the second runs the experts and scatters
    their outputs to the rank's tokens, a float32 partial sum over the
    expert split, reduced into ``x2d``'s placements before the cast, as the
    reference sums over every expert before it. Each rank does the products
    of its share of the tokens and experts, as the reference's program
    does. The slot dim is never split, so no mesh size has to divide the
    capacity."""
    from .layers import _local_extent

    mesh = x2d.device_mesh
    ws = [experts[n] for n in ("w_gate", "w_in", "w_out")]
    exp = list(ws[0].placements)
    if any(list(w.placements) != exp for w in ws) or any(p not in (Shard(0), Replicate()) for p in exp):
        raise ValueError(f"the einsum dispatch needs the experts split on their first dim or whole, not "
                         f"{[list(w.placements) for w in ws]}")
    split = [i for i, p in enumerate(exp) if p == Shard(0)]
    tok = [i for i, p in enumerate(x2d.placements) if p == Shard(0) and i not in split]
    coord = mesh.get_coordinate()
    block = 0
    for i in split:  # DTensor nests the shards in mesh-dim order
        block = block * mesh.size(i) + coord[i]
    e_local = cfg.num_experts // math.prod(mesh.size(i) for i in split)
    rows_pl = [Shard(0) if i in tok else Replicate() for i in range(mesh.ndim)]
    n_rows, t0 = _local_extent(x2d.shape[0], mesh, rows_pl, 0)
    rows = slice(t0, t0 + n_rows)
    rep = [Replicate()] * mesh.ndim

    def by(tok_p, split_p, other):
        return [tok_p if i in tok else split_p if i in split else other for i in range(mesh.ndim)]

    def gather(x, idx):
        dispatch, _ = _slots(None, idx, cfg=cfg, capacity=capacity, e0=block * e_local, e_n=e_local, rows=rows)
        return _gather(dispatch, x)

    xs = local_map(gather, out_placements=by(Partial(), Shard(0), Replicate()), in_placements=(rows_pl, rep),
                   in_grad_placements=(by(Shard(0), Partial(), Replicate()), rep), device_mesh=mesh,
                   redistribute_inputs=True)(x2d, gate_idx)
    xs = xs.redistribute(mesh, exp).to(x2d.dtype)

    def scatter(xl, w_g, w_i, w_o, gw, idx):
        _, combine = _slots(gw, idx, cfg=cfg, capacity=capacity, e0=block * e_local, e_n=e_local, rows=rows)
        return _scatter(combine, _expert_mlp({"w_gate": w_g, "w_in": w_i, "w_out": w_o}, xl))

    exp_grad = by(Partial(), Shard(0), Replicate())  # each rank's tokens add to its experts' gradients
    y = local_map(scatter, out_placements=by(Shard(0), Partial(), Replicate()), in_placements=(exp,) * 4 + (rep, rep),
                  in_grad_placements=(exp_grad,) * 4 + (by(Partial(), Partial(), Replicate()), rep), device_mesh=mesh,
                  redistribute_inputs=True)(xs, *ws, gate_w, gate_idx)
    y = y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x2d.placements])
    return y.to(x2d.dtype)


# ---------------------------------------------------------------------------
# all-to-all expert parallelism (local_map)
# ---------------------------------------------------------------------------


def _sort_group(ids, num_groups, capacity, *payloads):
    """Groups rows by ``ids`` into ``(num_groups, capacity, ...)`` padded
    buffers (a stable sort, so rows keep their order within a group).

    Returns ``(bufs, meta)`` where ``meta`` lets :func:`_ungroup` scatter
    results back to the original row order. Rows beyond capacity are
    dropped: they are written to one extra dump row, which is cut off."""
    N = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    start = torch.searchsorted(sorted_ids, torch.arange(num_groups, device=ids.device), side="left")
    pos_in_group = torch.arange(N, device=ids.device) - start[sorted_ids]
    valid = pos_in_group < capacity
    dest = torch.where(valid, sorted_ids * capacity + pos_in_group, num_groups * capacity)
    bufs = []
    for pl in payloads:
        flat = pl.new_zeros((num_groups * capacity + 1,) + pl.shape[1:]).index_put((dest,), pl[order])
        bufs.append(flat[:-1].reshape((num_groups, capacity) + pl.shape[1:]))
    return bufs, (order, dest, valid)


def _ungroup(buf, meta, N):
    """Inverse of :func:`_sort_group` for one payload: ``(G, C, ...)`` ->
    ``(N, ...)``, dropped rows zero."""
    order, dest, valid = meta
    flat = buf.reshape((-1,) + buf.shape[2:])
    gathered = torch.where(
        valid.reshape((-1,) + (1,) * (flat.ndim - 1)), flat[dest.clamp_max(flat.shape[0] - 1)], 0
    )
    return gathered[torch.argsort(order)]


def _a2a_local(x, gate_w, gate_idx, w_gate, w_in, w_out, *, cfg, group, n_peers, e_local, cap_send, cap_expert):
    """The per-rank body under ``local_map``: x ``(Tl, d)``; gate_w/idx
    ``(Tl, k)``; the expert weights with a leading ``e_local`` axis. Peer
    ``p`` of the exchange is rank ``p`` of ``group``, which holds experts
    ``[p * e_local, (p + 1) * e_local)``."""
    from torch.distributed import all_to_all_single
    from torch.distributed.nn.functional import all_to_all_single as all_to_all_diff

    Tl, d = x.shape
    k = cfg.top_k
    flat_ids = gate_idx.reshape(-1)  # (Tl*k,) global expert ids
    flat_x = x.repeat_interleave(k, dim=0)  # (Tl*k, d) token copies
    dest_peer = flat_ids // e_local
    local_eid = flat_ids % e_local

    (send_x, send_eid), meta_send = _sort_group(dest_peer, n_peers, cap_send, flat_x, local_eid)
    # exchange: recv[p] = what peer p sent to me (one (cap_send, d) block per
    # sender); invalid slots carry eid 0 and x == 0, harmless after the
    # expert MLP and the combine
    recv_x = all_to_all_diff(torch.empty_like(send_x), send_x.contiguous(), group=group)
    recv_eid = torch.empty_like(send_eid)
    all_to_all_single(recv_eid, send_eid.contiguous(), group=group)
    flat_recv_x = recv_x.reshape(-1, d)
    flat_recv_eid = recv_eid.reshape(-1)

    (grp_x,), meta_grp = _sort_group(flat_recv_eid, e_local, cap_expert, flat_recv_x)
    grp_y = _expert_mlp({"w_gate": w_gate, "w_in": w_in, "w_out": w_out}, grp_x)  # (e_local, cap_expert, d)
    flat_y = _ungroup(grp_y, meta_grp, flat_recv_eid.shape[0])
    back = flat_y.reshape(n_peers, cap_send, d).contiguous()
    ret = all_to_all_diff(torch.empty_like(back), back, group=group)
    flat_ret = _ungroup(ret, meta_send, flat_ids.shape[0])  # (Tl*k, d)
    y = (flat_ret.reshape(Tl, k, d).float() * gate_w[..., None]).sum(1)
    return y.to(x.dtype)


def _ep_ranks(mesh, ep_axes) -> list:
    """The ranks of each expert group of ``mesh`` (a ``DeviceMesh``, or a
    stand-in with ``axis_names`` and a ``shape`` mapping, whose ranks are
    laid out row-major as ``init_device_mesh`` lays them): one list per
    position on the other axes, holding the ranks in the order of the
    expert blocks that ``Shard(0)`` on each of ``ep_axes`` gives them. DTensor
    nests the shards in mesh-dim order, so the block index is the ranks'
    coordinates on ``ep_axes`` read major first, as the reference's
    ``all_to_all`` over an axis tuple numbers its peers."""
    shape = mesh_shape(mesh)
    names = list(shape)
    grid = getattr(mesh, "mesh", None)
    grid = torch.arange(math.prod(shape.values())).reshape(tuple(shape.values())) if grid is None else grid.cpu()
    rest = [names.index(a) for a in names if a not in ep_axes]
    grid = grid.permute(rest + [names.index(a) for a in ep_axes])
    return grid.reshape(-1, math.prod(shape[a] for a in ep_axes)).tolist()


_EP_GROUPS = {}


def _ep_group(mesh, ep_axes):
    """The process group of this rank's expert group: the expert axis's
    own group, or for several axes one flattened group over them
    (``DeviceMesh._flatten``, made once per mesh and axes by every rank)
    whose rank ``i`` holds expert block ``i`` (:func:`_ep_ranks`)."""
    if len(ep_axes) == 1:
        return mesh.get_group(ep_axes[0])
    key = (id(mesh), tuple(ep_axes))
    if key not in _EP_GROUPS:
        import torch.distributed as dist

        group = mesh[tuple(ep_axes)]._flatten("_".join(ep_axes)).get_group()
        want = next(r for r in _ep_ranks(mesh, ep_axes) if dist.get_rank() in r)
        if dist.get_process_group_ranks(group) != want:
            raise RuntimeError(f"the flattened expert group's ranks {dist.get_process_group_ranks(group)} are not "
                               f"in the expert blocks' order {want}")
        _EP_GROUPS[key] = (mesh, group)
    return _EP_GROUPS[key][1]


def _moe_a2a(cfg: ModelConfig, x2d, experts, gate_w, gate_idx):
    """The reference's ``_moe_a2a`` on DTensors: tokens ``Shard(0)`` over
    every mesh axis (data major), experts ``Shard(0)`` over the ``expert``
    rule's axes; ``y`` comes back in ``x2d``'s placements (a partial sum
    there replicated)."""
    if not isinstance(x2d, DTensor):
        raise TypeError("moe_impl='a2a' under an active mesh needs DTensor activations")
    mesh = current_mesh()
    names = tuple(mesh.mesh_dim_names)
    ep_axes = rules()["expert"]
    ep_axes = (ep_axes,) if isinstance(ep_axes, str) else tuple(ep_axes)
    n_peers = 1
    for a in ep_axes:
        n_peers *= int(mesh.size(names.index(a)))
    e_local = cfg.num_experts // n_peers
    T = x2d.shape[0]
    n_tok_shards = mesh.size()
    Tl = T // n_tok_shards
    cap_send = max(8, int(-(-Tl * cfg.top_k * cfg.capacity_factor // n_peers) // 8 * 8 + 8))
    cap_expert = max(8, int(-(-n_peers * cap_send * cfg.capacity_factor // e_local) // 8 * 8 + 8))

    tok = [Shard(0)] * len(names)
    exp = [Shard(0) if a in ep_axes else Replicate() for a in names]
    exp_grad = [Shard(0) if a in ep_axes else Partial() for a in names]  # summed over the token shards
    ws = [experts[n] for n in ("w_gate", "w_in", "w_out")]
    args = [t.redistribute(mesh, tok) for t in (x2d, gate_w, gate_idx)]
    args += [w.redistribute(mesh, exp) for w in ws]
    body = functools.partial(_a2a_local, cfg=cfg, group=_ep_group(mesh, ep_axes), n_peers=n_peers,
                             e_local=e_local, cap_send=cap_send, cap_expert=cap_expert)
    y = local_map(body, out_placements=tok, in_placements=(tok, tok, tok, exp, exp, exp),
                  in_grad_placements=(tok, tok, tok, exp_grad, exp_grad, exp_grad), device_mesh=mesh)(*args)
    return y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x2d.placements])


def _held_counts(cfg: ModelConfig, gate_idx, router_w):
    """The ``held`` route's bookkeeping, started before the shared expert:
    ``(ids, counts, host, ready)``, each (token, choice) pair's held expert
    (``num_experts_held`` for another chip's expert), the pairs each held
    expert got (and, last, the others) on the device, and those counts
    copied to the host without waiting (``ready``: the CUDA event after the
    copy, or ``None`` where the counts are on the host already). A scatter
    counts them: ``torch.bincount`` would read the largest id on the host
    first, before the shared expert is queued. A forward pass under remat
    keeps its host counts, by the router weight, for the backward pass's
    recompute of the layer, which then copies nothing and checks its own
    counts against them on the device."""
    held = cfg.experts_held
    local = gate_idx.reshape(-1) - cfg.first_expert_held
    ids = torch.where((local >= 0) & (local < held), local, held)
    counts = torch.zeros(held + 1, dtype=ids.dtype, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))
    recompute = torch._C._current_graph_task_id() != -1
    if recompute:
        ref, host, kept = _held_memo.pop(id(router_w), (None, None, None))
        if ref is not None and ref() is router_w:
            torch._assert_async((counts == kept).all())
            return ids, counts, host, None
    if counts.is_cuda:
        host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    else:
        host, ready = counts, None
    if not recompute and cfg.remat != "none" and torch.is_grad_enabled():
        for key in [k for k, (r, _, _) in _held_memo.items() if r() is None]:
            del _held_memo[key]
        _held_memo[id(router_w)] = (weakref.ref(router_w), host, counts)
    return ids, counts, host, ready


def _held_experts(cfg: ModelConfig, x2d, experts, gate_w, pending):
    """The ``held`` route (module docstring): ``(T, d)`` in x2d's dtype, the
    held experts' gated-SiLU outputs of the pairs routed to them, each times
    its float32 gate, summed at its token in float32. ``pending`` is
    :func:`_held_counts`'s; the host waits for the counts' copy alone, where
    there is one (a forward pass's one sync; the card goes on with what was
    queued after it), to learn the number ``n`` of held pairs. The pairs are
    sorted by held expert, each expert's followed by one row of zeros (so
    no group of the grouped products is empty, and every expert's weight
    gradient is written), and cut to those ``n + num_experts_held`` rows;
    one grouped product a weight runs each held expert on its own rows. The
    zero rows stand at index ``T * k`` of the pairs, one past the last: they
    read a zero row of x and a zero gate, and add into a row past the
    tokens that is cut off."""
    global pairs_held, max_load
    ids, counts, host, ready = pending
    if ready is not None:
        ready.synchronize()
    held = cfg.experts_held
    per_expert = host.tolist()[:held]
    n = sum(per_expert)
    # counted before the products: remat's recompute stops at the layer's last saved tensor, in the combine
    pairs_held += n
    max_load = max(max_load, max(per_expert))
    T, k = gate_w.shape
    order = torch.argsort(torch.cat([ids, torch.arange(held, device=ids.device)]), stable=True)
    pairs = order[:n + held].clamp_max(T * k)  # the zero rows' index: T * k
    offs = (counts[:held] + 1).cumsum(0).to(torch.int32)
    xs = F.pad(x2d, (0, 0, 0, 1))[pairs // k]
    h = F.silu(torch._grouped_mm(xs, experts["w_gate"], offs=offs)) * torch._grouped_mm(xs, experts["w_in"], offs=offs)
    ys = torch._grouped_mm(h, experts["w_out"], offs=offs)
    gates = F.pad(gate_w.reshape(-1), (0, 1))[pairs]
    y = torch.zeros((T + 1, ys.shape[1]), dtype=torch.float32, device=ys.device)
    return y.index_add(0, pairs // k, ys.float() * gates[:, None])[:T].to(x2d.dtype)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor, bias: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p: ``{router (d, E), experts {w_gate, w_in, w_out} (E, ...)[, shared
    {...}]}`` (``(num_experts_held, ...)`` experts under ``held``). x
    ``(B, S, d)`` -> ``(y (B, S, d), aux)``; ``bias`` is the sigmoid
    router's selection bias (:func:`route`). The router, the held route and
    the shared expert run in the spans ``moe.route``, ``moe.held`` and
    ``moe.shared`` and their backward spans (:mod:`repro_torch.spans`;
    items tokens)."""
    B, S, d = x.shape
    x2d = whole_rows(x).reshape(B * S, d)
    n = B * S
    impl = cfg.moe_impl
    if cfg.experts_held != cfg.num_experts and impl != "held":
        raise ValueError(f"a layer holding {cfg.experts_held} of {cfg.num_experts} experts runs moe_impl='held', "
                         f"not {impl!r}")
    with span("moe.route", items=n):
        gate_w, gate_idx, aux = route(cfg, mark_backward(x2d, "moe.route.bwd", end=True), p["router"], bias, B)
        gate_w = mark_backward(gate_w, "moe.route.bwd", end=False, items=n)
        pending = _held_counts(cfg, gate_idx, p["router"]) if impl == "held" else None
    shared = None
    if "shared" in p:  # deepseek-style always-on shared expert(s)
        sh = p["shared"]
        with span("moe.shared", items=n):
            xs = mark_backward(x2d, "moe.shared.bwd", end=True)
            shared = linear(F.silu(linear(xs, sh["w_gate"])) * linear(xs, sh["w_in"]), sh["w_out"])
            shared = mark_backward(shared, "moe.shared.bwd", end=False, items=n)

    if impl == "a2a" and current_mesh() is None:
        impl = "dense"
    if impl == "dense":
        y = _moe_dense(cfg, x2d, p["experts"], gate_w, gate_idx)
    elif impl == "einsum":
        y = _moe_einsum(cfg, x2d, p["experts"], gate_w, gate_idx, einsum_capacity(cfg, B * S))
    elif impl == "a2a":
        y = _moe_a2a(cfg, x2d, p["experts"], gate_w, gate_idx)
    elif impl == "held":
        with span("moe.held", items=n):
            y = _held_experts(cfg, mark_backward(x2d, "moe.held.bwd", end=True), p["experts"], gate_w, pending)
            y = mark_backward(y, "moe.held.bwd", end=False, items=n)
    else:
        raise ValueError(cfg.moe_impl)
    if shared is not None:
        y = y + shared
    y = y.reshape(B, S, d)
    return (whole_rows_grad(y) if isinstance(y, DTensor) else y), aux
