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

All share the router: softmax, top-k, renormalise, and the switch-style
load-balance auxiliary loss. The top k come from a stable descending sort,
so among equal probabilities the lower expert index comes first, as
``jax.lax.top_k`` orders them: ``torch.topk`` promises no order for ties,
and the order decides the einsum dispatch's slot positions and with them
which tokens the capacity drops.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..launch.sharding import current_mesh, linear, mesh_shape, no_batch_product, rules, whole_rows, whole_rows_grad

__all__ = ["einsum_capacity", "moe_ffn", "route"]


def route(cfg: ModelConfig, x2d: torch.Tensor, router_w: torch.Tensor):
    """x2d ``(T, d)`` -> ``(gate_w (T, k) float32, gate_idx (T, k) int64,
    aux)``, the router in float32. On DTensors the top k are taken on each
    rank's rows under ``local_map``, the experts whole (the sort is an
    index-style op: torch 2.11's DTensor cannot run its backward, whose
    scatter meets a plain tensor)."""
    probs = torch.softmax(linear(x2d.float(), router_w.float()), dim=-1)
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


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """p: ``{router (d, E), experts {w_gate, w_in, w_out} (E, ...)[, shared
    {...}]}``. x ``(B, S, d)`` -> ``(y (B, S, d), aux)``."""
    B, S, d = x.shape
    x2d = whole_rows(x).reshape(B * S, d)
    gate_w, gate_idx, aux = route(cfg, x2d, p["router"])

    impl = cfg.moe_impl
    if impl == "a2a" and current_mesh() is None:
        impl = "dense"
    if impl == "dense":
        y = _moe_dense(cfg, x2d, p["experts"], gate_w, gate_idx)
    elif impl == "einsum":
        y = _moe_einsum(cfg, x2d, p["experts"], gate_w, gate_idx, einsum_capacity(cfg, B * S))
    elif impl == "a2a":
        y = _moe_a2a(cfg, x2d, p["experts"], gate_w, gate_idx)
    else:
        raise ValueError(cfg.moe_impl)

    if "shared" in p:  # deepseek-style always-on shared expert(s)
        sh = p["shared"]
        y = y + linear(F.silu(linear(x2d, sh["w_gate"])) * linear(x2d, sh["w_in"]), sh["w_out"])
    y = y.reshape(B, S, d)
    return (whole_rows_grad(y) if isinstance(y, DTensor) else y), aux
