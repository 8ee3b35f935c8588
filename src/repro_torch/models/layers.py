"""Shared neural building blocks, ported from the JAX package's
``models/layers.py`` (plain PyTorch, params as nested dicts of tensors).

Conventions as there: activations in the config's compute dtype with float32
normalisation and softmax; heads laid out ``(B, S, H, D)``; weight names
stable (``wq``, ``w_in`` ...), so :mod:`repro_torch.models.convert` maps the
JAX parameter tree one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..kernels.flash_attention import flash_attention, kernel_head_dim
from ..launch.sharding import like, linear

__all__ = [
    "apply_rope",
    "attention",
    "dense_init",
    "gelu",
    "gqa_attention",
    "make_rope",
    "mlp_act",
    "mlp_gated",
    "rms_norm",
    "softcap",
    "squared_relu",
]


# erf(sqrt(2)) = 2 * Phi(2) - 1: the uniform range whose erfinv is a normal
# truncated at +-2 sigma
_TRUNC2 = math.erf(math.sqrt(2.0))


def dense_init(gen: torch.Generator, shape, fan_in=None, dtype=torch.float32, scale: float = 1.0):
    """A normal truncated at +-2 standard deviations, times
    ``scale / sqrt(fan_in)`` (``fan_in`` defaults to ``shape[0]``): the
    distribution of the reference's ``dense_init``. Drawn in float32 on the
    generator's device by inverting the normal CDF, then cast."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = scale / max(fan_in, 1) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device).uniform_(-_TRUNC2, _TRUNC2, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return t.to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + gamma)`` with the variance in float32, cast back
    to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: ``cap * tanh(x / cap)`` in float32."""
    return cap * torch.tanh(x.float() / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def make_rope(positions: torch.Tensor, head_dim: int, base: float = 10000.0):
    """Returns (sin, cos) of shape ``positions.shape + (head_dim // 2,)``."""
    half = head_dim // 2
    freqs = like(positions, base ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half))
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: ``(..., S, H, D)``; sin/cos: ``(..., S, D/2)`` broadcast over heads.
    Rotates split halves (not interleaved pairs)."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    s = sin[..., None, :]  # add the head axis
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA/MQA, causal / sliding-window / prefix-LM / bidirectional,
# optional logit softcap)
# ---------------------------------------------------------------------------


def _build_mask(q_pos, kv_pos, kind: str, window: int = 0, prefix_len=None):
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    if kind == "bidirectional":
        return like(q_pos, torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device))
    if kind == "causal":
        return kp <= qp
    if kind == "sliding":
        return (kp <= qp) & (kp > qp - window)
    if kind == "prefix":
        pl = 0 if prefix_len is None else prefix_len  # None at decode: pure causal
        return (kp <= qp) | (kp < pl)
    raise ValueError(kind)


def _flash_route(q, k, v, kind, prefix_len, kv_valid) -> bool:
    """The reference's conditions for the kernel route
    (``models/layers.py::attention``) that name features the kernel lacks: a
    prefix mask, a cache mask, ``Sq != Sk``. A head dim the kernels are not
    built for (D = 80) takes the kernel route too, as in the reference: the
    wrapper runs it on zero-padded inputs. The reference also refuses
    ``D != Dv``; here a v head dim below q's (MLA's 128 against 192) takes
    the kernel route on v zero-padded to q's (:func:`_flash_bshd`). The reference's
    length conditions (``Sq >= 128``, ``Sq % 128 == 0``) are dropped with its
    fault: there the kernel gets 512-row blocks and a grid of ``Sq // 512``,
    so for ``Sq % 512 != 0`` the rows past the last whole block are never
    written. This kernel masks ragged tiles itself and computes every row of
    every length."""
    return (
        kind in ("causal", "sliding", "bidirectional")
        and prefix_len is None and kv_valid is None
        and q.shape[1] == k.shape[1]
        and v.shape[-1] <= q.shape[-1]
    )


def _flash_bshd(q, k, v, kind, window, softcap, scale):
    """:func:`flash_attention` on ``(B, S, H, D)`` layouts. A v head dim
    ``Dv`` below q's ``D`` is zero-padded: zero columns of v give zero
    output columns, which are cut off, and their gradient is cut off in
    turn. On the card q, k and v are padded at once to the kernel instance's
    head dim (:func:`kernel_head_dim`: MLA's 192 runs at 256), so v is
    copied once; the softmax scale stays ``D ** -0.5`` of the true D unless
    given."""
    D, Dv = q.shape[-1], v.shape[-1]
    if Dv < D:
        Dk = kernel_head_dim(D) if q.device.type == "cuda" else D
        padded = (x if x.shape[-1] == Dk else F.pad(x, (0, Dk - x.shape[-1])) for x in (q, k, v))
        return _flash_bshd(*padded, kind, window, softcap, D ** -0.5 if scale is None else scale)[..., :Dv]
    o, _ = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kind, window, softcap, scale)
    return o.transpose(1, 2)


def _local_extent(n: int, mesh, placements, dim: int):
    """``(size, offset)`` of this rank's piece of a dim of global length
    ``n`` that ``placements`` shard (DTensor's split: pieces of
    ``ceil(len / ways)``, nested in mesh-dim order), from the mesh's
    coordinate as Python ints. DTensor's own helper reads the coordinate
    from a tensor, which a fake tensor cannot give (the dry run's fake
    process group)."""
    from torch.distributed.tensor import Shard

    coord, size, off = mesh.get_coordinate(), n, 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = -(-size // mesh.size(i))
            start = min(piece * coord[i], size)
            size, off = min(piece, size - start), off + start
    return size, off


def _attention_local_map(q, k, v, kv_valid, masks, local_attention):
    """Attention on DTensors: each rank runs ``local_attention(q, k, v,
    kv_valid, *masks)`` (the one-device :func:`attention`, either route) on
    its local shards under ``local_map``, as the reference's attention runs
    per shard under GSPMD. q may be sharded on batch (dim 0) and heads
    (dim 2), as the ``shard`` calls before it place it; k and v are
    redistributed to q's placements, except on a mesh dim where q's heads
    are sharded and the KV heads do not divide it (GQA with replicated KV).
    There local head ``h`` is global head ``off + h``, whose KV head is
    ``(off + h) // G``, so the body gets the KV heads its q heads use, and
    k's and v's gradients on that mesh dim are partial sums. ``kv_valid``
    follows q's batch; the mask positions (``masks``) are replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, H, Hkv = q.device_mesh, q.shape[2], k.shape[2]
    qp = list(q.placements)
    if any(p not in (Replicate(), Shard(0), Shard(2)) for p in qp):
        raise ValueError(f"attention on a mesh: q must be sharded on batch and heads only, got {qp}")
    kp, kgp, remap = [], [], False
    for i, p in enumerate(qp):
        remap_dim = p == Shard(2) and Hkv % mesh.size(i) != 0
        remap |= remap_dim
        kp.append(Replicate() if remap_dim else p)
        kgp.append(Partial() if remap_dim else p)
    bp = [p if p == Shard(0) else Replicate() for p in qp]
    Hl, off = _local_extent(H, mesh, qp, 2)
    G = H // Hkv

    def body(ql, kl, vl, valid, *mask_args):
        if remap:
            if Hl % G == 0 and off % G == 0:  # whole groups: KV heads [off / G, (off + Hl) / G)
                kl, vl = (x.narrow(2, off // G, Hl // G) for x in (kl, vl))
            else:  # one KV head for each local q head
                idx = (off + torch.arange(Hl, device=kl.device)) // G
                kl, vl = (x.index_select(2, idx) for x in (kl, vl))
        return local_attention(ql, kl, vl, valid, *mask_args)

    mask_pl = [[Replicate()] * mesh.ndim if isinstance(m, DTensor) else None for m in masks]
    valid_pl = bp if isinstance(kv_valid, DTensor) else None
    in_pl = (qp, kp, kp, valid_pl, *mask_pl)
    return local_map(body, out_placements=qp, in_placements=in_pl, in_grad_placements=(qp, kgp, kgp, *in_pl[3:]),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, kv_valid, *masks)


def _attention_seq_sharded(q, k, v, q_pos, kv_pos, kind, window, prefix_len, attn_softcap, scale):
    """Attention over a key/value cache split on its sequence dim (the
    long-context decode cache), without gathering it: each rank forms the
    float32 scores of its block of slots, the row maxima are combined by a
    max and the exponentials' sums and the unnormalised outputs by a sum
    over the mesh dims that split the sequence, as the plain route's
    softmax would form them over the whole row. A head-dim split of the
    cache (``cache_pspecs`` puts "model" there when the KV heads do not
    divide it) is taken up by q too, and its partial scores are summed over
    that mesh dim; a KV-head split splits q's heads alike; batch shards
    stay. No gradient: a decode step."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, kp = k.device_mesh, list(k.placements)
    qp = [Replicate() if p == Shard(1) else p for p in kp]
    seq = [mesh.get_group(i) for i, p in enumerate(kp) if p == Shard(1)]
    hd = [mesh.get_group(i) for i, p in enumerate(kp) if p == Shard(3)]
    scale = q.shape[-1] ** -0.5 if scale is None else scale

    def body(ql, kl, vl, qpos, kvpos, pl):
        B, Sq, H, D = ql.shape
        Hkv = kl.shape[2]
        qf = (ql * scale).float().reshape(B, Sq, Hkv, H // Hkv, D)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kl.float())
        for g in hd:
            dist.all_reduce(logits, group=g)
        if attn_softcap:
            logits = softcap(logits, attn_softcap)
        mask = _build_mask(qpos, kvpos, kind, window, pl)[None, None, None]
        logits = logits.masked_fill(~mask, -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        for g in seq:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(logits - m)
        total = e.sum(dim=-1)  # (B, Hkv, G, Sq)
        out = torch.einsum("bhgqk,bkhd->bqhgd", e, vl.float())
        for g in seq:
            dist.all_reduce(total, group=g)
            dist.all_reduce(out, group=g)
        out = out / total.permute(0, 3, 1, 2)[..., None]
        return out.reshape(B, Sq, H, vl.shape[-1]).to(vl.dtype)

    rep = [Replicate()] * mesh.ndim
    kv_pos_pl = [Shard(0) if p == Shard(1) else Replicate() for p in kp]
    pl_pl = rep if isinstance(prefix_len, DTensor) else None
    with torch.no_grad():
        return local_map(body, out_placements=qp, in_placements=(qp, kp, kp, rep, kv_pos_pl, pl_pl), device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v, q_pos, kv_pos, prefix_len)


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    kind: str = "causal",
    window: int = 0,
    prefix_len: Optional[torch.Tensor] = None,
    attn_softcap: float = 0.0,
    kv_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool: cache validity
    scale: Optional[float] = None,
    block_q: int = 0,
    impl: str = "plain",
) -> torch.Tensor:
    """Grouped-query attention. Returns ``(B, Sq, H, Dv)``.

    ``impl="flash"`` routes full self-attention (causal / sliding /
    bidirectional, no prefix, no cache mask, ``Sq == Sk`` of any length,
    ``Dv <= D``) through the flash-attention kernel
    (:func:`repro_torch.kernels.flash_attention.flash_attention`), whose
    output carries a gradient through the backward kernels; everything else
    takes the plain route. ``block_q`` does not apply to the kernel, whose q
    tile is fixed.

    Plain route: ``block_q > 0`` loops over query blocks so the score tensor
    is bounded at ``(B, H, block_q, Sk)`` (exact: each block sees the full
    key row); otherwise one dense einsum/softmax, with the probabilities cast
    to v's dtype before the value product, as the reference does.

    On DTensors either route runs on each rank's local shards
    (:func:`_attention_local_map`).
    """
    if isinstance(k, DTensor) and any(p.is_shard(1) for p in k.placements) and kv_valid is None:
        return _attention_seq_sharded(q, k, v, q_pos, kv_pos, kind, window, prefix_len, attn_softcap, scale)
    if isinstance(q, DTensor):
        def local_attention(ql, kl, vl, valid, qp, kvp, pl):
            return attention(ql, kl, vl, q_pos=qp, kv_pos=kvp, kind=kind, window=window, prefix_len=pl,
                             attn_softcap=attn_softcap, kv_valid=valid, scale=scale, block_q=block_q, impl=impl)

        return _attention_local_map(q, k, v, kv_valid, (q_pos, kv_pos, prefix_len), local_attention)
    B, Sq, H, D = q.shape
    if impl == "flash" and _flash_route(q, k, v, kind, prefix_len, kv_valid):
        return _flash_bshd(q, k, v, kind, window, attn_softcap, scale)
    if impl not in ("plain", "flash"):
        raise ValueError(f"impl must be 'plain' or 'flash', got {impl!r}")
    if block_q and Sq > block_q:
        outs = [
            attention(
                q[:, i:i + block_q], k, v, q_pos=q_pos[i:i + block_q], kv_pos=kv_pos, kind=kind,
                window=window, prefix_len=prefix_len, attn_softcap=attn_softcap,
                kv_valid=kv_valid, scale=scale, block_q=0,
            )
            for i in range(0, Sq, block_q)
        ]
        return torch.cat(outs, dim=1)
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf = (q * scale).float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if attn_softcap:
        logits = softcap(logits, attn_softcap)
    mask = _build_mask(q_pos, kv_pos, kind, window, prefix_len)[None, None, None]  # (1, 1, 1, Sq, Sk)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def gqa_attention(params, x, cfg_heads, *, rope_sincos, kind="causal", window=0, prefix_len=None,
                  attn_softcap=0.0, query_pre_scale=None):
    """Projection, RoPE, attention and out-projection for the common case.

    params: ``{wq (d, H, hd), wk (d, Hkv, hd), wv (d, Hkv, hd), wo (H, hd,
    d)}``; ``x (B, S, d)``; ``cfg_heads = (H, Hkv, hd)``; ``rope_sincos``
    the ``(sin, cos)`` of :func:`make_rope` at positions ``0..S-1``.
    Returns ``(B, S, d)``."""
    H, Hkv, hd = cfg_heads
    sin, cos = rope_sincos
    B, S, d = x.shape

    def proj(w, heads):
        return linear(x, w.reshape(d, heads * hd)).reshape(B, S, heads, hd)

    q = apply_rope(proj(params["wq"], H), sin, cos)
    k = apply_rope(proj(params["wk"], Hkv), sin, cos)
    v = proj(params["wv"], Hkv)
    pos = torch.arange(S, device=x.device)
    out = attention(q, k, v, q_pos=pos, kv_pos=pos, kind=kind, window=window, prefix_len=prefix_len,
                    attn_softcap=attn_softcap, scale=query_pre_scale)
    return linear(out.reshape(B, S, H * hd), params["wo"].reshape(H * hd, d))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    r = torch.relu(x)
    return r * r


def mlp_gated(params, x, act=F.silu):
    """SwiGLU-style: ``(act(x W_gate) * x W_in) W_out``."""
    h = act(linear(x, params["w_gate"])) * linear(x, params["w_in"])
    return linear(h, params["w_out"])


def mlp_act(params, x, act):
    """Plain two-matrix MLP with activation (gelu / squared-relu / ...)."""
    return linear(act(linear(x, params["w_in"])), params["w_out"])
