"""Dense decoder LMs (llama family: deepseek-7b, granite-20b with MQA,
minitron-8b with its squared-ReLU MLP; gemma2-2b with its local/global
alternation, softcaps and post-norms): the forward, the loss and the KV-cache
decode of the JAX package's ``models/dense.py``.

Parameters are a dict ``{"emb", "layers", "ln_f"[, "lm_head"]}`` whose
``"layers"`` is a list with one dict per layer, in order; the JAX package's
``(n_groups, period, ...)`` stack maps onto it as layer ``g * period + sub``
(:func:`repro_torch.models.convert.params_from_jax`). The stack is a Python
loop over groups of ``period`` layers with ``kind = pattern[sub]``; under
``cfg.remat == "full"`` or ``"dots"`` each group is checkpointed, as the
reference checkpoints its scan body (:func:`_maybe_remat`). The reference's ``shard`` calls stand at the
same points (:func:`repro_torch.launch.sharding.shard`): the identity
without a mesh, a DTensor redistribution under one.

The decode cache is a pair ``(k, v)`` of tensors ``(L, B, S_max, Hkv, hd)``
with one leading layer axis (the reference's ``(n_groups, period)`` axes
flattened the same way as the parameters). Unlike the reference, whose
``dynamic_update_slice`` returns new arrays, a decode step writes the new
keys and values into the cache's storage and returns the same tensors: a
functional copy would move the whole cache every token. A caller that needs
the cache of an earlier step keeps a clone.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ModelConfig
from ..core.torch_dp import resolve_device
from ..launch.sharding import axis_size, in_no_batch_product, like, linear, shard, whole_groups
from ..spans import mark_backward, span
from .layers import (_local_extent, apply_rope, attention, dense_init, gelu, make_rope, mlp_act, mlp_gated, rms_norm,
                     softcap, squared_relu)

__all__ = [
    "attn_pattern",
    "cross_entropy",
    "dense_forward",
    "dense_init",
    "dense_loss",
    "decode_position",
    "dense_decode_step",
    "init_dense",
    "init_dense_cache",
    "init_layer_stack",
    "layer_apply",
    "stack_decode",
    "stack_forward",
    "write_cache",
]

def attn_pattern(cfg: ModelConfig):
    if cfg.attn_kind == "local_global":
        if cfg.long_context:  # 500k serving mode: all layers sliding-window
            return ("sliding", "sliding")
        return ("sliding", "causal")
    if cfg.attn_kind == "bidirectional":
        return ("bidirectional",)
    if cfg.attn_kind == "prefix":
        return ("prefix",)
    return ("causal",)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, gen: torch.Generator):
    d, H, Hkv, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff
    pd, dev = cfg.pdtype(), gen.device
    p = {
        "ln1": torch.zeros((d,), dtype=pd, device=dev),
        "ln2": torch.zeros((d,), dtype=pd, device=dev),
        "attn": {
            "wq": dense_init(gen, (d, H, hd), fan_in=d, dtype=pd),
            "wk": dense_init(gen, (d, Hkv, hd), fan_in=d, dtype=pd),
            "wv": dense_init(gen, (d, Hkv, hd), fan_in=d, dtype=pd),
            "wo": dense_init(gen, (H, hd, d), fan_in=H * hd, dtype=pd),
        },
    }
    if cfg.mlp_kind in ("gated_silu", "gated_gelu"):
        p["mlp"] = {
            "w_gate": dense_init(gen, (d, f), dtype=pd),
            "w_in": dense_init(gen, (d, f), dtype=pd),
            "w_out": dense_init(gen, (f, d), fan_in=f, dtype=pd),
        }
    else:  # plain activation MLP (squared_relu / gelu)
        p["mlp"] = {
            "w_in": dense_init(gen, (d, f), dtype=pd),
            "w_out": dense_init(gen, (f, d), fan_in=f, dtype=pd),
        }
    if cfg.attn_kind == "local_global":  # gemma2 post-norms
        p["ln1b"] = torch.zeros((d,), dtype=pd, device=dev)
        p["ln2b"] = torch.zeros((d,), dtype=pd, device=dev)
    return p


def init_layer_stack(cfg: ModelConfig, gen: torch.Generator, init_one=None):
    """The reference's stacked layers: every leaf of ``init_one(cfg, gen)``
    (default: one dense layer) stacked on ``(n_groups, period)`` leading
    axes, layer ``g * period + sub`` at ``[g, sub]``, drawn in layer order
    (so equal to :func:`init_dense`'s ``"layers"`` list, stacked, from the
    same generator state)."""
    init_one = init_one or _init_layer
    period = len(attn_pattern(cfg))
    n_groups = cfg.num_layers // period
    layers = [init_one(cfg, gen) for _ in range(n_groups * period)]

    def stack(xs):
        if isinstance(xs[0], dict):
            return {k: stack([x[k] for x in xs]) for k in xs[0]}
        return torch.stack(xs).reshape(n_groups, period, *xs[0].shape)

    return stack(layers)


def init_dense(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters on the generator's device, drawn in a fixed order
    (embedding, layers 0..L-1, head)."""
    pd = cfg.pdtype()
    params = {
        "emb": dense_init(gen, (cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model, dtype=pd),
        "layers": [_init_layer(cfg, gen) for _ in range(cfg.num_layers)],
        "ln_f": torch.zeros((cfg.d_model,), dtype=pd, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=pd)
    return params


# ---------------------------------------------------------------------------
# layer body and stack
# ---------------------------------------------------------------------------


def _mlp(cfg: ModelConfig, p, x):
    x = shard(x, "batch", None, None)
    if cfg.mlp_kind == "gated_silu":
        return mlp_gated(p, x, F.silu)
    if cfg.mlp_kind == "gated_gelu":
        return mlp_gated(p, x, gelu)
    if cfg.mlp_kind == "squared_relu":
        return mlp_act(p, x, squared_relu)
    return mlp_act(p, x, gelu)


def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    w2 = w.reshape(w.shape[0], -1)
    if isinstance(w2, DTensor):  # heads split evenly, or replicated
        w2 = whole_groups(w2, 1, w.shape[1])
        return whole_groups(linear(x, w2), -1, w.shape[1]).reshape(*x.shape[:-1], *w.shape[1:])
    return linear(x, w2).reshape(*x.shape[:-1], *w.shape[1:])


def _out_proj(out, wo):
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matrix product."""
    return linear(out.reshape(*out.shape[:2], -1), wo.reshape(-1, wo.shape[-1]))


def decode_position(pos, device) -> torch.Tensor:
    """The decode position as a 0-d int64 tensor on ``device``: a Python
    int becomes one by a fill on the device (no copy from the host, so no
    wait on the card), a tensor is moved there."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long)
    return torch.full((), int(pos), dtype=torch.long, device=device)


def write_cache(cache: torch.Tensor, x: torch.Tensor, write_pos: torch.Tensor) -> torch.Tensor:
    """Writes ``x (B, Sq, ...)`` into ``cache (B, S_max, ...)`` at rows
    ``write_pos .. write_pos + Sq - 1``, in place, and returns ``cache``. The
    start is clamped to ``[0, S_max - Sq]``, as ``dynamic_update_slice``
    clamps it. A DTensor cache is written on each rank's local shard; one
    split on its sequence dim (``cache_pspecs``' long-context case) takes on
    each rank the rows that fall in its block of slots (:func:`_write_block`)."""
    Sq, S_max = x.shape[1], cache.shape[1]
    idx = write_pos.clamp(0, S_max - Sq) + like(write_pos, torch.arange(Sq, device=cache.device))
    if isinstance(cache, DTensor):
        x = x.to(cache.dtype).redistribute(cache.device_mesh, _off_seq(cache.placements))
        if Shard(1) in cache.placements:
            return _on_cache_shards(functools.partial(_write_block, start=_block_start(cache)), cache, idx, x)
        return _on_cache_shards(lambda c, i, xl: c.index_copy_(1, i, xl), cache, idx, x)
    return cache.index_copy_(1, idx, x.to(cache.dtype))


def _off_seq(placements) -> list:
    """``placements`` with the sequence dim's shards (``Shard(1)``) replicated."""
    return [Replicate() if p == Shard(1) else p for p in placements]


def _block_start(cache) -> int:
    """The first global slot of this rank's block of ``cache``'s sequence dim."""
    return _local_extent(cache.shape[1], cache.device_mesh, cache.placements, 1)[1]


def _write_block(c, i, xl, start):
    """The local body of a write into a cache split on its sequence dim:
    ``c`` holds global slots ``[start, start + len)``; row ``r`` of ``xl``
    goes to global slot ``i[r]``. One row (a decode step) is written where
    it falls in the block, else its clamped slot gets its own value back, so
    no rank moves its block. Several rows (a prefill into the cache) are
    written by one pass over the block, each slot taking the row that lands
    on it."""
    n = c.shape[1]
    if xl.shape[1] == 1:
        j = i - start
        inside = ((j >= 0) & (j < n)).view((1, -1) + (1,) * (c.dim() - 2))
        j = j.clamp(0, n - 1)
        return c.index_copy_(1, j, torch.where(inside, xl, c.index_select(1, j)))
    r = torch.arange(start, start + n, device=c.device) - i[0]
    inside = ((r >= 0) & (r < xl.shape[1])).view((1, -1) + (1,) * (c.dim() - 2))
    return c.copy_(torch.where(inside, xl.index_select(1, r.clamp(0, xl.shape[1] - 1)), c))


def _window_select(cache, idx):
    """``cache.index_select(1, idx)`` of a DTensor cache, the selected slots
    replicated on the sequence dim: each rank selects the slots it owns and
    zeros the rest, and a sum over the mesh dims that split the sequence
    gives every rank the window (``idx`` is small: the sliding window's
    slots; the cache itself stays where it is)."""
    pl = list(cache.placements)
    if Shard(1) not in pl:
        return _on_cache_shards(lambda c, i: c.index_select(1, i), cache, idx)
    start = _block_start(cache)

    def select(c, i):
        j = i - start
        inside = ((j >= 0) & (j < c.shape[1])).view((1, -1) + (1,) * (c.dim() - 2))
        return c.index_select(1, j.clamp(0, c.shape[1] - 1)) * inside.to(c.dtype)

    mesh = cache.device_mesh
    out = local_map(select, out_placements=[Partial() if p == Shard(1) else p for p in pl],
                    in_placements=(pl, [Replicate()] * mesh.ndim), device_mesh=mesh)(cache, idx)
    return out.redistribute(mesh, _off_seq(pl))


def _on_cache_shards(op, cache, idx, *xs):
    """``op(cache, idx, *xs)`` on each rank's local shards (``local_map``),
    for the cache ops along the sequence dim (1) that have no sharding rule
    in every torch version (``index_copy_``, ``index_select``): ``xs`` in
    the cache's placements with the sequence dim replicated, ``idx``
    replicated; the cache is not redistributed, so an in-place op writes
    its local storage."""
    mesh, pl = cache.device_mesh, list(cache.placements)
    rep = [Replicate()] * mesh.ndim
    return local_map(op, out_placements=pl, in_placements=(pl, rep) + (_off_seq(pl),) * len(xs),
                     device_mesh=mesh)(cache, idx, *xs)


def layer_apply(cfg: ModelConfig, p, h, kind: str, rope_sincos, *, q_pos, kv_pos, cache_kv=None, write_pos=None,
                prefix_len=None):
    """One transformer block. Returns ``(h, new_kv)``: without a cache the
    fresh ``(k, v)`` of this call (after RoPE), with ``cache_kv = (k_cache,
    v_cache)`` (each ``(B, S_max, Hkv, hd)``) and ``write_pos`` (a 0-d
    tensor) the caches, with this call's keys and values written at
    ``write_pos`` in place.

    Decoding one token through a ``"sliding"`` layer of a cache longer than
    twice the window attends only to the ``window`` slots ending at
    ``write_pos`` (start clipped to ``[0, S_max - window]``), as the
    reference's long-context branch does. ``prefix_len`` (a ``"prefix"``
    layer's bidirectional prefix, PaliGemma's image patches) goes to
    :func:`repro_torch.models.layers.attention`, which takes the plain route
    under it, as the reference does."""
    sin, cos = rope_sincos
    kv_heads_spec = "tensor" if cfg.num_kv_heads % max(axis_size("tensor"), 1) == 0 else None
    a_in = rms_norm(h, p["ln1"])
    q = shard(apply_rope(_proj(a_in, p["attn"]["wq"]), sin, cos), "batch", None, "tensor", None)
    k = shard(apply_rope(_proj(a_in, p["attn"]["wk"]), sin, cos), "batch", None, kv_heads_spec, None)
    v = shard(_proj(a_in, p["attn"]["wv"]), "batch", None, kv_heads_spec, None)

    if cache_kv is not None and write_pos is not None:
        k_cache, v_cache = (write_cache(c, x, write_pos) for c, x in zip(cache_kv, (k, v)))
        k_use, v_use, kv_pos_use = k_cache, v_cache, kv_pos
        new_kv = (k_cache, v_cache)
        S_max = k_cache.shape[1]
        if kind == "sliding" and q.shape[1] == 1 and S_max > 2 * cfg.window:
            start = (write_pos - cfg.window + 1).clamp(0, S_max - cfg.window)
            kv_pos_use = start + like(start, torch.arange(cfg.window, device=h.device))
            if isinstance(k_cache, DTensor):
                k_use, v_use = (_window_select(c, kv_pos_use) for c in (k_cache, v_cache))
            else:
                k_use, v_use = k_cache.index_select(1, kv_pos_use), v_cache.index_select(1, kv_pos_use)
    else:
        k_use, v_use, kv_pos_use = k, v, kv_pos
        new_kv = (k, v)

    out = attention(
        q, k_use, v_use,
        q_pos=q_pos, kv_pos=kv_pos_use, kind=kind, window=cfg.window, prefix_len=prefix_len,
        attn_softcap=cfg.attn_softcap, block_q=cfg.attn_block_q, impl=cfg.attn_impl,
    )
    # head-parallel -> sequence-parallel handoff before the output projection
    out = shard(out, "batch", "act_seq", None, None)
    attn_out = _out_proj(out, p["attn"]["wo"])
    if "ln1b" in p:
        attn_out = rms_norm(attn_out, p["ln1b"])
    h = h + attn_out

    mlp_out = _mlp(cfg, p["mlp"], rms_norm(h, p["ln2"]))
    if "ln2b" in p:
        mlp_out = rms_norm(mlp_out, p["ln2b"])
    return shard(h + mlp_out, "batch", "act_seq", None), new_kv


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, func, *args, **kwargs):
    """The policy of ``remat="dots"``, the reference's
    ``checkpoint_dots_with_no_batch_dims``: save the output of every matrix
    product with no batch dims, recompute everything else. Which aten op a
    product reaches does not tell (a projection reaches ``mm``, or ``bmm``
    on a weight broadcast over a batch that ``matmul`` could not fold; an
    einsum without batch dims reaches ``bmm`` with a batch of one), so the
    products the reference writes without batch dims are marked where they
    are written (:func:`repro_torch.launch.sharding.no_batch_product`:
    ``linear``, the MoE dispatches' gathers); attention's and the SSM
    cells' batched products, and the MoE experts' products batched over
    the experts, are recomputed. On DTensors the policy sees the DTensor
    op (the mode runs above DTensor's dispatch), so a saved product keeps
    its DTensor output and the redistributions before it are recomputed."""
    if func in _PRODUCTS and in_no_batch_product():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` under ``torch.utils.checkpoint`` (not reentrant) when grad
    mode is on, as the reference wraps its scan body in ``jax.checkpoint``:
    ``remat="full"`` keeps only its inputs and runs it again in the backward
    pass (``nothing_saveable``); ``remat="dots"`` also keeps the output of
    every product with no batch dims (:func:`_save_dots`, through
    ``create_selective_checkpoint_contexts``), and the backward pass
    recomputes the rest from those. Without grad mode there is nothing to
    recompute. The layers draw no random numbers, so no RNG state is
    stashed."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, **kw)


def stack_forward(cfg: ModelConfig, layers, h, *, prefix_len=None, collect_cache=False):
    """The layer stack over the full sequence, in groups of
    ``period = len(attn_pattern(cfg))`` layers (the reference's scan body);
    sublayer ``sub`` of a group has attention kind ``attn_pattern(cfg)[sub]``
    (``prefix_len``: see :func:`layer_apply`). Returns ``(h, caches)``: with
    ``collect_cache`` the pair ``(k, v)`` of every layer's keys and values
    after RoPE, stacked ``(L, B, S, Hkv, hd)`` as a decode cache is laid
    out, else ``None``."""
    S = h.shape[1]
    pattern = attn_pattern(cfg)
    pos = like(h, torch.arange(S, device=h.device))
    rope = make_rope(pos, cfg.hd, cfg.rope_base)

    def group_body(h, group):
        kvs = []
        for kind, p in zip(pattern, group):
            h, kv = layer_apply(cfg, p, h, kind, rope, q_pos=pos, kv_pos=pos, prefix_len=prefix_len)
            kvs.append(kv if collect_cache else None)
        return h, kvs

    body = _maybe_remat(cfg, group_body)
    kvs = []
    for g in range(0, len(layers), len(pattern)):
        h, group_kvs = body(h, layers[g:g + len(pattern)])
        kvs += group_kvs
    if not collect_cache:
        return h, None
    return h, tuple(torch.stack(xs) for xs in zip(*kvs))


def stack_decode(cfg: ModelConfig, layers, h, cache, pos):
    """One decode step through the stack: ``h (B, Sq, d)`` at positions
    ``pos ..`` against ``cache = (k, v)``, each ``(L, B, S_max, Hkv, hd)``,
    which it updates in place. Returns ``(h, cache)``."""
    pattern = attn_pattern(cfg)
    k_all, v_all = cache
    pos = like(h, decode_position(pos, h.device))
    q_pos = pos[None]
    kv_pos = like(h, torch.arange(k_all.shape[2], device=h.device))
    rope = make_rope(q_pos, cfg.hd, cfg.rope_base)
    for i, p in enumerate(layers):
        h, _ = layer_apply(cfg, p, h, pattern[i % len(pattern)], rope, q_pos=q_pos, kv_pos=kv_pos,
                           cache_kv=(k_all[i], v_all[i]), write_pos=pos)
    return h, cache


# ---------------------------------------------------------------------------
# public model API
# ---------------------------------------------------------------------------


def _rows(table, ids):
    """``table[ids]``; on DTensors under ``local_map``: the table
    replicated, each rank looking up its own ids (placed as ``ids``), the
    table's gradient summed over the mesh dims that split the ids. Only
    redistributions and a local lookup, so no sharding rule of the index
    ops is needed."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = ids.redistribute(mesh, [Replicate() if p.is_partial() else p for p in ids.placements])
    ip = list(ids.placements)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in ip]
    return local_map(lambda t, i: t[i], out_placements=ip, in_placements=([Replicate()] * mesh.ndim, ip),
                     in_grad_placements=(grad, ip), device_mesh=mesh, redistribute_inputs=True)(table, ids)


def _embed(cfg: ModelConfig, params, tokens):
    h = _rows(params["emb"], tokens).to(cfg.cdtype())
    if cfg.scale_embedding:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return shard(h, "batch", "act_seq", None)


def _logits(cfg: ModelConfig, params, h):
    """Float32 logits ``(B, S, V)``. Without grad mode the softcap runs in
    place on the float32 copy, so at most one compute-dtype and one float32
    logit tensor are alive (the values are those of ``softcap(logits, cap)``);
    with grad mode it runs out of place, since autograd keeps tanh's output
    for the backward pass and an in-place multiply would overwrite it."""
    h = rms_norm(h, params["ln_f"])
    head = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
    logits = shard(linear(h, head.to(h.dtype)), "batch", None, "tensor")  # before the in-place softcap
    if not cfg.logit_softcap:
        return logits.float()
    if torch.is_grad_enabled():
        return softcap(logits, cfg.logit_softcap)
    return logits.float().div_(cfg.logit_softcap).tanh_().mul_(cfg.logit_softcap)


def _hidden(params, cfg: ModelConfig, tokens, *, prefix_len=None, collect_cache=False):
    """The embedding and the stack over tokens ``(B, S)``: ``(h, caches)``
    (:func:`stack_forward`), in the spans ``model.embed`` and
    ``model.stack`` and their backward spans (:mod:`repro_torch.spans`)."""
    n = tokens.numel()
    with span("model.embed", items=n):
        table = mark_backward(params["emb"], "model.embed.bwd", end=True)
        h = mark_backward(_embed(cfg, {**params, "emb": table}, tokens), "model.embed.bwd", end=False, items=n)
    with span("model.stack", items=n):
        h = mark_backward(h, "model.stack.bwd", end=True)
        h, caches = stack_forward(cfg, params["layers"], h, prefix_len=prefix_len, collect_cache=collect_cache)
        return mark_backward(h, "model.stack.bwd", end=False, items=n), caches


def dense_forward(params, cfg: ModelConfig, tokens, *, prefix_len=None, collect_cache=False):
    """tokens ``(B, S)`` -> ``(logits, caches)``: float32 logits ``(B, S,
    V)`` and, with ``collect_cache``, every layer's ``(k, v)``
    (:func:`stack_forward`), else ``None``."""
    h, caches = _hidden(params, cfg, tokens, prefix_len=prefix_len, collect_cache=collect_cache)
    return _logits(cfg, params, h), caches


def init_dense_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zero caches ``(k, v)``, each ``(L, B, max_len, Hkv, hd)`` in the
    compute dtype, on ``device``."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=cfg.cdtype(), device=dev), torch.zeros(shape, dtype=cfg.cdtype(), device=dev))


def dense_decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """tokens ``(B, 1)``; ``pos`` a Python int or 0-d integer tensor.
    Returns ``(logits (B, 1, V), cache)``, the cache updated in place."""
    h = _embed(cfg, params, tokens)
    h, cache = stack_decode(cfg, params["layers"], h, cache, pos)
    return _logits(cfg, params, h), cache


class _NLL(torch.autograd.Function):
    """Per-position negative log-likelihood ``logsumexp(x - m) - (x - m)[t]``
    of float32 logits ``x (B, S, V)`` with ``m`` the row maximum, as the
    reference forms it, with its gradient ``(softmax(x) - onehot(t)) * g``
    written out. Autograd through the same expression would keep ``x - m``
    for the logsumexp and, in the backward pass, build the gather's
    zero-filled gradient and the logsumexp's exponentials as further
    ``(B, S, V)`` float32 tensors (at gemma2-2b's vocabulary and S = 8,192
    each is 8.4 GB). This keeps ``x`` and the row terms, and each pass builds
    one such tensor."""

    @staticmethod
    def forward(ctx, x, targets):
        m = x.amax(dim=-1, keepdim=True)
        shifted = x - m
        at_target = shifted.gather(-1, targets[..., None]).squeeze(-1)
        lse = shifted.exp_().sum(dim=-1).log_()
        ctx.save_for_backward(x, targets, m, lse)
        return lse - at_target

    @staticmethod
    def backward(ctx, g):
        x, targets, m, lse = ctx.saved_tensors
        grad = (x - m).sub_(lse[..., None]).exp_().mul_(g[..., None])
        return grad.scatter_add_(-1, targets[..., None], -g[..., None]), None


def _nll_by_rows(x, targets):
    """:class:`_NLL` of the DTensor logits ``x (B, S, V)`` under
    ``local_map``, with the mesh dims that shard the vocab moved to the
    sequence."""
    mesh = x.device_mesh
    rows = [Shard(1) if p == Shard(2) else p for p in x.placements]
    x, targets = x.redistribute(mesh, rows), targets.redistribute(mesh, rows)
    return local_map(_NLL.apply, out_placements=rows, in_placements=(rows, rows), device_mesh=mesh)(x, targets)


def cross_entropy(logits, targets, valid=None):
    """Mean next-token negative log-likelihood in float32, over all
    positions or, with ``valid``, over the valid ones. The reference takes
    ``(x - m)[target]`` as a one-hot product so that a vocab-sharded ``x``
    stays sharded; on one device a gather gives the same value (the
    product's sum has one nonzero term). On DTensors the vocab-sharded
    logits are redistributed so that each rank holds whole rows of its
    positions (vocab shards become sequence shards, one all-to-all), and
    the rows' terms are formed locally (:func:`_nll_by_rows`)."""
    x = logits.float()
    nll = _nll_by_rows(x, targets) if isinstance(x, DTensor) else _NLL.apply(x, targets)
    if valid is None:
        return nll.mean()
    w = valid.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def dense_loss(params, cfg: ModelConfig, batch):
    """``batch["tokens"] (B, S + 1)``: the mean loss of predicting
    ``tokens[:, 1:]`` from ``tokens[:, :-1]``."""
    tokens = batch["tokens"]
    h, _ = _hidden(params, cfg, tokens[:, :-1])
    n = tokens[:, 1:].numel()
    with span("model.loss_head", items=n):
        h = mark_backward(h, "model.loss_head.bwd", end=True)
        loss = cross_entropy(_logits(cfg, params, h), tokens[:, 1:])
        return mark_backward(loss, "model.loss_head.bwd", end=False, items=n)
