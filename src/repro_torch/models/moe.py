"""Mixture-of-Experts decoder LMs, after the JAX package's ``models/moe.py``.

Covers:
  * olmoe-1b-7b — uniform stack: GQA attention + 64-expert top-8 MoE FFN.
  * deepseek-v3-671b — MLA attention, dense-FFN prefix layers, MoE layers
    (1 shared + 256 routed experts, top-8), the MTP depth-1 head.

Parameters are ``{"emb", "moe_layers", "ln_f", "lm_head"[, "dense_layers",
"mtp"]}`` with ``"moe_layers"`` and ``"dense_layers"`` lists of per-layer
dicts (the reference stacks them on a leading ``(n,)`` axis). The router aux
losses of the MoE layers are averaged and added to the LM loss with
``cfg.router_aux_weight``.

The published DeepSeek-V3, beyond the reference (config fields the JAX
package lacks): ``dense_prefix_mla`` runs MLA in the dense prefix layers
too (``{"ln1", "ln2", "attn_mla", "mlp"}``); ``router_score="sigmoid"``
selects on the affinities plus a per-layer bias, which is state outside the
parameters: ``batch["router_bias"]``, one ``(num_experts,)`` tensor a MoE
layer, read and never written, so no gradient or optimizer step reaches it
(the published bias update speed 0, §4.2); ``moe_impl="held"`` holds
``num_experts_held`` of the experts
(:mod:`repro_torch.models.moe_dispatch`).

The decode cache is ``{"moe": (k, v)[, "dense": (k, v)]}`` with a leading
layer axis, as the reference lays it out: ``(n, B, S_max, Hkv, hd)``, or,
with MLA, ``(c_kv (n_moe, B, S_max, kv_lora_rank), k_rope (n_moe, B, S_max,
rope_head_dim))`` (the dense layers' too under ``dense_prefix_mla``). A
decode step writes into the cache's storage and returns the same tensors
(:mod:`repro_torch.models.dense`).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.torch_dp import resolve_device
from ..launch.sharding import axis_size, like, linear, shard
from ..spans import mark_backward, span
from .dense import (
    _embed,
    _init_layer,
    _logits,
    _maybe_remat,
    _mlp,
    _out_proj,
    _proj,
    cross_entropy,
    decode_position,
    dense_init,
    layer_apply,
    write_cache,
)
from .layers import apply_rope, attention, make_rope, rms_norm
from .mla import init_mla, init_mla_cache, mla_decode_step, mla_forward
from .moe_dispatch import moe_ffn

__all__ = ["dense_mla_layer_apply", "init_moe_cache", "init_moe_model", "moe_decode_step", "moe_forward",
           "moe_layer_apply", "moe_loss"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_moe_ffn(cfg: ModelConfig, gen: torch.Generator):
    d, E, fe = cfg.d_model, cfg.experts_held, cfg.d_ff_expert
    pd = cfg.pdtype()
    p = {
        "router": dense_init(gen, (d, cfg.num_experts), dtype=pd),
        "experts": {
            "w_gate": dense_init(gen, (E, d, fe), fan_in=d, dtype=pd),
            "w_in": dense_init(gen, (E, d, fe), fan_in=d, dtype=pd),
            "w_out": dense_init(gen, (E, fe, d), fan_in=fe, dtype=pd),
        },
    }
    if cfg.num_shared_experts:
        fs = fe * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (d, fs), dtype=pd),
            "w_in": dense_init(gen, (d, fs), dtype=pd),
            "w_out": dense_init(gen, (fs, d), fan_in=fs, dtype=pd),
        }
    return p


def _init_moe_layer(cfg: ModelConfig, gen: torch.Generator):
    d, pd, dev = cfg.d_model, cfg.pdtype(), gen.device
    p = {"ln1": torch.zeros((d,), dtype=pd, device=dev), "ln2": torch.zeros((d,), dtype=pd, device=dev)}
    if cfg.use_mla:
        p["attn_mla"] = init_mla(cfg, gen)
    else:
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        p["attn"] = {
            "wq": dense_init(gen, (d, H, hd), fan_in=d, dtype=pd),
            "wk": dense_init(gen, (d, Hkv, hd), fan_in=d, dtype=pd),
            "wv": dense_init(gen, (d, Hkv, hd), fan_in=d, dtype=pd),
            "wo": dense_init(gen, (H, hd, d), fan_in=H * hd, dtype=pd),
        }
    p["moe"] = _init_moe_ffn(cfg, gen)
    return p


def _init_dense_mla_layer(cfg: ModelConfig, gen: torch.Generator):
    """A dense prefix layer under ``dense_prefix_mla``: MLA and the gated-SiLU
    MLP of width ``d_ff``."""
    d, f, pd, dev = cfg.d_model, cfg.d_ff, cfg.pdtype(), gen.device
    return {
        "ln1": torch.zeros((d,), dtype=pd, device=dev),
        "ln2": torch.zeros((d,), dtype=pd, device=dev),
        "attn_mla": init_mla(cfg, gen),
        "mlp": {
            "w_gate": dense_init(gen, (d, f), dtype=pd),
            "w_in": dense_init(gen, (d, f), dtype=pd),
            "w_out": dense_init(gen, (f, d), fan_in=f, dtype=pd),
        },
    }


def init_moe_model(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters on the generator's device, drawn in a fixed order
    (embedding, dense prefix layers, MoE layers, head, MTP)."""
    pd, dev, d = cfg.pdtype(), gen.device, cfg.d_model
    params = {"emb": dense_init(gen, (cfg.vocab_size, d), fan_in=d, dtype=pd)}
    if cfg.dense_prefix_layers:  # same dims; the plain gated-SiLU FFN of width d_ff
        init_dense = _init_dense_mla_layer if cfg.dense_prefix_mla else _init_layer
        params["dense_layers"] = [init_dense(cfg, gen) for _ in range(cfg.dense_prefix_layers)]
    params["moe_layers"] = [_init_moe_layer(cfg, gen) for _ in range(cfg.num_layers - cfg.dense_prefix_layers)]
    params["ln_f"] = torch.zeros((d,), dtype=pd, device=dev)
    params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=pd)
    if cfg.use_mtp:
        params["mtp"] = {
            "ln_in": torch.zeros((2 * d,), dtype=pd, device=dev),
            "proj": dense_init(gen, (2 * d, d), dtype=pd),
            "layer": _init_layer(cfg, gen),
        }
    return params


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------


def _moe_attention(cfg: ModelConfig, p, h, *, q_pos, kv_pos, rope, cache=None, write_pos=None):
    """Returns ``(attn_out, new_cache)``. ``cache`` is ``None`` (no cache),
    ``"collect"`` (return this call's keys and values, or MLA's latents) or
    the layer's cache pair, written at ``write_pos`` in place."""
    decoding = cache is not None and not isinstance(cache, str) and write_pos is not None
    collect = isinstance(cache, str) and cache == "collect"
    if cfg.use_mla:
        if decoding:
            return mla_decode_step(cfg, p["attn_mla"], h, cache, write_pos)
        return mla_forward(cfg, p["attn_mla"], h, q_pos=q_pos, collect_cache=collect)
    sin, cos = rope
    kv_spec = "tensor" if cfg.num_kv_heads % max(axis_size("tensor"), 1) == 0 else None
    q = shard(apply_rope(_proj(h, p["attn"]["wq"]), sin, cos), "batch", None, "tensor", None)
    k = shard(apply_rope(_proj(h, p["attn"]["wk"]), sin, cos), "batch", None, kv_spec, None)
    v = shard(_proj(h, p["attn"]["wv"]), "batch", None, kv_spec, None)
    if decoding:
        kc, vc = (write_cache(c, x, write_pos) for c, x in zip(cache, (k, v)))
        out = attention(q, kc, vc, q_pos=q_pos, kv_pos=kv_pos, kind="causal")
        new_cache = (kc, vc)
    else:
        out = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, kind="causal", block_q=cfg.attn_block_q,
                        impl=cfg.attn_impl)
        new_cache = (k, v) if collect else None
    # head-parallel -> sequence-parallel handoff (see dense.layer_apply)
    out = shard(out, "batch", "act_seq", None, None)
    return _out_proj(out, p["attn"]["wo"]), new_cache


def moe_layer_apply(cfg: ModelConfig, p, h, *, q_pos, kv_pos, rope, cache=None, write_pos=None, router_bias=None):
    """One MoE block. Returns ``(h, new_cache, aux)``; ``router_bias`` is the
    layer's selection bias (module docstring)."""
    attn_out, new_cache = _moe_attention(
        cfg, p, rms_norm(h, p["ln1"]), q_pos=q_pos, kv_pos=kv_pos, rope=rope, cache=cache, write_pos=write_pos,
    )
    h = h + attn_out
    y, aux = moe_ffn(cfg, p["moe"], rms_norm(h, p["ln2"]), router_bias)
    return shard(h + y, "batch", "act_seq", None), new_cache, aux


def dense_mla_layer_apply(cfg: ModelConfig, p, h, *, q_pos, kv_pos, rope, cache=None, write_pos=None):
    """One dense prefix block under ``dense_prefix_mla``: MLA
    (:func:`_moe_attention`, its cache as a MoE block's) and the gated-SiLU
    MLP. Returns ``(h, new_cache)``."""
    attn_out, new_cache = _moe_attention(
        cfg, p, rms_norm(h, p["ln1"]), q_pos=q_pos, kv_pos=kv_pos, rope=rope, cache=cache, write_pos=write_pos,
    )
    h = h + attn_out
    return shard(h + _mlp(cfg, p["mlp"], rms_norm(h, p["ln2"])), "batch", "act_seq", None), new_cache


# ---------------------------------------------------------------------------
# forward / loss / decode
# ---------------------------------------------------------------------------


def _stacked(pairs):
    return tuple(torch.stack(xs) for xs in zip(*pairs))


def moe_forward(params, cfg: ModelConfig, tokens, *, collect_cache=False, router_bias=None):
    """Returns ``(logits, aux_mean, caches, h_final)``; ``caches`` is
    ``{"moe"[, "dense"]}`` with each layer's keys and values (MLA: its
    latents ``(c_kv, k_r)``, ``k_r`` before the rope, as the reference
    collects them) stacked on a leading layer axis under ``collect_cache``,
    else ``None``. ``router_bias``: one selection bias a MoE layer, or
    ``None`` (module docstring)."""
    h, aux, caches = _moe_hidden(params, cfg, tokens, collect_cache=collect_cache, router_bias=router_bias)
    return _logits(cfg, params, h), aux, caches, h


def _moe_hidden(params, cfg: ModelConfig, tokens, *, collect_cache=False, router_bias=None):
    """:func:`moe_forward` up to the head: ``(h_final, aux_mean, caches)``."""
    h = _embed(cfg, params, tokens)
    pos = like(h, torch.arange(h.shape[1], device=h.device))
    rope = make_rope(pos, cfg.hd, cfg.rope_base)
    caches = {}

    if cfg.dense_prefix_layers:
        def dense_body(hh, lp):
            if cfg.dense_prefix_mla:
                return dense_mla_layer_apply(cfg, lp, hh, q_pos=pos, kv_pos=pos, rope=rope,
                                             cache="collect" if collect_cache else None)
            return layer_apply(cfg, lp, hh, "causal", rope, q_pos=pos, kv_pos=pos)

        body, kvs = _maybe_remat(cfg, dense_body), []
        for lp in params["dense_layers"]:
            h, kv = body(h, lp)
            kvs.append(kv)
        if collect_cache:
            caches["dense"] = _stacked(kvs)

    def moe_body(hh, lp, bias):
        return moe_layer_apply(cfg, lp, hh, q_pos=pos, kv_pos=pos, rope=rope,
                               cache="collect" if collect_cache else None, router_bias=bias)

    body, kvs, auxes = _maybe_remat(cfg, moe_body), [], []
    biases = router_bias if router_bias is not None else [None] * len(params["moe_layers"])
    for lp, bias in zip(params["moe_layers"], biases, strict=True):
        h, c, aux = body(h, lp, bias)
        kvs.append(c)
        auxes.append(aux)
    if collect_cache:
        caches["moe"] = _stacked(kvs)
    return h, torch.stack(auxes).mean(), caches if collect_cache else None


def moe_loss(params, cfg: ModelConfig, batch):
    """``batch["tokens"] (B, S + 1)``, or ``(B, S + 2)`` with MTP: the LM
    loss plus ``router_aux_weight`` times the mean router aux loss, plus
    ``mtp_weight`` times the MTP depth-1 head's loss on ``tokens[:, 2:]``.
    ``batch["router_bias"]``, where given, holds the MoE layers' selection
    biases (module docstring). The LM head and its cross-entropy run in the
    span ``model.loss_head`` and its backward span (:mod:`repro_torch.spans`,
    as ``models/dense.py::dense_loss``; items tokens)."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if cfg.use_mtp:
        inp, tgt = tokens[:, :-2], tokens[:, 1:-1]
    h, aux, _ = _moe_hidden(params, cfg, inp, router_bias=batch.get("router_bias"))
    n = tgt.numel()
    with span("model.loss_head", items=n):
        lm = cross_entropy(_logits(cfg, params, mark_backward(h, "model.loss_head.bwd", end=True)), tgt)
        lm = mark_backward(lm, "model.loss_head.bwd", end=False, items=n)
    loss = lm + cfg.router_aux_weight * aux
    if cfg.use_mtp:
        # MTP depth-1 (DeepSeek-V3 §2.2): the final hidden state with the
        # embedding of the NEXT token, one extra layer, predict t + 2
        nxt_emb = _embed(cfg, params, tokens[:, 1:-1])
        h_in = rms_norm(torch.cat([rms_norm(h, params["ln_f"]), nxt_emb], dim=-1), params["mtp"]["ln_in"])
        h2 = linear(h_in, params["mtp"]["proj"])
        pos = like(h2, torch.arange(h2.shape[1], device=h2.device))
        rope = make_rope(pos, cfg.hd, cfg.rope_base)
        h2, _ = layer_apply(cfg, params["mtp"]["layer"], h2, "causal", rope, q_pos=pos, kv_pos=pos)
        loss = loss + cfg.mtp_weight * cross_entropy(_logits(cfg, params, h2), tokens[:, 2:])
    return loss


def init_moe_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zero caches in the compute dtype on ``device`` (module docstring)."""
    dev = resolve_device(device)
    caches = {}
    n_moe = cfg.num_layers - cfg.dense_prefix_layers

    def kv(n):
        shape = (n, batch, max_len, cfg.num_kv_heads, cfg.hd)
        return (torch.zeros(shape, dtype=cfg.cdtype(), device=dev), torch.zeros(shape, dtype=cfg.cdtype(), device=dev))

    if cfg.dense_prefix_layers:
        n = cfg.dense_prefix_layers
        caches["dense"] = init_mla_cache(cfg, batch, max_len, (n,), dev) if cfg.dense_prefix_mla else kv(n)
    caches["moe"] = init_mla_cache(cfg, batch, max_len, (n_moe,), dev) if cfg.use_mla else kv(n_moe)
    return caches


def moe_decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """tokens ``(B, 1)``; ``pos`` a Python int or 0-d integer tensor.
    Returns ``(logits (B, 1, V), cache)``, the cache updated in place."""
    h = _embed(cfg, params, tokens)
    pos = like(h, decode_position(pos, h.device))
    q_pos = pos[None]
    kv_pos = like(h, torch.arange(cache["moe"][0].shape[2], device=h.device))
    rope = make_rope(q_pos, cfg.hd, cfg.rope_base)

    if cfg.dense_prefix_layers:
        k_all, v_all = cache["dense"]
        for i, lp in enumerate(params["dense_layers"]):
            if cfg.dense_prefix_mla:
                h, _ = dense_mla_layer_apply(cfg, lp, h, q_pos=q_pos, kv_pos=kv_pos, rope=rope,
                                             cache=(k_all[i], v_all[i]), write_pos=pos)
            else:
                h, _ = layer_apply(cfg, lp, h, "causal", rope, q_pos=q_pos, kv_pos=kv_pos,
                                   cache_kv=(k_all[i], v_all[i]), write_pos=pos)
    a_all, b_all = cache["moe"]
    for i, lp in enumerate(params["moe_layers"]):
        h, _, _ = moe_layer_apply(cfg, lp, h, q_pos=q_pos, kv_pos=kv_pos, rope=rope, cache=(a_all[i], b_all[i]),
                                  write_pos=pos)
    return _logits(cfg, params, h), cache
