"""Dense decoder LMs (llama family: deepseek-7b; gemma2-2b with its
local/global alternation, softcaps and post-norms): the forward half of the
JAX package's ``models/dense.py``.

Parameters are a dict ``{"emb", "layers", "ln_f"[, "lm_head"]}`` whose
``"layers"`` is a list with one dict per layer, in order; the JAX package's
``(n_groups, period, ...)`` stack maps onto it as layer ``g * period + sub``
(:func:`repro_torch.models.convert.params_from_jax`). The layer loop is a
Python loop with ``kind = pattern[i % period]``. The reference's ``shard``
calls are the identity on one device and are dropped; the KV cache, decode
step and loss wait for later slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import apply_rope, attention, gelu, make_rope, mlp_act, mlp_gated, rms_norm, squared_relu

__all__ = [
    "attn_pattern",
    "dense_forward",
    "dense_init",
    "init_dense",
    "layer_apply",
    "stack_forward",
]

# erf(sqrt(2)) = 2 * Phi(2) - 1: the uniform range whose erfinv is a normal
# truncated at +-2 sigma
_TRUNC2 = math.erf(math.sqrt(2.0))


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
    if cfg.mlp_kind == "gated_silu":
        return mlp_gated(p, x, F.silu)
    if cfg.mlp_kind == "gated_gelu":
        return mlp_gated(p, x, gelu)
    if cfg.mlp_kind == "squared_relu":
        return mlp_act(p, x, squared_relu)
    return mlp_act(p, x, gelu)


def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def layer_apply(cfg: ModelConfig, p, h, kind: str, rope_sincos, *, q_pos, kv_pos):
    """One transformer block over the full sequence (the reference's
    train/prefill branch; its cache branch, which also returns the keys and
    values, comes with the decode slice). Returns ``h``."""
    sin, cos = rope_sincos
    a_in = rms_norm(h, p["ln1"])
    q = apply_rope(_proj(a_in, p["attn"]["wq"]), sin, cos)
    k = apply_rope(_proj(a_in, p["attn"]["wk"]), sin, cos)
    v = _proj(a_in, p["attn"]["wv"])
    out = attention(
        q, k, v,
        q_pos=q_pos, kv_pos=kv_pos, kind=kind, window=cfg.window, attn_softcap=cfg.attn_softcap,
        block_q=cfg.attn_block_q, impl=cfg.attn_impl,
    )
    wo = p["attn"]["wo"]
    attn_out = out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    if "ln1b" in p:
        attn_out = rms_norm(attn_out, p["ln1b"])
    h = h + attn_out

    mlp_out = _mlp(cfg, p["mlp"], rms_norm(h, p["ln2"]))
    if "ln2b" in p:
        mlp_out = rms_norm(mlp_out, p["ln2b"])
    return h + mlp_out


def stack_forward(cfg: ModelConfig, layers, h):
    """The layer stack over the full sequence; layer ``i`` has attention kind
    ``attn_pattern(cfg)[i % period]``. Returns ``h``."""
    S = h.shape[1]
    pattern = attn_pattern(cfg)
    pos = torch.arange(S, device=h.device)
    rope = make_rope(pos, cfg.hd, cfg.rope_base)
    for i, p in enumerate(layers):
        h = layer_apply(cfg, p, h, pattern[i % len(pattern)], rope, q_pos=pos, kv_pos=pos)
    return h


# ---------------------------------------------------------------------------
# public model API
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params, tokens):
    h = params["emb"][tokens].to(cfg.cdtype())
    if cfg.scale_embedding:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return h


def _logits(cfg: ModelConfig, params, h):
    """Float32 logits ``(B, S, V)``. The softcap runs in place on the float32
    copy, so at most one compute-dtype and one float32 logit tensor are alive
    (the values are those of ``softcap(logits, cap)``)."""
    h = rms_norm(h, params["ln_f"])
    head = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ head.to(h.dtype)).float()
    if cfg.logit_softcap:
        logits.div_(cfg.logit_softcap).tanh_().mul_(cfg.logit_softcap)
    return logits


def dense_forward(params, cfg: ModelConfig, tokens):
    """tokens ``(B, S)`` -> float32 logits ``(B, S, V)``."""
    h = _embed(cfg, params, tokens)
    h = stack_forward(cfg, params["layers"], h)
    return _logits(cfg, params, h)
