"""Zamba2-style hybrid: a Mamba2 backbone plus one SHARED attention block
applied every ``cfg.shared_attn_every`` layers (arXiv:2411.15242), after the
JAX package's ``models/hybrid.py``.

The shared block's weights are reused at every application; its input is
``concat(hidden, original embeddings)`` projected back to ``d_model``, and
it runs through :func:`repro_torch.models.dense.layer_apply` with
``cfg.attn_impl``, so on the card the prefill and the training step run the
flash kernels (at zamba2-2.7b's head dim 80 on the D = 128 instances, on
zero-padded inputs). Each application keeps its own KV cache at decode.

Parameters are a dict ``{"emb", "mamba", "shared", "shared_in_proj",
"ln_f", "lm_head"}``: the reference's ``mamba_groups`` stack ``(n_groups,
period, ...)`` becomes the list ``"mamba"`` of ``num_layers`` blocks
(``[g, j]`` is block ``g * period + j``); ``"shared"`` is one dense layer.

The decode cache is ``{"mamba": (conv, ssd), "attn": (k, v)}``: ``conv
(L, B, K-1, conv_dim)`` in the compute dtype and ``ssd (L, B, H, P, N)``
float32, one row per Mamba2 layer; ``k``, ``v`` ``(n_groups, B, S_max,
Hkv, hd)``, one row per application of the shared block. A decode step
writes the new keys and values into the attention cache's storage in place
(as the dense cache is written, :func:`repro_torch.models.dense.write_cache`)
and returns the same ``k``, ``v`` tensors; the conv and SSD states are
replaced: the step returns new tensors and leaves the given ones as they
were, as the reference does. A collect-state prefill (``zamba_forward(...,
collect_state=True)``) needs an attention cache exactly as long as the
prompt, as the reference's does (its keys are masked at ``arange(S)``); a
caller that decodes after it copies the collected keys and values into a
longer cache.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.torch_dp import resolve_device
from ..launch.sharding import like, linear, shard
from .dense import _embed, _init_layer, _logits, _maybe_remat, cross_entropy, decode_position, dense_init, layer_apply
from .layers import make_rope, rms_norm
from .ssm import causal_conv1d, causal_conv1d_step, ssd_chunked, ssd_step

__all__ = [
    "init_zamba",
    "init_zamba_cache",
    "zamba_decode_step",
    "zamba_forward",
    "zamba_loss",
]


def _dims(cfg: ModelConfig):
    inner = cfg.ssm_expand * cfg.d_model
    H = inner // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = inner + 2 * N  # x, B, C are convolved
    d_in_proj = 2 * inner + 2 * N + H  # z, x, B, C, dt
    return inner, H, P, N, conv_dim, d_in_proj


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_mamba_block(cfg: ModelConfig, gen: torch.Generator):
    d = cfg.d_model
    inner, H, P, N, conv_dim, d_in_proj = _dims(cfg)
    pd, dev = cfg.pdtype(), gen.device
    return {
        "ln": torch.zeros((d,), dtype=pd, device=dev),
        "in_proj": dense_init(gen, (d, d_in_proj), dtype=pd),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), fan_in=cfg.ssm_conv, dtype=pd),
        "A_log": torch.zeros((H,), dtype=pd, device=dev),  # A = -exp(A_log) = -1 at init
        "dt_bias": torch.full((H,), -1.0, dtype=pd, device=dev),  # softplus(-1+x) ~ 0.3
        "D": torch.ones((H,), dtype=pd, device=dev),
        "gn": torch.zeros((inner,), dtype=pd, device=dev),
        "out_proj": dense_init(gen, (inner, d), fan_in=inner, dtype=pd),
    }


def init_zamba(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters on the generator's device, drawn in a fixed order
    (embedding, Mamba2 blocks 0..L-1, the shared block, its input
    projection, the head)."""
    pd = cfg.pdtype()
    emb = dense_init(gen, (cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model, dtype=pd)
    mamba = [_init_mamba_block(cfg, gen) for _ in range(cfg.num_layers)]
    shared = _init_layer(cfg, gen)
    return {
        "emb": emb,
        "mamba": mamba,
        # single SHARED transformer block + 2d->d input projector
        "shared": shared,
        "shared_in_proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype=pd),
        "ln_f": torch.zeros((cfg.d_model,), dtype=pd, device=gen.device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=pd),
    }


# ---------------------------------------------------------------------------
# mamba2 block body
# ---------------------------------------------------------------------------


def _mamba_block(cfg, p, h, state=None, step=False):
    """state: (conv_state (B,K-1,conv_dim), ssd_state (B,H,P,N)) or None
    (zeros)."""
    inner, H, P, N, conv_dim, _ = _dims(cfg)
    x = rms_norm(h, p["ln"])
    B, S = x.shape[0], x.shape[1]
    proj = linear(x, p["in_proj"])
    z = proj[..., :inner]
    xbc = proj[..., inner:inner + conv_dim]
    dt_pre = proj[..., inner + conv_dim:]  # (B,S,H)
    xbc = shard(xbc, "batch", None, "tensor")
    conv_state = state[0] if state is not None else None
    if step:
        xbc, conv_state = causal_conv1d_step(xbc, p["conv_w"], conv_state)
    else:
        xbc, conv_state = causal_conv1d(xbc, p["conv_w"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :inner].reshape(B, S, H, P)
    Bm = xbc[..., inner:inner + N]
    Cm = xbc[..., inner + N:]
    dt = F.softplus(dt_pre.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    ssd_state = state[1] if state is not None else None
    if step:
        y, ssd_state = ssd_step(xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], ssd_state)
        y = y[:, None]
    else:
        y, ssd_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk=min(cfg.chunk_size, S), state=ssd_state)
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, inner)
    y = rms_norm(y * F.silu(z), p["gn"])
    return h + linear(y, p["out_proj"]), (conv_state, ssd_state)


def _shared_block(cfg, params, h, emb0, rope, q_pos, kv_pos, cache_kv=None, write_pos=None):
    u = linear(torch.cat([h, emb0], dim=-1), params["shared_in_proj"])
    u, new_kv = layer_apply(
        cfg, params["shared"], u, "causal", rope, q_pos=q_pos, kv_pos=kv_pos,
        cache_kv=cache_kv, write_pos=write_pos,
    )
    return h + u, new_kv


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------


def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zero conv and SSD states and zero KV caches of ``max_len`` slots, on
    ``device`` (layout in the module docstring)."""
    inner, H, P, N, conv_dim, _ = _dims(cfg)
    n_groups = cfg.num_layers // cfg.shared_attn_every
    dev = resolve_device(device)
    mamba = (
        torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=cfg.cdtype(), device=dev),
        torch.zeros((cfg.num_layers, batch, H, P, N), dtype=torch.float32, device=dev),
    )
    kv_shape = (n_groups, batch, max_len, cfg.num_kv_heads, cfg.hd)
    attn = (torch.zeros(kv_shape, dtype=cfg.cdtype(), device=dev), torch.zeros(kv_shape, dtype=cfg.cdtype(), device=dev))
    return {"mamba": mamba, "attn": attn}


def _group(cfg, layers, params, h, emb0, rope, q_pos, kv_pos, m_states, cache_kv, write_pos, step):
    """One group: ``len(layers)`` Mamba2 blocks, then the shared block.
    Returns (h, new Mamba2 states, the shared block's (k, v))."""
    new_m = []
    for p, st in zip(layers, m_states):
        h, st = _mamba_block(cfg, p, h, st, step=step)
        new_m.append(st)
    h, kv = _shared_block(cfg, params, h, emb0, rope, q_pos, kv_pos, cache_kv=cache_kv, write_pos=write_pos)
    return shard(h, "batch", "act_seq", None), new_m, kv


def _mamba_states(cfg, state, g):
    period = cfg.shared_attn_every
    if state is None:
        return [None] * period
    conv, ssd = state["mamba"]
    return [(conv[i], ssd[i]) for i in range(g * period, (g + 1) * period)]


def _stack_mamba(m_states):
    return tuple(torch.stack([st[i] for st in m_states]) for i in range(2))


def zamba_forward(params, cfg: ModelConfig, tokens, *, state=None, collect_state=False):
    """tokens ``(B, S)`` -> ``(logits, state)``: float32 logits ``(B, S,
    V)`` and, with ``collect_state``, the cache after the last token: the
    conv and SSD states and the attention cache, which must be exactly
    ``S`` slots long (a new one if ``state`` is ``None``; the keys and
    values are written into it in place). ``state`` also gives the conv and
    SSD states before the first token (zeros if ``None``)."""
    h = _embed(cfg, params, tokens)
    emb0 = h
    B, S = tokens.shape
    pos = like(h, torch.arange(S, device=h.device))
    rope = make_rope(pos, cfg.hd, cfg.rope_base)
    period = cfg.shared_attn_every
    n_groups = cfg.num_layers // period
    write_pos = None
    if collect_state:
        if state is None:
            state = init_zamba_cache(cfg, B, S, device=h.device)
        if state["attn"][0].shape[2] != S:
            raise ValueError(f"a collect-state prefill needs an attention cache of exactly S = {S} slots (the "
                             f"reference masks its keys at arange(S)); got {state['attn'][0].shape[2]}")
        write_pos = like(h, decode_position(0, h.device))
    body = _maybe_remat(cfg, functools.partial(_group, cfg, step=False))
    m_all = []
    for g in range(n_groups):
        cache_kv = tuple(t[g] for t in state["attn"]) if collect_state else None
        h, new_m, _ = body(params["mamba"][g * period:(g + 1) * period], params, h, emb0, rope, pos, pos,
                           _mamba_states(cfg, state, g), cache_kv, write_pos)
        m_all += new_m
    new_state = {"mamba": _stack_mamba(m_all), "attn": state["attn"]} if collect_state else None
    return _logits(cfg, params, h), new_state


def zamba_loss(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, _ = zamba_forward(params, cfg, tokens[:, :-1])
    return cross_entropy(logits, tokens[:, 1:])


def zamba_decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """tokens ``(B, 1)`` at position ``pos`` (a Python int or a 0-d integer
    tensor; no host sync) -> ``(logits (B, 1, V), cache)``: the attention
    cache written in place, new conv and SSD states."""
    h = _embed(cfg, params, tokens)
    emb0 = h
    pos = like(h, decode_position(pos, h.device))
    k_all, v_all = cache["attn"]
    q_pos = pos[None]
    kv_pos = like(h, torch.arange(k_all.shape[2], device=h.device))
    rope = make_rope(q_pos, cfg.hd, cfg.rope_base)
    period = cfg.shared_attn_every
    m_all = []
    for g in range(cfg.num_layers // period):
        h, new_m, _ = _group(cfg, params["mamba"][g * period:(g + 1) * period], params, h, emb0, rope, q_pos,
                             kv_pos, _mamba_states(cfg, cache, g), (k_all[g], v_all[g]), pos, step=True)
        m_all += new_m
    return _logits(cfg, params, h), {"mamba": _stack_mamba(m_all), "attn": (k_all, v_all)}
