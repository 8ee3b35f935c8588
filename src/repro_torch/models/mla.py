"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), after the
JAX package's ``models/mla.py``.

Train/prefill uses the *non-absorbed* form (per-head K/V materialised from
the compressed latent). Decode uses the *absorbed* form: the queries are
projected into the latent space and attend directly against the cached
``c_kv``, so the cache is ``(B, S, kv_lora_rank + rope_head_dim)`` instead
of ``(B, S, H, ...)``. The q/k head dim (``hd + rope_head_dim``) differs
from v's: the JAX package takes the plain route for it, the port's
``attn_impl="flash"`` the flash kernels on v zero-padded to q's head dim
(:func:`repro_torch.models.layers.attention`). Train/prefill attention runs
in the span ``attn.mla`` and its backward span (:mod:`repro_torch.spans`;
items tokens).

As in :mod:`repro_torch.models.dense`, a decode step writes into the
cache's storage and returns the same tensors.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..launch.sharding import like, linear, shard
from ..spans import mark_backward, span
from .dense import _out_proj, _proj, dense_init, write_cache
from .layers import apply_rope, attention, make_rope, rms_norm

__all__ = ["init_mla", "init_mla_cache", "mla_decode_step", "mla_forward"]


def init_mla(cfg: ModelConfig, gen: torch.Generator):
    """Random MLA parameters, drawn in a fixed order on the generator's device."""
    d, H = cfg.d_model, cfg.num_heads
    nd, rd = cfg.hd, cfg.rope_head_dim
    vd = cfg.v_head_dim or nd
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    pd, dev = cfg.pdtype(), gen.device
    return {
        "w_dq": dense_init(gen, (d, qr), dtype=pd),
        "q_ln": torch.zeros((qr,), dtype=pd, device=dev),
        "w_uq": dense_init(gen, (qr, H, nd + rd), fan_in=qr, dtype=pd),
        "w_dkv": dense_init(gen, (d, kr), dtype=pd),
        "kv_ln": torch.zeros((kr,), dtype=pd, device=dev),
        "w_uk": dense_init(gen, (kr, H, nd), fan_in=kr, dtype=pd),
        "w_uv": dense_init(gen, (kr, H, vd), fan_in=kr, dtype=pd),
        "w_kr": dense_init(gen, (d, rd), dtype=pd),
        "wo": dense_init(gen, (H, vd, d), fan_in=H * vd, dtype=pd),
    }


def _latents(cfg: ModelConfig, p, x):
    """The compressed latents and the rope key: ``(c_q, c_kv, k_r)``."""
    cq = rms_norm(linear(x, p["w_dq"]), p["q_ln"])
    ckv = rms_norm(linear(x, p["w_dkv"]), p["kv_ln"])
    kr = linear(x, p["w_kr"])  # (B, S, rd), shared across heads
    return cq, ckv, kr


def mla_forward(cfg: ModelConfig, p, x, *, q_pos, collect_cache=False):
    """Non-absorbed attention over the full sequence. Returns ``(y,
    cache)`` with ``cache = (c_kv, k_rope)`` (the latents before the rope,
    as the reference collects them) under ``collect_cache``, else ``None``."""
    n = x.shape[0] * x.shape[1]
    with span("attn.mla", items=n):
        y, cache = _mla_full(cfg, p, mark_backward(x, "attn.mla.bwd", end=True), q_pos, collect_cache)
        return mark_backward(y, "attn.mla.bwd", end=False, items=n), cache


def _mla_full(cfg: ModelConfig, p, x, q_pos, collect_cache):
    nd, rd = cfg.hd, cfg.rope_head_dim
    cq, ckv, kr = _latents(cfg, p, x)
    q = _proj(cq, p["w_uq"])  # (B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    sin, cos = make_rope(q_pos, rd, cfg.rope_base)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(kr[:, :, None, :], sin, cos)  # (B, S, 1, rd)
    k_nope = _proj(ckv, p["w_uk"])
    v = _proj(ckv, p["w_uv"])
    q_full = shard(torch.cat([q_nope, q_rope], -1), "batch", None, "tensor", None)
    k_full = shard(torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], rd)], -1), "batch", None, "tensor", None)
    out = attention(
        q_full, k_full, v, q_pos=q_pos, kv_pos=q_pos, kind="causal",
        scale=(nd + rd) ** -0.5, block_q=cfg.attn_block_q, impl=cfg.attn_impl,
    )
    # head-parallel -> sequence-parallel handoff (see dense.layer_apply)
    out = shard(out, "batch", "act_seq", None, None)
    return _out_proj(out, p["wo"]), ((ckv, kr) if collect_cache else None)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers_stacked, device):
    """Zero caches ``(c_kv, k_rope)`` of shapes ``n_layers_stacked + (batch,
    max_len, kv_lora_rank)`` and ``... rope_head_dim)``."""
    shape_c = tuple(n_layers_stacked) + (batch, max_len, cfg.kv_lora_rank)
    shape_r = tuple(n_layers_stacked) + (batch, max_len, cfg.rope_head_dim)
    return (torch.zeros(shape_c, dtype=cfg.cdtype(), device=device),
            torch.zeros(shape_r, dtype=cfg.cdtype(), device=device))


def mla_decode_step(cfg: ModelConfig, p, x, cache, pos):
    """Absorbed decode. x ``(B, 1, d)``; cache ``(c_kv (B, S, kr), k_rope
    (B, S, rd))``, written at ``pos`` (a 0-d tensor) in place. Returns
    ``(y (B, 1, d), cache)``."""
    nd, rd = cfg.hd, cfg.rope_head_dim
    ckv_cache, kr_cache = cache
    S = ckv_cache.shape[1]
    cq, ckv_t, kr_t = _latents(cfg, p, x)  # (B, 1, *)
    sin, cos = make_rope(pos[None], rd, cfg.rope_base)
    kr_t = apply_rope(kr_t[:, :, None, :], sin, cos)[:, :, 0, :]  # (B, 1, rd)
    write_cache(ckv_cache, ckv_t, pos)
    write_cache(kr_cache, kr_t, pos)

    q = _proj(cq, p["w_uq"])  # (B, 1, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, sin, cos)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])  # W_uk absorbed into the query
    scale = (nd + rd) ** -0.5
    ckv32 = ckv_cache.float()
    logits = (
        torch.einsum("bshr,btr->bhst", q_c.float(), ckv32)
        + torch.einsum("bshk,btk->bhst", q_rope.float(), kr_cache.float())
    ) * scale  # (B, H, 1, S)
    mask = like(pos, torch.arange(S, device=x.device))[None, None, None, :] <= pos
    w = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    out_c = torch.einsum("bhst,btr->bshr", w, ckv32)  # (B, 1, H, kr)
    out = torch.einsum("bshr,rhk->bshk", out_c.to(x.dtype), p["w_uv"])  # (B, 1, H, vd)
    return _out_proj(out, p["wo"]), (ckv_cache, kr_cache)
