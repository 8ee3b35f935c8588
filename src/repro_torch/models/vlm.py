"""PaliGemma-style VLM (arXiv:2407.07726), after the JAX package's
``models/vlm.py``.

The SigLIP vision tower is stubbed, as in the reference: inputs are
precomputed patch embeddings ``(B, num_patches, patch_dim)``. This module is
the multimodal projector and the gemma-style text decoder (the dense model,
:mod:`repro_torch.models.dense`) with PaliGemma's prefix-LM mask:
bidirectional over the image patches, causal over the text. Under that mask
attention takes the plain route (query-blocked at ``attn_block_q``, float32
scores), as the reference's does: the flash kernel has no prefix mask.

Parameters: the dense model's plus ``"patch_proj" (patch_dim, d)``. The
decode cache and step are the dense ones: a decode is causal over the image
and text already in the cache.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..launch.sharding import linear, shard
from .dense import (
    _embed,
    _logits,
    cross_entropy,
    dense_decode_step,
    dense_init,
    init_dense,
    init_dense_cache,
    stack_forward,
)

__all__ = [
    "init_paligemma",
    "init_paligemma_cache",
    "paligemma_decode_step",
    "paligemma_forward",
    "paligemma_loss",
]


def init_paligemma(cfg: ModelConfig, gen: torch.Generator):
    """:func:`repro_torch.models.dense.init_dense`'s parameters, then the
    patch projection, drawn in that order."""
    params = init_dense(cfg, gen)
    params["patch_proj"] = dense_init(gen, (cfg.patch_dim, cfg.d_model), dtype=cfg.pdtype())
    return params


def _fuse(params, cfg: ModelConfig, patches, tokens):
    """The projected patches (scaled by sqrt(d_model) in their own dtype
    where the embedding is) before the text embeddings: ``(B, P + S, d)``."""
    img = linear(patches.to(cfg.cdtype()), params["patch_proj"])
    if cfg.scale_embedding:
        img = img * torch.tensor(cfg.d_model ** 0.5, dtype=img.dtype, device=img.device)
    return shard(torch.cat([img, _embed(cfg, params, tokens)], dim=1), "batch", None, None)


def paligemma_forward(params, cfg: ModelConfig, patches, tokens, *, collect_cache=False):
    """``patches (B, P, patch_dim)``, ``tokens (B, S)`` -> ``(logits,
    caches)``: float32 logits over the text positions only, ``(B, S, V)``,
    and, with ``collect_cache``, every layer's ``(k, v)`` over all ``P + S``
    positions (:func:`repro_torch.models.dense.stack_forward`), else
    ``None``. The first ``P`` positions (the image) form the bidirectional
    prefix."""
    h = _fuse(params, cfg, patches, tokens)
    P = patches.shape[1]
    h, caches = stack_forward(cfg, params["layers"], h, prefix_len=P, collect_cache=collect_cache)
    return _logits(cfg, params, h[:, P:]), caches


def paligemma_loss(params, cfg: ModelConfig, batch):
    """``batch``: ``{"patches" (B, P, F), "tokens" (B, S + 1)}``: the mean
    loss of predicting ``tokens[:, 1:]`` from the image and
    ``tokens[:, :-1]``."""
    tokens = batch["tokens"]
    logits, _ = paligemma_forward(params, cfg, batch["patches"], tokens[:, :-1])
    return cross_entropy(logits, tokens[:, 1:])


def init_paligemma_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """The dense cache (:func:`repro_torch.models.dense.init_dense_cache`)."""
    return init_dense_cache(cfg, batch, max_len, device)


def paligemma_decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """The dense decode step: causal over the (image + text) cache."""
    return dense_decode_step(params, cfg, cache, tokens, pos)
