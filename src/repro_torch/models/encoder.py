"""HuBERT-style encoder-only audio model (arXiv:2106.07447), after the JAX
package's ``models/encoder.py``.

The conv waveform frontend is stubbed, as in the reference: inputs are
precomputed frame embeddings ``(B, S, frame_dim)``. The backbone is the dense
layer stack (:func:`repro_torch.models.dense.stack_forward`) with the
``("bidirectional",)`` pattern, so with ``attn_impl="flash"`` every layer
runs the flash kernels' bidirectional route (hubert-xlarge's D = 80 on the
D = 128 instances, zero-padded). Training is masked prediction of cluster
ids at the masked frames.

Parameters: ``{"frame_proj" (frame_dim, d), "mask_emb" (d,), "layers"
(a list, one dict per layer, as the dense model's), "ln_f", "head" (d,
V)}``. There is no decode step.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..launch.sharding import linear, shard
from .dense import _init_layer, cross_entropy, dense_init, stack_forward
from .layers import rms_norm

__all__ = ["hubert_forward", "hubert_loss", "init_hubert"]


def init_hubert(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters on the generator's device, drawn in a fixed order
    (frame projection, mask embedding, layers 0..L-1, head)."""
    pd, d = cfg.pdtype(), cfg.d_model
    frame_proj = dense_init(gen, (cfg.frame_dim, d), dtype=pd)
    mask_emb = dense_init(gen, (d,), fan_in=d, dtype=pd)
    layers = [_init_layer(cfg, gen) for _ in range(cfg.num_layers)]
    return {
        "frame_proj": frame_proj,
        "mask_emb": mask_emb,
        "layers": layers,
        "ln_f": torch.zeros((d,), dtype=pd, device=gen.device),
        "head": dense_init(gen, (d, cfg.vocab_size), dtype=pd),
    }


def hubert_forward(params, cfg: ModelConfig, frames, mask=None):
    """``frames (B, S, frame_dim)``; ``mask (B, S)`` bool (True = masked:
    the frame's projection is replaced by ``mask_emb``). Returns float32
    logits ``(B, S, V)``."""
    h = linear(frames.to(cfg.cdtype()), params["frame_proj"])
    if mask is not None:
        h = torch.where(mask[..., None], params["mask_emb"].to(h.dtype), h)
    h = shard(h, "batch", "act_seq", None)
    h, _ = stack_forward(cfg, params["layers"], h)
    return shard(linear(rms_norm(h, params["ln_f"]), params["head"]).float(), "batch", None, "tensor")


def hubert_loss(params, cfg: ModelConfig, batch):
    """``batch``: ``{"frames" (B, S, F), "mask" (B, S) bool, "labels" (B, S)
    int}``: the mean cross-entropy of the labels at the masked frames."""
    logits = hubert_forward(params, cfg, batch["frames"], batch["mask"])
    return cross_entropy(logits, batch["labels"], valid=batch["mask"])
