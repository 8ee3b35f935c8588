"""Model API of the port: family dispatch, dummy batches and parameter/FLOPs
accounting, after the JAX package's ``models/model.py``.

The port holds the ``dense`` family's forward (prefill). Every other family,
and the decode and training entry points, come with later slices
(ROADMAP.md, Queue 1) and raise ``NotImplementedError`` until then.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.torch_dp import resolve_device
from . import dense

__all__ = [
    "init_params",
    "make_dummy_batch",
    "model_flops_per_token",
    "param_count",
    "prefill_fn",
]


def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch}) is not ported yet; the port holds the dense "
            "family (ROADMAP.md, Queue 1)"
        )


def init_params(cfg: ModelConfig, gen=0, device="cuda"):
    """Random parameters. ``gen`` is a ``torch.Generator`` (its device is
    used) or an int seed for a new generator on ``device``."""
    _dense_only(cfg)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen))
    return dense.init_dense(cfg, gen)


def prefill_fn(params, cfg: ModelConfig, batch):
    """Forward over the full sequence: ``batch["tokens"] (B, S)`` -> float32
    logits ``(B, S, V)``, on the device of the parameters. Runs under
    ``torch.inference_mode``."""
    _dense_only(cfg)
    with torch.inference_mode():
        return dense.dense_forward(params, cfg, batch["tokens"])


def make_dummy_batch(cfg: ModelConfig, B: int, S: int, mode: str, rng: np.random.Generator,
                     device="cuda") -> Dict[str, Any]:
    """Random tokens from a numpy generator (the reference's draw), as int64
    on ``device``: ``(B, S)``, plus one target column in ``train`` mode."""
    _dense_only(cfg)
    extra = 1 if mode == "train" else 0
    tokens = rng.integers(0, cfg.vocab_size, (B, S + extra)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens).long().to(resolve_device(device))}


def _leaves(tree):
    if isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def param_count(params) -> int:
    return int(sum(x.numel() for x in _leaves(params)))


def model_flops_per_token(params, cfg: ModelConfig, seq_len: int, mode: str = "train") -> float:
    """MODEL_FLOPS (6·N·D accounting) per token: 6·N for train (fwd+bwd),
    2·N for inference, plus the attention term 12·L·d_attn·S (train) or
    4·L·d_attn·S (inference), halved for causality, as the reference counts
    it. Dense models: every parameter is active."""
    _dense_only(cfg)
    mult = 6.0 if mode == "train" else 2.0
    flops = mult * param_count(params)
    attn_mult = 12.0 if mode == "train" else 4.0
    flops += attn_mult * cfg.num_layers * cfg.hd * cfg.num_heads * min(seq_len, 10**9) / 2
    return float(flops)
