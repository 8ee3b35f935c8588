"""Step builders of the port, after the JAX package's ``launch/steps.py``.

``build_prefill_step`` is the dense-LM prefill, the entry point of this
slice. The train and serve steps come with their slices (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.model import prefill_fn

__all__ = ["build_prefill_step"]


def build_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)``: float32 logits over the full
    sequence (:func:`repro_torch.models.prefill_fn`)."""

    def prefill_step(params, batch):
        return prefill_fn(params, cfg, batch)

    return prefill_step
