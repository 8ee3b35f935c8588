"""Step builders of the port, after the JAX package's ``launch/steps.py``.

``build_train_step`` is the dense-LM training step (loss, gradients,
optimizer update) and ``build_prefill_step`` the dense-LM prefill. The serve
step comes with its slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from ..configs.base import ModelConfig
from ..fl.client import loss_and_grads
from ..models.model import loss_fn, prefill_fn
from ..optim.optimizers import apply_updates, get_optimizer

__all__ = ["build_prefill_step", "build_train_step", "value_and_grad"]


def value_and_grad(params, cfg: ModelConfig, batch):
    """``(loss, grads)`` of :func:`repro_torch.models.loss_fn`
    (:func:`repro_torch.fl.client.loss_and_grads`): no ``.grad`` is kept on
    the parameters; ``loss`` is detached."""
    return loss_and_grads(lambda p, b: loss_fn(p, cfg, b), params, batch)


def build_train_step(cfg: ModelConfig):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` with ``opt = get_optimizer(cfg.optimizer,
    cfg.learning_rate)`` and ``opt_state = opt.init(params)``. The parameters
    and the optimizer state are updated in place and returned."""
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return train_step, opt


def build_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)``: float32 logits over the full
    sequence (:func:`repro_torch.models.prefill_fn`)."""

    def prefill_step(params, batch):
        return prefill_fn(params, cfg, batch)

    return prefill_step
