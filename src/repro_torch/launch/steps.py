"""Step builders of the port, after the JAX package's ``launch/steps.py``.

``build_train_step`` is the dense-LM training step (loss, gradients,
optimizer update) and ``build_prefill_step`` the dense-LM prefill. The serve
step comes with its slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.model import loss_fn, prefill_fn
from ..optim.optimizers import apply_updates, get_optimizer, tree_leaves, tree_map

__all__ = ["build_prefill_step", "build_train_step", "value_and_grad"]


def value_and_grad(params, cfg: ModelConfig, batch):
    """``(loss, grads)`` of :func:`repro_torch.models.loss_fn`, as the
    reference's ``jax.value_and_grad``: the gradients, a tree shaped like
    ``params``, come from ``torch.autograd.grad`` over aliases of the
    parameter leaves, so no ``.grad`` is kept on them. ``loss`` is
    detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        xs = iter([p.detach().requires_grad_() for p in leaves])
        aliased = tree_map(lambda _: next(xs), params)
        loss = loss_fn(aliased, cfg, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(aliased)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


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
