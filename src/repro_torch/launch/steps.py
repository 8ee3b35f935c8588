"""Step builders of the port, after the JAX package's ``launch/steps.py``.

``build_train_step`` is the LM training step (loss, gradients, optimizer
update), ``build_prefill_step`` the prefill and ``build_serve_step`` one
greedy decode step against the decode cache (KV caches, and the recurrent
states of the xLSTM and Zamba2 models), for every family through the model
API (:mod:`repro_torch.models.model`; the encoder has no serve step).
"""

from __future__ import annotations

from ..configs.base import ModelConfig
from ..fl.client import loss_and_grads
from ..models.model import decode_fn, layer_stacks, loss_fn, prefill_fn
from ..optim.optimizers import apply_updates, get_optimizer

__all__ = ["build_prefill_step", "build_serve_step", "build_train_step", "value_and_grad"]


def value_and_grad(params, cfg: ModelConfig, batch):
    """``(loss, grads)`` of :func:`repro_torch.models.loss_fn`
    (:func:`repro_torch.fl.client.loss_and_grads`): no ``.grad`` is kept on
    the parameters; ``loss`` is detached."""
    return loss_and_grads(lambda p, b: loss_fn(p, cfg, b), params, batch)


def build_train_step(cfg: ModelConfig):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` with ``opt = get_optimizer(cfg.optimizer,
    cfg.learning_rate)`` and ``opt_state = opt.init(params)``. The parameters
    and the optimizer state are updated in place and returned. Adafactor
    factors the reference's stacked leaves (``stacks=layer_stacks(cfg)``)."""
    kw = {"stacks": layer_stacks(cfg)} if cfg.optimizer == "adafactor" else {}
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate, **kw)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return train_step, opt


def build_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)``: float32 logits over the full
    sequence (:func:`repro_torch.models.prefill_fn`; the encoder's frames,
    the VLM's text after its patches)."""

    def prefill_step(params, batch):
        return prefill_fn(params, cfg, batch)

    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, tokens, pos) -> (next_tok, cache)``: one
    decode step (:func:`repro_torch.models.decode_fn`) and the greedy next
    token ``(B, 1)``, int64 (the port's token dtype; the reference's is
    int32), left on the device. KV caches are updated in place; recurrent
    states come back new (:func:`repro_torch.models.decode_fn`)."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_fn(params, cfg, cache, tokens, pos)
        return logits[:, -1:, :].argmax(dim=-1), cache

    return serve_step
