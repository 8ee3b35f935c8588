"""Client-side local training, after the JAX package's ``fl/client.py``.

The reference scans every client over ``max_steps`` batches with the steps
past the scheduler's ``x_i`` masked to no-ops, so a whole round is one
``vmap``-ped program. Here a client runs exactly its ``x_i`` steps with
ordinary autograd, which computes the same parameters and loss: the masked
steps changed nothing. Exact step counts also compose with
``torch.utils.checkpoint`` (``remat="full"``) and with the models' custom
autograd functions, which ``torch.func.vmap`` and ``torch.func.grad`` do
not run (saved-tensor hooks, old-style ``autograd.Function``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..optim.optimizers import Optimizer, apply_updates, tree_leaves, tree_map

__all__ = ["local_train", "loss_and_grads", "make_client_fn", "train_steps"]


def loss_and_grads(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, as the reference's
    ``jax.value_and_grad``: the gradients, a tree shaped like ``params``,
    come from ``torch.autograd.grad`` over aliases of the leaves, so no
    ``.grad`` is kept on them; a leaf the loss does not use gets a zero
    gradient. ``loss`` is detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        xs = iter([p.detach().requires_grad_() for p in leaves])
        aliased = tree_map(lambda _: next(xs), params)
        loss = loss_fn(aliased, batch)
        grads = torch.autograd.grad(loss, tree_leaves(aliased), allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def train_steps(loss_fn: Callable, optimizer: Optimizer, params, batches, num_steps: int) -> torch.Tensor:
    """Runs ``num_steps`` updates on ``params`` IN PLACE, step ``s`` on
    ``batches[s]`` (a tensor, or a tree of tensors with a leading steps
    axis); the optimizer state starts fresh. Returns the mean loss over the
    executed steps as a float32 scalar tensor on the parameters' device (0.0
    for ``num_steps = 0``), without waiting for it."""
    max_steps = tree_leaves(batches)[0].shape[0]
    device = tree_leaves(params)[0].device
    opt_state = optimizer.init(params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    for s in range(min(int(num_steps), max_steps)):
        loss, grads = loss_and_grads(loss_fn, params, tree_map(lambda b: b[s], batches))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        del grads, updates
        loss_sum = loss_sum + loss
    return loss_sum / max(float(num_steps), 1.0)


def local_train(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    optimizer: Optimizer,
    params: Any,
    batches: Any,
    num_steps,
):
    """Runs ``num_steps`` (<= max_steps) local updates on a copy of
    ``params``.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar``.
      optimizer: client-local optimizer (state re-initialized every round, as
        FedAvg clients are stateless between rounds).
      params: starting (global) parameters; left as they are.
      batches: a tensor (or tree of tensors) with a leading ``(max_steps,
        ...)`` axis.
      num_steps: the scheduler's ``x_i`` for this client (an int, or a
        scalar tensor, which is read on the host).

    Returns:
      (final_params, mean_loss) — mean over the *executed* steps only
      (0.0 if num_steps == 0), a float32 scalar tensor.
    """
    p = tree_map(lambda t: t.detach().clone(), params)
    return p, train_steps(loss_fn, optimizer, p, batches, int(num_steps))


def make_client_fn(loss_fn: Callable, optimizer: Optimizer):
    """Closure: (params, batches, num_steps) -> (params, loss)."""

    def client_fn(params, batches, num_steps):
        return local_train(loss_fn, optimizer, params, batches, num_steps)

    return client_fn
