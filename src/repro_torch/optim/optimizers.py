"""SGD, momentum and AdamW on trees of tensors (dicts and lists), after the
JAX package's ``optim/optimizers.py``.

The interface is the reference's: ``opt = adamw(lr)``; ``state =
opt.init(params)``; ``updates, state = opt.update(grads, state, params)``;
``params = apply_updates(params, updates)``. So is the arithmetic, down to
where it rounds: ``mu`` is kept in the parameter dtype and ``nu`` in float32,
the bias corrections are float32 powers of the step, and the update is cast
to the parameter dtype before it is added. A Python number meeting a tensor
takes the tensor's dtype first, as a weakly typed JAX scalar does (``0.9``
becomes ``0.8984375`` against bfloat16), so bfloat16 moments round as the
reference's do. ``torch.optim.AdamW`` is not used: it keeps its moments in
the parameters' dtype and rounds elsewhere.

Unlike the reference, ``update`` writes the new moments into the state's
tensors and ``apply_updates`` adds into the parameters, in place (no
gradient is recorded), so a step holds one extra tree, the updates. The
reference's other optimizers come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

__all__ = [
    "AdamState", "Optimizer", "adamw", "apply_updates", "get_optimizer", "momentum", "sgd", "tree_leaves",
    "tree_map",
]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and lists (and of the trees
    in ``rest``, which share its structure), in the tree's shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, x, *(r[k] for r in rest)) for k, x in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def apply_updates(params, updates):
    """``p + u`` in ``p``'s dtype for every leaf, written into ``params``
    (the reference returns a new tree with the same values). Returns
    ``params``."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u), params, updates)
    return params


def _as(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: the value a weakly typed JAX scalar takes
    against a tensor of that dtype."""
    return torch.tensor(x, dtype=dtype).item()


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        with torch.no_grad():
            return tree_map(lambda g: _as(-lr, g.dtype) * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum; the state (one tree like the parameters) is
    updated in place and returned."""

    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        with torch.no_grad():
            def upd(m, g):
                m.mul_(_as(beta, m.dtype)).add_(g)
                if nesterov:
                    return _as(-lr, m.dtype) * (_as(beta, m.dtype) * m + g)
                return _as(-lr, m.dtype) * m

            return tree_map(upd, state, grads), state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    mu: Any
    nu: Any


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mu_dtype: Optional[torch.dtype] = None,
) -> Optimizer:
    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device), mu=mu, nu=nu)

    def update(grads, state, params):
        with torch.no_grad():
            step = state.step + 1
            t = step.float()
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t

            def upd(g, m, v, p):
                m.mul_(_as(b1, m.dtype)).add_(_as(1 - b1, g.dtype) * g)
                v.mul_(_as(b2, v.dtype)).add_(_as(1 - b2, v.dtype) * g.float().square())
                u = (m.float() / bc1) / ((v / bc2).sqrt() + eps) + _as(weight_decay, p.dtype) * p
                return (-lr * u).to(p.dtype)

            updates = tree_map(upd, grads, state.mu, state.nu, params)
        return updates, AdamState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    makers = {"sgd": sgd, "momentum": momentum, "adamw": adamw}
    if name in makers:
        return makers[name](lr, **kw)
    if name == "adafactor":
        raise NotImplementedError(
            "optimizer 'adafactor' is not ported yet: it comes with the MoE family (ROADMAP.md, Queue 1)"
        )
    raise ValueError(f"unknown optimizer {name!r}")
