"""SGD, momentum, AdamW and Adafactor on trees of tensors (dicts and lists),
after the JAX package's ``optim/optimizers.py``.

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
gradient is recorded), so a step holds one extra tree, the updates. AdamW
updates each leaf with :func:`repro_torch.kernels.adamw.adamw_leaf`: on the
card one hand-written CUDA pass a leaf, bit for bit the ATen ops of its
plain version, which runs on the CPU.

Adafactor works on the reference's *stacked* leaves: the reference stacks a
model's layers on leading axes (``(n_groups, period)`` for the dense stack,
``(n,)`` for the MoE lists), factors every stacked leaf of rank >= 2 over
its last two axes and clips by the RMS of the whole stacked leaf. So a
per-layer 1-D gain stacked ``(n_groups, period, d)`` is factored, and the
clip spans every layer. :func:`adafactor` stacks the same-named leaves of
each list of layers on the leading axes that ``stacks`` gives it (a list it
does not name is refused: the layout is the model's, see
:func:`repro_torch.models.layer_stacks`), keeps its state on the stacked
shapes (the reference's ``vr``/``vc`` trees) and hands the updates back per
layer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from ..kernels.adamw import adamw_leaf
from ..spans import span

__all__ = [
    "AdafactorState", "AdamState", "Optimizer", "adafactor", "adamw", "apply_updates", "get_optimizer", "momentum",
    "sgd", "tree_leaves", "tree_map",
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


def _numel(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def _spanned(update):
    """An optimizer's ``update`` inside the span ``optim.update``
    (:mod:`repro_torch.spans`), counting the gradients' elements."""

    @functools.wraps(update)
    def spanned(grads, *rest):
        with span("optim.update", items=lambda: _numel(grads)):
            return update(grads, *rest)

    return spanned


def apply_updates(params, updates):
    """``p + u`` in ``p``'s dtype for every leaf, written into ``params``
    (the reference returns a new tree with the same values), inside the
    span ``optim.apply``. Returns ``params``."""
    with span("optim.apply", items=lambda: _numel(updates)), torch.no_grad():
        tree_map(lambda p, u: _local(p).add_(_local(u, p)), params, updates)
    return params


def _local(x, like=None):
    """The local tensor of ``x`` in ``like``'s placements (default: its
    own) when ``x`` is a DTensor, else ``x``: the optimizers' arithmetic is
    elementwise, or reduces over the dims a leaf is split on explicitly, so
    it runs on each rank's local shards, with no DTensor dispatch per
    operation."""
    if not isinstance(x, DTensor):
        return x
    if like is not None and x.placements != like.placements:
        x = x.redistribute(like.device_mesh, like.placements)
    return x.to_local()


def _like(local, p):
    """``local`` as the DTensor placed as ``p`` (``local`` itself if ``p``
    is a plain tensor)."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False, shape=p.shape, stride=p.stride())


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

    return Optimizer(init, _spanned(update))


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

    return Optimizer(init, _spanned(update))


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

    f32 = torch.float32
    # (b1, 1 - b1, weight_decay) as a weakly typed JAX scalar rounds against
    # each dtype, and b2, 1 - b2 against nu's float32
    rounded = {dt: (_as(b1, dt), _as(1 - b1, dt), _as(weight_decay, dt))
               for dt in (torch.bfloat16, torch.float16, torch.float32, torch.float64)}
    b2_f32, c2_f32 = _as(b2, f32), _as(1 - b2, f32)

    def update(grads, state, params):
        with torch.no_grad():
            step = state.step + 1
            t = step.float()
            # fills, not host-to-device copies: the step never waits on the host
            bc1 = 1 - torch.full((), b1, dtype=f32, device=t.device) ** t
            bc2 = 1 - torch.full((), b2, dtype=f32, device=t.device) ** t

            def upd(g, m, v, p):
                gl, ml, vl, pl = _local(g, p), _local(m), _local(v), _local(p)
                # contiguous: some gradients arrive strided (olmoe's experts, xlstm's blocks)
                u = adamw_leaf(gl.contiguous(), ml, vl, pl, bc1, bc2, b1=rounded[ml.dtype][0],
                               c1=rounded[gl.dtype][1], b2=b2_f32, c2=c2_f32, eps=eps, wd=rounded[pl.dtype][2], lr=lr)
                return _like(u, p)

            updates = tree_map(upd, grads, state.mu, state.nu, params)
        return updates, AdamState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init, _spanned(update))


class AdafactorState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    vr: Any  # row second moment (the full v of a leaf of rank < 2), on the stacked tree
    vc: Any  # column second moment (a 0-d zero for a leaf of rank < 2)


def _stack_lead(stacks, name, layers) -> tuple:
    if name not in stacks:
        raise ValueError(f"adafactor: the list of layers {name!r} needs its stacked layout: pass "
                         "stacks=repro_torch.models.layer_stacks(cfg)")
    lead = tuple(stacks[name])
    if math.prod(lead) != len(layers):
        raise ValueError(f"adafactor: stacks[{name!r}] = {lead} does not hold {len(layers)} layers")
    return lead


def _stacked(p, lead: tuple):
    """``(shape, placements)`` of leaf ``p`` stacked on the leading axes
    ``lead``: a DTensor's placements with each ``Shard(d)`` moved past
    them (the stacked axes are never split), ``None`` for a plain tensor."""
    pl = None
    if isinstance(p, DTensor):
        pl = [Shard(q.dim + len(lead)) if isinstance(q, Shard) else q for q in p.placements]
    return lead + tuple(p.shape), pl


def _stacked_leaves(params, stacks):
    """The stacked tree's leaves as ``(shape, placements)``
    (:func:`_stacked`), in the layout of :func:`_stack_tree`."""
    return {name: tree_map(lambda p, lead=_stack_lead(stacks, name, x): _stacked(p, lead), x[0])
            if isinstance(x, list) else tree_map(lambda p: _stacked(p, ()), x) for name, x in params.items()}


def _stack_tree(tree, stacks):
    """``tree`` with each top-level list of layers ``tree[name]`` replaced by
    one tree of its same-named leaves stacked to ``stacks[name] +
    leaf.shape``."""
    return {name: tree_map(lambda *ls, lead=_stack_lead(stacks, name, x): torch.stack(ls).reshape(lead + ls[0].shape),
                           *x)
            if isinstance(x, list) else x for name, x in tree.items()}


def _unstack_tree(stacked, like):
    """The inverse of :func:`_stack_tree`, in the shape of ``like``."""
    return {name: [tree_map(lambda s, l, i=i, n=len(x): s.reshape((n,) + l.shape)[i], stacked[name], layer)
                   for i, layer in enumerate(x)]
            if isinstance(x, list) else stacked[name] for name, x in like.items()}


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    stacks: Optional[dict] = None,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), without
    momentum, on the reference's stacked leaves (module docstring).
    ``stacks`` maps each top-level list of layers to the leading axes the
    reference stacks it on (:func:`repro_torch.models.layer_stacks`); a
    list it does not name raises ``ValueError``, since stacking it another
    way would factor and clip other leaves. The state's ``vr`` and ``vc``
    are trees of the stacked shapes, updated in place."""
    stacks = dict(stacks or {})

    def init(params):
        first = tree_leaves(params)[0]

        def zeros(leaf, drop):
            """Zeros of the leaf's shape without dim ``drop`` (counted from
            the end; none for a leaf of rank < 2, a 0-d zero for vc there)."""
            shape, pl = leaf
            if len(shape) >= 2:
                n = len(shape)
                keep = [d for d in range(n) if d != n - drop]
                shape = tuple(shape[d] for d in keep)
                pl = pl and [Shard(keep.index(p.dim)) if isinstance(p, Shard) and p.dim in keep else
                             (Replicate() if isinstance(p, Shard) else p) for p in pl]
            elif drop == 2:
                shape, pl = (), pl and [Replicate()] * len(pl)
            if pl is None:
                return torch.zeros(shape, dtype=torch.float32, device=first.device)
            return dtensor_zeros(shape, dtype=torch.float32, device_mesh=first.device_mesh, placements=pl)

        leaves = _stacked_leaves(params, stacks)
        return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                              vr=tree_map(lambda lf: zeros(lf, 1), leaves), vc=tree_map(lambda lf: zeros(lf, 2), leaves))

    def update(grads, state, params):
        with torch.no_grad():
            step = state.step + 1
            beta = 1.0 - (step.float() + 1.0) ** (-decay)

            def sqrt(x):
                """The correctly rounded float32 square root, through
                float64 (PyTorch's float32 one on the CPU is not: it is
                within an ulp)."""
                return x.double().sqrt().float()

            def upd(g, vr, vc, leaf):
                shape, pl = leaf
                split = {}  # dim of the stacked leaf -> the mesh dims (of size > 1) that split it
                for i, q in enumerate(pl or ()):
                    if isinstance(q, Shard) and mesh.size(i) > 1:
                        split.setdefault(q.dim, []).append(i)

                def mean(x, dim=None, keepdim=False):
                    """A float32 mean summed in float64: the correctly rounded
                    mean, within float32 summation-order noise of the
                    reference's. ``x``'s dims are the stacked leaf's first
                    ones; over a split dim the local sums are added over
                    the mesh dims that split it (an all-reduce)."""
                    if not split:
                        m = x.mean(dtype=torch.float64) if dim is None else x.mean(dim=dim, keepdim=keepdim,
                                                                                     dtype=torch.float64)
                        return m.float()
                    dims = range(x.dim()) if dim is None else [dim % x.dim()]
                    m = x.sum(dtype=torch.float64) if dim is None else x.sum(dim=dim, keepdim=keepdim,
                                                                             dtype=torch.float64)
                    for i in sorted({i for d in dims for i in split.get(d, ())}):
                        dist.all_reduce(m, group=mesh.get_group(i))
                    return (m / math.prod(shape[d] for d in dims)).float()

                vr, vc = _local(vr), _local(vc)
                g32 = g.float()
                g2 = g32.square() + eps
                if g.dim() >= 2:
                    vr.mul_(beta).add_((1 - beta) * mean(g2, -1))
                    vc.mul_(beta).add_((1 - beta) * mean(g2, -2))
                    # rank-1 reconstruction of 1/sqrt(v)
                    r = vr / mean(vr, -1, keepdim=True).clamp_min(eps)
                    pre = g32 / (sqrt(r)[..., None] * sqrt(vc)[..., None, :] + eps)
                else:
                    vr.mul_(beta).add_((1 - beta) * g2)
                    pre = g32 / (sqrt(vr) + eps)
                # update clipping by RMS
                rms = sqrt(mean(pre.square()) + eps)
                pre = pre / (rms / clip_threshold).clamp_min(1.0)
                return -lr * pre

            # on DTensors every leaf's arithmetic runs on its local shards:
            # the gradients in the parameters' placements, stacked locally
            first = tree_leaves(params)[0]
            mesh = first.device_mesh if isinstance(first, DTensor) else None
            local_params = tree_map(_local, params)
            g_stacked = _stack_tree(tree_map(_local, grads, params), stacks)
            u_stacked = tree_map(upd, g_stacked, state.vr, state.vc, _stacked_leaves(params, stacks))
            updates = tree_map(lambda u, p: _like(u.to(p.dtype), p), _unstack_tree(u_stacked, local_params), params)
        return updates, AdafactorState(step=step, vr=state.vr, vc=state.vc)

    return Optimizer(init, _spanned(update))


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    makers = {"sgd": sgd, "momentum": momentum, "adamw": adamw, "adafactor": adafactor}
    if name not in makers:
        raise ValueError(f"unknown optimizer {name!r}")
    return makers[name](lr, **kw)
