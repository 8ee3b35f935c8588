"""Step builders and sharding specs of the port, after the JAX package's
``launch/steps.py``.

``build_train_step`` is the LM training step (loss, gradients, optimizer
update), ``build_prefill_step`` the prefill and ``build_serve_step`` one
greedy decode step against the decode cache (KV caches, and the recurrent
states of the xLSTM and Zamba2 models), for every family through the model
API (:mod:`repro_torch.models.model`; the encoder has no serve step).

Under an active mesh (:mod:`repro_torch.launch.sharding`) the same steps
run on DTensor arguments, one process per rank: parameters placed by
:func:`repro_torch.launch.sharding.distribute_params` (or
:func:`train_shardings`), batches by :func:`batch_pspecs`, decode caches by
:func:`cache_pspecs`. The spec functions are pure functions of shapes and
the mesh's axis sizes. ``abstract_params`` and ``abstract_opt_state`` give
the parameters and the optimizer state as fake tensors
(:func:`repro_torch.models.model.fake_mode`), for the dry run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..fl.client import loss_and_grads
from ..models.model import decode_fn, fake_mode, init_params, layer_stacks, loss_fn, prefill_fn
from ..optim.optimizers import AdafactorState, AdamState, apply_updates, get_optimizer
from ..spans import span
from . import sharding as shd

__all__ = [
    "abstract_opt_state",
    "abstract_params",
    "batch_pspecs",
    "build_prefill_step",
    "build_serve_step",
    "build_train_step",
    "cache_pspecs",
    "distribute_tree",
    "opt_state_pspecs",
    "spec_leaves",
    "train_shardings",
    "value_and_grad",
]


def _optimizer(cfg: ModelConfig):
    """The train step's optimizer: Adafactor factors the reference's stacked
    leaves (``stacks=layer_stacks(cfg)``); AdamW takes ``cfg.adam_b2`` and
    ``cfg.weight_decay``."""
    kw = {}
    if cfg.optimizer == "adafactor":
        kw = {"stacks": layer_stacks(cfg)}
    elif cfg.optimizer == "adamw":
        kw = {"b2": cfg.adam_b2, "weight_decay": cfg.weight_decay}
    return get_optimizer(cfg.optimizer, cfg.learning_rate, **kw)


def value_and_grad(params, cfg: ModelConfig, batch):
    """``(loss, grads)`` of :func:`repro_torch.models.loss_fn`
    (:func:`repro_torch.fl.client.loss_and_grads`): no ``.grad`` is kept on
    the parameters; ``loss`` is detached."""
    return loss_and_grads(lambda p, b: loss_fn(p, cfg, b), params, batch)


def _tokens_predicted(batch):
    """``B * (T - 1)`` of ``batch["tokens"] (B, T)``; ``None`` for a batch
    without tokens (the encoder's)."""
    tokens = batch.get("tokens")
    return None if tokens is None else tokens.shape[0] * (tokens.shape[1] - 1)


def build_train_step(cfg: ModelConfig):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` with ``opt = get_optimizer(cfg.optimizer,
    cfg.learning_rate)`` and ``opt_state = opt.init(params)``. The parameters
    and the optimizer state are updated in place and returned. Adafactor
    factors the reference's stacked leaves (``stacks=layer_stacks(cfg)``).
    The step runs in the span ``train.step`` (:mod:`repro_torch.spans`)."""
    opt = _optimizer(cfg)

    def train_step(params, opt_state, batch):
        with span("train.step", items=lambda: _tokens_predicted(batch)):
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


def _greedy(logits):
    """``logits.argmax(dim=-1)``; on DTensors the vocabulary replicated and
    the argmax taken on the local shards (``local_map``: the reduction has
    no sharding rule in every torch version)."""
    if not isinstance(logits, DTensor):
        return logits.argmax(dim=-1)
    mesh = logits.device_mesh
    pl = [Replicate() if p == Shard(logits.ndim - 1) or p.is_partial() else p for p in logits.placements]
    return local_map(lambda x: x.argmax(dim=-1), out_placements=pl, in_placements=(pl,), device_mesh=mesh,
                     redistribute_inputs=True)(logits)


def build_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, tokens, pos) -> (next_tok, cache)``: one
    decode step (:func:`repro_torch.models.decode_fn`) and the greedy next
    token ``(B, 1)``, int64 (the port's token dtype; the reference's is
    int32), left on the device. KV caches are updated in place; recurrent
    states come back new (:func:`repro_torch.models.decode_fn`)."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_fn(params, cfg, cache, tokens, pos)
        return _greedy(logits[:, -1:, :]), cache

    return serve_step


# ---------------------------------------------------------------------------
# abstract values (fake tensors: no allocation)
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig, device="cuda"):
    """:func:`repro_torch.models.init_params` under the fake mode: the
    parameter tree's shapes and dtypes on ``device``, nothing allocated."""
    with fake_mode():
        return init_params(cfg, 0, device)


def abstract_opt_state(cfg: ModelConfig, params_struct):
    """The train step's optimizer state (:func:`build_train_step`'s
    ``opt.init``) for ``params_struct`` under the fake mode."""
    with fake_mode():
        return _optimizer(cfg).init(params_struct)


# ---------------------------------------------------------------------------
# sharding specs (a spec is a tuple: see repro_torch.launch.sharding)
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    """A spec: a plain tuple of ``None``, axis names and tuples of axis
    names (a tuple of specs, a cache's ``(k, v)``, is not one)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def _map_tree(fn, tree, is_leaf):
    """``fn`` over the leaves (``is_leaf``) of a tree of dicts, lists,
    tuples and NamedTuples, in the tree's shape."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, x, is_leaf) for k, x in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, x, is_leaf) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, x, is_leaf) for x in tree)
    return fn(tree)


def _map_specs(fn, tree):
    """``fn`` over the specs (tuples) of a tree of specs."""
    return _map_tree(fn, tree, _is_spec)


def _map_tensors(fn, tree):
    """``fn`` over the tensors of a tree (``None`` leaves stay ``None``)."""
    return _map_tree(lambda x: None if x is None else fn(x), tree, lambda x: x is None or hasattr(x, "shape"))


def spec_leaves(specs) -> list:
    """The specs of a tree of specs, in the tree's order."""
    out = []
    _map_specs(out.append, specs)
    return out


def distribute_tree(tree, specs, mesh=None):
    """``tree``'s tensors as DTensors on ``mesh`` (default: the active
    mesh), each placed by the spec at the same place of ``specs`` (as
    ``batch_pspecs`` and ``cache_pspecs`` give them), a dim of size 1
    replicated."""
    mesh = shd.current_mesh() if mesh is None else mesh
    it = iter(spec_leaves(specs))
    return _map_tensors(lambda x: distribute_tensor(x, mesh, shd.spec_to_placements(next(it), mesh, x.shape)), tree)


def _stacked_specs(pspecs, stacks):
    """The specs of the stacked tree (:func:`repro_torch.optim.optimizers._stack_tree`):
    each list of layers becomes one tree of its first layer's specs with
    the stacked axes' ``None`` in front (a replicated ``()`` stays
    ``()``), as the reference's rules pad a stacked leaf."""
    return {name: _map_specs(lambda s, n=len(stacks[name]): ((None,) * n + s) if s else s, x[0])
            if isinstance(x, list) else x for name, x in pspecs.items()}


def opt_state_pspecs(cfg: ModelConfig, pspecs):
    """The optimizer state's specs for parameter specs ``pspecs``
    (:func:`repro_torch.launch.sharding.param_pspecs`). Adafactor's ``vr``
    and ``vc`` live on the stacked leaves, so their specs follow the
    reference's rule on the stacked specs (``layer_stacks(cfg)``)."""
    name = cfg.optimizer
    if name == "sgd":
        return ()
    if name == "momentum":
        return pspecs
    if name == "adamw":
        return AdamState(step=(), mu=pspecs, nu=pspecs)
    if name == "adafactor":
        stacked = _stacked_specs(pspecs, layer_stacks(cfg))
        vr = _map_specs(lambda s: s[:-1] if len(s) >= 2 else s, stacked)
        vc = _map_specs(lambda s: s[:-2] + s[-1:] if len(s) >= 2 else (), stacked)
        return AdafactorState(step=(), vr=vr, vc=vc)
    raise ValueError(name)


def _batch_axes_for(B: int):
    """Logical batch axes that actually divide B (else unsharded)."""
    shape = shd.mesh_shape()
    rule = shd.rules()["batch"]
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    if B % math.prod(shape[a] for a in axes) == 0:
        return axes if len(axes) > 1 else axes[0]
    # try data only
    if B % shape["data"] == 0:
        return "data"
    return None


def batch_pspecs(cfg: ModelConfig, batch_struct, B: int):
    """A spec for each tensor of ``batch_struct``: its leading batch dim on
    the batch axes that divide ``B``."""
    ba = _batch_axes_for(B)
    return _map_tensors(lambda leaf: (ba,) + (None,) * (len(leaf.shape) - 1), batch_struct)


def cache_pspecs(cfg: ModelConfig, cache_struct, B: int, S: int):
    """The reference's heuristic per-leaf cache sharding:
      batch dim -> batch axes (if divisible); else
      seq dim   -> 'data' (long-context: shard the KV cache sequence);
      largest remaining dim divisible by the tensor size -> 'model'.
    The port's caches carry one leading layer axis where the reference's
    carry ``(n_groups, period)``. That axis is never placed, and the scans
    start after it, so a layer count equal to ``B`` or ``S`` takes no axis;
    the specs of the other dims agree with the reference's."""
    shape = shd.mesh_shape()
    ba = _batch_axes_for(B)
    tensor_size = shape["model"]
    data_size = shape["data"]

    def spec(leaf):
        dims = list(leaf.shape)
        out = [None] * len(dims)
        batch_done = False
        if ba is not None:
            for i, dsz in enumerate(dims[1:], 1):
                if dsz == B:
                    out[i] = ba
                    batch_done = True
                    break
        data_taken = batch_done and (ba == "data" or (isinstance(ba, tuple) and "data" in ba))
        if not data_taken:
            for i, dsz in enumerate(dims[1:], 1):
                if out[i] is None and dsz == S and S % data_size == 0:
                    out[i] = "data"
                    break
        # largest remaining dim divisible by the tensor size -> 'model'
        cands = [(dsz, i) for i, dsz in enumerate(dims[1:], 1)
                 if out[i] is None and dsz % tensor_size == 0 and dsz >= tensor_size and dsz != S]
        if cands:
            _, i = max(cands)
            out[i] = "model"
        return tuple(out)

    return _map_tensors(spec, cache_struct)


def train_shardings(cfg: ModelConfig, params_struct, opt_struct, batch_struct, B: int):
    """DTensor placements (on the active mesh) of the parameters, the
    optimizer state and the batch: ``(params, opt_state, batch)`` trees of
    placement lists, a dim of size 1 replicated as ``distribute_params``
    places it (the shapes read from the structs' tensors; with
    ``opt_struct=None`` the optimizer state's placements follow its specs
    alone)."""
    mesh = shd.current_mesh()
    pspecs = shd.param_pspecs(params_struct)
    ospecs = opt_state_pspecs(cfg, pspecs)
    bspecs = batch_pspecs(cfg, batch_struct, B)

    def to_pl(specs, struct):
        shapes, n = [], []
        if struct is not None:
            _map_tensors(lambda x: shapes.append(tuple(x.shape)), struct)
            _map_specs(n.append, specs)
            if len(n) != len(shapes):
                raise ValueError(f"{len(n)} specs for a struct of {len(shapes)} tensors")
        it = iter(shapes)
        return _map_specs(lambda s: shd.spec_to_placements(s, mesh, next(it, None)), specs)

    return (to_pl(pspecs, params_struct), (() if cfg.optimizer == "sgd" else to_pl(ospecs, opt_struct)),
            to_pl(bspecs, batch_struct))
