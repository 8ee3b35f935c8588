"""Mesh context and sharding rules, after the JAX package's
``launch/sharding.py``, on PyTorch's ``DeviceMesh`` and ``DTensor``.

Models are written against *logical* axes; this module resolves them to
mesh axes at run time (or to no-ops when no mesh is active: one device).

Logical axes:
  batch   -> ('pod', 'data') when the pod axis exists, else ('data',)
  fsdp    -> 'data'   (weight shards all-gathered at use; ZeRO-3 style)
  tensor  -> 'model'  (heads / ff / vocab / expert-hidden)
  expert  -> EP placement axes (('model',) or ('data', 'model'))
  seq     -> optional KV-cache sequence sharding for long-context decode

A spec is a tuple with one entry per tensor dim: ``None``, one mesh axis
name, or a tuple of them (what the reference's ``PartitionSpec`` holds).
:func:`spec_to_placements` turns a spec into DTensor placements on a
``DeviceMesh``. The mesh is read by its axis names and sizes only, so a
stand-in with ``axis_names`` and a ``shape`` mapping serves the pure
functions (:func:`infer_pspec`, :func:`param_pspecs`, :func:`axis_size`).

``set_mesh(mesh, rules)`` installs the active mesh; ``shard(x, *logical)``
redistributes a DTensor to the logical spec (the reference's sharding
constraint), and is the identity without a mesh. Under a mesh the model runs
on DTensors, one process per rank: parameters come from
:func:`distribute_params`, batches and caches from
:func:`repro_torch.launch.steps.batch_pspecs` and ``cache_pspecs``.
"""

from __future__ import annotations

import math
import re
import threading
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

__all__ = [
    "DEFAULT_RULES",
    "axis_size",
    "current_mesh",
    "distribute_params",
    "infer_pspec",
    "local_shards",
    "logical_to_mesh",
    "mesh_context",
    "no_batch_product",
    "param_pspecs",
    "rules",
    "set_mesh",
    "shard",
    "spec_to_placements",
]

_MESH = None
_RULES = {}

DEFAULT_RULES = {
    "batch": ("data",),
    "fsdp": ("data",),
    "tensor": ("model",),
    "expert": ("model",),
    "seq": None,
    # sequence-parallel residual activations: 'model' for train/prefill
    # shapes (divides the residual stack saved for backward by the
    # tensor-parallel degree); None for decode.
    "act_seq": None,
}


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh=None) -> dict:
    """``{axis name: size}`` of ``mesh`` (default: the active mesh): a
    ``DeviceMesh``'s dim names and sizes, or a stand-in's ``shape``
    mapping."""
    mesh = _MESH if mesh is None else mesh
    if isinstance(mesh.shape, Mapping):
        return {a: int(mesh.shape[a]) for a in _axis_names(mesh)}
    return dict(zip(_axis_names(mesh), (int(s) for s in mesh.shape)))


def set_mesh(mesh, rules: Optional[dict] = None):
    global _MESH, _RULES
    _MESH = mesh
    _RULES = dict(DEFAULT_RULES)
    if mesh is not None and "pod" in _axis_names(mesh):
        _RULES["batch"] = ("pod", "data")
    if rules:
        _RULES.update(rules)


def current_mesh():
    return _MESH


def rules():
    return dict(_RULES)


@contextmanager
def mesh_context(mesh, rules: Optional[dict] = None):
    prev_mesh, prev_rules = _MESH, dict(_RULES)
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        set_mesh(prev_mesh)
        _RULES.clear()
        _RULES.update(prev_rules)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes behind a logical axis (1 if no mesh)."""
    if _MESH is None:
        return 1
    shape = mesh_shape()
    return math.prod(shape[a] for a in _axes(_RULES.get(logical)))


def logical_to_mesh(*logical) -> tuple:
    """The spec (one entry per logical name) of logical axes under the
    active rules."""
    parts = []
    for name in logical:
        ax = None if name is None else _RULES.get(name, None)
        if isinstance(ax, (tuple, list)):
            parts.append(tuple(ax) if len(ax) > 1 else ax[0])
        else:
            parts.append(ax)
    return tuple(parts)


def spec_to_placements(spec, mesh, shape=None) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that a spec entry names, ``Replicate()`` on the others. An
    entry naming several axes shards its dim over them major first, as JAX
    orders a tuple entry; DTensor nests shards in mesh-dim order, so their
    order must be the mesh's. Given the tensor's ``shape``, a dim of size 1
    is placed as ``Replicate()`` on every axis (it holds the same values on
    every rank): DTensor's views refuse a sharded singleton (MQA's one KV
    head on a model axis of size 1). So is a dim that its axes do not
    divide (gemma2-2b's 8 heads on the production mesh's 16-wide model
    axis): DTensor would split it unevenly, which ``local_map`` bodies
    (attention) cannot take, where the reference's GSPMD pads it. Raises
    ``ValueError`` on an axis used twice, on an axis the mesh lacks, or on
    a tuple out of the mesh's order."""
    names = _axis_names(mesh)
    placements, used = [Replicate()] * len(names), set()
    for dim, entry in enumerate(spec):
        if shape is not None and entry is not None and (
                shape[dim] == 1 or shape[dim] % math.prod(mesh_shape(mesh)[a] for a in _axes(entry))):
            entry = None
        mesh_dims = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec}: mesh {names} has no axis {a!r}")
            i = names.index(a)
            if i in used:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            used.add(i)
            placements[i] = Shard(dim)
            mesh_dims.append(i)
        if mesh_dims != sorted(mesh_dims):
            raise ValueError(f"spec {spec}: entry {entry} is out of the mesh's axis order {names}")
    return placements


def like(x, t: torch.Tensor):
    """``t``, a plain tensor made the same on every rank (positions, masks,
    indices), as a replicated DTensor on ``x``'s mesh when ``x`` is a
    DTensor; else ``t`` itself, so the one-device path keeps its tensors."""
    if isinstance(x, DTensor) and not isinstance(t, DTensor):
        mesh = x.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient's local tensor
    contiguous. A redistribution's backward can hand back a local tensor
    in another memory layout (gloo's all-to-all is an all-gather and a
    chunk), while DTensor's views (a matrix product's ``_unsafe_view``
    backward) take the local tensor to be laid out as the global one is."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and not g._local_tensor.is_contiguous():
            g = DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements, run_check=False,
                                   shape=g.shape, stride=g.stride())
        return g


def _redistribute(x, placements):
    """``x.redistribute`` to ``placements``, its gradient's local tensor
    made contiguous (:class:`_ContiguousGrad`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        x = _ContiguousGrad.apply(x)
    return x.redistribute(x.device_mesh, placements)


def whole_groups(x, dim: int, groups: Optional[int] = None):
    """The DTensor ``x`` with every mesh dim that shards axis ``dim`` but
    does not divide ``groups`` replicated (every one, without ``groups``),
    so that the axis can be split into ``groups`` (DTensor cannot split an
    uneven shard: the heads of a flattened ``heads * head_dim`` axis, GQA's
    ``(Hkv, G)`` split of the q heads). It always redistributes, so ``x``'s
    gradient comes back in the same placements. A plain tensor is returned
    as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    placements = [Replicate() if p == Shard(dim) and (groups is None or groups % x.device_mesh.size(i)) else p
                  for i, p in enumerate(x.placements)]
    return _redistribute(x, placements)


def whole_rows(x):
    """The DTensor ``x`` with every mesh dim that shards one of its leading
    dims behind the first one longer than 1 replicated (the sequence of a
    ``(B, S, d)`` activation whose batch is more than one), so that a
    matrix product or a reshape can flatten the leading dims into rows.
    torch 2.11's views refuse to flatten a sharded dim into any but the
    first place of a group; later torch passes it as a ``_StridedShard``.
    Other tensors are returned as they are."""
    if not isinstance(x, DTensor) or x.ndim < 3:
        return x
    first = next((i for i in range(x.ndim - 1) if x.shape[i] > 1), x.ndim - 1)
    placements = [Replicate() if isinstance(p, Shard) and first < p.dim % x.ndim < x.ndim - 1 else p
                  for p in x.placements]
    return x if placements == list(x.placements) else _redistribute(x, placements)


class _WholeRowsGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient's rows whole
    (:func:`whole_rows`): a product's output added to a sequence-split
    residual gets its gradient split so."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return whole_rows(g)


def whole_rows_grad(y):
    """``y`` (a DTensor), its gradient's rows made whole
    (:func:`whole_rows`): for a tensor that a reshape unflattened from rows
    and that is added to a sequence-split residual."""
    return _WholeRowsGrad.apply(y) if torch.is_grad_enabled() and y.requires_grad else y


_PRODUCT = threading.local()


@contextmanager
def no_batch_product():
    """Marks the matrix products run under it as products with no batch
    dims (the reference's ``dot_general`` without batch dimensions: an
    activation times a weight, the einsum dispatch's gathers), whatever
    aten op they reach (``mm``, ``addmm``, or ``bmm`` on an operand
    broadcast over the batch): what ``remat="dots"`` saves
    (:func:`repro_torch.models.dense._maybe_remat`)."""
    depth = getattr(_PRODUCT, "depth", 0)
    _PRODUCT.depth = depth + 1
    try:
        yield
    finally:
        _PRODUCT.depth = depth


def in_no_batch_product() -> bool:
    """Whether this thread runs inside :func:`no_batch_product`."""
    return getattr(_PRODUCT, "depth", 0) > 0


def linear(x, w):
    """``x @ w`` for an activation ``x (..., d)`` and a weight ``(d, f)``, a
    product with no batch dims (:func:`no_batch_product`). On DTensors the
    rows (``x``'s leading dims) are made whole first, and so are the
    gradient's (:func:`whole_rows`): the product flattens them both ways,
    which torch 2.11's views refuse where a dim behind the first is sharded
    (a sequence split by ``act_seq``). The gathered rows are recomputed
    under ``remat="dots"``; the product is saved."""
    if not isinstance(x, DTensor):
        with no_batch_product():
            return x @ w
    x = whole_rows(x)
    with no_batch_product():
        y = x @ w
    return whole_rows_grad(y)


def shard(x, *logical):
    """Redistributes the DTensor ``x`` to the spec of ``logical`` on its
    mesh (the reference's ``with_sharding_constraint``, which holds the
    gradient to the same placements, as a redistribution's backward does);
    the identity without an active mesh. Under a mesh a plain tensor raises
    ``TypeError``: it means the program left the DTensor world. A dim of
    size 1 (a batch of one) stays replicated: it holds the same values, and
    DTensor cannot flatten a sharded singleton dim into its neighbour."""
    if _MESH is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"shard{logical}: a plain {type(x).__name__} under an active mesh (expected a DTensor)")
    return _redistribute(x, spec_to_placements(logical_to_mesh(*logical), x.device_mesh, x.shape))


def local_shards(fn, args, in_specs, out_specs):
    """``fn(*args)`` on each rank's local shards (``local_map``), the
    reference's ``shard_map`` for functions that are independent along the
    dims they are split on: the recurrent cells along batch and heads, the
    depthwise conv along batch and channels. ``in_specs`` and ``out_specs``
    give one logical spec (``("batch", None, "tensor", None)``) per argument
    and per output; ``fn`` returns a flat tuple of tensors (or one tensor).
    A logical axis splits its dims over its mesh axes, and only where its
    mesh size divides every dim it labels and that dim is longer than 1
    (heads that do not divide the model axis stay whole on every rank, as
    ``whole_groups`` keeps them); the other dims are
    replicated, the inputs redistributed to that. The gradient of an input
    replicated on a mesh dim that splits the work is a partial sum there.
    Without a DTensor argument ``fn`` runs as it is."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    names = _axis_names(mesh)
    split = {}
    for a, spec in zip(args, in_specs):
        for size, name in zip(() if a is None else a.shape, spec):
            if name is not None:
                n = math.prod(mesh.size(names.index(ax)) for ax in _axes(_RULES.get(name)))
                split[name] = split.get(name, True) and size % n == 0 and size > 1

    def placements(spec):
        pl = [Replicate()] * mesh.ndim
        for dim, name in enumerate(spec):
            for ax in _axes(_RULES.get(name)) if name is not None and split[name] else ():
                pl[names.index(ax)] = Shard(dim)
        return pl

    in_pl = [None if a is None else placements(s) for a, s in zip(args, in_specs)]
    used = {i for pl in in_pl if pl for i, p in enumerate(pl) if isinstance(p, Shard)}
    grad_pl = [None if pl is None else [Partial() if i in used and p == Replicate() else p for i, p in enumerate(pl)]
               for pl in in_pl]
    out_pl = tuple(placements(s) for s in out_specs)
    return local_map(fn, out_placements=out_pl if len(out_pl) > 1 else out_pl[0], in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh, redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# Parameter sharding rules (matched on the leaf's path string).
# Rules give the LOGICAL spec of the trailing dims; leading stacked-layer
# axes are padded with None. The port's paths index a list of layers
# (``layers/3/attn/wq``) and carry no stacked axis; the same rules apply.
# ---------------------------------------------------------------------------

_PARAM_RULES = [
    # embeddings / unembedding
    (r"(^|/)emb$", ("tensor", "fsdp")),  # (V, d)
    (r"(^|/)lm_head$", ("fsdp", "tensor")),  # (d, V)
    # attention
    (r"(^|/)(wq|wk|wv)$", ("fsdp", "tensor", None)),  # (d, H, hd)
    (r"(^|/)wo$", ("tensor", None, "fsdp")),  # (H, hd, d)
    # MLA
    (r"(^|/)(w_dq|w_dkv|w_kr)$", ("fsdp", None)),
    (r"(^|/)(w_uq|w_uk|w_uv)$", (None, "tensor", None)),  # (rank, H, hd)
    (r"(^|/)w_o_mla$", ("tensor", None, "fsdp")),
    # MoE: expert dim over EP axes; d/fe unsharded (the 'tensor' axis is a
    # subset of the EP axes, so using it twice would conflict)
    (r"experts/(w_gate|w_in)$", ("expert", None, None)),  # (E, d, fe)
    (r"experts/w_out$", ("expert", None, None)),  # (E, fe, d)
    (r"(^|/)router$", ("fsdp", None)),  # (d, E)
    # dense MLP
    (r"(^|/)(w_gate|w_in)$", ("fsdp", "tensor")),
    (r"(^|/)w_out$", ("tensor", "fsdp")),
    # mamba / xlstm projections
    (r"(^|/)in_proj$", ("fsdp", "tensor")),
    (r"(^|/)out_proj$", ("tensor", "fsdp")),
    (r"(^|/)conv_w$", (None, "tensor")),  # (K, conv_dim)
    (r"(^|/)(A_log|dt_bias|D)$", ("tensor",)),  # (H,)
    # mLSTM head-wise block-diagonal projections
    (r"(^|/)(wq_m|wk_m)$", (None, None, None)),  # (H, DV, DK) small
    (r"(^|/)wv_m$", (None, None, "tensor")),  # (H, DV, DV)
    (r"(^|/)(wi_gate|wf_gate|wo_gate_m)$", ("fsdp", None)),
    # sLSTM
    (r"(^|/)(rz|ri|rf|ro)$", (None, None, None)),  # (H, D, D) small
    (r"(^|/)w_zifo$", ("fsdp", None, None)),  # (d, 4, H*D)
    # frontends / misc projections
    (r"(^|/)(frame_proj|patch_proj)$", ("fsdp", "tensor")),
    (r"(^|/)mask_emb$", (None,)),
    # norms / biases / scalars: replicated
    (r".*", None),
]


def _axes_size(entry) -> int:
    if _MESH is None:
        return 1
    shape = mesh_shape()
    return math.prod(shape[a] for a in _axes(entry))


def infer_pspec(path: str, shape) -> tuple:
    """The spec of the leaf at ``path`` (``/``-joined keys and list
    indices) of shape ``shape`` under the active mesh and rules."""
    ndim = len(shape)
    for pattern, logical in _PARAM_RULES:
        if re.search(pattern, path):
            if logical is None:
                return ()
            spec = list(logical_to_mesh(*logical))
            # pad leading stacked-layer axes
            while len(spec) < ndim:
                spec.insert(0, None)
            if len(spec) > ndim:  # rule longer than leaf (e.g. scalar) -> replicate
                return ()
            # drop axes that don't divide the dim (e.g. MQA kv=1 heads)
            for i, entry in enumerate(spec):
                if entry is not None and shape[i] % _axes_size(entry) != 0:
                    spec[i] = None
            return tuple(spec)
    return ()


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, x, f"{path}/{k}" if path else str(k)) for k, x in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, x, f"{path}/{i}" if path else str(i)) for i, x in enumerate(tree)]
    return fn(path, tree)


def param_pspecs(params):
    """A tree like ``params`` (dicts and lists) of specs (requires an
    active mesh)."""
    return _map_with_path(lambda path, leaf: infer_pspec(path, tuple(leaf.shape)), params)


def distribute_params(params, mesh=None):
    """``params`` as DTensors on ``mesh`` (default: the active mesh), each
    leaf placed by :func:`param_pspecs` under the active rules (a dim of
    size 1 replicated: :func:`spec_to_placements`), its data taken from
    rank 0. A local shard may share storage with the leaf it
    came from, so a step that updates the DTensors in place may change
    ``params`` too: pass a copy to keep them."""
    mesh = _MESH if mesh is None else mesh
    return _map_with_path(
        lambda path, leaf: distribute_tensor(
            leaf, mesh, spec_to_placements(infer_pspec(path, tuple(leaf.shape)), mesh, leaf.shape),
            src_data_rank=0),
        params)
