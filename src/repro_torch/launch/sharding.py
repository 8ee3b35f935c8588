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
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

__all__ = [
    "DEFAULT_RULES",
    "axis_size",
    "current_mesh",
    "distribute_params",
    "infer_pspec",
    "logical_to_mesh",
    "mesh_context",
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


def spec_to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that a spec entry names, ``Replicate()`` on the others. An
    entry naming several axes shards its dim over them major first, as JAX
    orders a tuple entry; DTensor nests shards in mesh-dim order, so their
    order must be the mesh's. Raises ``ValueError`` on an axis used twice,
    on an axis the mesh lacks, or on a tuple out of the mesh's order."""
    names = _axis_names(mesh)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        mesh_dims = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec}: mesh {names} has no axis {a!r}")
            i = names.index(a)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
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


def whole_groups(x, dim: int, groups: int):
    """The DTensor ``x`` with every mesh dim that shards axis ``dim`` but
    does not divide ``groups`` replicated, so that the axis can be split
    into ``groups`` (DTensor cannot split an uneven shard: the heads of a
    flattened ``heads * head_dim`` axis, GQA's ``(Hkv, G)`` split of the q
    heads). It always redistributes, so ``x``'s gradient comes back in the
    same placements. A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    placements = [Replicate() if p == Shard(dim) and groups % x.device_mesh.size(i) else p
                  for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, placements)


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
    placements = [Replicate() if isinstance(p, Shard) and x.shape[p.dim] == 1 else p
                  for p in spec_to_placements(logical_to_mesh(*logical), x.device_mesh)]
    return x.redistribute(x.device_mesh, placements)


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
    leaf placed by :func:`param_pspecs` under the active rules, its data
    taken from rank 0. A local shard may share storage with the leaf it
    came from, so a step that updates the DTensors in place may change
    ``params`` too: pass a copy to keep them."""
    mesh = _MESH if mesh is None else mesh
    return _map_with_path(
        lambda path, leaf: distribute_tensor(
            leaf, mesh, spec_to_placements(infer_pspec(path, tuple(leaf.shape)), mesh), src_data_rank=0),
        params)
