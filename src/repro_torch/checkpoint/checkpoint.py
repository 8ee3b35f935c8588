"""Dependency-free tree checkpointing: ``.npz`` arrays + a ``.json``
manifest, in the JAX package's layout (``checkpoint/checkpoint.py``).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or Python scalars. A leaf's key is the ``/``-joined path of dict keys
and list indices, dict keys taken in sorted order as ``jax.tree_util``
flattens them, so a checkpoint written by either package names its arrays
the same way. ``None`` is an empty subtree, as in JAX.

bfloat16 tensors have no numpy dtype: they are stored as their uint16 bit
patterns and the manifest's ``"dtypes"`` names them ``"bfloat16"``, so they
restore bit for bit. (The JAX package writes bfloat16 arrays as 2-byte void
records; those load as bfloat16 too.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "array_to_tensor",
    "flatten_with_paths",
    "latest_checkpoint",
    "load_checkpoint",
    "load_checkpoint_arrays",
    "map_with_paths",
    "save_checkpoint",
]


def map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, in its shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, tree[k], f"{prefix}{k}/") for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, x, f"{prefix}{i}/") for i, x in enumerate(tree))
    return fn(prefix[:-1], tree)


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in ``jax.tree_util``'s order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in flatten_with_paths(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _to_numpy(leaf):
    """(array, dtype name for the manifest or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def array_to_tensor(arr: np.ndarray, dtype: Optional[str] = None) -> torch.Tensor:
    """A CPU tensor of a stored array; ``dtype="bfloat16"`` (the manifest's
    name) reads uint16 bit patterns, and 2-byte void records are taken as
    bfloat16 bits too."""
    arr = np.asarray(arr)
    if dtype == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(directory: str, step: int, tree: Any, extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays, keys, dtypes = {}, [], {}
    for k, leaf in flatten_with_paths(tree):
        keys.append(k)
        arrays[k], name = _to_numpy(leaf)
        if name is not None:
            dtypes[k] = name
    base = os.path.join(directory, f"ckpt_{step:08d}")
    np.savez(base + ".npz", **arrays)
    manifest = {"step": step, "keys": keys, "extra": extra or {}, "dtypes": dtypes}
    with open(base + ".json", "w") as f:
        json.dump(manifest, f)
    return base


def _restore(arr, dtype: Optional[str], like):
    """``arr`` in the dtype, shape and (for a tensor) device of ``like``."""
    if isinstance(like, torch.Tensor):
        t = array_to_tensor(arr, dtype)
        return t.to(like.dtype).reshape(like.shape).to(like.device)
    like = np.asarray(like)
    if dtype is not None:
        return array_to_tensor(arr, dtype).float().numpy().astype(like.dtype).reshape(like.shape)
    return np.asarray(arr).astype(like.dtype).reshape(like.shape)


def load_checkpoint(directory: str, step: int, like: Any):
    """The checkpoint's tree in the structure of ``like``, each leaf in the
    dtype, shape and device of ``like``'s, and the manifest."""
    base = os.path.join(directory, f"ckpt_{step:08d}")
    with open(base + ".json") as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(base + ".npz") as data:
        tree = map_with_paths(lambda k, leaf: _restore(data[k], dtypes.get(k), leaf), like)
    return tree, manifest


def load_checkpoint_arrays(directory: str, step: int):
    """Schema-driven restore: the raw ``{path: np.ndarray}`` mapping plus the
    manifest, with no ``like`` tree required (bfloat16 arrays as their uint16
    bits: :func:`array_to_tensor` with the manifest's ``"dtypes"`` entry
    reads them). For consumers whose restore target is not a fixed tree —
    e.g. the campaign checkpoints, where the number of rounds (and whether a
    round carries recovery provenance) is data, not structure."""
    base = os.path.join(directory, f"ckpt_{step:08d}")
    with open(base + ".json") as f:
        manifest = json.load(f)
    with np.load(base + ".npz") as data:
        arrays = {k: data[k] for k in manifest["keys"]}
    return arrays, manifest


def latest_checkpoint(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("ckpt_") : -len(".json")])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".json")
    ]
    return max(steps) if steps else None
