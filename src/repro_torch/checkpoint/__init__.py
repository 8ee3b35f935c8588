"""Checkpointing of the port: the JAX package's npz + json manifest layout
over trees of tensors (``checkpoint.py``)."""

from .checkpoint import (
    array_to_tensor,
    flatten_with_paths,
    latest_checkpoint,
    load_checkpoint,
    load_checkpoint_arrays,
    map_with_paths,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_checkpoint_arrays",
    "latest_checkpoint",
    "array_to_tensor",
    "flatten_with_paths",
    "map_with_paths",
]
