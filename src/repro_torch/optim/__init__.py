"""Optimizers of the port, after the JAX package's ``optim/``: AdamW so far
(``optimizers.py``)."""

from .optimizers import AdamState, Optimizer, adamw, apply_updates, get_optimizer, tree_leaves, tree_map

__all__ = ["AdamState", "Optimizer", "adamw", "apply_updates", "get_optimizer", "tree_leaves", "tree_map"]
