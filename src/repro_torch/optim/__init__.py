"""Optimizers and learning-rate schedules of the port, after the JAX
package's ``optim/``: SGD, momentum and AdamW (``optimizers.py``; Adafactor
comes with the MoE family) and the four schedules (``schedules.py``)."""

from .optimizers import (
    AdamState,
    Optimizer,
    adamw,
    apply_updates,
    get_optimizer,
    momentum,
    sgd,
    tree_leaves,
    tree_map,
)
from .schedules import constant, cosine, linear_decay, warmup_cosine

__all__ = [
    "AdamState", "Optimizer", "sgd", "momentum", "adamw", "apply_updates", "get_optimizer",
    "tree_leaves", "tree_map", "constant", "cosine", "warmup_cosine", "linear_decay",
]
