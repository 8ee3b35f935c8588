"""Optimizers and learning-rate schedules of the port, after the JAX
package's ``optim/``: SGD, momentum, AdamW and Adafactor (``optimizers.py``)
and the four schedules (``schedules.py``)."""

from .optimizers import (
    AdafactorState,
    AdamState,
    Optimizer,
    adafactor,
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
    "AdafactorState", "AdamState", "Optimizer", "sgd", "momentum", "adamw", "adafactor", "apply_updates", "get_optimizer",
    "tree_leaves", "tree_map", "constant", "cosine", "warmup_cosine", "linear_decay",
]
