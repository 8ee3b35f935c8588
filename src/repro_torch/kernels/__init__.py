"""The port's kernels, each beside its plain PyTorch version.

``minplus``: the exact solver's device path, hand-written Hopper kernels
(``csrc/minplus.cu``, built by ``build`` at their first launch): the banded
min-plus row update behind ``minplus_cuda_batch``, the whole class scan in
one host call behind ``minplus_scan_cuda``, which also launches the
backtrack when given ``t_star``, and the backtrack alone behind
``minplus_backtrack_cuda``. ``blocked``: the tiled PyTorch CPU backend.
``ref``: the dense PyTorch oracle and the plain scan and backtrack, the
kernels' plain versions.
``ops`` exposes the dispatching wrappers — ``backend="auto"`` selects by the
tensor's device.

``flash_attention``: flash attention for the LM prefill and training, the
forward (``csrc/flash_fwd.cu``) behind ``flash_attention.flash_attention``
and the dQ and dK/dV backward (``csrc/flash_bwd.cu``) behind
``flash_attention.flash_attention_bwd`` and its autograd Function, with
their plain versions ``flash_attention_ref`` and ``flash_attention_bwd_ref``.
Import it as a module; it is not re-exported here, so
``kernels.flash_attention`` stays the module.

``adamw``: AdamW's update of one leaf in one pass (``csrc/adamw.cu``)
behind ``adamw.adamw_leaf``, with its plain version ``adamw_leaf_ref``;
``optim.adamw`` runs every leaf through it. Imported as a module, like
``flash_attention``.
"""

from .blocked import auto_block_sizes, minplus_blocked, minplus_blocked_batch
from .minplus import (
    hopper_tile_sizes,
    minplus_backtrack_cuda,
    minplus_cuda,
    minplus_cuda_batch,
    minplus_scan_cuda,
)
from .ops import BACKENDS, BIG, DISPATCH_TABLE, minplus_step, minplus_step_batch, resolve_backend
from .ref import backtrack_ref, minplus_scan_ref, minplus_step_ref, minplus_step_ref_batch

__all__ = [
    "BACKENDS",
    "BIG",
    "DISPATCH_TABLE",
    "auto_block_sizes",
    "backtrack_ref",
    "hopper_tile_sizes",
    "minplus_backtrack_cuda",
    "minplus_blocked",
    "minplus_blocked_batch",
    "minplus_cuda",
    "minplus_cuda_batch",
    "minplus_scan_cuda",
    "minplus_scan_ref",
    "minplus_step",
    "minplus_step_batch",
    "minplus_step_ref",
    "minplus_step_ref_batch",
    "resolve_backend",
]
