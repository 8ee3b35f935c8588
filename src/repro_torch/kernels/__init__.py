"""The port's kernels, each beside its plain PyTorch version.

``minplus``: the banded min-plus row update of the exact solver, a
hand-written Hopper kernel (``csrc/minplus.cu``, built by ``build`` at its
first launch) behind ``minplus_cuda_batch``. ``blocked``: the tiled PyTorch
CPU backend. ``ref``: the dense PyTorch oracle, the kernel's plain version.
``ops`` exposes the dispatching wrappers — ``backend="auto"`` selects by the
tensor's device.

``flash_attention``: the flash-attention forward of the LM prefill
(``csrc/flash_fwd.cu``) behind ``flash_attention.flash_attention``, with its
plain version ``flash_attention_ref``. Import it as a module; it is not
re-exported here, so ``kernels.flash_attention`` stays the module.
"""

from .blocked import auto_block_sizes, minplus_blocked_batch
from .minplus import hopper_tile_sizes, minplus_cuda, minplus_cuda_batch
from .ops import BACKENDS, BIG, DISPATCH_TABLE, minplus_step, minplus_step_batch, resolve_backend
from .ref import minplus_step_ref, minplus_step_ref_batch

__all__ = [
    "BACKENDS",
    "BIG",
    "DISPATCH_TABLE",
    "auto_block_sizes",
    "hopper_tile_sizes",
    "minplus_blocked_batch",
    "minplus_cuda",
    "minplus_cuda_batch",
    "minplus_step",
    "minplus_step_batch",
    "minplus_step_ref",
    "minplus_step_ref_batch",
    "resolve_backend",
]
