"""AdamW's update of one leaf as one hand-written CUDA pass
(``csrc/adamw.cu``, built by :mod:`repro_torch.kernels.build` at the first
launch), beside its plain version.

:func:`adamw_leaf` reads a leaf's gradient, parameter and moments once,
writes the new moments in place and returns the update in the parameter's
dtype, rounding where the plain version's ATen ops round, so the two agree
bit for bit (``tests/test_torch_adamw_kernel.py`` holds them to it on the
card). On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs :func:`adamw_leaf_ref`. A fake CUDA tensor (the dry run's stand-ins,
which carry shapes only: :func:`repro_torch.models.model.fake_mode`) takes
the kernel's checks and result without a launch. Nothing falls back from
one to the other.

A cost counter (:class:`repro_torch.launch.hlo_analysis.CostCounter`) sees
no ctypes launch, so the wrapper counts each launch into the active
counters itself, by the bytes the kernel reads and writes (18 an element
with bfloat16 parameters and first moment), on real and fake tensors alike:
the dry run counts what the card runs.

The kernel takes the parameters and gradients in bfloat16 or float32 (one
dtype for both), the first moment in bfloat16 or float32 and the second in
float32, all contiguous and of one shape: every ``adamw`` config of the port
(``configs/``) keeps bfloat16 or float32 parameters with ``mu`` in their
dtype. The bias corrections are 0-d float32 tensors on the leaf's device,
read by the kernel, so a step copies nothing from the host.

Counters, raised only where the kernel is launched, so a run shows that its
steps went through it by reading them before and after: ``launches`` (one a
leaf with elements) and ``elements`` (the elements those launches updated).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from . import build

__all__ = ["DTYPES", "adamw_leaf", "adamw_leaf_ref", "elements", "launches"]

DTYPES = (torch.bfloat16, torch.float32)  # what the kernel takes for g and p, and for m

launches = 0  # kernel launches since import (or since a caller reset it)
elements = 0  # elements those launches updated


def adamw_leaf_ref(g, m, v, p, bc1, bc2, *, b1, c1, b2, c2, eps, wd, lr):
    """The plain version: ``m`` and ``v`` updated in place by ATen ops, the
    update ``-lr * u`` returned in ``p``'s dtype. The constants are the
    optimizer's, rounded as a weakly typed JAX scalar rounds against each
    tensor: ``b1`` to ``m``'s dtype, ``c1`` (``1 - b1``) to ``g``'s, ``b2``
    and ``c2`` (``1 - b2``) to float32, ``wd`` to ``p``'s."""
    m.mul_(b1).add_(c1 * g)
    v.mul_(b2).add_(c2 * g.float().square())
    u = (m.float() / bc1) / ((v / bc2).sqrt() + eps) + wd * p
    return (-lr * u).to(p.dtype)


def _check(g, m, v, p, bc1, bc2):
    if p.dtype not in DTYPES or g.dtype != p.dtype:
        raise TypeError(f"adamw kernel: p and g must share a dtype of {DTYPES}, got {p.dtype} and {g.dtype}")
    if m.dtype not in DTYPES or v.dtype != torch.float32:
        raise TypeError(f"adamw kernel: m must be one of {DTYPES} and v float32, got {m.dtype} and {v.dtype}")
    for name, x in (("g", g), ("m", m), ("v", v)):
        if x.shape != p.shape:
            raise ValueError(f"adamw kernel: {name} has shape {tuple(x.shape)}, p {tuple(p.shape)}")
    for name, x in (("g", g), ("m", m), ("v", v), ("p", p)):
        if x.device != p.device:
            raise ValueError(f"adamw kernel: {name} on {x.device}, p on {p.device}")
        if not x.is_contiguous():
            raise ValueError(f"adamw kernel: {name} must be contiguous")
    for name, x in (("bc1", bc1), ("bc2", bc2)):
        if x.dtype != torch.float32 or x.dim() != 0 or x.device != p.device:
            raise ValueError(f"adamw kernel: {name} must be a 0-d float32 tensor on {p.device}")


def adamw_leaf(g, m, v, p, bc1, bc2, *, b1, c1, b2, c2, eps, wd, lr):
    """One leaf's AdamW update: ``m`` and ``v`` updated in place, the update
    returned in ``p``'s dtype, as :func:`adamw_leaf_ref` (same arguments)
    computes them. On a CUDA tensor one kernel launch on the current
    stream (on a fake one, the update's stand-in); on a CPU tensor the
    plain version."""
    global launches, elements
    from torch._subclasses.fake_tensor import is_fake

    if p.device.type != "cuda":
        return adamw_leaf_ref(g, m, v, p, bc1, bc2, b1=b1, c1=c1, b2=b2, c2=c2, eps=eps, wd=wd, lr=lr)
    _check(g, m, v, p, bc1, bc2)
    u = torch.empty_like(p)
    if _get_current_dispatch_mode_stack():
        from ..launch.hlo_analysis import count_kernel

        # reads g, p, m, v; writes m, v, u
        count_kernel("adamw_kernel", sum(x.nbytes for x in (g, p, m, v, m, v, u)))
    if is_fake(p):
        return u
    n = p.numel()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launch_fn()(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), u.data_ptr(), bc1.data_ptr(),
                          bc2.data_ptr(), p.dtype == torch.bfloat16, m.dtype == torch.bfloat16, b1, c1, b2, c2,
                          eps, wd, -lr, n, stream)
    if rc != 0:
        raise RuntimeError(f"adamw_launch failed: cudaError {rc} (n={n}, p {p.dtype}, m {m.dtype})")
    if n:
        launches += 1
        elements += n
    return u


_launch = None


def _launch_fn():
    """The C entry point, built and bound at the first launch."""
    global _launch
    if _launch is None:
        fn = build.library("adamw").adamw_launch
        # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 7 + [I] * 2 + [F] * 7 + [ctypes.c_longlong, P]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch
