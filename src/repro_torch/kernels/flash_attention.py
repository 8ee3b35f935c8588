"""Flash-attention forward as a hand-written Hopper kernel, beside its plain
PyTorch version.

``flash_attention`` launches ``csrc/flash_fwd.cu`` (built by
:mod:`repro_torch.kernels.build` at the first launch) on CUDA tensors and runs
the plain version, :func:`flash_attention_ref`, on CPU tensors; it never falls
back from one to the other. Both return what the JAX package's
``kernels/flash_attention.py::_fwd`` returns, ``(o, lse)``: the TPU kernel
``_fwd_kernel`` is what this one replaces. Layout as there: q ``(B, H, Sq, D)``,
k and v ``(B, Hkv, Sk, D)``, the kv head of query head ``h`` is ``h // (H / Hkv)``.

The kernel is forward only. Its backward (the JAX package's ``_dq_kernel`` and
``_dkv_kernel`` behind a ``torch.autograd.Function``) is the training slice of
ROADMAP.md, Queue 1; until then ``flash_attention`` refuses inputs that
require a gradient rather than return an output with no gradient.

``launches`` counts kernel launches, and only those: a run shows that it went
through the kernel by reading it before and after.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = [
    "BLOCK_K",
    "BLOCK_Q",
    "HEAD_DIMS",
    "KINDS",
    "NEG_INF",
    "SMEM_OPTIN_BYTES",
    "flash_attention",
    "flash_attention_ref",
    "flash_mask",
    "flash_smem_bytes",
    "flash_tile_sizes",
    "launches",
]

NEG_INF = -1e30  # the score of a masked (q, k) pair, as in the reference
KINDS = ("causal", "sliding", "bidirectional")  # kernel codes 0, 1, 2
HEAD_DIMS = (16, 32, 64, 128, 256)  # head dimensions csrc/flash_fwd.cu is built for
BLOCK_Q = 64  # query rows per block (kBQ in csrc/flash_fwd.cu)
BLOCK_K = 64  # keys per K/V tile (kBK)
# Dynamic shared memory one block may opt into on an H100 (227 KB).
SMEM_OPTIN_BYTES = 232_448
MAX_GRID_YZ = 65535  # H runs on gridDim.y, B on gridDim.z
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since import (or since a caller reset it)


def flash_smem_bytes(D: int) -> int:
    """Shared memory of one block: float32 Q and K tiles with rows padded to
    ``D + 1``, the V tile, and the P tile with rows padded to ``BLOCK_K + 1``
    (``smem_floats`` in csrc/flash_fwd.cu)."""
    return 4 * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) + BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1))


def flash_tile_sizes(D: int, smem_budget: int = SMEM_OPTIN_BYTES):
    """``(Bq, Bk)`` for head dimension ``D``: 64 x 64, the tile the kernel's
    thread layout is written for (16 row groups of 4 rows, 16 column lanes
    of 4 keys). Raises for a ``D`` the kernel is not built for or whose tiles
    would not fit ``smem_budget`` (at D = 256 they take 213,760 bytes)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the flash kernel; supported: {HEAD_DIMS}")
    need = flash_smem_bytes(D)
    if need > smem_budget:
        raise ValueError(f"head dim {D} needs {need} B of shared memory, above the budget {smem_budget}")
    return BLOCK_Q, BLOCK_K


def flash_mask(Sq: int, Sk: int, kind: str, window: int, device=None) -> torch.Tensor:
    """``(Sq, Sk)`` bool mask on positions ``0..Sq-1`` and ``0..Sk-1``."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    if kind == "bidirectional":
        return torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if kind == "causal":
        return ki <= qi
    if kind == "sliding":
        return (ki <= qi) & (ki > qi - window)
    raise ValueError(kind)


def flash_attention_ref(q, k, v, kind="causal", window=0, softcap=0.0, scale=None):
    """The kernel's plain version: dense float32 scores, no online softmax.

    Masked scores are ``NEG_INF``; ``l_safe = max(l, 1e-30)``,
    ``o = (p @ v) / l_safe`` cast to q's dtype and ``lse = m + log(l_safe)``
    in float32, as the reference's ``_fwd`` returns them. Holds the whole
    ``(B, H, Sq, Sk)`` score tensor (updated in place).
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf = (q.float() * scale).reshape(B, Hkv, G, Sq, D)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))  # (B, Hkv, G, Sq, Sk)
    if softcap:
        s.div_(softcap).tanh_().mul_(softcap)
    s.masked_fill_(~flash_mask(Sq, Sk, kind, window, q.device), NEG_INF)
    m = s.amax(dim=-1)
    p = s.sub_(m[..., None]).exp_()
    l_safe = p.sum(dim=-1).clamp_min_(1e-30)
    o = torch.matmul(p, v.float()[:, :, None]) / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def _check_inputs(q, k, v, kind):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"q, k and v must share device and dtype; {name} is {x.dtype} on {x.device}")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"need Sq >= 1 and Sk >= 1, got Sq={Sq}, Sk={Sk}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward only: its backward kernels come with the "
            "training slice (ROADMAP.md, Queue 1); call it under torch.no_grad() "
            "or on tensors that do not require a gradient"
        )


def flash_attention(q, k, v, kind="causal", window=0, softcap=0.0, scale=None):
    """Flash-attention forward: ``(o, lse)`` with ``o`` in q's dtype, shape
    ``(B, H, Sq, D)``, and ``lse`` float32 ``(B, H, Sq)``.

    On CUDA tensors it launches the Hopper kernel on the current stream; the
    head dimension must be contiguous (other strides are free, so
    ``x.transpose(1, 2)`` views go in without a copy). On CPU tensors it
    returns :func:`flash_attention_ref`. ``scale`` defaults to ``D ** -0.5``.
    """
    global launches
    _check_inputs(q, k, v, kind)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kind, window, softcap, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    flash_tile_sizes(D)
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"B={B} and H={H} must not exceed the grid's limit {MAX_GRID_YZ}")
    if not -(2**30) <= int(window) <= 2**30:
        raise ValueError(f"window {window} out of range")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head dimension (stride 1 on the last axis)")

    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    launch = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, Hkv, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            KINDS.index(kind), int(window), float(softcap), scale, _DTYPE_CODE[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd_launch failed: code {rc} (B={B}, H={H}, Hkv={Hkv}, Sq={Sq}, Sk={Sk}, D={D}, "
            f"{q.dtype}, kind={kind})"
        )
    launches += 1
    return o, lse


_launch = None


def _launch_fn():
    """The C entry point, built and bound at the first launch."""
    global _launch
    if _launch is None:
        fn = build.library("flash_fwd").flash_fwd_launch
        # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch
