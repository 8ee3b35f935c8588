"""Flash attention as hand-written Hopper kernels, forward and backward,
beside their plain PyTorch versions.

``flash_attention`` launches ``csrc/flash_fwd.cu`` on CUDA tensors and runs
the plain version, :func:`flash_attention_ref`, on CPU tensors; it never falls
back from one to the other. It returns what the JAX package's
``kernels/flash_attention.py::_fwd`` returns, ``(o, lse)``: the TPU kernel
``_fwd_kernel`` is what the forward replaces. Layout as there: q
``(B, H, Sq, D)``, k and v ``(B, Hkv, Sk, D)``, the kv head of query head
``h`` is ``h // (H / Hkv)``.

When an input requires a gradient, ``flash_attention`` goes through a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``, ``_fa_fwd`` /
``_fa_bwd``): it saves ``q, k, v, o, lse`` and its backward is
:func:`flash_attention_bwd`, which launches the two kernels of
``csrc/flash_bwd.cu`` (the TPU kernels ``_dq_kernel`` and ``_dkv_kernel``) on
CUDA tensors and runs :func:`flash_attention_bwd_ref` on CPU tensors.

``launches``, ``launches_dq`` and ``launches_dkv`` count the launches of the
forward, dQ and dK/dV kernels, and only those: a run shows that it went
through a kernel by reading its count before and after. Every kernel is
built by :mod:`repro_torch.kernels.build` at its first launch.
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
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_ref",
    "flash_bwd_smem_bytes",
    "flash_bwd_tile_sizes",
    "flash_mask",
    "flash_smem_bytes",
    "flash_tile_sizes",
    "launches",
    "launches_dkv",
    "launches_dq",
]

NEG_INF = -1e30  # the score of a masked (q, k) pair, as in the reference
KINDS = ("causal", "sliding", "bidirectional")  # kernel codes 0, 1, 2
HEAD_DIMS = (16, 32, 64, 128, 256)  # head dimensions csrc/flash_fwd.cu and flash_bwd.cu are built for
BLOCK_Q = 64  # query rows per block (kBQ in csrc/flash_fwd.cu)
BLOCK_K = 64  # keys per K/V tile (kBK)
BWD_BLOCK_Q = 64  # query rows per tile of both backward kernels (kBQ in csrc/flash_bwd.cu)
BWD_BLOCK_K = 32  # keys per tile of both backward kernels (kBK)
# Dynamic shared memory one block may opt into on an H100 (227 KB).
SMEM_OPTIN_BYTES = 232_448
MAX_GRID_YZ = 65535  # H runs on gridDim.y, B on gridDim.z
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset them): forward, dQ, dK/dV
launches = 0
launches_dq = 0
launches_dkv = 0


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


def flash_bwd_smem_bytes(D: int):
    """Shared memory of one block of each backward kernel, ``(dq, dkv)``:
    float32 Q and dO tiles (``BWD_BLOCK_Q`` rows) and K and V tiles
    (``BWD_BLOCK_K`` rows) with rows padded to ``D + 1``; the dS tile (dQ) or
    the P and dS tiles plus the q rows' lse and delta (dK/dV), P/dS rows
    padded to ``BWD_BLOCK_K + 1`` (``dq_smem_floats`` and ``dkv_smem_floats``
    in csrc/flash_bwd.cu)."""
    tiles = 2 * BWD_BLOCK_Q * (D + 1) + 2 * BWD_BLOCK_K * (D + 1)
    score = BWD_BLOCK_Q * (BWD_BLOCK_K + 1)
    return 4 * (tiles + score), 4 * (tiles + 2 * score + 2 * BWD_BLOCK_Q)


def flash_bwd_tile_sizes(D: int, smem_budget: int = SMEM_OPTIN_BYTES):
    """``(Bq, Bk)`` of both backward kernels for head dimension ``D``:
    64 query rows by 32 keys, the tile their thread layout is written for
    (16 row groups of 4 rows, 16 key lanes of 2 keys). Raises for a ``D`` the
    kernels are not built for or whose tiles would not fit ``smem_budget`` (at
    D = 256 the dK/dV block takes 214,784 bytes)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the flash kernels; supported: {HEAD_DIMS}")
    need = max(flash_bwd_smem_bytes(D))
    if need > smem_budget:
        raise ValueError(f"head dim {D} needs {need} B of shared memory, above the budget {smem_budget}")
    return BWD_BLOCK_Q, BWD_BLOCK_K


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


def flash_attention_bwd_ref(q, k, v, o, lse, do, kind="causal", window=0, softcap=0.0, scale=None):
    """The backward kernels' plain version, ``(dq, dk, dv)``, formed as the
    reference's ``_bwd`` forms them, in dense float32.

    ``P = exp(where(mask, S, NEG_INF) - lse)`` with ``S`` the softcapped
    scores of the pre-scaled q; ``dS = P * (dO V^T - delta)`` with
    ``delta = rowsum(dO * O)``, times the softcap's chain rule
    ``1 - tanh^2(s_raw / softcap)``, then zero where the mask is false.
    ``dq = scale * dS K``; ``dk = dS^T (q * scale)`` and ``dv = P^T dO``
    summed over the GQA group. Outputs in the dtypes of q, k and v. Holds a
    few ``(B, H, Sq, Sk)`` float32 tensors (updated in place).
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf = (q.float() * scale).reshape(B, Hkv, G, Sq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]  # (B, Hkv, 1, Sk, D)
    dof = do.float().reshape(B, Hkv, G, Sq, D)
    delta = (dof * o.float().reshape(B, Hkv, G, Sq, D)).sum(dim=-1, keepdim=True)
    masked = ~flash_mask(Sq, Sk, kind, window, q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2))  # s_raw, (B, Hkv, G, Sq, Sk)
    if softcap:
        t = s.div_(softcap).tanh_()
        s = t * softcap
    p = s.masked_fill_(masked, NEG_INF).sub_(lse.reshape(B, Hkv, G, Sq, 1)).exp_()
    ds = torch.matmul(dof, vf.transpose(-1, -2)).sub_(delta).mul_(p)
    if softcap:
        ds.mul_(t.square_().neg_().add_(1.0))  # 1 - tanh^2(s_raw / softcap)
    ds.masked_fill_(masked, 0.0)
    dq = torch.matmul(ds, kf).mul_(scale).reshape(B, H, Sq, D)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _check_launch(q, k, v, window):
    """What the kernels take beyond :func:`_check_inputs`."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    B, H = q.shape[:2]
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"B={B} and H={H} must not exceed the grid's limit {MAX_GRID_YZ}")
    if not -(2**30) <= int(window) <= 2**30:
        raise ValueError(f"window {window} out of range")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head dimension (stride 1 on the last axis)")


def _shapes(q, k):
    B, H, Sq, D = q.shape
    return f"B={B}, H={H}, Hkv={k.shape[1]}, Sq={Sq}, Sk={k.shape[2]}, D={D}, {q.dtype}"


class _FlashAttention(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` of ``flash_attention``: the forward
    kernel, saving ``q, k, v, o, lse`` (``_fa_fwd``), and the backward
    kernels (``_fa_bwd``). ``lse`` carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, softcap, scale):
        o, lse = _forward(q, k, v, kind, window, softcap, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.opts = (kind, window, softcap, scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do, *ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, kind="causal", window=0, softcap=0.0, scale=None):
    """Flash attention: ``(o, lse)`` with ``o`` in q's dtype, shape
    ``(B, H, Sq, D)``, and ``lse`` float32 ``(B, H, Sq)``.

    On CUDA tensors it launches the Hopper kernel on the current stream; the
    head dimension must be contiguous (other strides are free, so
    ``x.transpose(1, 2)`` views go in without a copy). On CPU tensors it
    returns :func:`flash_attention_ref`. ``scale`` defaults to ``D ** -0.5``.
    When grad mode is on and q, k or v requires a gradient, ``o`` carries one:
    its backward is :func:`flash_attention_bwd`.
    """
    _check_inputs(q, k, v, kind)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kind, window, softcap, scale)
    return _forward(q, k, v, kind, window, softcap, scale)


def _forward(q, k, v, kind, window, softcap, scale):
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kind, window, softcap, scale)
    _check_launch(q, k, v, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    flash_tile_sizes(D)
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
        raise RuntimeError(f"flash_fwd_launch failed: code {rc} ({_shapes(q, k)}, kind={kind})")
    launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, kind="causal", window=0, softcap=0.0, scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention`'s ``o`` for the cotangent
    ``do``, given the forward's ``o`` and ``lse``: the reference's ``_bwd``.

    On CUDA tensors it computes ``delta = rowsum(dO * O)`` in float32 with
    PyTorch (the reference also forms it outside its kernels) and launches
    the dQ kernel and then the dK/dV kernel on the current stream; ``do``
    without a contiguous last axis is made contiguous first. On CPU tensors
    it returns :func:`flash_attention_bwd_ref`. dq comes in q's dtype and
    shape, dk and dv in k's.
    """
    _check_inputs(q, k, v, kind)
    B, H, Sq, D = q.shape
    for name, x, shape, dtype in (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (B, H, Sq), torch.float32)):
        if not isinstance(x, torch.Tensor) or x.shape != shape or x.dtype != dtype or x.device != q.device:
            got = (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else type(x)
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {q.device}, got {got}")
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, kind, window, softcap, scale)
    _check_launch(q, k, v, window)
    flash_bwd_tile_sizes(D)
    do, delta = _bwd_rows(o, do)
    (dq,) = _launch_bwd("dq", q, k, v, do, lse, delta, kind, window, softcap, scale)
    dk, dv = _launch_bwd("dkv", q, k, v, do, lse, delta, kind, window, softcap, scale)
    return dq, dk, dv


def _bwd_rows(o, do):
    """``do`` with a contiguous last axis, and ``delta = rowsum(dO * O)`` in
    float32, contiguous ``(B, H, Sq)`` (the reference's ``_bwd`` at :206)."""
    if do.stride(3) != 1:
        do = do.contiguous()
    return do, (do.float() * o.float()).sum(dim=-1).contiguous()


def _launch_bwd(which, q, k, v, do, lse, delta, kind, window, softcap, scale):
    """One backward kernel on checked inputs: ``"dq"`` -> ``(dq,)``,
    ``"dkv"`` -> ``(dk, dv)``; counts the launch."""
    global launches_dq, launches_dkv
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if which == "dq":
        outs = (torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device),)
    else:
        outs = tuple(torch.empty((B, Hkv, Sk, D), dtype=k.dtype, device=q.device) for _ in range(2))
    launch = _bwd_launch_fns()[which == "dkv"]
    lse = lse.contiguous()
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in outs), B, H, Hkv, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            KINDS.index(kind), int(window), float(softcap), scale, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_{which}_launch failed: code {rc} ({_shapes(q, k)}, kind={kind})")
    if which == "dq":
        launches_dq += 1
    else:
        launches_dkv += 1
    return outs


# every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_launch = None
_bwd_fns = None


def _launch_fn():
    """The forward's C entry point, built and bound at the first launch."""
    global _launch
    if _launch is None:
        fn = build.library("flash_fwd").flash_fwd_launch
        fn.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I] * 2 + [_F] * 2 + [_I, _P]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _bwd_launch_fns():
    """The backward's two C entry points (dQ, dK/dV), built and bound at the
    first launch."""
    global _bwd_fns
    if _bwd_fns is None:
        lib = build.library("flash_bwd")
        fns = []
        for fn, n_out in ((lib.flash_bwd_dq_launch, 1), (lib.flash_bwd_dkv_launch, 2)):
            fn.argtypes = [_P] * (6 + n_out) + [_I] * 6 + [_L] * 12 + [_I] * 2 + [_F] * 2 + [_I, _P]
            fn.restype = ctypes.c_int
            fns.append(fn)
        _bwd_fns = tuple(fns)
    return _bwd_fns
