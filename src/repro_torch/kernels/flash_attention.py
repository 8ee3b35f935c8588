"""Flash attention as hand-written Hopper kernels, forward and backward,
beside their plain PyTorch versions.

``flash_attention`` launches ``csrc/flash_fwd.cu`` on CUDA tensors and runs
the plain version, :func:`flash_attention_ref`, on CPU tensors; it never falls
back from one to the other. The CUDA kernels take two routes by the inputs'
dtype: float32 runs on the CUDA cores in float32; bfloat16 runs the forward,
dQ and dK/dV on the tensor cores (``wgmma``, with TMA-fed rings of K/V or, for
dK/dV, Q/dO stages; ``csrc/flash_tc.cuh``). It returns what the JAX package's
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
forward, dQ and dK/dV kernels, and only those; ``launches_fwd_tc``,
``launches_dq_tc`` and ``launches_dkv_tc`` count the tensor-core route's share
of each. A run shows that it went through a kernel by reading its count
before and after. Every kernel is built by :mod:`repro_torch.kernels.build`
at its first launch.
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
    "flash_dkv_tc_smem_bytes",
    "flash_dkv_tc_tile_sizes",
    "flash_dq_tc_smem_bytes",
    "flash_dq_tc_tile_sizes",
    "flash_mask",
    "flash_smem_bytes",
    "flash_tc_smem_bytes",
    "flash_tc_tile_sizes",
    "flash_tile_sizes",
    "launches",
    "launches_dkv",
    "launches_dkv_tc",
    "launches_dq",
    "launches_dq_tc",
    "launches_fwd_tc",
]

NEG_INF = -1e30  # the score of a masked (q, k) pair, as in the reference
KINDS = ("causal", "sliding", "bidirectional")  # kernel codes 0, 1, 2
HEAD_DIMS = (16, 32, 64, 128, 256)  # head dimensions csrc/flash_fwd.cu and flash_bwd.cu are built for
BLOCK_Q = 64  # query rows per block (kBQ in csrc/flash_fwd.cu)
BLOCK_K = 64  # keys per K/V tile (kBK)
BWD_BLOCK_Q = 64  # query rows per tile of both backward kernels (kBQ in csrc/flash_bwd.cu)
BWD_BLOCK_K = 32  # keys per tile of both backward kernels (kBK)
# The bfloat16 tensor-core route (csrc/flash_tc.cuh): 256 threads, two
# warpgroups of 64 query rows, thread 0 issuing TMA loads into a ring of
# TC_STAGES K/V stages; every tile lies in shared memory as 64-column chunks
# of 128-byte rows.
TC_BLOCK_Q = 128  # query rows per block of the forward (kTcBQ in csrc/flash_fwd.cu)
TC_BLOCK_K = 64  # keys per K/V stage of the forward (kTcBK)
DQ_TC_BLOCK_Q = 128  # query rows per block of dQ (kDqTcBQ in csrc/flash_bwd.cu)
DQ_TC_BLOCK_K = 32  # keys per K/V stage of dQ (kDqTcBK)
# dK/dV turns the shape around: a block owns DKV_TC_BLOCK_K keys (K and V
# resident) and streams the GQA group's DKV_TC_BLOCK_Q-row Q and dO tiles.
DKV_TC_BLOCK_Q = 64  # query rows per Q/dO stage of dK/dV (kDkvTcBQ in csrc/flash_bwd.cu)
DKV_TC_BLOCK_K = 64  # keys per block of dK/dV (kDkvTcBK)
TC_STAGES = 2  # kStages in csrc/flash_tc.cuh
TC_SMEM_ALIGN = 1024  # kSmemAlign: the 128-byte swizzle repeats every 1024 bytes
TC_BARRIER_BYTES = 128  # kBarrierBytes: the q tile's and each stage's mbarriers
TMA_ALIGN = 16  # TMA reads from a 16-byte-aligned base with strides of a multiple of 16 bytes
# Dynamic shared memory one block may opt into on an H100 (227 KB).
SMEM_OPTIN_BYTES = 232_448
MAX_GRID_YZ = 65535  # H runs on gridDim.y, B on gridDim.z
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller reset them): forward, dQ, dK/dV
launches = 0
launches_dq = 0
launches_dkv = 0
# of which on the bfloat16 tensor-core route: forward, dQ, dK/dV
launches_fwd_tc = 0
launches_dq_tc = 0
launches_dkv_tc = 0


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


def _tc_tile_bytes(rows: int, D: int) -> int:
    """Bytes of a ``rows`` x ``D`` bfloat16 tile in 64-column chunks of
    128-byte rows (``tile_bytes`` in csrc/flash_tc.cuh)."""
    return -(-D // 64) * rows * 128


def flash_tc_smem_bytes(D: int) -> int:
    """Shared memory of one block of the tensor-core forward: the q tile and
    ``TC_STAGES`` stages of K and V tiles, the alignment slack and the
    barriers (``tc_smem_bytes`` in csrc/flash_fwd.cu)."""
    return (TC_SMEM_ALIGN + _tc_tile_bytes(TC_BLOCK_Q, D) + TC_STAGES * 2 * _tc_tile_bytes(TC_BLOCK_K, D)
            + TC_BARRIER_BYTES)


def flash_dq_tc_smem_bytes(D: int) -> int:
    """Shared memory of one block of the tensor-core dQ kernel: the q and dO
    tiles and ``TC_STAGES`` stages of K and V tiles, the alignment slack and
    the barriers (``dq_tc_smem_bytes`` in csrc/flash_bwd.cu)."""
    return (TC_SMEM_ALIGN + 2 * _tc_tile_bytes(DQ_TC_BLOCK_Q, D) + TC_STAGES * 2 * _tc_tile_bytes(DQ_TC_BLOCK_K, D)
            + TC_BARRIER_BYTES)


def flash_dkv_tc_smem_bytes(D: int) -> int:
    """Shared memory of one block of the tensor-core dK/dV kernel: the
    resident K and V tiles, ``TC_STAGES`` stages of Q and dO tiles, the
    float32 tile the two warpgroups exchange (one per stage), each stage's
    lse and delta, the alignment slack and the barriers (``dkv_tc_smem_bytes``
    in csrc/flash_bwd.cu)."""
    BQ, BK = DKV_TC_BLOCK_Q, DKV_TC_BLOCK_K
    return (TC_SMEM_ALIGN + 2 * _tc_tile_bytes(BK, D) + TC_STAGES * 2 * _tc_tile_bytes(BQ, D)
            + TC_STAGES * BK * BQ * 4 + TC_STAGES * 2 * BQ * 4 + TC_BARRIER_BYTES)


def _tc_tiles(D, need, tiles, smem_budget, what):
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the {what} kernel; supported: {HEAD_DIMS}")
    if need > smem_budget:
        raise ValueError(f"head dim {D} needs {need} B of shared memory in the {what} kernel, above the budget "
                         f"{smem_budget}")
    return tiles


def flash_tc_tile_sizes(D: int, smem_budget: int = SMEM_OPTIN_BYTES):
    """``(Bq, Bk)`` of the tensor-core forward for head dimension ``D``:
    128 query rows (two warpgroups of 64, wgmma's row count) by 64 keys.
    Raises for a ``D`` it is not built for or whose tiles would not fit
    ``smem_budget`` (at D = 256 they take 197,760 bytes)."""
    return _tc_tiles(D, flash_tc_smem_bytes(D), (TC_BLOCK_Q, TC_BLOCK_K), smem_budget, "tensor-core forward")


def flash_dq_tc_tile_sizes(D: int, smem_budget: int = SMEM_OPTIN_BYTES):
    """``(Bq, Bk)`` of the tensor-core dQ kernel for head dimension ``D``:
    128 query rows by 32 keys, so that dQ (D / 2), S and dP (16 each) stay in
    a consumer thread's registers. Raises for a ``D`` it is not built for or
    whose tiles would not fit ``smem_budget`` (at D = 256 they take 197,760
    bytes)."""
    return _tc_tiles(D, flash_dq_tc_smem_bytes(D), (DQ_TC_BLOCK_Q, DQ_TC_BLOCK_K), smem_budget, "tensor-core dQ")


def flash_dkv_tc_tile_sizes(D: int, smem_budget: int = SMEM_OPTIN_BYTES):
    """``(Bq, Bk)`` of the tensor-core dK/dV kernel for head dimension ``D``:
    64-row Q/dO stages by 64 keys (wgmma's row count), dV and dK in different
    warpgroups' registers. Raises for a ``D`` it is not built for or whose
    tiles would not fit ``smem_budget`` (at D = 256 they take 231,552
    bytes)."""
    return _tc_tiles(D, flash_dkv_tc_smem_bytes(D), (DKV_TC_BLOCK_Q, DKV_TC_BLOCK_K), smem_budget,
                     "tensor-core dK/dV")


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


def _tma_error(x):
    """Why TMA cannot read the (B, H, S, D) tensor ``x``, or None: it needs a
    base aligned to ``TMA_ALIGN`` bytes and, on every axis of more than one
    entry but the last, a stride of a multiple of ``TMA_ALIGN`` bytes."""
    if x.data_ptr() % TMA_ALIGN:
        return f"base address {x.data_ptr() % TMA_ALIGN} bytes past a {TMA_ALIGN}-byte boundary"
    for ax in range(3):
        nbytes = x.stride(ax) * x.element_size()
        if x.shape[ax] > 1 and nbytes % TMA_ALIGN:
            return f"stride of axis {ax} is {nbytes} bytes, not a multiple of {TMA_ALIGN}"
    return None


def _check_tma(x, name):
    """Raises where TMA cannot read ``x``: the tensor-core route has no other
    way in."""
    err = _tma_error(x)
    if err is not None:
        raise ValueError(f"{name}: the bfloat16 tensor-core route reads its inputs with TMA; {err} "
                         f"(shape {tuple(x.shape)}, strides {x.stride()})")


def _strides(x):
    """The strides of axes 0..2 of ``x``, an axis of one entry given its
    contiguous stride: the kernels only ever index 0 there, and a tensor
    map needs every stride to be a multiple of 16 bytes."""
    out, step = [], x.shape[3]
    for ax in (2, 1, 0):
        out.append(x.stride(ax) if x.shape[ax] > 1 else step)
        step *= x.shape[ax]
    return out[::-1]


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
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_tma(x, name)


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

    On CUDA tensors it launches the Hopper kernel on the current stream: on
    the float32 CUDA cores for float32, on the tensor cores for bfloat16. The
    head dimension must be contiguous (other strides are free, so
    ``x.transpose(1, 2)`` views go in without a copy); bfloat16 inputs also
    need what TMA needs (:func:`_check_tma`), or it raises. On CPU tensors it
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
    global launches, launches_fwd_tc
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kind, window, softcap, scale)
    _check_launch(q, k, v, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    tc = q.dtype == torch.bfloat16
    (flash_tc_tile_sizes if tc else flash_tile_sizes)(D)
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    launch = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, Hkv, Sq, Sk, D,
            *_strides(q), *_strides(k), *_strides(v),
            KINDS.index(kind), int(window), float(softcap), scale, _DTYPE_CODE[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd_launch failed: code {rc} ({_shapes(q, k)}, kind={kind})")
    launches += 1
    launches_fwd_tc += tc
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, kind="causal", window=0, softcap=0.0, scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention`'s ``o`` for the cotangent
    ``do``, given the forward's ``o`` and ``lse``: the reference's ``_bwd``.

    On CUDA tensors it computes ``delta = rowsum(dO * O)`` in float32 with
    PyTorch (the reference also forms it outside its kernels) and launches
    the dQ kernel and then the dK/dV kernel on the current stream; ``do``
    without a contiguous last axis (or, in bfloat16, that TMA cannot read) is
    made contiguous first. bfloat16 runs both on the tensor cores. On CPU
    tensors it returns :func:`flash_attention_bwd_ref`. dq comes in q's dtype
    and shape, dk and dv in k's.
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
    if q.dtype == torch.bfloat16:
        flash_dq_tc_tile_sizes(D)
        flash_dkv_tc_tile_sizes(D)
        if B * H * (Sq + 3) >= 2**31:
            raise ValueError(f"B*H*Sq = {B * H * Sq} rows of lse: the dK/dV kernel indexes them with 32 bits")
    else:
        flash_bwd_tile_sizes(D)
    do, delta = _bwd_rows(o, do)
    (dq,) = _launch_bwd("dq", q, k, v, do, lse, delta, kind, window, softcap, scale)
    dk, dv = _launch_bwd("dkv", q, k, v, do, lse, delta, kind, window, softcap, scale)
    return dq, dk, dv


def _bwd_rows(o, do):
    """``do`` with a contiguous last axis (and, in bfloat16, readable by TMA),
    and ``delta = rowsum(dO * O)`` in float32, contiguous ``(B, H, Sq)`` (the
    reference's ``_bwd`` at :206)."""
    if do.stride(3) != 1 or (do.dtype == torch.bfloat16 and _tma_error(do) is not None):
        do = do.contiguous()
    return do, (do.float() * o.float()).sum(dim=-1).contiguous()


def _tma_rows(x):
    """The contiguous float32 ``(B, H, Sq)`` tensor ``x`` as the bfloat16
    dK/dV kernel reads it with TMA: ``(B, H, Sq)`` rounded up to a multiple
    of 4 rows (each q tile's 64 values then start 16-byte aligned; the
    padding is zeros and is never used), on a 16-byte-aligned base
    (``tma_rows`` in csrc/flash_bwd.cu). Copies only where ``x`` is not so
    already."""
    pad = -x.shape[-1] % 4
    if pad:
        return torch.nn.functional.pad(x, (0, pad))
    return x if x.data_ptr() % TMA_ALIGN == 0 else x.clone()


def _launch_bwd(which, q, k, v, do, lse, delta, kind, window, softcap, scale):
    """One backward kernel on checked inputs: ``"dq"`` -> ``(dq,)``,
    ``"dkv"`` -> ``(dk, dv)``; counts the launch. The bfloat16 kernels read
    q, k, v and ``do`` with TMA (it raises where TMA cannot), and dK/dV also
    ``lse`` and ``delta`` (:func:`_tma_rows`)."""
    global launches_dq, launches_dkv, launches_dq_tc, launches_dkv_tc
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    tc = q.dtype == torch.bfloat16
    if which == "dq":
        outs = (torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device),)
    else:
        outs = tuple(torch.empty((B, Hkv, Sk, D), dtype=k.dtype, device=q.device) for _ in range(2))
    launch = _bwd_launch_fns()[which == "dkv"]
    lse = lse.contiguous()
    if tc:
        for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
            _check_tma(x, name)
        if which == "dkv":
            lse, delta = _tma_rows(lse), _tma_rows(delta)
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in outs), B, H, Hkv, Sq, Sk, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            KINDS.index(kind), int(window), float(softcap), scale, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_{which}_launch failed: code {rc} ({_shapes(q, k)}, kind={kind})")
    if which == "dq":
        launches_dq += 1
        launches_dq_tc += tc
    else:
        launches_dkv += 1
        launches_dkv_tc += tc
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
