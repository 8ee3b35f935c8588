"""The banded min-plus row update as a hand-written Hopper kernel.

``minplus_cuda_batch`` launches ``csrc/minplus.cu`` (built by
:mod:`repro_torch.kernels.build` at the first launch) on a CUDA tensor and
runs the plain PyTorch version (:func:`repro_torch.kernels.ref.minplus_step_ref_batch`)
on a CPU tensor; it never falls back from one to the other. It replaces the
JAX package's TPU kernel (``kernels/minplus.py::_minplus_batch_kernel``) and
its Pallas-GPU twin (``kernels/gpu.py::_minplus_gpu_kernel``).

``launches`` counts kernel launches, and only those: a run shows that it
went through the kernel by reading it before and after.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import minplus_step_ref_batch

__all__ = [
    "minplus_cuda",
    "minplus_cuda_batch",
    "hopper_tile_sizes",
    "smem_bytes",
    "DEFAULT_BT",
    "DEFAULT_BW",
    "SMEM_BUDGET_BYTES",
    "MAX_THREADS",
    "MAX_BT",
    "launches",
]

# Output tile and band chunk on a long row: one output per thread, and the
# whole band of W <= 1024 in one chunk. The fastest of the BT x BW sweep that
# chip_smoke.py prints (phase 5) on an H100 at B=16, T+1=10,001, W=1,001.
DEFAULT_BT = 256
DEFAULT_BW = 1024

MAX_THREADS = 256  # threads per block (kMaxThreads in csrc/minplus.cu)
MAX_BT = 8 * MAX_THREADS  # at most 8 outputs per thread
# Dynamic shared memory a block may take without an opt-in attribute.
SMEM_BUDGET_BYTES = 48 * 1024
MAX_GRID_Y = 65535  # B runs on gridDim.y

launches = 0  # kernel launches since import (or since a caller reset it)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length() if v > 1 else 1


def smem_bytes(BT: int, BW: int) -> int:
    """Shared memory one block takes: the row window of the span its
    threads compute (``BT`` rounded up to whole strips) plus ``BW`` costs,
    ``4·(span + BW − 1) + 4·BW`` bytes."""
    nt = min(int(BT), MAX_THREADS)
    r = -(-int(BT) // nt)
    r = next(x for x in (1, 2, 4, 8, r) if x >= r)
    return 4 * (nt * r + BW - 1) + 4 * BW


def hopper_tile_sizes(Tp: int, W: int, smem_budget: int = SMEM_BUDGET_BYTES):
    """``(BT, BW)`` for a row of ``Tp`` outputs and a band of ``W``.

    Both are powers of two: ``BW = min(DEFAULT_BW, ceil_pow2(W))`` and
    ``BT = min(DEFAULT_BT, ceil_pow2(Tp))``, so a tile never overshoots the
    padded row and a short row runs in one block. ``BT`` halves until the
    block's shared memory fits ``smem_budget``; at the defaults it takes
    about 9 KB, so many blocks share an SM.
    """
    BW = min(DEFAULT_BW, _pow2_ceil(W))
    BT = min(DEFAULT_BT, _pow2_ceil(Tp))
    while BT > 1 and smem_bytes(BT, BW) > smem_budget:
        BT //= 2
    while BW > 1 and smem_bytes(BT, BW) > smem_budget:
        BW //= 2
    return BT, BW


def _check_io(kprev: torch.Tensor, cost: torch.Tensor, out, iout):
    for name, x in (("kprev", kprev), ("cost", cost)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Tp = kprev.shape
    if cost.shape[0] != B or Tp < 1 or cost.shape[1] < 1:
        raise ValueError(f"bad shapes kprev {tuple(kprev.shape)}, cost {tuple(cost.shape)}")
    if cost.device != kprev.device:
        raise ValueError(f"kprev on {kprev.device}, cost on {cost.device}")
    for name, x, dtype in (("out", out, torch.float32), ("iout", iout, torch.int32)):
        if x is None:
            continue
        if x.dtype != dtype or x.shape != kprev.shape or x.device != kprev.device:
            raise ValueError(f"{name} must be {dtype} of shape {tuple(kprev.shape)} on {kprev.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        lo, hi = x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()
        for y in (kprev, cost):
            ylo = y.data_ptr()
            if lo < ylo + y.numel() * y.element_size() and ylo < hi:
                raise ValueError(f"{name} overlaps an input")


def minplus_cuda_batch(
    kprev: torch.Tensor,
    cost: torch.Tensor,
    *,
    BT: int | None = None,
    BW: int | None = None,
    out: torch.Tensor | None = None,
    iout: torch.Tensor | None = None,
):
    """Batched DP row update. Same contract as
    :func:`repro_torch.kernels.ref.minplus_step_ref_batch`: contiguous
    float32 ``kprev (B, T+1)`` and ``cost (B, W)`` on one device ->
    ``(B, T+1)`` float32 values and int32 first-min argmins.

    On a CUDA tensor it launches the Hopper kernel on the current stream,
    writing into ``out``/``iout`` when given (they must not overlap the
    inputs) and allocating them otherwise; ``BT``/``BW`` default to
    :func:`hopper_tile_sizes`. On a CPU tensor it returns the plain
    version's result (copied into ``out``/``iout`` when given).
    """
    global launches
    _check_io(kprev, cost, out, iout)
    B, Tp = kprev.shape
    W = cost.shape[1]
    bt, bw = hopper_tile_sizes(Tp, W)
    BT = int(BT) if BT is not None else bt
    BW = int(BW) if BW is not None else bw
    if not (1 <= BT <= MAX_BT) or BW < 1:
        raise ValueError(f"need 1 <= BT <= {MAX_BT} and BW >= 1, got BT={BT}, BW={BW}")
    if smem_bytes(BT, BW) > SMEM_BUDGET_BYTES:
        raise ValueError(f"BT={BT}, BW={BW} need {smem_bytes(BT, BW)} B of shared memory")

    if kprev.device.type == "cpu":
        kout, idx = minplus_step_ref_batch(kprev, cost)
        if out is None and iout is None:
            return kout, idx
        out = kout if out is None else out.copy_(kout)
        iout = idx if iout is None else iout.copy_(idx)
        return out, iout
    if kprev.device.type != "cuda":
        raise ValueError(f"minplus_cuda_batch runs on cuda or cpu tensors, not {kprev.device}")
    if B > MAX_GRID_Y:
        raise ValueError(f"B={B} exceeds the grid's y limit {MAX_GRID_Y}")

    out = torch.empty_like(kprev) if out is None else out
    iout = torch.empty(kprev.shape, dtype=torch.int32, device=kprev.device) if iout is None else iout
    launch = _launch_fn()
    with torch.cuda.device(kprev.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            kprev.data_ptr(), cost.data_ptr(), out.data_ptr(), iout.data_ptr(),
            B, Tp, W, BT, BW, stream,
        )
    if rc != 0:
        raise RuntimeError(f"minplus_band_launch failed: cudaError {rc} (B={B}, Tp={Tp}, W={W}, BT={BT}, BW={BW})")
    launches += 1
    return out, iout


def minplus_cuda(kprev: torch.Tensor, cost: torch.Tensor, **kw):
    """One DP row update: the ``B = 1`` slice of :func:`minplus_cuda_batch`
    (``kprev (T+1,)``, ``cost (W,)``)."""
    kout, iout = minplus_cuda_batch(kprev[None], cost[None], **kw)
    return kout[0], iout[0]


_launch = None


def _launch_fn():
    """The C entry point, built and bound at the first launch."""
    global _launch
    if _launch is None:
        fn = build.library("minplus").minplus_band_launch
        # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch
