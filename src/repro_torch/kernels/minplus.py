"""The exact solver's device path as hand-written Hopper kernels
(``csrc/minplus.cu``, built by :mod:`repro_torch.kernels.build` at the first
launch): the banded min-plus row update, the whole class scan in one host
call, and the backtrack through the argmin slab.

``minplus_cuda_batch`` launches the row kernel once. ``minplus_scan_cuda``
runs the ``n`` classes of a solve in one host call (the C function issues
the ``n`` row launches on the stream) and, given ``t_star``, the backtrack
kernel after them; ``minplus_backtrack_cuda`` launches the backtrack alone
(the class ring's reverse walk). On a CUDA tensor each launches its kernels or raises; on
a CPU tensor each runs
its plain PyTorch version (:mod:`repro_torch.kernels.ref`:
``minplus_step_ref_batch``, ``minplus_scan_ref``, ``backtrack_ref``). Nothing
falls back from one to the other. The row kernel replaces the JAX package's
TPU kernel (``kernels/minplus.py::_minplus_batch_kernel``) and its
Pallas-GPU twin (``kernels/gpu.py::_minplus_gpu_kernel``); the scan and the
backtrack replace the reference's ``lax.scan``s, which are plain jnp.

Counters, each raised only where its kernels are launched, so a run shows
what it went through by reading them before and after: ``launches`` (row
kernel launches, ``n`` per scan), ``launches_scan`` (host calls into the
scan) and ``launches_backtrack`` (backtrack launches). A call made while
its stream is being captured into a CUDA graph launches nothing and counts
nothing; whoever replays the graph adds the launches it holds
(``core/sweep.py``).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from . import build
from .ref import backtrack_ref, minplus_scan_ref, minplus_step_ref_batch

__all__ = [
    "minplus_cuda",
    "minplus_cuda_batch",
    "minplus_scan_cuda",
    "minplus_backtrack_cuda",
    "hopper_tile_sizes",
    "smem_bytes",
    "DEFAULT_BT",
    "DEFAULT_BW",
    "SMEM_BUDGET_BYTES",
    "MAX_THREADS",
    "MAX_BT",
    "launches",
    "launches_scan",
    "launches_backtrack",
]

# Output tile and band chunk on a long row: one warp's 256 outputs with the
# band split over the block's 4 warps, and the whole band of W <= 1024 in one
# chunk (chip_smoke.py phase 5 prints the sweep on an H100 at B=16,
# T+1=10,001, W=1,001).
DEFAULT_BT = 256
DEFAULT_BW = 1024

MAX_THREADS = 128  # threads per block (kThreads in csrc/minplus.cu)
OUTPUTS_PER_THREAD = 8  # kR: consecutive outputs a thread owns
WARP_OUTPUTS = 32 * OUTPUTS_PER_THREAD
MAX_BT = (MAX_THREADS // 32) * WARP_OUTPUTS  # four warps side by side along t
# Dynamic shared memory a block may take without an opt-in attribute.
SMEM_BUDGET_BYTES = 48 * 1024
MAX_GRID_Y = 65535  # B runs on gridDim.y
MAX_W = 1 << 24  # the kernel keeps each j as an exact float (kMaxW)

launches = 0  # row-kernel launches since import (or since a caller reset it)
launches_scan = 0  # host calls into the scan
launches_backtrack = 0  # backtrack launches


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length() if v > 1 else 1


def _tile_groups(BT: int) -> int:
    """Warps side by side along t in a tile of ``BT`` outputs (the rest of
    the block's 4 warps split the band)."""
    return next(g for g in (1, 2, 4) if g * WARP_OUTPUTS >= BT)


def smem_bytes(BT: int, BW: int) -> int:
    """Shared memory one block takes (``smem_words`` in csrc/minplus.cu):
    the row window of its span (``_tile_groups(BT)`` warps of 256 outputs)
    plus ``BW8 - 1`` entries, one pad word after every 8 and rounded up to
    a float4, then ``BW8`` costs, with ``BW8`` = ``BW`` rounded up to a
    multiple of 8; at least the merge buffer of one value and one index per
    thread. A ``BT`` below 256 takes as much as 256: the block computes a
    whole warp span of outputs and keeps the first ``BT``."""
    bw8 = -(-int(BW) // 8) * 8
    nk = _tile_groups(int(BT)) * WARP_OUTPUTS + bw8 - 1
    window = ((nk - 1) + ((nk - 1) >> 3) + 1 + 3) & ~3
    return 4 * max(window + bw8, 2 * MAX_THREADS)


def hopper_tile_sizes(Tp: int, W: int, smem_budget: int = SMEM_BUDGET_BYTES):
    """``(BT, BW)`` for a row of ``Tp`` outputs and a band of ``W``.

    Both are powers of two: ``BW = min(DEFAULT_BW, ceil_pow2(W))`` and
    ``BT = min(DEFAULT_BT, ceil_pow2(Tp))``, so a tile never overshoots the
    padded row and a short row runs in one block. ``BW`` halves until the
    block's shared memory fits ``smem_budget``; ``BT`` does not, since below
    256 it saves nothing (:func:`smem_bytes`). At the defaults a block takes
    about 10 KB, so many blocks share an SM.
    """
    BW = min(DEFAULT_BW, _pow2_ceil(W))
    BT = min(DEFAULT_BT, _pow2_ceil(Tp))
    while BW > 1 and smem_bytes(BT, BW) > smem_budget:
        BW //= 2
    return BT, BW


def _tiles(Tp: int, W: int, BT, BW):
    if W > MAX_W:
        raise ValueError(f"W={W} exceeds {MAX_W}: the kernel keeps each j as an exact float")
    bt, bw = hopper_tile_sizes(Tp, W)
    BT = int(BT) if BT is not None else bt
    BW = int(BW) if BW is not None else bw
    if not (1 <= BT <= MAX_BT) or BW < 1:
        raise ValueError(f"need 1 <= BT <= {MAX_BT} and BW >= 1, got BT={BT}, BW={BW}")
    if smem_bytes(BT, BW) > SMEM_BUDGET_BYTES:
        raise ValueError(f"BT={BT}, BW={BW} need {smem_bytes(BT, BW)} B of shared memory")
    return BT, BW


def _check(name, x, dtype, dim, contiguous=True):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _extent(x: torch.Tensor) -> int:
    """Bytes from ``x``'s first element to past its last, with its strides."""
    if x.numel() == 0:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))) * x.element_size()


def _overlaps(x: torch.Tensor, y: torch.Tensor) -> bool:
    lo, ylo = x.data_ptr(), y.data_ptr()
    return lo < ylo + _extent(y) and ylo < lo + _extent(x)


def _check_io(kprev: torch.Tensor, cost: torch.Tensor, out, iout):
    _check("kprev", kprev, torch.float32, 2)
    _check("cost", cost, torch.float32, 2)
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
        if _overlaps(x, kprev) or _overlaps(x, cost):
            raise ValueError(f"{name} overlaps an input")


def _on_card(x: torch.Tensor, what: str, B: int) -> None:
    """Raises unless ``x`` is a CUDA tensor and ``B`` fits the grid."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if B > MAX_GRID_Y:
        raise ValueError(f"B={B} exceeds the grid's y limit {MAX_GRID_Y}")


def _raise_on(rc: int, what: str, **shape) -> None:
    if rc != 0:
        dims = ", ".join(f"{k}={v}" for k, v in shape.items())
        raise RuntimeError(f"{what} failed: cudaError {rc} ({dims})")


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
    :func:`hopper_tile_sizes` (a block computes at least a warp's 256
    outputs, so a ``BT`` below that only discards some). On a CPU tensor it returns the plain
    version's result (copied into ``out``/``iout`` when given).
    """
    global launches
    _check_io(kprev, cost, out, iout)
    B, Tp = kprev.shape
    W = cost.shape[1]
    BT, BW = _tiles(Tp, W, BT, BW)

    if kprev.device.type == "cpu":
        kout, idx = minplus_step_ref_batch(kprev, cost)
        if out is None and iout is None:
            return kout, idx
        out = kout if out is None else out.copy_(kout)
        iout = idx if iout is None else iout.copy_(idx)
        return out, iout
    _on_card(kprev, "minplus_cuda_batch", B)

    out = torch.empty_like(kprev) if out is None else out
    iout = torch.empty(kprev.shape, dtype=torch.int32, device=kprev.device) if iout is None else iout
    fns = _launch_fns()
    with torch.cuda.device(kprev.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns.band(kprev.data_ptr(), cost.data_ptr(), out.data_ptr(), iout.data_ptr(), B, Tp, W, BT, BW, stream)
    _raise_on(rc, "minplus_band_launch", B=B, Tp=Tp, W=W, BT=BT, BW=BW)
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return out, iout


def minplus_cuda(kprev: torch.Tensor, cost: torch.Tensor, **kw):
    """One DP row update: the ``B = 1`` slice of :func:`minplus_cuda_batch`
    (``kprev (T+1,)``, ``cost (W,)``)."""
    kout, iout = minplus_cuda_batch(kprev[None], cost[None], **kw)
    return kout[0], iout[0]


def _check_t_star(t_star: torch.Tensor, B: int, device) -> torch.Tensor:
    if not isinstance(t_star, torch.Tensor) or t_star.shape != (B,) or t_star.device != device:
        raise ValueError(f"t_star must be a ({B},) tensor on {device}")
    if t_star.dtype.is_floating_point or t_star.dtype.is_complex or t_star.dtype == torch.bool:
        raise TypeError(f"t_star must hold integers, got {t_star.dtype}")
    return t_star.to(torch.int64).contiguous()


def minplus_scan_cuda(
    k0: torch.Tensor,
    costs: torch.Tensor,
    I: torch.Tensor,
    *,
    t_star: torch.Tensor | None = None,
):
    """The class scan of the DP in one host call, and optionally the
    backtrack after it.

    From the DP row ``k0 (B, T+1)`` (float32, contiguous) over the classes of
    ``costs (B, n, W)`` (float32, read with its strides, so a transposed or
    sliced view needs no copy), writing class ``i``'s argmins into ``I[i]``
    of the contiguous ``(n, B, T+1)`` int32 slab. With ``t_star (B,)``
    (integers in ``[0, T]``) it then walks back from it. Returns ``(k_last,
    X)``: the last row and the ``(B, n)`` int32 schedules, or ``None`` for
    ``X`` without ``t_star``. The range of ``t_star`` is the caller's to
    keep (it is checked where it is known on the host, as in
    ``solve_schedule_dp_batch``): on the card a walk that leaves
    ``[0, T]`` reads nothing and gives ``x_i = 0``, on the CPU it raises.

    On a CUDA tensor one C call issues the ``n`` row launches (and the
    backtrack) on the current stream; ``k0`` is then one half of the
    ping-pong pair of rows and is overwritten when ``n > 1``. On a CPU
    tensor it runs the plain versions, :func:`minplus_scan_ref` and
    :func:`backtrack_ref`.
    """
    global launches, launches_scan, launches_backtrack
    _check("k0", k0, torch.float32, 2)
    _check("costs", costs, torch.float32, 3, contiguous=False)
    _check("I", I, torch.int32, 3)
    B, Tp = k0.shape
    n, W = costs.shape[1], costs.shape[2]
    if costs.shape[0] != B or Tp < 1 or W < 1 or tuple(I.shape) != (n, B, Tp):
        raise ValueError(f"bad shapes k0 {tuple(k0.shape)}, costs {tuple(costs.shape)}, I {tuple(I.shape)}")
    if costs.device != k0.device or I.device != k0.device:
        raise ValueError(f"k0 on {k0.device}, costs on {costs.device}, I on {I.device}")
    if _overlaps(I, k0) or _overlaps(I, costs) or _overlaps(k0, costs):
        raise ValueError("k0, costs and I must not overlap")
    t = None if t_star is None else _check_t_star(t_star, B, k0.device)
    BT, BW = _tiles(Tp, W, None, None)

    if k0.device.type == "cpu":
        k_last = minplus_scan_ref(k0, costs, I)
        return k_last, (None if t is None else backtrack_ref(I, t))
    _on_card(k0, "minplus_scan_cuda", B)

    kbuf = torch.empty_like(k0)
    X = None if t is None else torch.empty((B, n), dtype=torch.int32, device=k0.device)
    fns = _launch_fns()
    with torch.cuda.device(k0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns.scan(
            k0.data_ptr(), kbuf.data_ptr(), costs.data_ptr(), I.data_ptr(),
            None if t is None else t.data_ptr(), None if X is None else X.data_ptr(),
            n, B, Tp, W, *costs.stride(), BT, BW, stream,
        )
    _raise_on(rc, "minplus_scan_launch", n=n, B=B, Tp=Tp, W=W, BT=BT, BW=BW)
    if not torch.cuda.is_current_stream_capturing():
        launches += n
        launches_scan += 1
        if X is not None and n > 0:
            launches_backtrack += 1
    return (k0 if n % 2 == 0 else kbuf), X


def minplus_backtrack_cuda(I: torch.Tensor, t_star: torch.Tensor) -> torch.Tensor:
    """The backtrack alone: the reverse walk through the contiguous ``(n, B,
    T+1)`` int32 argmin slab ``I`` from ``t_star (B,)`` (integers, on ``I``'s
    device), ``x_i = I[i, b, t_b]; t_b -= x_i``. Returns the ``(B, n)`` int32
    schedules. The class ring (:func:`repro_torch.core.torch_dp.solve_fused_batch_ring`)
    walks each position's slab with it, after every forward turn has ended.

    On a CUDA tensor it launches the backtrack kernel on the current stream
    (none when ``n == 0``), where a ``t_b`` outside the row gives ``x_i = 0``;
    on a CPU tensor it runs :func:`backtrack_ref`, which raises there.
    """
    global launches_backtrack
    _check("I", I, torch.int32, 3)
    n, B, Tp = I.shape
    if B < 1 or Tp < 1:
        raise ValueError(f"bad slab shape {tuple(I.shape)}")
    t = _check_t_star(t_star, B, I.device)

    if I.device.type == "cpu":
        return backtrack_ref(I, t)
    _on_card(I, "minplus_backtrack_cuda", B)

    X = torch.empty((B, n), dtype=torch.int32, device=I.device)
    fns = _launch_fns()
    with torch.cuda.device(I.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns.backtrack(I.data_ptr(), t.data_ptr(), X.data_ptr(), n, B, Tp, stream)
    _raise_on(rc, "minplus_backtrack_launch", n=n, B=B, Tp=Tp)
    if n > 0 and not torch.cuda.is_current_stream_capturing():
        launches_backtrack += 1
    return X


_launch = None


def _launch_fns():
    """The C entry points, built and bound at the first launch."""
    global _launch
    if _launch is None:
        lib = build.library("minplus")
        # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
        P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        argtypes = {
            "band": ("minplus_band_launch", [P] * 4 + [I32] * 5 + [P]),
            "scan": ("minplus_scan_launch", [P] * 6 + [I32] * 4 + [I64] * 3 + [I32] * 2 + [P]),
            "backtrack": ("minplus_backtrack_launch", [P] * 3 + [I32] * 3 + [P]),
        }
        bound = {}
        for key, (name, types) in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
            bound[key] = fn
        _launch = SimpleNamespace(**bound)
    return _launch
