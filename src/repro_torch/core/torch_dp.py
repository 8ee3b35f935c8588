"""PyTorch implementation of the (MC)^2MKP dynamic program for scheduling
instances (contiguous classes), built on the min-plus row update.

The DP row update over classes is ``n`` banded min-plus convolutions, each
writing its argmins into a preallocated ``(n, B, T+1)`` int32 slab, and
backtracking walks that slab in reverse on the same device. On the card
(backend ``"cuda"``, which ``"auto"`` picks there) the scan and the backtrack
are one host call into ``kernels/minplus.py::minplus_scan_cuda``: no PyTorch
op and no Python step per class. The other backends run the plain versions,
a Python loop of row updates and of gather steps. The fused solver
(:func:`solve_fused_batch_torch`) returns only the ``(B, n)`` schedules plus
the final DP row ``K_last``, so nothing bigger than the answer has to leave
the device. :func:`solve_fused_batch_ring` runs the same solve with the
class axis as a ring over the positions of a :class:`SweepMesh`, each
keeping only its own part of the argmin slab.

Inputs are the 0-lower-limit equivalent instance (Section 5.2) as dense
arrays: ``costs (n, W)`` padded with BIG beyond each ``U_i``.
:func:`pack_batch` builds them for a whole :class:`ProblemBatch` on the
device from its float64 tables, bit-identical to the host's
``pack_problem(remove_lower_limits(batch))``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device they raise rather than run on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.minplus import minplus_backtrack_cuda, minplus_scan_cuda
from ..kernels.ops import BIG, minplus_step_batch, resolve_backend
from ..kernels.ref import backtrack_ref, minplus_scan_ref
from .problem import (
    PACK_BIG,
    Problem,
    ProblemBatch,
    remove_lower_limits,
    restore_lower_limits,
)

__all__ = [
    "SweepMesh",
    "solve_schedule_dp_torch",
    "solve_schedule_dp_batch",
    "solve_fused_batch_torch",
    "solve_fused_batch_ring",
    "dp_tables_batch",
    "pack_batch",
    "pack_problem",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there
    (a run asked for the card never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def pack_problem(p0, device="cuda") -> torch.Tensor:
    """Dense BIG-padded float32 cost tensor for 0-lower-limit instance(s),
    on ``device``.

    A :class:`Problem` packs to ``(n, W)``; a :class:`ProblemBatch` packs to
    ``(B, n, W)``. Tables are saturated to BIG and downcast in numpy before
    they move, as the JAX package does. Entries beyond each ``U_i`` are BIG
    so those item sizes are never selected.
    """
    dev = resolve_device(device)
    if isinstance(p0, ProblemBatch):
        costs = np.minimum(p0.costs, float(BIG)).astype(np.float32)
    else:
        W = int(p0.upper.max()) + 1
        lens = p0.upper.astype(np.int64) + 1  # valid prefix per class: 0..U_i
        costs = np.full((p0.n, W), float(BIG), dtype=np.float32)
        mask = np.arange(W)[None, :] < lens[:, None]
        costs[mask] = np.concatenate(
            [np.asarray(t[:l], dtype=np.float32) for t, l in zip(p0.cost_tables, lens)]
        )
    return torch.from_numpy(costs).to(dev)


def pack_batch(batch: ProblemBatch, device="cuda") -> torch.Tensor:
    """The packed ``(B, n, W)`` float32 cost tensor of ``batch``'s
    0-lower-limit instances, built on ``device``: bit-identical to
    ``pack_problem(remove_lower_limits(batch), device)``.

    The float64 tables and the limits cross to the device once; there, as
    torch ops, each row is shifted left by its ``L`` and rebased to
    ``C(L) = 0`` (paper eqs. (8)-(10)), entries past ``U - L`` become BIG,
    and the result is saturated to BIG and cast to float32. The float64
    subtract and the round-to-nearest cast are the same IEEE operations on
    the device as in numpy.
    """
    dev = resolve_device(device)
    costs = torch.from_numpy(batch.costs).to(dev)
    lower = torch.from_numpy(batch.lower).to(dev)
    upper = torch.from_numpy(batch.upper).to(dev)
    return _pack_on_device(costs, lower, upper)


def _pack_on_device(costs: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """:func:`pack_batch` on tensors already on the device: float64 ``costs
    (B, n, W)``, int64 ``lower``/``upper (B, n)``."""
    W = costs.shape[2]
    src = torch.arange(W, device=costs.device) + lower[:, :, None]  # C(j + L)
    valid = src <= upper[:, :, None]
    base = costs.gather(2, lower[:, :, None])  # C(L)
    shifted = costs.gather(2, src.clamp_(max=W - 1)) - base
    packed = torch.where(valid, shifted, PACK_BIG)
    # a scalar bound, not a tensor made from one: no host-to-device copy, so
    # the pack can be captured into a CUDA graph
    return packed.clamp(max=float(BIG)).to(torch.float32)


def _dp_scan_from(k0: torch.Tensor, costs: torch.Tensor, I: torch.Tensor, backend: str = "ref"):
    """Continues the class scan from the DP row ``k0 (B, T+1)`` over the
    classes in ``costs (B, n, W)``, writing step ``i``'s argmins into
    ``I[i]`` of the ``(n, B, T+1)`` int32 slab. Backend ``"cuda"`` is one
    call of :func:`minplus_scan_cuda`, which overwrites ``k0`` when
    ``n > 1``; the others loop over :func:`minplus_step_batch`. Returns the
    final row."""
    if resolve_backend(backend, k0.device) == "cuda":
        return minplus_scan_cuda(k0, costs, I)[0]
    return minplus_scan_ref(k0, costs, I, step=lambda k, c: minplus_step_batch(k, c, backend=backend))


def _dp_buffers(costs: torch.Tensor, T: int):
    """The DP's first row ``k0 (B, T+1)`` (0 at ``t = 0``, BIG elsewhere) and
    an empty ``(n, B, T+1)`` int32 argmin slab, on ``costs``' device."""
    B, n, _ = costs.shape
    k0 = torch.full((B, T + 1), BIG, dtype=torch.float32, device=costs.device)
    k0[:, 0] = 0.0
    return k0, torch.empty((n, B, T + 1), dtype=torch.int32, device=costs.device)


def _dp_tables_batch(costs: torch.Tensor, T: int, backend: str = "ref"):
    """Scans the DP over classes for a whole batch: ``costs (B, n, W)`` ->
    ``(K_last (B, T+1), I (n, B, T+1) int32)``, both on ``costs``' device."""
    k0, I = _dp_buffers(costs, T)
    return _dp_scan_from(k0, costs, I, backend=backend), I


def dp_tables_batch(costs: torch.Tensor, T: int, backend: str = "auto"):
    """Public two-step form of the class scan: returns ``(K_last (B, T+1),
    I (n, B, T+1))``. Production solves use :func:`solve_fused_batch_torch`,
    which keeps ``I`` inside; this remains as the oracle the fused solver is
    held against."""
    return _dp_tables_batch(costs.to(torch.float32), int(T), backend=backend)


# The backtrack kernel's plain version: n gather steps in reverse.
_backtrack_batch = backtrack_ref


def _solve_fused_batch(costs: torch.Tensor, t_star: torch.Tensor, T: int, backend: str = "ref"):
    k0, I = _dp_buffers(costs, T)
    if resolve_backend(backend, costs.device) == "cuda":
        # one host call: the n row launches, then the backtrack launch
        k_last, X = minplus_scan_cuda(k0, costs, I, t_star=t_star)
        return X, k_last
    k_last = _dp_scan_from(k0, costs, I, backend=backend)
    return _backtrack_batch(I, t_star), k_last


def solve_fused_batch_torch(costs: torch.Tensor, t_star, T: int, backend: str = "auto"):
    """Fused batched solver: class scan + reverse backtrack on ``costs``'
    device.

    Args:
      costs: ``(B, n, W)`` float32 packed tables (0-lower-limit instances).
      t_star: ``(B,)`` filled capacities to backtrack from, in ``[0, T]``;
        checked where they are on the host (a sequence, a numpy array or a
        CPU tensor), left to the caller on the card, where a walk out of
        the row would give zeros.
      T: row width (max ``T'`` across the batch).

    Returns ``(X, K_last)``: ``(B, n)`` int32 schedules and the ``(B, T+1)``
    final DP row (``K_last[b, t]`` = minimal cost of assigning exactly ``t``
    units across instance ``b``). The ``(n, B, T+1)`` argmin slab is
    allocated, filled and read on the device and never returned.
    """
    T = int(T)
    t_star = torch.as_tensor(t_star)
    _check_t_range(t_star, T)
    return _solve_fused_batch(costs.to(torch.float32), t_star.to(costs.device), T, backend=backend)


class SweepMesh:
    """A 1-D mesh of positions over an explicit device sequence: the port's
    counterpart of the JAX package's ``jax.sharding.Mesh`` for the sweep
    engine's batch sharding and class ring. One process drives every
    position, as one JAX controller drives its mesh.

    A device may repeat: positions on one device each hold their own shard
    and slab, as the reference's forced host devices
    (``--xla_force_host_platform_device_count``) do on the CPU. The mesh
    answers what callers of the reference's mesh read: ``axis_names``,
    ``shape[axis]`` and ``devices.size``; ``positions`` is the device tuple.
    Every position must be of one device type; a CUDA position raises without
    a card.
    """

    def __init__(self, devices, axis: str = "sweep"):
        positions = tuple(_canonical_device(d) for d in devices)
        if not positions:
            raise ValueError("a sweep mesh needs at least one device")
        if len({d.type for d in positions}) != 1:
            raise ValueError(f"a sweep mesh's devices must share one type, got {[str(d) for d in positions]}")
        self.positions = positions
        self.axis_names = (str(axis),)
        self.shape = {str(axis): len(positions)}
        self.devices = np.array(positions, dtype=object)

    def __repr__(self) -> str:
        return f"SweepMesh({[str(d) for d in self.positions]}, axis={self.axis_names[0]!r})"


def _canonical_device(device) -> torch.device:
    """:func:`resolve_device` with a CUDA device's index filled in."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_positions(mesh, axis=None):
    """``(axis, devices)`` of a :class:`SweepMesh` along ``axis`` (its only
    axis by default); anything else is refused."""
    if not isinstance(mesh, SweepMesh):
        raise TypeError(f"a sweep mesh must be a SweepMesh (make_sweep_mesh), got {type(mesh).__name__}")
    axis = mesh.axis_names[0] if axis is None else axis
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh!r}")
    return axis, mesh.positions


def _check_t_range(t_star: torch.Tensor, T: int) -> None:
    """Refuses ``t_star`` outside ``[0, T]`` where it is known on the host."""
    if t_star.device.type == "cpu" and t_star.numel() and not (0 <= int(t_star.min()) <= int(t_star.max()) <= T):
        raise ValueError(f"t_star must lie in [0, T={T}], got [{int(t_star.min())}, {int(t_star.max())}]")


def solve_fused_batch_ring(costs: torch.Tensor, t_star, T: int, backend: str, mesh, axis: str):
    """Fused DP + backtrack with the CLASS axis run as a ring over
    ``mesh[axis]`` (the JAX package's ``solve_fused_batch_ring``): the same
    ``(X (B, n), K_last (B, T+1))`` as :func:`solve_fused_batch_torch`, bit
    for bit, on ``costs``' device. ``n`` must be divisible by the ring size
    ``D`` (the sweep engine pads its n-bucket up to a multiple).

    Position ``d`` holds classes ``[d n/D, (d+1) n/D)`` and its own ``(n/D,
    B, T+1)`` int32 argmin slab on its own device. The scan is sequential in
    ``n``, so the row is handed around the ring: on turn ``d`` position ``d``
    continues it through its classes with the unsharded scan's op sequence
    and hands a copy of it to the next position (a peer copy across cards).
    The row after the last turn is ``K_last``. Then the reverse walk:
    positions ``D-1 .. 0`` each backtrack their own slab from the workload
    carry ``t`` (:func:`~repro_torch.kernels.minplus.minplus_backtrack_cuda`
    on the card), which becomes ``t - x.sum(1)`` (int64) and goes back one
    position. Compute is pipelined, not divided: what shards is the argmin
    slab, whose bytes per position fall by ``D``.

    Every step runs on the current stream of its position's device; PyTorch
    orders a copy between two devices against the current streams of both.
    """
    _, devices = _mesh_positions(mesh, axis)
    D = len(devices)
    B, n, _ = costs.shape
    if n % D:
        raise ValueError(f"the ring splits the class axis evenly: n={n} is not divisible by the ring size {D}")
    T = int(T)
    t_star = torch.as_tensor(t_star)
    _check_t_range(t_star, T)
    backend = resolve_backend(backend, devices[0])
    costs = costs.to(torch.float32)
    n_loc = n // D
    row, slabs = None, []
    for d, dev in enumerate(devices):  # forward turns
        mine = costs[:, d * n_loc : (d + 1) * n_loc].to(dev)
        if row is None:
            row, slab = _dp_buffers(mine, T)
        else:
            row = row.to(dev, copy=True)  # the hand-on: never a buffer the last turn reuses
            slab = torch.empty((n_loc, B, T + 1), dtype=torch.int32, device=dev)
        row = _dp_scan_from(row, mine, slab, backend=backend)
        slabs.append(slab)
    k_last = row.to(costs.device)
    backtrack = minplus_backtrack_cuda if backend == "cuda" else backtrack_ref
    t, xs = t_star.to(devices[-1], torch.int64), [None] * D
    for d in range(D - 1, -1, -1):  # the reverse walk
        t = t.to(devices[d])
        xs[d] = backtrack(slabs[d], t)
        t = t - xs[d].sum(1)
    return torch.cat([x.to(costs.device) for x in xs], dim=1), k_last


def solve_schedule_dp_torch(problem: Problem, backend: str = "auto", device="cuda") -> np.ndarray:
    """Optimal schedule of one instance (drop-in for
    :func:`repro_torch.core.mc2mkp.solve_schedule_dp`), solved on
    ``device``. Returns an ``(n,)`` int64 numpy schedule."""
    problem.validate()
    p0 = remove_lower_limits(problem)
    costs = pack_problem(p0, device)
    # Scheduling instances always fill the knapsack: T* == T.
    X, _ = solve_fused_batch_torch(costs[None], [int(p0.T)], int(p0.T), backend=backend)
    return restore_lower_limits(problem, X[0].cpu().numpy().astype(np.int64))


def solve_schedule_dp_batch(problems, backend: str = "auto", device="cuda") -> np.ndarray:
    """Solves ``B`` scheduling instances with one batched DP on ``device``.

    Accepts a sequence of :class:`Problem` (ragged ``n``/``U_i``/``T`` are
    padded into a dense stack) or a prebuilt :class:`ProblemBatch`. Returns a
    ``(B, n)`` int64 array of schedules — row ``b`` solves instance ``b``;
    columns past an instance's own ``n`` are 0. The cost tables are packed on
    ``device`` (:func:`pack_batch`); the host keeps only ``validate()``,
    ``T'`` and the final ``restore_lower_limits``. Only the ``(B, n)``
    schedules come back to the host.
    """
    batch = problems if isinstance(problems, ProblemBatch) else ProblemBatch.from_problems(problems)
    batch.validate()
    costs = pack_batch(batch, device)
    # eq. (8) on the host: T' = T - sum L. Scheduling instances always fill
    # the knapsack, so T*_b == T'_b.
    Tp = batch.T - batch.lower.sum(axis=1)
    X, _ = solve_fused_batch_torch(costs, Tp, int(Tp.max()), backend=backend)
    return restore_lower_limits(batch, X.cpu().numpy().astype(np.int64))
