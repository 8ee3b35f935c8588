"""Sweep engine: shape-bucketed plans, one CUDA graph per bucket on the card.

Production traffic — multi-round campaigns with drifting energy estimates,
100-point deadline sweeps, what-if grids — re-solves *near*-identical shapes
constantly, so the engine **bucketizes** shapes: each of
``B``/``n``/``T_max``/``W_max`` is rounded up to the next power of two, and
the padded program for a bucket is kept in an LRU of plans. Padding is
*inert* (phantom instances / resources / BIG table entries; see
:meth:`ProblemBatch.pad_to`), so bucketed solves are bit-identical to
uncached :func:`~repro_torch.core.torch_dp.solve_schedule_dp_batch`. The
bucket keys, labels and counters are the JAX package's (``repro.core.sweep``),
so both engines report the same ``cache_stats()`` after the same calls.

**A bucket entry is a plan; ``compiles`` counts plan builds.** A plan runs
one body over inputs of the bucket's shape: the float64 tables and int64
limits of the ORIGINAL batch padded on the host, and the workloads ``T'``.
The body removes the lower limits on the device
(:func:`~repro_torch.core.torch_dp._pack_on_device`; phantoms have
``L = U = 0`` and entries past ``U`` are never read, so the packed tensor is
bit-identical to packing the padded 0-lower-limit batch) and then solves:

  * ``("dp", B, n, T, W)`` — the fused DP: the class scan and backtrack,
    on the card one host call into
    :func:`~repro_torch.kernels.minplus.minplus_scan_cuda` (``n`` row
    launches and the backtrack launch);
  * ``("marginal", B, n, W)`` — the MarIn/MarCo selection
    (:func:`~repro_torch.core.marginal_torch.marginal_select`), with no
    ``T`` in the key: workloads are inputs there, not shapes.

On the CPU a plan calls its body on each dispatch. On the card its first
call copies the inputs into static device buffers and runs the body eagerly
(the warm-up, which also builds and loads the kernels outside any capture,
and whose result is the answer), then captures the body on the engine's
side stream into one ``torch.cuda.CUDAGraph``. Every later dispatch copies
its inputs into the static buffers, replays the graph and clones the
outputs into fresh tensors; a replay adds the launches the graph holds to
the min-plus counters (``n`` row launches, one backtrack). A capture that
fails raises: nothing falls back to eager runs.

The engine is thread-safe. Cache and counters are guarded by one lock; a
second lock serialises dispatches, because two dispatches to one bucket
share its static buffers: under it, a dispatch copies in, replays, clones
and records a CUDA event on the engine's stream, so the next dispatch's
copy-in is ordered after this one's clone. The returned handle's ``done()``
asks the event, and ``result()`` waits on it, copies the schedules to the
host, unpads and restores lower limits.

Regime-split solves (``split_regimes=True``) partition a batch by its paper
Table 2 algorithm: the DP sub-batch first, then the selection sub-batch,
then MarDecUn/MarDec on the host; a :class:`RegimeSplitHandle` reassembles
rows in original order.

Multi-device sweeps, over a :class:`~repro_torch.core.torch_dp.SweepMesh`
(:func:`make_sweep_mesh`), which one process drives, as one JAX controller
drives the reference's mesh:

  * ``mesh=`` shards the batch axis: ``B`` rounds up to a multiple of the
    mesh size and each position runs the bucket's plan over its ``B/D`` rows
    on its own device and stream (its own CUDA graph on the card); the
    handle waits on one event per position and gathers the rows in order;
  * ``ring_mesh=`` runs the class axis as a ring
    (:func:`~repro_torch.core.torch_dp.solve_fused_batch_ring`): ``n``
    rounds up to a multiple of the ring size. On one card every turn goes
    into the bucket's one graph; across cards the turns run eagerly, each on
    its device's engine stream, ordered by the peer copies (a capture across
    devices was not tried: the card's machine has one card).

Selection buckets stay unsharded, as in the reference. Bucket keys, labels
and ``cache_stats()`` read as the reference's with the same mesh sizes.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..kernels import minplus as _minplus
from ..kernels.ops import resolve_backend
from ._deprecation import warn_deprecated
from .marginal_torch import (
    MARGINAL_BATCH_ALGORITHMS,
    marginal_select,
    select_algorithm_batch,
)
from .problem import (
    ProblemBatch,
    remove_lower_limits,
    restore_lower_limits,
    total_cost_batch,
)
from .torch_dp import (
    SweepMesh,
    _canonical_device,
    _mesh_positions,
    _pack_on_device,
    _solve_fused_batch,
    resolve_device,
    solve_fused_batch_ring,
)

__all__ = [
    "RegimeSplitHandle",
    "SweepEngine",
    "SweepHandle",
    "SweepMesh",
    "bucket_shape",
    "default_engine",
    "make_sweep_mesh",
    "request_bucket",
    "reset_default_engines",
    "solve_dp_batch_cached",
    "solve_schedule_batch_cached",
]

def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def bucket_shape(B: int, n: int, T: int, W: int):
    """The cache bucket for an actual packed shape: every dim rounds up to
    the next power of two. Worst-case padding is <2x per dim (~16x work in
    the T*W-dominated DP), bought once per bucket; in exchange all nearby
    shapes share one plan."""
    return (_next_pow2(B), _next_pow2(n), _next_pow2(T), _next_pow2(W))


def request_bucket(batch: ProblemBatch):
    """The non-batch pow2 bucket axes ``(n, T, W)`` of the DP plan for
    ``batch``: those of its 0-lower-limit batch, computed in closed form —
    the shift preserves ``n`` and the table width ``W`` and maps
    ``T -> T - sum(L)`` — so keying costs O(B*n), not a full O(B*n*W)
    table shift."""
    Tp = int((batch.T - batch.lower.sum(axis=1)).max())
    return _next_pow2(batch.n), _next_pow2(Tp), _next_pow2(batch.W)


def make_sweep_mesh(axis: str = "sweep", device="cuda") -> SweepMesh:
    """1-D mesh over every visible device of ``device``'s type: each card
    (``"cuda"``, the default; raises without one), or the one CPU. For more
    positions than devices (a card or the CPU repeated), build a
    :class:`~repro_torch.core.torch_dp.SweepMesh` from a device list."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return SweepMesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())], axis)
    return SweepMesh([dev], axis)


class _Plan:
    """One bucket's executable on one position: ``body`` over inputs of the
    position's shard of the bucket's shape.

    Without streams (the CPU), or with streams on several cards (the class
    ring across cards), each call runs ``body`` on the inputs. With one
    stream, the first call runs it eagerly on static device copies of the
    inputs and captures it on that stream into a CUDA graph; later calls
    copy into the static buffers and replay. ``row_launches`` and
    ``backtracks`` are the min-plus row and backtrack kernels the graph
    holds; a replay adds them to the counters. Calls are serialised by the
    engine, which makes ``streams`` current around them."""

    def __init__(self, body, device: torch.device, streams=(), row_launches=0, backtracks=0):
        self.body = body
        self.device = device
        self.streams = tuple(streams)
        self.row_launches = row_launches
        self.backtracks = backtracks
        self.inputs = None  # static input buffers (card)
        self.outputs = None  # the graph's static outputs (card)
        self.graph = None

    def __call__(self, *arrays):
        if len(self.streams) != 1:
            return self.body(*(torch.from_numpy(a).to(self.device) for a in arrays))
        if self.graph is None:
            self.inputs = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
            out = self.body(*self.inputs)  # the warm-up, and the answer
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.streams[0], capture_error_mode="thread_local"):
                self.outputs = self.body(*self.inputs)
            self.graph = graph
            return out
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(torch.from_numpy(a))
        self.graph.replay()
        _minplus.launches += self.row_launches
        _minplus.launches_backtrack += self.backtracks
        return tuple(o.clone() for o in self.outputs)


class _DeviceSchedulePart:
    """Launch/materialize seam shared by the DP and selection handles: the
    padded ``(Bb, nb)`` schedules as shards along the batch axis (one per
    position of a batch mesh, else one), still computing when they are on
    the card (``events`` mark their ends, one per position), plus the
    ORIGINAL (unpadded) batch to unpad against.

    Materialization is lock-guarded: handles are handed across threads, and
    without the lock two concurrent first calls to :meth:`result` would race
    the transfer-and-cache sequence and could hand different array objects
    to different callers.
    """

    def __init__(self, raw, batch, events=()):
        self._raw = raw  # shards of the (Bb, nb) int32 schedules, in row order
        self._batch = batch  # the ORIGINAL (unpadded) ProblemBatch
        self._events = events  # empty on the CPU: the solve has landed
        self._out: Optional[np.ndarray] = None
        self._mat_lock = threading.Lock()  # guards every host-side cache

    def done(self) -> bool:
        """True once the solve has landed (the device work behind it has
        finished on every position)."""
        return self._out is not None or all(e.query() for e in self._events)

    def _host(self, shards) -> np.ndarray:
        """The shards on the host, joined along the batch axis."""
        for e in self._events:
            e.synchronize()
        if len(shards) == 1:
            return shards[0].cpu().numpy()
        return np.concatenate([t.cpu().numpy() for t in shards])

    def result(self) -> np.ndarray:
        """The ``(B, n)`` int64 schedules — blocks until the solve lands.
        Thread-safe: concurrent callers all receive the SAME array."""
        with self._mat_lock:
            if self._out is None:
                X0 = self._host(self._raw)[: self._batch.B, : self._batch.n]
                self._out = restore_lower_limits(self._batch, X0.astype(np.int64))
            return self._out


class SweepHandle(_DeviceSchedulePart):
    """An in-flight batched solve: the bucket's plan has run (on the card:
    queued on the engine's stream), but the schedule is not yet on the host.
    :meth:`result` waits, copies, unpads, and restores lower limits;
    repeated calls return the same array.

    The fused DP also returns the final DP row: :meth:`k_last` /
    :meth:`objectives` expose it without any extra dispatch. Both are in
    0-lower-limit terms (Section 5.2) — add each instance's fixed cost
    ``sum_i C_i(L_i)`` to recover original-instance energies.
    """

    def __init__(self, raw, k_last, batch, t_star, events=()):
        super().__init__(raw, batch, events)
        self._k_last = k_last  # shards of the (Bb, Tb+1) final DP rows
        self._t_star = t_star  # (Bb,) filled capacities of the padded batch
        self._k_host: Optional[np.ndarray] = None  # cached k_last transfer

    def k_last(self) -> np.ndarray:
        """The ``(B, T_bucket+1)`` final DP row of the real instances:
        ``k_last()[b, t]`` is the minimal cost of assigning exactly ``t``
        units in 0-lower-limit instance ``b`` (BIG where infeasible) — a
        free workload-Pareto curve per solve. The device transfer happens
        once; repeated calls (and :meth:`objectives`) reuse it, from any
        thread."""
        with self._mat_lock:
            if self._k_host is None:
                self._k_host = self._host(self._k_last)[: self._batch.B]
            return self._k_host

    def objectives(self) -> np.ndarray:
        """Per-instance optimal objective ``K_last[b, t*_b]`` of the
        0-lower-limit instances, shape ``(B,)`` float32 — what the returned
        schedules cost, with no extra dispatch or host-side re-evaluation."""
        k = self.k_last()
        t = np.asarray(self._t_star)
        return k[np.arange(self._batch.B), t[: self._batch.B]]

    def frontier(self, b: int = 0):
        """The pruned (workload, energy) Pareto set of instance ``b``,
        extracted from the final DP row with no extra dispatch: ``(t, e)``
        arrays, workload ascending / energy strictly increasing, in
        0-lower-limit terms (add ``t += sum(L_b)`` and the fixed cost
        ``sum_i C_i(L_i)`` to recover original-instance points). The
        workload-axis sibling of the deadline-axis frontier built by
        :func:`repro_torch.core.pareto.pareto_frontier`."""
        from .pareto import workload_frontier  # leaf-ward: pareto imports sweep

        return workload_frontier(self.k_last()[int(b)])


class _SelectionPart(_DeviceSchedulePart):
    """An in-flight batched marginal-selection solve (MarIn/MarCo slice of a
    regime-split dispatch): like :class:`SweepHandle`, :meth:`result`
    waits, unpads, and restores lower limits."""

    def __init__(self, raw_x, raw_obj, batch, events=()):
        super().__init__(raw_x, batch, events)
        self._raw_obj = raw_obj  # shards of the (Bb,) float32 0-lower-limit objectives
        self._obj_host: Optional[np.ndarray] = None

    def objectives(self) -> np.ndarray:
        with self._mat_lock:
            if self._obj_host is None:
                self._obj_host = self._host(self._raw_obj).astype(np.float64)[: self._batch.B]
            return self._obj_host


class _HostPart:
    """An already-materialized host-solved slice (MarDecUn argmin /
    MarDec packing enumeration) of a regime-split dispatch."""

    def __init__(self, X, obj):
        self._X = X
        self._obj = obj

    def done(self) -> bool:
        return True

    def result(self) -> np.ndarray:
        return self._X

    def objectives(self) -> np.ndarray:
        return self._obj


class RegimeSplitHandle:
    """A mixed-regime in-flight solve: each regime sub-batch ran on its own
    path (selection / host marginal algorithms / fused DP) and this handle
    reassembles rows in the ORIGINAL problem order.

    :meth:`objectives` returns per-instance 0-lower-limit objectives (same
    convention as :meth:`SweepHandle.objectives`; device-solved entries are
    float32-precise). :meth:`k_last` is undefined — only the fused DP
    produces a full final row, and pure-DP dispatches return a plain
    :class:`SweepHandle` which does expose it.
    """

    def __init__(self, B: int, n: int, parts):
        self._B, self._n = B, n
        self._parts = parts  # list of (original-index list, part/handle)
        self._out: Optional[np.ndarray] = None
        self._mat_lock = threading.Lock()

    def done(self) -> bool:
        return self._out is not None or all(p.done() for _, p in self._parts)

    def result(self) -> np.ndarray:
        with self._mat_lock:
            if self._out is None:
                X = np.zeros((self._B, self._n), dtype=np.int64)
                for idx, part in self._parts:
                    X[idx] = part.result()
                self._out = X
            return self._out

    def objectives(self) -> np.ndarray:
        obj = np.zeros(self._B, dtype=np.float64)
        for idx, part in self._parts:
            obj[idx] = np.asarray(part.objectives(), np.float64)
        return obj

    def k_last(self) -> np.ndarray:
        raise ValueError(
            "k_last() is only defined for pure-DP dispatches (the fused DP's "
            "final row); this batch was regime-split — use objectives(), or "
            "dispatch with split_regimes=False for the full Pareto row"
        )


class SweepEngine:
    """Plan-cached batched (MC)^2MKP solver on one device, or over a sweep
    mesh.

    Args:
      backend: min-plus backend (:func:`~repro_torch.kernels.ops.resolve_backend`):
        "auto" resolves by the device ("cuda" on the card, "blocked" on the
        CPU); "ref" forces the dense plain version.
      max_entries: LRU capacity — distinct shape buckets kept warm.
      mesh: a :class:`~repro_torch.core.torch_dp.SweepMesh` to shard the
        BATCH axis over: each position solves its rows of the bucket on its
        own device and stream; bit-identical to one device.
      mesh_axis: the batch mesh's axis name (default: its only axis).
      ring_mesh: a sweep mesh to run the CLASS axis over as a ring
        (:func:`~repro_torch.core.torch_dp.solve_fused_batch_ring`): the row
        is handed around the positions, each keeping only its own argmin
        slab; bit-identical to the unsharded scan. For one very wide problem
        (large ``n``); mutually exclusive with ``mesh`` (large ``B``).
      ring_axis: the ring mesh's axis name (default: its only axis).
      device: where the plans run; ``"cuda"`` (the default) raises without
        a card. With a mesh, its devices must be of this type, and the
        engine's device is the mesh's first.
    """

    def __init__(
        self,
        backend: str = "auto",
        max_entries: int = 64,
        mesh=None,
        mesh_axis: Optional[str] = None,
        ring_mesh=None,
        ring_axis: Optional[str] = None,
        device="cuda",
    ):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if mesh is not None and ring_mesh is not None:
            raise ValueError(
                "mesh (batch-axis sharding) and ring_mesh (class-axis ring) "
                "are mutually exclusive — build one engine per strategy"
            )
        device = _canonical_device(device)
        # the batch axis' positions: the mesh's devices, else the one device
        positions, ring = (device,), ()
        self.mesh, self.mesh_axis, self.ring_mesh, self.ring_axis = mesh, None, ring_mesh, None
        if mesh is not None:
            self.mesh_axis, positions = _mesh_positions(mesh, mesh_axis)
        if ring_mesh is not None:
            self.ring_axis, ring = _mesh_positions(ring_mesh, ring_axis)
            positions = ring[:1]
        if positions[0].type != device.type:
            raise ValueError(f"the mesh's devices ({positions[0].type}) conflict with device={str(device)!r}")
        self.device, self._positions = positions[0], positions
        self._ndev, self._ring_ndev = len(positions), max(len(ring), 1)
        self.backend = resolve_backend(backend, self.device)
        self.max_entries = int(max_entries)
        self._cache: OrderedDict = OrderedDict()
        self._hits = self._misses = self._compiles = self._evictions = 0
        self._bucket_hits: dict = {}  # bucket key -> warm-hit count
        # Guards cache + counters: solves may come from several threads.
        self._lock = threading.Lock()
        # Serialises dispatches: a bucket's static buffers are shared.
        self._run_lock = threading.Lock()
        # the streams each batch position's plan runs on: one on the card (a
        # repeated card gets one a position, so its positions overlap as on
        # separate cards), none on the CPU; the ring adds one on each other
        # card it visits
        cuda = self.device.type == "cuda"
        self._plan_streams = tuple((torch.cuda.Stream(d),) if cuda else () for d in positions)
        self._stream = self._plan_streams[0][0] if cuda else None
        others = dict.fromkeys(d for d in ring if cuda and d != self.device)
        self._ring_streams = self._plan_streams[0] + tuple(torch.cuda.Stream(d) for d in others)

    # ---- cache ---------------------------------------------------------

    @staticmethod
    def _bucket_label(key) -> str:
        """JSON-friendly bucket name, e.g. ``"dp:B8:n16:T128:W64"``."""
        kind, *dims = key
        names = ("B", "n", "T", "W") if kind == "dp" else ("B", "n", "W")
        return ":".join([kind] + [f"{a}{d}" for a, d in zip(names, dims)])

    def cache_stats(self) -> dict:
        """Counters since construction (or the last :meth:`clear`).
        ``compiles`` counts plan builds (on the card, each is one warm-up
        and one graph capture per position) — with a warm cache it stays
        flat no matter how many solves run. ``per_bucket_hits`` breaks the
        warm hits down by bucket (keyed by :meth:`_bucket_label`; counts
        survive eviction — they describe traffic, not cache residency)."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "compiles": self._compiles,
                "evictions": self._evictions,
                "entries": len(self._cache),
                "max_entries": self.max_entries,
                "per_bucket_hits": {
                    self._bucket_label(k): v for k, v in self._bucket_hits.items()
                },
            }

    def clear(self) -> None:
        """Drops all cached plans and zeroes the counters."""
        with self._lock:
            self._cache.clear()
            self._hits = self._misses = self._compiles = self._evictions = 0
            self._bucket_hits = {}

    def _entry(self, key) -> tuple:
        with self._lock:
            plans = self._cache.get(key)
            if plans is not None:
                self._hits += 1
                self._bucket_hits[key] = self._bucket_hits.get(key, 0) + 1
                self._cache.move_to_end(key)
                return plans
            self._misses += 1
            self._compiles += 1
            plans = self._build(key)
            self._cache[key] = plans
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
                self._evictions += 1
            return plans

    def _build(self, key) -> tuple:
        """A bucket's plans: one per position of the batch axis (a selection
        bucket and a ring bucket have one)."""
        if key[0] == "marginal":

            def run_sel(costs64, lower, upper, t_star):
                # monotone fast path: top-T' marginal-unit selection — no DP
                # table, O(B·nW·log nW)
                return marginal_select(_pack_on_device(costs64, lower, upper), upper - lower, t_star)

            return (_Plan(run_sel, self.device, self._plan_streams[0]),)

        _, _, nb, Tb, _ = key
        backend = self.backend
        kernels = backend == "cuda"
        if self.ring_mesh is not None:
            ring_mesh, ring_axis = self.ring_mesh, self.ring_axis

            def run_ring(costs64, lower, upper, t_star):
                return solve_fused_batch_ring(_pack_on_device(costs64, lower, upper), t_star, Tb, backend, ring_mesh,
                                              ring_axis)

            return (_Plan(run_ring, self.device, self._ring_streams, nb if kernels else 0,
                          self._ring_ndev if kernels else 0),)

        def run(costs64, lower, upper, t_star):
            # fused DP + backtrack: only (X, K_last) leave the plan, never
            # the (n, B, T+1) argmin slab
            return _solve_fused_batch(_pack_on_device(costs64, lower, upper), t_star, Tb, backend=backend)

        return tuple(
            _Plan(run, d, streams, nb if kernels else 0, int(kernels))
            for d, streams in zip(self._positions, self._plan_streams)
        )

    def _run(self, key, padded: ProblemBatch):
        """Runs ``key``'s plans on the padded batch, each on its shard of
        rows. Returns their outputs, the padded workloads ``T'`` and, on the
        card, one event after each plan's work."""
        t_star = padded.T - padded.lower.sum(axis=1)
        arrays = (padded.costs, padded.lower, padded.upper, t_star)
        outs, events = [], []
        with self._run_lock:
            plans = self._entry(key)
            rows = len(t_star) // len(plans)
            for p, plan in enumerate(plans):
                shard = [a[p * rows : (p + 1) * rows] for a in arrays]
                with contextlib.ExitStack() as current:
                    for s in plan.streams:
                        current.enter_context(torch.cuda.stream(s))
                    outs.append(plan(*shard))
                if plan.streams:
                    events.append(torch.cuda.Event())
                    events[-1].record(plan.streams[0])
        return outs, t_star, tuple(events)

    # ---- solving -------------------------------------------------------

    def _dispatch_dp(self, batch: ProblemBatch) -> SweepHandle:
        nb, Tb, Wb = request_bucket(batch)  # same math as the JAX engine's
        # the ring splits the class axis evenly and the mesh the batch axis:
        # their buckets round up to multiples of the sizes (padding is inert)
        nb = _round_up(nb, self._ring_ndev)
        Bb = _round_up(_next_pow2(batch.B), self._ndev)
        outs, t_star, events = self._run(("dp", Bb, nb, Tb, Wb), batch.pad_to(B=Bb, n=nb, W=Wb))
        return SweepHandle([o[0] for o in outs], [o[1] for o in outs], batch, t_star.astype(np.int32), events)

    def _dispatch_selection(self, batch: ProblemBatch):
        """Runs the MarIn/MarCo slice on the selection plan of its own shape
        bucket (``("marginal", B, n, W)`` — no ``T`` in the key: the
        workload is an input, not a shape). Marginal buckets share the
        engine's LRU and counters with the DP buckets, and run unsharded on
        the engine's device, as in the reference."""
        if batch.W < 2:  # every resource pinned at its lower limit: T' == 0
            zeros = np.zeros((batch.B, batch.n), dtype=np.int64)
            return _HostPart(restore_lower_limits(batch, zeros), np.zeros(batch.B))
        Bb, nb, _, Wb = bucket_shape(batch.B, batch.n, 1, batch.W)
        [(x, obj)], _, events = self._run(("marginal", Bb, nb, Wb), batch.pad_to(B=Bb, n=nb, W=Wb))
        return _SelectionPart([x], [obj], batch, events)

    @staticmethod
    def _host_part(batch: ProblemBatch, algorithm: str) -> _HostPart:
        """MarDecUn / MarDec slice: solved eagerly on the host (numpy) at
        dispatch time."""
        X = MARGINAL_BATCH_ALGORITHMS[algorithm](batch)
        b0 = remove_lower_limits(batch)
        obj = total_cost_batch(b0, X - batch.lower)
        return _HostPart(X, obj)

    @staticmethod
    def _take(batch: ProblemBatch, idx) -> ProblemBatch:
        """Row-slices a batch, keeping the (n, W) envelope — padding is
        inert on every path, so sub-batch solves are bit-identical to
        solving the instances alone."""
        idx = np.asarray(idx, dtype=np.int64)
        return ProblemBatch(
            T=batch.T[idx],
            lower=batch.lower[idx],
            upper=batch.upper[idx],
            costs=batch.costs[idx],
        )

    def dispatch(self, problems, split_regimes: bool = False):
        """Launches the batched solve WITHOUT materializing the result.

        Padding happens eagerly (numpy), the bucket's plan runs once — on
        the card its work is queued on the engine's stream — and the
        returned :class:`SweepHandle` copies the schedule to the host only
        on :meth:`SweepHandle.result`.

        ``split_regimes=True`` enables the monotone fast path: each
        instance's marginal-cost regime picks its algorithm (paper Table 2,
        via :func:`~repro_torch.core.marginal_torch.select_algorithm_batch`),
        the batch is partitioned into per-algorithm sub-batches (MarIn/MarCo
        -> selection, MarDecUn/MarDec -> host numpy, arbitrary -> fused DP),
        and a :class:`RegimeSplitHandle` reassembles rows in original order
        — bit-identical to dispatching each sub-batch alone. Batches that
        classify as pure-DP take exactly the default path (same buckets,
        same counters, plain :class:`SweepHandle`). The default ``False``
        keeps bit-identity with
        :func:`~repro_torch.core.torch_dp.solve_schedule_dp_batch` for every
        instance. MarDec sub-batches compute at dispatch time."""
        batch = (
            problems
            if isinstance(problems, ProblemBatch)
            else ProblemBatch.from_problems(problems)
        )
        batch.validate()
        if not split_regimes:
            return self._dispatch_dp(batch)
        algs = select_algorithm_batch(batch)
        groups: dict = {}
        for b, alg in enumerate(algs):
            key = "selection" if alg in ("marin", "marco") else alg
            groups.setdefault(key, []).append(b)
        if set(groups) == {"dp"}:
            return self._dispatch_dp(batch)
        parts = []
        # DP first: its plan is the slowest, let it compute while the host
        # parts run
        if "dp" in groups:
            parts.append((groups["dp"], self._dispatch_dp(self._take(batch, groups["dp"]))))
        if "selection" in groups:
            parts.append(
                (groups["selection"], self._dispatch_selection(self._take(batch, groups["selection"])))
            )
        for alg in ("mardecun", "mardec"):
            if alg in groups:
                parts.append((groups[alg], self._host_part(self._take(batch, groups[alg]), alg)))
        return RegimeSplitHandle(batch.B, batch.n, parts)

    def solve(self, problems, split_regimes: bool = False) -> np.ndarray:
        """Drop-in for :func:`~repro_torch.core.torch_dp.solve_schedule_dp_batch`:
        same inputs (sequence of :class:`Problem` or a prebuilt
        :class:`ProblemBatch`), bit-identical ``(B, n)`` int64 schedules —
        but warm buckets replay their plan. With ``split_regimes=True``,
        monotone instances ride the marginal fast path instead of the DP
        (see :meth:`dispatch`)."""
        return self.dispatch(problems, split_regimes=split_regimes).result()


# ---------------------------------------------------------------------------
# Process-wide default engines: schedule_batch / deadline_sweep / the facade
# all share these, so ANY repeated shape anywhere in the process is warm.
# ---------------------------------------------------------------------------

_DEFAULT_ENGINES: dict = {}
_DEFAULT_LOCK = threading.Lock()


def default_engine(backend: str = "auto", device="cuda") -> SweepEngine:
    """The shared engine for ``backend`` on ``device`` (created on first
    use). Keyed on the RESOLVED backend and the device, so "auto" and its
    resolved name (e.g. "blocked" on the CPU) share one engine and one warm
    cache."""
    dev = _canonical_device(device)
    key = (resolve_backend(backend, dev), str(dev))
    with _DEFAULT_LOCK:
        eng = _DEFAULT_ENGINES.get(key)
        if eng is None:
            eng = _DEFAULT_ENGINES[key] = SweepEngine(backend=key[0], device=dev)
        return eng


def reset_default_engines() -> None:
    """Drops the shared engines (test isolation)."""
    with _DEFAULT_LOCK:
        _DEFAULT_ENGINES.clear()


def _resolve_engine(backend: Optional[str], engine, device="cuda"):
    """The engine a cached solve runs on: the given one (after checking it
    does not contradict an explicitly named backend — its plans run ITS
    backend, so we raise rather than silently running the wrong kernel;
    backends compare after "auto" resolution on the engine's device), else
    the shared default for ``backend`` on ``device`` (``None`` -> "auto")."""
    if engine is not None:
        if backend is not None and resolve_backend(backend, engine.device) != engine.backend:
            raise ValueError(
                f"backend {backend!r} conflicts with engine.backend "
                f"{engine.backend!r}; pass an engine built for that backend"
            )
        return engine
    return default_engine(backend or "auto", device)


def _solve_cached(
    problems, backend: Optional[str], engine, split_regimes: bool, device="cuda"
) -> np.ndarray:
    """THE cached batched solve every public path shares: resolves the
    engine (:func:`_resolve_engine`) and runs one blocking solve. Private —
    callers go through :class:`repro_torch.core.solver.Solver` (or the
    deprecated shims below, which delegate here unchanged)."""
    return _resolve_engine(backend, engine, device).solve(problems, split_regimes=split_regimes)


def solve_dp_batch_cached(
    problems, backend: Optional[str] = None, engine=None, device="cuda"
) -> np.ndarray:
    """Deprecated shim: use ``Solver(engine=...).solve(problems,
    algorithm="dp_batch")`` (the facade).

    Batched DP solve through a sweep engine (the given one, else the shared
    default for ``backend`` on ``device``); delegates to the same private
    implementation the facade calls, so behavior — including the
    backend-vs-engine conflict ValueError — is bit-identical."""
    warn_deprecated(
        "solve_dp_batch_cached", 'Solver(engine=...).solve(problems, algorithm="dp_batch")'
    )
    return _solve_cached(problems, backend, engine, False, device)


def solve_schedule_batch_cached(
    problems, backend: Optional[str] = None, engine=None, device="cuda"
) -> np.ndarray:
    """Deprecated shim: use ``Solver(engine=...).solve(problems)`` (the
    facade).

    Regime-dispatched batched solve: monotone instances ride the marginal
    fast path, only arbitrary-regime instances pay the DP. Same
    engine/backend conventions (and conflict check) as
    :func:`solve_dp_batch_cached`; returns ``(B, n)`` int64 schedules in
    original problem order."""
    warn_deprecated(
        "solve_schedule_batch_cached", "Solver(engine=...).solve(problems)"
    )
    return _solve_cached(problems, backend, engine, True, device)
