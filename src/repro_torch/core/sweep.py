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

Multi-GPU sweeps (the JAX package's ``mesh`` batch sharding and
``ring_mesh`` class ring) are not ported: they raise
``NotImplementedError`` (ROADMAP Queue 1, item 2).
"""

from __future__ import annotations

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
from .torch_dp import _pack_on_device, _solve_fused_batch, resolve_device

__all__ = [
    "RegimeSplitHandle",
    "SweepEngine",
    "SweepHandle",
    "bucket_shape",
    "default_engine",
    "make_sweep_mesh",
    "request_bucket",
    "reset_default_engines",
    "solve_dp_batch_cached",
    "solve_schedule_batch_cached",
]

_MULTI_GPU = (
    "multi-GPU sweeps (batch sharding over a mesh, the class-axis ring) are "
    "not ported yet: ROADMAP Queue 1, item 2 (torch.distributed)"
)


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


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


def make_sweep_mesh(axis: str = "sweep"):
    """Not ported: a sweep mesh over several cards needs
    ``torch.distributed``."""
    raise NotImplementedError(_MULTI_GPU)


class _Plan:
    """One bucket's executable: ``body`` over inputs of the bucket's shape.

    On the CPU each call runs ``body`` on the inputs. On the card the first
    call runs it eagerly on static copies of the inputs and captures it into
    a CUDA graph; later calls copy into the static buffers and replay.
    ``row_launches`` is the number of min-plus row kernels the graph holds
    (with one backtrack after them when it is not 0). Calls are serialised
    by the engine."""

    def __init__(self, body, device: torch.device, stream, row_launches=0):
        self.body = body
        self.device = device
        self.stream = stream
        self.row_launches = row_launches
        self.inputs = None  # static input buffers (card)
        self.outputs = None  # the graph's static outputs (card)
        self.graph = None

    def __call__(self, *arrays):
        if self.device.type != "cuda":
            return self.body(*(torch.from_numpy(a) for a in arrays))
        if self.graph is None:
            self.inputs = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
            out = self.body(*self.inputs)  # the warm-up, and the answer
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                self.outputs = self.body(*self.inputs)
            self.graph = graph
            return out
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(torch.from_numpy(a))
        self.graph.replay()
        if self.row_launches:
            _minplus.launches += self.row_launches
            _minplus.launches_backtrack += 1
        return tuple(o.clone() for o in self.outputs)


class _DeviceSchedulePart:
    """Launch/materialize seam shared by the DP and selection handles: a
    padded ``(Bb, nb)`` schedule tensor, still computing when it is on the
    card (``event`` marks its end), plus the ORIGINAL (unpadded) batch to
    unpad against.

    Materialization is lock-guarded: handles are handed across threads, and
    without the lock two concurrent first calls to :meth:`result` would race
    the transfer-and-cache sequence and could hand different array objects
    to different callers.
    """

    def __init__(self, raw, batch, event=None):
        self._raw = raw  # (Bb, nb) int32 tensor
        self._batch = batch  # the ORIGINAL (unpadded) ProblemBatch
        self._event = event  # None on the CPU: the solve has landed
        self._out: Optional[np.ndarray] = None
        self._mat_lock = threading.Lock()  # guards every host-side cache

    def done(self) -> bool:
        """True once the solve has landed (the device work behind it has
        finished)."""
        return self._out is not None or self._event is None or self._event.query()

    def _host(self, t: torch.Tensor) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return t.cpu().numpy()

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

    def __init__(self, raw, k_last, batch, t_star, event=None):
        super().__init__(raw, batch, event)
        self._k_last = k_last  # (Bb, Tb+1) final DP row tensor
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

    def __init__(self, raw_x, raw_obj, batch, event=None):
        super().__init__(raw_x, batch, event)
        self._raw_obj = raw_obj  # (Bb,) float32 0-lower-limit objectives
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


def _canonical_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SweepEngine:
    """Plan-cached batched (MC)^2MKP solver on one device.

    Args:
      backend: min-plus backend (:func:`~repro_torch.kernels.ops.resolve_backend`):
        "auto" resolves by the device ("cuda" on the card, "blocked" on the
        CPU); "ref" forces the dense plain version.
      max_entries: LRU capacity — distinct shape buckets kept warm.
      device: where the plans run; ``"cuda"`` (the default) raises without
        a card.
      mesh, ring_mesh: multi-GPU sharding; not ported, they raise
        ``NotImplementedError`` (ROADMAP Queue 1, item 2).
    """

    def __init__(
        self,
        backend: str = "auto",
        max_entries: int = 64,
        mesh=None,
        ring_mesh=None,
        device="cuda",
    ):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if mesh is not None or ring_mesh is not None:
            raise NotImplementedError(_MULTI_GPU)
        self.device = _canonical_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.max_entries = int(max_entries)
        self._cache: OrderedDict = OrderedDict()
        self._hits = self._misses = self._compiles = self._evictions = 0
        self._bucket_hits: dict = {}  # bucket key -> warm-hit count
        # Guards cache + counters: solves may come from several threads.
        self._lock = threading.Lock()
        # Serialises dispatches: a bucket's static buffers are shared.
        self._run_lock = threading.Lock()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

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
        and one graph capture) — with a warm cache it stays flat no matter
        how many solves run. ``per_bucket_hits`` breaks the warm hits down
        by bucket (keyed by :meth:`_bucket_label`; counts survive eviction
        — they describe traffic, not cache residency)."""
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

    def _entry(self, key) -> _Plan:
        with self._lock:
            plan = self._cache.get(key)
            if plan is not None:
                self._hits += 1
                self._bucket_hits[key] = self._bucket_hits.get(key, 0) + 1
                self._cache.move_to_end(key)
                return plan
            self._misses += 1
            self._compiles += 1
            plan = self._build(key)
            self._cache[key] = plan
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
                self._evictions += 1
            return plan

    def _build(self, key) -> _Plan:
        if key[0] == "marginal":

            def run_sel(costs64, lower, upper, t_star):
                # monotone fast path: top-T' marginal-unit selection — no DP
                # table, O(B·nW·log nW)
                return marginal_select(_pack_on_device(costs64, lower, upper), upper - lower, t_star)

            return _Plan(run_sel, self.device, self._stream)

        _, _, nb, Tb, _ = key
        backend = self.backend

        def run(costs64, lower, upper, t_star):
            # fused DP + backtrack: only (X, K_last) leave the plan, never
            # the (n, B, T+1) argmin slab
            return _solve_fused_batch(_pack_on_device(costs64, lower, upper), t_star, Tb, backend=backend)

        return _Plan(run, self.device, self._stream, nb if backend == "cuda" else 0)

    def _run(self, key, padded: ProblemBatch):
        """Runs ``key``'s plan on the padded batch. Returns its outputs, the
        padded workloads ``T'`` and, on the card, the event after them."""
        t_star = padded.T - padded.lower.sum(axis=1)
        arrays = (padded.costs, padded.lower, padded.upper, t_star)
        with self._run_lock:
            plan = self._entry(key)
            if self._stream is None:
                return plan(*arrays), t_star, None
            with torch.cuda.stream(self._stream):
                out = plan(*arrays)
                event = torch.cuda.Event()
                event.record()
            return out, t_star, event

    # ---- solving -------------------------------------------------------

    def _dispatch_dp(self, batch: ProblemBatch) -> SweepHandle:
        nb, Tb, Wb = request_bucket(batch)  # same math as the JAX engine's
        Bb = _next_pow2(batch.B)
        (X, k_last), t_star, event = self._run(("dp", Bb, nb, Tb, Wb), batch.pad_to(B=Bb, n=nb, W=Wb))
        return SweepHandle(X, k_last, batch, t_star.astype(np.int32), event)

    def _dispatch_selection(self, batch: ProblemBatch):
        """Runs the MarIn/MarCo slice on the selection plan of its own shape
        bucket (``("marginal", B, n, W)`` — no ``T`` in the key: the
        workload is an input, not a shape). Marginal buckets share the
        engine's LRU and counters with the DP buckets."""
        if batch.W < 2:  # every resource pinned at its lower limit: T' == 0
            zeros = np.zeros((batch.B, batch.n), dtype=np.int64)
            return _HostPart(restore_lower_limits(batch, zeros), np.zeros(batch.B))
        Bb, nb, _, Wb = bucket_shape(batch.B, batch.n, 1, batch.W)
        (x, obj), _, event = self._run(("marginal", Bb, nb, Wb), batch.pad_to(B=Bb, n=nb, W=Wb))
        return _SelectionPart(x, obj, batch, event)

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
