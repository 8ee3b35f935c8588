"""Hierarchical fleet-scale scheduling (DESIGN.md §16).

Every solve so far is one dense ``(B, n, W, T)`` batch with ``n ≈ 16``
clients; the pseudo-polynomial DP is O(n·T·W) per instance, so a flat solve
over thousands of clients is hopeless (n = 2048, T ≈ 25k, W ≈ 32 is ~10^9
min-plus cells). This module scales ``n`` with a two-level decomposition in
which every level stays a small exact (MC)²MKP:

  1. **Cluster** clients by their (cost_table, time_table) profiles: a
     fixed-dimension feature vector per client (log capacity, log total
     energy, a resampled normalized marginal-cost curve, optionally log
     completion time), z-scored, then k-means as torch ops on the engine's
     device, its initial centres drawn in numpy from ``seed``. Labels are
     remapped to first-appearance order, so singleton clusters reproduce
     the original client order exactly.
     The JAX package draws its initial centres with ``jax.random.choice``,
     which numpy cannot reproduce: the same ``seed`` gives other clusters
     there (each certified by its own ``gap_bound``).
  2. **Per-cluster curves**: ONE pure-DP :class:`~repro_torch.core.sweep.SweepEngine`
     dispatch solves every cluster at its full capacity — clusters share pow2
     plan buckets, and the fused DP's free ``K_last`` row IS each
     cluster's exact workload-Pareto curve ``K_c(t)`` (0-lower-limit terms).
  3. **Top-level allocation**: a small exact (MC)²MKP over the cluster
     curves assigns the round workload across clusters. Curves are sampled
     every ``quantum`` units (``q = 1`` keeps them exact), so the top DP has
     ``T' / q`` rows over ``k`` classes of width ``cap_c / q``; the residual
     ``T' − q·Σm_c`` is repaired greedily on the exact curves.
  4. **Gap bound**: a second top-level instance over the *bin-minimum*
     curves ``K̲_c(m) = min_{t ∈ bin m} K_c(t)`` lower-bounds every feasible
     allocation; its final DP row (free, same dispatch as stage 3) gives
     ``LB = min_{s ∈ [s_lo, T_q]} row(s)`` where any exact allocation's bin
     total lands in ``[s_lo, T_q]`` (each cluster rounds down < ``q`` units,
     so ``s_lo = ⌈(T' − k(q−1))/q⌉``). The reported relative
     ``gap_bound = (E_curve − LB)/LB`` is a certificate: the true optimum
     lies within it. With ``q = 1`` the decomposition is exact and the bound
     collapses to ~0 (f32 association noise).
  5. **Per-cluster schedules**: ONE regime-split dispatch solves each
     cluster at its allocated workload — monotone clusters ride the §13
     marginal fast path, arbitrary ones batch into the fused DP.

The only optimality gap is intra-cluster quantization (stage 3); the
decomposition itself is exact because cluster curves are exact.

Everything is surfaced through :meth:`repro_torch.core.solver.Solver.solve_fleet`
(→ :class:`FleetSolution`), the FL server's round planning
(``PlanPolicy(fleet_clusters=...)``), and the serve layer
(``SchedulerService.submit_fleet``). :class:`PlanPolicy` is the typed
planning config those three consume. The port of ``repro.core.fleet``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .problem import Problem, total_cost, validate_schedule
from .sweep import SweepEngine, default_engine
from .torch_dp import resolve_device

__all__ = [
    "FleetRun",
    "FleetSolution",
    "PlanPolicy",
    "cluster_clients",
    "solve_fleet",
]


# ---------------------------------------------------------------------------
# PlanPolicy: the typed planning config (satellite 1 of the API redesign)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanPolicy:
    """Round-planning policy consumed by the FL server (``policy=...``) and
    :meth:`repro_torch.core.solver.Solver.solve_fleet` — the typed replacement for
    the sprawl of the server's constructor kwargs (each legacy kwarg
    remains a bit-identical warn-once shim).

    Fields mirror the legacy kwargs one-for-one; the ``fleet_*`` trio is new:
    ``fleet_clusters`` switches round planning to the two-level fleet path
    (``None`` = flat planning; ``"auto"`` ≈ √n clusters), ``fleet_quantum``
    sets the top-level curve sampling step (``None`` = auto, 1 = exact), and
    ``fleet_seed`` seeds the deterministic k-means.
    """

    algorithm: str = "auto"
    round_T: Optional[int] = None
    participation_floor: Optional[int] = None
    scenario_T_candidates: Sequence[int] = ()
    scenario_dropouts: Sequence[Sequence[int]] = ()
    engine: Optional[SweepEngine] = None
    service: Optional[object] = None
    frontier_mode: Optional[object] = None
    time_tables: Optional[Sequence[np.ndarray]] = None
    frontier_points: int = 12
    fleet_clusters: Optional[object] = None  # int | "auto" | None
    fleet_quantum: Optional[int] = None
    fleet_seed: int = 0
    # a repro_torch.core.resilience.RetryPolicy: the server's Solver retries
    # transient engine failures during round planning (DESIGN.md §17);
    # None = fail fast (the campaign loop still has its own re-plan path)
    retry: Optional[object] = None
    # adaptive planning under drift (DESIGN.md §18). lookahead=k solves the
    # next k rounds' schedules per speculative batch (0 = off);
    # drift_tolerance bounds both the Page–Hinkley detector and the
    # speculative-plan validation band; reliability (an EWMA decay in
    # (0, 1]) arms crash/straggle-history capacity down-weighting;
    # watermark_quantile (in (0, 1)) arms intra-round re-planning at that
    # quantile of planned per-client finish times. All default-off: a
    # default policy runs the pre-adaptive loop byte-identically.
    lookahead: int = 0
    drift_tolerance: float = 0.1
    reliability: Optional[float] = None
    watermark_quantile: Optional[float] = None

    def __post_init__(self):
        # normalize the sequence fields so policies compare by value
        object.__setattr__(
            self, "scenario_T_candidates", tuple(self.scenario_T_candidates or ())
        )
        object.__setattr__(
            self,
            "scenario_dropouts",
            tuple(tuple(s) for s in (self.scenario_dropouts or ())),
        )
        if self.time_tables is not None:
            object.__setattr__(
                self,
                "time_tables",
                tuple(np.asarray(t, dtype=np.float64) for t in self.time_tables),
            )
        if self.frontier_mode is not None and self.time_tables is None:
            raise ValueError("frontier_mode requires time_tables")
        if int(self.lookahead) < 0:
            raise ValueError("lookahead must be >= 0")
        if int(self.lookahead) > 0 and (
            self.frontier_mode is not None or self.fleet_clusters is not None
        ):
            raise ValueError(
                "lookahead speculation requires the default min-energy "
                "planning path (no frontier_mode / fleet_clusters)"
            )
        if not (float(self.drift_tolerance) > 0.0):
            raise ValueError("drift_tolerance must be > 0")
        if self.reliability is not None and not (0.0 < float(self.reliability) <= 1.0):
            raise ValueError("reliability is an EWMA decay in (0, 1]")
        if self.watermark_quantile is not None and not (
            0.0 < float(self.watermark_quantile) < 1.0
        ):
            raise ValueError("watermark_quantile must be in (0, 1)")


# ---------------------------------------------------------------------------
# Stage 1: deterministic client clustering
# ---------------------------------------------------------------------------

_FEATURE_POINTS = 8  # resampled marginal-curve signature length


def _initial_centres(n: int, k: int, seed: int) -> np.ndarray:
    """The ``k`` distinct clients whose features start Lloyd's iterations,
    drawn in numpy from ``seed`` (deterministic on every device)."""
    return np.random.default_rng(int(seed)).choice(n, size=k, replace=False)


def _kmeans_labels(feats: torch.Tensor, start, k: int, iters: int) -> torch.Tensor:
    """Lloyd iterations in float32 on ``feats``' device: deterministic given
    (feats, start). Empty clusters keep their previous center (they simply
    end up unused). The centre sums are a float32 reduction of the one-hot
    products, not a matrix product, so no TF32 tensor core rounds them. The
    card and the CPU still sum in different orders, so a centre may differ
    in its last bits and a near-tie may label differently: equal labels on
    both are checked on the instances the tests and the card's smoke run
    use, not guaranteed."""
    centers = feats[torch.as_tensor(np.asarray(start, dtype=np.int64), device=feats.device)]
    ar = torch.arange(k, device=feats.device)
    for _ in range(iters):
        d2 = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        lab = torch.argmin(d2, dim=1)
        one = (lab[:, None] == ar[None, :]).to(feats.dtype)  # (n, k)
        cnt = one.sum(dim=0)
        sums = (one[:, :, None] * feats[:, None, :]).sum(dim=0)  # (k, d)
        centers = torch.where(
            cnt[:, None] > 0, sums / torch.clamp(cnt[:, None], min=1.0), centers
        )
    d2 = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return torch.argmin(d2, dim=1)


def _client_features(problem: Problem, time_tables=None) -> np.ndarray:
    """Fixed-dimension profile per client, in 0-lower-limit terms: log free
    capacity, log total energy over it, the normalized cost curve resampled
    at ``_FEATURE_POINTS`` fill fractions (the shape signature that separates
    linear / increasing / decreasing marginal regimes), and — when time
    tables are given — log completion time at capacity. Columns are z-scored
    so no single scale dominates the k-means metric."""
    n = problem.n
    L, U = problem.lower, problem.upper
    fr = np.linspace(0.0, 1.0, _FEATURE_POINTS)
    cols = _FEATURE_POINTS + 2 + (1 if time_tables is not None else 0)
    feats = np.zeros((n, cols), dtype=np.float64)
    for i in range(n):
        tbl = np.asarray(problem.cost_tables[i], dtype=np.float64)
        cap = int(U[i] - L[i])
        base = float(tbl[L[i]])
        total = float(tbl[L[i] + cap]) - base
        feats[i, 0] = math.log1p(cap)
        feats[i, 1] = math.log1p(max(total, 0.0))
        if cap > 0:
            js = L[i] + np.round(fr * cap).astype(np.int64)
            feats[i, 2 : 2 + _FEATURE_POINTS] = (tbl[js] - base) / max(
                abs(total), 1e-12
            )
        if time_tables is not None:
            tt = np.asarray(time_tables[i], dtype=np.float64)
            feats[i, -1] = math.log1p(max(float(tt[min(int(U[i]), len(tt) - 1)]), 0.0))
    mu, sd = feats.mean(axis=0), feats.std(axis=0)
    return (feats - mu) / np.where(sd > 1e-12, sd, 1.0)


def _auto_clusters(n: int) -> int:
    return max(1, int(round(math.sqrt(n))))


def cluster_clients(
    problem: Problem,
    *,
    clusters=None,
    seed: int = 0,
    time_tables=None,
    iters: int = 16,
    device="cuda",
) -> np.ndarray:
    """Deterministic k-means clustering of the fleet by cost/time profiles.

    Returns ``(n,)`` int64 labels in **first-appearance order**: client 0 is
    always in cluster 0, and the first client of each new cluster fixes its
    id. That canonical order makes the decomposition reproducible under a
    fixed ``seed`` and, when every cluster is a singleton
    (``clusters == n``), makes the top-level instance literally the flat
    instance — the basis of the exactness tests.

    ``clusters``: target count (clamped to ``n``); ``None`` / ``"auto"``
    picks ``≈ √n``. ``device``: where Lloyd's iterations run (``"cuda"``,
    which raises without a card, unless the caller asks for the CPU).
    """
    n = problem.n
    if clusters is None or clusters == "auto":
        k = _auto_clusters(n)
    else:
        k = int(clusters)
        if k < 1:
            raise ValueError("clusters must be >= 1")
    k = min(k, n)
    if k == n:
        return np.arange(n, dtype=np.int64)  # singletons: identity labels
    feats = _client_features(problem, time_tables)
    x = torch.as_tensor(feats, dtype=torch.float32).to(resolve_device(device))
    lab = _kmeans_labels(x, _initial_centres(n, k, seed), k, iters).cpu().numpy()
    # canonical relabel: cluster ids in order of first appearance (empty
    # k-means cells vanish here — k_eff is the number of distinct labels)
    remap: dict = {}
    out = np.empty(n, dtype=np.int64)
    for i, c in enumerate(lab.tolist()):
        if c not in remap:
            remap[c] = len(remap)
        out[i] = remap[c]
    return out


# ---------------------------------------------------------------------------
# Stages 2-5: curves -> top-level allocation (+ gap bound) -> schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetSolution:
    """Result of a two-level fleet solve.

    ``schedule`` is the full ``(n,)`` per-client assignment (sums to ``T``);
    ``objective`` its exact float64 energy under the original tables.
    ``gap_bound`` is the certified relative optimality gap (see module
    docstring) — 0 means provably optimal up to f32 noise. ``allocations``
    holds each cluster's workload in original terms, ``curves`` the per-
    cluster exact workload-Pareto rows (0-lower-limit terms, f32) the
    allocation was solved over, and ``cluster_stats`` one dict per cluster
    (size / capacity / workload / regime).
    """

    schedule: np.ndarray
    objective: float
    labels: np.ndarray
    allocations: np.ndarray
    gap_bound: float
    num_clusters: int
    quantum: int
    cluster_stats: tuple
    curves: np.ndarray
    cache_stats: Optional[dict] = None


def _auto_quantum(max_cap: int, workload: int) -> int:
    """Top-level curve sampling step: keep the top DP's class width ≤ ~256
    multiples. Quantization error is paid relative to the round *workload*,
    not the fleet capacity, so over-provisioned fleets (capacity ≫ T) must
    not coarsen further than the workload itself warrants. Small fleets
    (every n ≤ 64 gap benchmark) get ``q = 1`` — the exact decomposition."""
    return max(1, math.ceil(min(max_cap, workload) / 256))


class FleetRun:
    """A staged two-level fleet solve.

    Construction runs stage 1 (clustering: host numpy features, then
    k-means on the engine's device) and *launches* stage 2 (the per-cluster
    curve dispatch — its replay queued on the engine's stream, or one
    coalescable served request when built over a service). :meth:`finish`
    blocks on the curves, runs the top-level allocation + residual repair +
    per-cluster schedule dispatch, and returns the :class:`FleetSolution`.
    The serve layer's ``submit_fleet`` future wraps exactly this split.
    """

    def __init__(
        self,
        problem: Problem,
        *,
        engine: Optional[SweepEngine] = None,
        service=None,
        clusters=None,
        quantum: Optional[int] = None,
        seed: int = 0,
        time_tables=None,
        check: bool = True,
        device="cuda",
    ):
        problem.validate()
        self.problem = problem
        self.check = bool(check)
        self._service = service
        self._engine = (
            service.engine
            if service is not None
            else (engine if engine is not None else default_engine(device=device))
        )
        self.labels = cluster_clients(
            problem,
            clusters=clusters,
            seed=seed,
            time_tables=time_tables,
            device=self._engine.device,
        )
        self.num_clusters = int(self.labels.max()) + 1
        self.members = [
            np.flatnonzero(self.labels == c) for c in range(self.num_clusters)
        ]
        L, U = problem.lower, problem.upper
        self._caps = np.array(
            [int((U[idx] - L[idx]).sum()) for idx in self.members], dtype=np.int64
        )
        self._lsums = np.array(
            [int(L[idx].sum()) for idx in self.members], dtype=np.int64
        )
        Tp = int(problem.T - L.sum())  # round workload in 0-lower terms
        self.quantum = (
            _auto_quantum(int(self._caps.max()), Tp)
            if quantum is None
            else int(quantum)
        )
        if self.quantum < 1:
            raise ValueError("quantum must be >= 1")
        # stage 2 launch: each cluster's workload-Pareto curve. No cluster
        # is ever allocated more than the round workload, so the curve is
        # harvested only up to min(capacity, T' + q) — over-provisioned
        # fleets (capacity ≫ T) would otherwise pay DP tables as wide as
        # their idle capacity
        self._cluster_probs = [
            Problem(
                T=int(
                    min(
                        U[idx].sum(),
                        L[idx].sum() + Tp + self.quantum,
                    )
                ),
                lower=L[idx],
                upper=U[idx],
                cost_tables=tuple(problem.cost_tables[i] for i in idx),
            )
            for idx in self.members
        ]
        self._curve_handle = self._dispatch(self._cluster_probs, split=False)
        self._solution: Optional[FleetSolution] = None

    def _dispatch(self, probs, split: bool):
        if self._service is not None:
            return self._service.submit(probs, split_regimes=split)
        return self._engine.dispatch(probs, split_regimes=split)

    def done(self) -> bool:
        """True once the in-flight curve dispatch has landed (the remaining
        stages are small and run inside :meth:`finish`)."""
        return self._solution is not None or self._curve_handle.done()

    def _remaining(self, deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise TimeoutError("fleet solve not served within the timeout")
        return rem

    def _materialize(self, handle, deadline: Optional[float], what: str = "result"):
        """Blocks on one staged result, spending only the budget left on the
        deadline clock for served futures (direct engine handles expose no
        timeout — there the device computation is already in flight and the
        caller used the blocking ``solve_fleet`` path anyway)."""
        fn = getattr(handle, what)
        if self._service is not None and deadline is not None:
            return fn(timeout=self._remaining(deadline))
        return fn()

    def finish(self, timeout: Optional[float] = None) -> FleetSolution:
        """Runs stages 3–5 and returns the (cached) :class:`FleetSolution`.
        ``timeout`` is one deadline across ALL remaining staged solves;
        served requests that outlive it raise :class:`TimeoutError` (the
        run stays retryable — nothing is cached on a timed-out pass)."""
        if self._solution is not None:
            return self._solution
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        p, q, k = self.problem, self.quantum, self.num_clusters
        caps = self._caps
        Tp = int(p.T - p.lower.sum())  # round workload in 0-lower terms

        # stage 3: top-level (MC)²MKP over the cluster curves, sampled every
        # q units — batched with the bin-minimum LB instance (stage 4) into
        # ONE dispatch (same (k, T_q, M+1) envelope -> same pow2 bucket)
        K = np.asarray(
            self._materialize(self._curve_handle, deadline, "k_last"),
            dtype=np.float64,
        )  # (k, curve)
        M0 = caps // q
        T_q = min(Tp // q, int(M0.sum()))
        # a cluster can never receive more than T_q quanta — clamping the
        # class widths is lossless and keeps the top DP's tables narrow
        # when capacity ≫ workload
        M = np.minimum(M0, T_q)
        endpoint, binmin = [], []
        for c in range(k):
            idx = (np.arange(int(M[c]) + 1)) * q
            endpoint.append(K[c, idx])
            binmin.append(
                np.array(
                    [
                        K[c, m * q : min((m + 1) * q, int(caps[c]) + 1)].min()
                        for m in range(int(M[c]) + 1)
                    ]
                )
            )
        zeros = np.zeros(k, dtype=np.int64)
        top = [
            Problem(T=T_q, lower=zeros, upper=M, cost_tables=tuple(endpoint)),
            Problem(T=T_q, lower=zeros, upper=M, cost_tables=tuple(binmin)),
        ]
        top_handle = self._dispatch(top, split=False)
        m_alloc = np.asarray(self._materialize(top_handle, deadline))[0, :k].astype(
            np.int64
        )
        row_lb = np.asarray(
            self._materialize(top_handle, deadline, "k_last"), dtype=np.float64
        )[1]

        # stage 4: the certificate. Any feasible exact allocation rounds
        # down < q units per cluster, so its bin total s lands in
        # [ceil((T' - k(q-1))/q), T_q]; the LB row minimized over that range
        # lower-bounds the true optimum.
        s_lo = max(0, -((-(Tp - k * (q - 1))) // q))  # integer ceil-div
        s_lo = min(s_lo, T_q)
        lb0 = float(row_lb[s_lo : T_q + 1].min())

        # residual repair: T' - q*T_q leftover units, added one at a time
        # where the EXACT curve's marginal is cheapest
        t = m_alloc * q
        r = Tp - int(t.sum())
        ar = np.arange(k)
        for _ in range(r):
            marg = np.where(
                t < caps, K[ar, np.minimum(t + 1, K.shape[1] - 1)] - K[ar, t], np.inf
            )
            t[int(np.argmin(marg))] += 1
        e_curve0 = float(K[ar, t].sum())  # achieved value, 0-lower curve terms

        # gap bound in ABSOLUTE terms: add the fixed lower-limit cost back
        fixed = float(
            sum(p.cost_tables[i][int(p.lower[i])] for i in range(p.n))
        )
        lb_abs = lb0 + fixed
        gap = max(0.0, (e_curve0 + fixed) - lb_abs) / max(abs(lb_abs), 1e-12)

        # stage 5: per-cluster schedules at the allocated workloads, ONE
        # regime-split dispatch (monotone clusters ride the §13 fast path)
        alloc = t + self._lsums
        sched_probs = [
            Problem(
                T=int(alloc[c]),
                lower=p.lower[idx],
                upper=p.upper[idx],
                cost_tables=tuple(p.cost_tables[i] for i in idx),
            )
            for c, idx in enumerate(self.members)
        ]
        X = np.asarray(
            self._materialize(self._dispatch(sched_probs, split=True), deadline)
        )
        x = np.zeros(p.n, dtype=np.int64)
        for c, idx in enumerate(self.members):
            x[idx] = X[c, : len(idx)]
        if self.check:
            validate_schedule(p, x)
        stats = tuple(
            {
                "size": int(len(idx)),
                "capacity": int(p.upper[idx].sum()),
                "workload": int(alloc[c]),
                "regime": sched_probs[c].regime(),
            }
            for c, idx in enumerate(self.members)
        )
        self._solution = FleetSolution(
            schedule=x,
            objective=float(total_cost(p, x)),
            labels=self.labels,
            allocations=alloc,
            gap_bound=float(gap),
            num_clusters=k,
            quantum=q,
            cluster_stats=stats,
            curves=np.asarray(self._curve_handle.k_last()),
            cache_stats=self._engine.cache_stats(),
        )
        return self._solution


def solve_fleet(
    problem: Problem,
    *,
    engine: Optional[SweepEngine] = None,
    service=None,
    clusters=None,
    quantum: Optional[int] = None,
    seed: int = 0,
    time_tables=None,
    check: bool = True,
    device="cuda",
) -> FleetSolution:
    """Blocking two-level fleet solve — :class:`FleetRun` start + finish.
    Callers go through :meth:`repro_torch.core.solver.Solver.solve_fleet`.
    Without an ``engine`` or ``service`` the shared default engine on
    ``device`` runs it."""
    return FleetRun(
        problem,
        engine=engine,
        service=service,
        clusters=clusters,
        quantum=quantum,
        seed=seed,
        time_tables=time_tables,
        check=check,
        device=device,
    ).finish()
