"""Adaptive planning under drift (DESIGN.md §18).

The paper's schedules are optimal only for the cost tables they are handed;
in deployment those tables drift (thermal throttling, battery state,
contention) and a frozen schedule silently decays from optimal to wrong.
This module makes the campaign runtime *proactive* on top of the
reactive fault layer (``fl/faults.py``), with four cooperating pieces:

  * :class:`DriftPlan` / :class:`DriftInjector` — seeded, replayable drift:
    one integer seed expands into a per-(round, client) multiplicative
    scale on the TRUE device energy (random walk + throttle events).
    Applied on the main thread at the top of each round, drift is plan
    data — serial and pipelined campaigns see identical worlds, and
    checkpoint resume replays the same trajectory.
  * :class:`DriftDetector` — a two-sided Page–Hinkley test over the
    estimator's per-round mean relative innovation. Pure deterministic
    arithmetic over the telemetry sequence: the same rounds produce the
    same in-band / drifted classifications everywhere.
  * :class:`AdaptiveCoordinator` — speculative multi-round lookahead: at a
    round boundary it solves the next ``lookahead`` rounds' schedules from
    the estimator's PREDICTED tables as ONE extra
    :class:`~repro_torch.core.solver.Solver` batch on the existing planner
    executor. When a speculative round arrives in-band (detector quiet,
    bounds unchanged, predicted tables within ``drift_tolerance`` of the
    fresh snapshot) the pre-solved schedule commits with ZERO extra engine
    dispatches; otherwise it counts a ``speculation_miss`` and re-plans
    fresh. Planning stays a pure function of the estimator snapshot, so the
    §11 serial == pipelined bit-identity contract is preserved.
  * :func:`watermark_split` — speculative *intra-round* re-planning: a
    mid-round telemetry watermark (the ``watermark_quantile`` of planned
    per-client finish times, in batch-time units) at which crashes that
    already happened and stragglers' projected completions are known
    (client-side progress telemetry timestamps every batch, so an observed
    rate below 1 projects the exact ``floor(x_i / sev)`` completion the
    fault model charges). Early-detectable faults trigger
    :meth:`~repro_torch.fl.server.FederatedServer.recover_round`'s residual
    re-solve BEFORE the barrier; crashes after the watermark get a second,
    post-barrier pass. When every fault is early-detectable the early
    residual instance is byte-for-byte the reactive one, so the recovered
    assignments are bit-identical — only the wall-clock improves
    (``barrier_wait`` reduction reported per round).

A numpy copy of the JAX package's ``fl/adaptive.py`` (it imports only the
problem type and the fault layer): the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.problem import Problem, total_cost
from .faults import RoundFaults

__all__ = [
    "AdaptiveCoordinator",
    "AdaptiveRoundStats",
    "DriftDetector",
    "DriftInjector",
    "DriftPlan",
    "WatermarkStats",
    "watermark_split",
]


# ---------------------------------------------------------------------------
# seeded drift: the world moves, deterministically
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DriftPlan:
    """An immutable drift schedule: ``scales[r, i]`` multiplies client
    ``i``'s TRUE energy table during round ``r`` (rounds past the last row
    hold the final scale). Like :class:`~repro_torch.fl.faults.FaultPlan`, the
    plan is DATA — one seed, one trajectory, replayable everywhere."""

    seed: int
    scales: np.ndarray  # (num_rounds, n_clients) float64 multiplicative
    events: tuple = ()  # ((round, client, factor, duration), ...) provenance

    def __post_init__(self):
        object.__setattr__(
            self, "scales", np.asarray(self.scales, dtype=np.float64)
        )

    @classmethod
    def generate(
        cls,
        seed: int,
        num_rounds: int,
        n_clients: int,
        walk_sigma: float = 0.01,
        p_event: float = 0.1,
        event_scale=(1.5, 3.0),
        event_rounds=(2, 5),
    ) -> "DriftPlan":
        """Expands ``seed`` into a drift trajectory: a per-client geometric
        random walk (log-scale steps ~ N(0, walk_sigma)) overlaid with
        throttle events — with probability ``p_event`` per round one client's
        cost multiplies by uniform(*event_scale*) for uniform(*event_rounds*)
        rounds, then recovers."""
        rng = np.random.default_rng(seed)
        walk = np.cumsum(
            rng.normal(0.0, walk_sigma, size=(num_rounds, n_clients)), axis=0
        )
        scales = np.exp(walk)
        events = []
        for r in range(num_rounds):
            if rng.random() < p_event:
                c = int(rng.integers(0, n_clients))
                f = float(rng.uniform(event_scale[0], event_scale[1]))
                dur = int(rng.integers(event_rounds[0], event_rounds[1] + 1))
                scales[r : r + dur, c] *= f
                events.append((r, c, f, dur))
        return cls(seed=int(seed), scales=scales, events=tuple(events))

    @classmethod
    def step(
        cls, num_rounds: int, n_clients: int, round_index: int, clients, factor: float,
        seed: int = 0,
    ) -> "DriftPlan":
        """A deterministic step event: from ``round_index`` on, each client
        in ``clients`` costs ``factor``x — the regime-flip benchmarks use
        this to make a frozen estimator measurably wrong."""
        scales = np.ones((int(num_rounds), int(n_clients)), dtype=np.float64)
        for c in clients:
            scales[int(round_index):, int(c)] = float(factor)
        events = tuple(
            (int(round_index), int(c), float(factor), int(num_rounds) - int(round_index))
            for c in clients
        )
        return cls(seed=int(seed), scales=scales, events=events)


class DriftInjector:
    """Applies a :class:`DriftPlan` to a fleet: a stateless per-round
    overwrite of each :class:`~repro_torch.fl.energy.DeviceProfile.drift_scale`
    (so checkpoint resume lands in exactly the round's world). Touches only
    the TRUE simulator tables — the scheduler finds out through its own
    noisy measurements, like a real deployment would."""

    def __init__(self, plan: DriftPlan):
        self.plan = plan

    def apply(self, round_index: int, fleet) -> None:
        scales = self.plan.scales
        row = scales[min(int(round_index), len(scales) - 1)]
        for i, dev in enumerate(fleet):
            dev.drift_scale = float(row[i]) if i < len(row) else 1.0


# ---------------------------------------------------------------------------
# drift detection: two-sided Page–Hinkley over round-mean innovations
# ---------------------------------------------------------------------------


class DriftDetector:
    """Classifies each round's estimator telemetry as in-band or drifted.

    Input per round: the mean signed relative innovation
    ``z̄ = mean((measured - C_i(x_i)) / C_i(x_i))``. A calibrated, stationary
    fleet keeps ``z̄`` near 0 (measurement noise averages out); sustained or
    abrupt cost movement pushes it away. The test is the standard two-sided
    Page–Hinkley statistic: ``m_t = Σ (z̄_s - mean_s ∓ δ)`` with an alarm
    when the excursion from its running extremum exceeds ``λ``. Defaults tie
    both to the policy's drift tolerance (``δ = tolerance/2``,
    ``λ = tolerance``): changes smaller than the tolerance are absorbed by
    the calibrator, larger ones must invalidate speculation.

    Pure deterministic float arithmetic over the input sequence — no clocks,
    no randomness — so serial/pipelined campaigns and checkpoint resumes
    classify identically (state round-trips via :meth:`state`)."""

    _STATE_KEYS = ("t", "mean", "m_pos", "min_pos", "m_neg", "max_neg", "alarms", "last_drifted")

    def __init__(self, tolerance: float = 0.1, delta: Optional[float] = None,
                 threshold: Optional[float] = None):
        self.tolerance = float(tolerance)
        self.delta = float(delta) if delta is not None else self.tolerance / 2.0
        self.threshold = float(threshold) if threshold is not None else self.tolerance
        self.alarms = 0
        self.last_drifted = False
        self.reset()

    def reset(self) -> None:
        """Re-baselines the test (called after every alarm: the calibrator
        is already chasing the new regime, so the next rounds are judged
        against a fresh baseline)."""
        self.t = 0
        self.mean = 0.0
        self.m_pos = 0.0
        self.min_pos = 0.0
        self.m_neg = 0.0
        self.max_neg = 0.0

    def update(self, value: float) -> bool:
        """Folds one round's signal in; returns True when the round is
        classified as drifted."""
        x = float(value)
        self.t += 1
        self.mean += (x - self.mean) / self.t
        self.m_pos += x - self.mean - self.delta
        self.min_pos = min(self.min_pos, self.m_pos)
        self.m_neg += x - self.mean + self.delta
        self.max_neg = max(self.max_neg, self.m_neg)
        drifted = (self.m_pos - self.min_pos > self.threshold) or (
            self.max_neg - self.m_neg > self.threshold
        )
        if drifted:
            self.alarms += 1
            self.reset()
        self.last_drifted = bool(drifted)
        return bool(drifted)

    def state(self) -> dict:
        return {
            "t": int(self.t), "mean": float(self.mean),
            "m_pos": float(self.m_pos), "min_pos": float(self.min_pos),
            "m_neg": float(self.m_neg), "max_neg": float(self.max_neg),
            "alarms": int(self.alarms), "last_drifted": bool(self.last_drifted),
        }

    def load_state(self, state: dict) -> None:
        for k in self._STATE_KEYS:
            setattr(self, k, state[k])


# ---------------------------------------------------------------------------
# intra-round watermark: re-plan before the barrier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WatermarkStats:
    """Timing of one watermarked round, in batch-time units (healthy client
    = 1 batch per unit; client ``i``'s local window closes at ``x_i``; the
    round barrier is ``max x_i``). ``reactive_finish`` is when the round
    would end had recovery waited for the barrier; ``early_finish`` is when
    it ends with recovery work dispatched at the watermark."""

    t_watermark: float
    t_barrier: float
    early_detected: tuple  # clients whose fault was visible at the watermark
    late_detected: tuple  # crashes after the watermark (second-pass recovery)
    reactive_finish: float = 0.0
    early_finish: float = 0.0

    @property
    def saved(self) -> float:
        return max(self.reactive_finish - self.early_finish, 0.0)

    @property
    def saved_pct(self) -> float:
        if self.reactive_finish <= 0.0:
            return 0.0
        return 100.0 * self.saved / self.reactive_finish

    def as_dict(self) -> dict:
        return {
            "t_watermark": float(self.t_watermark),
            "t_barrier": float(self.t_barrier),
            "early_detected": [int(c) for c in self.early_detected],
            "late_detected": [int(c) for c in self.late_detected],
            "reactive_finish": float(self.reactive_finish),
            "early_finish": float(self.early_finish),
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["WatermarkStats"]:
        if d is None:
            return None
        return cls(
            t_watermark=float(d["t_watermark"]),
            t_barrier=float(d["t_barrier"]),
            early_detected=tuple(int(c) for c in d["early_detected"]),
            late_detected=tuple(int(c) for c in d["late_detected"]),
            reactive_finish=float(d["reactive_finish"]),
            early_finish=float(d["early_finish"]),
        )


def watermark_split(faults: RoundFaults, assignments, quantile: float):
    """Splits a round's faults into what the mid-round watermark can see.

    The watermark fires at the ``quantile`` of planned per-client finish
    times (participants only). At that instant the telemetry knows, exactly
    and deterministically:

      * crashes whose crash time (= batches banked, at unit rate) is before
        the watermark — the heartbeat already went silent;
      * every straggler's projected completion: per-batch latency telemetry
        puts its observed rate at ``1/sev``, which projects to precisely the
        ``floor(x_i / sev)`` batches the fault model will charge.

    Crashes at or after the watermark are invisible until they happen and
    are returned separately for a post-barrier second pass.

    Returns ``(early_faults, late_crashed, stats)`` where ``early_faults``
    is a :class:`~repro_torch.fl.faults.RoundFaults` over the ORIGINAL assignments
    (None when nothing is early-detectable), ``late_crashed`` is a tuple of
    client ids, and ``stats`` is a partially-filled :class:`WatermarkStats`
    (finish times are filled in once recovery assignments are known)."""
    x = np.asarray(assignments, dtype=np.int64)
    active = x[x > 0].astype(np.float64)
    if active.size == 0:
        return None, tuple(faults.crashed), None
    t_barrier = float(active.max())
    t_watermark = float(np.quantile(active, float(quantile)))
    early_crashed = tuple(
        int(c) for c in faults.crashed if float(faults.completed[c]) < t_watermark
    )
    late_crashed = tuple(
        int(c) for c in faults.crashed if float(faults.completed[c]) >= t_watermark
    )
    stragglers = tuple(int(s) for s in faults.stragglers)
    early = None
    if early_crashed or stragglers:
        completed = x.copy()  # late crashes still look healthy at the watermark
        for c in early_crashed:
            completed[c] = min(int(faults.completed[c]), int(x[c]))
        for s in stragglers:
            completed[s] = min(int(faults.completed[s]), int(x[s]))
        early = RoundFaults(
            round_index=int(faults.round_index),
            completed=completed,
            crashed=early_crashed,
            stragglers=stragglers,
        )
    stats = WatermarkStats(
        t_watermark=t_watermark,
        t_barrier=t_barrier,
        early_detected=tuple(sorted(set(early_crashed) | set(stragglers))),
        late_detected=late_crashed,
    )
    return early, late_crashed, stats


# ---------------------------------------------------------------------------
# per-round adaptive telemetry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdaptiveRoundStats:
    """What the adaptive layer did to one round: the drift classification of
    its telemetry, whether its plan came from a committed speculation, and
    the watermark timing when intra-round re-planning fired."""

    round_index: int
    drifted: bool = False
    innovation_mean: float = 0.0
    innovation_abs: float = 0.0
    speculation: Optional[str] = None  # "hit" | "miss" | None (fresh solve)
    watermark: Optional[WatermarkStats] = None

    def as_dict(self) -> dict:
        return {
            "round_index": int(self.round_index),
            "drifted": bool(self.drifted),
            "innovation_mean": float(self.innovation_mean),
            "innovation_abs": float(self.innovation_abs),
            "speculation": self.speculation,
            "watermark": None if self.watermark is None else self.watermark.as_dict(),
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["AdaptiveRoundStats"]:
        if d is None:
            return None
        return cls(
            round_index=int(d["round_index"]),
            drifted=bool(d["drifted"]),
            innovation_mean=float(d["innovation_mean"]),
            innovation_abs=float(d["innovation_abs"]),
            speculation=d["speculation"],
            watermark=WatermarkStats.from_dict(d.get("watermark")),
        )


# ---------------------------------------------------------------------------
# the coordinator: speculation + watermark + reliability, one owner
# ---------------------------------------------------------------------------


class _SpecEntry:
    """One buffered speculative plan: the predicted problem it was solved
    against and where its schedule row lives (a shared batch future until
    materialized, then a concrete array after checkpoint/restore)."""

    __slots__ = ("round_index", "problem", "future", "index", "schedule")

    def __init__(self, round_index, problem, future, index, schedule=None):
        self.round_index = int(round_index)
        self.problem = problem
        self.future = future
        self.index = int(index)
        self.schedule = schedule

    def materialize(self) -> np.ndarray:
        if self.schedule is None:
            self.schedule = np.asarray(
                self.future.result()[self.index], dtype=np.int64
            )
        return self.schedule


class AdaptiveCoordinator:
    """Owns the campaign loop's adaptive state (DESIGN.md §18): the drift
    detector, the speculative plan buffer, reliability bookkeeping, and the
    watermark recovery path. Created by the campaign runner when the
    server's :class:`~repro_torch.core.fleet.PlanPolicy` enables any adaptive
    feature; with the policy defaults the runner never constructs one and
    every code path is byte-identical to the pre-adaptive loop.

    Determinism contract: every decision (validate/commit/miss, drift
    classification, reliability updates, watermark splits) happens on the
    MAIN thread from main-thread state; the planner executor only ever runs
    pure functions of immutable snapshots (the speculative batch solve, the
    commit materialization). The single-FIFO executor guarantee (§11) makes
    the commit task safe: its batch future was submitted earlier, so it is
    resolved — or at the head of the queue — by the time the commit runs."""

    def __init__(self, server):
        policy = server.policy
        self.server = server
        self.lookahead = int(policy.lookahead)
        self.tolerance = float(policy.drift_tolerance)
        self.watermark_quantile = (
            None if policy.watermark_quantile is None else float(policy.watermark_quantile)
        )
        self.reliability = (
            None if policy.reliability is None else float(policy.reliability)
        )
        self.detector = DriftDetector(tolerance=self.tolerance)
        self.spec_hits = 0
        self.spec_misses = 0
        self.spec_batches = 0
        self.drift_rounds = 0
        self.early_replans = 0
        self._wm_saved: list = []
        self._wm_saved_pct: list = []
        self._buffer: list = []  # _SpecEntry, ascending round order
        self._pending: Optional[dict] = None  # next round's plan decision
        self._pending_future = None
        self._per_round: dict = {}  # round -> AdaptiveRoundStats (popped per round)

    @staticmethod
    def enabled(policy) -> bool:
        return (
            int(policy.lookahead) > 0
            or policy.watermark_quantile is not None
            or policy.reliability is not None
        )

    # ---- planning ------------------------------------------------------

    def first_plan(self, round_index: int, T: int, submit):
        """The campaign's eager initial submission. After a checkpoint
        restore whose pending decision targets this round, the stored
        schedule is replayed instead of re-solving — bit-identical to the
        uninterrupted run, with zero extra dispatches."""
        if self._pending is not None and self._pending["round"] == int(round_index):
            return self._replay_pending(T, submit)
        return self._submit_fresh(round_index, T, self.server.build_problem(T), submit)

    def next_plan(self, round_index: int, T: int, submit):
        """The round-boundary planning decision for ``round_index``: commit
        the buffered speculative plan when it validates in-band (zero extra
        solves), otherwise count a miss, flush the stale buffer, and solve
        fresh (refilling the speculation window)."""
        fresh = self.server.build_problem(T)
        entry = None
        if self._buffer and self._buffer[0].round_index == int(round_index):
            entry = self._buffer.pop(0)
        elif self._buffer:
            self._buffer = []
        if entry is not None:
            if self._validates(entry, fresh):
                self.spec_hits += 1
                self._stats(round_index).speculation = "hit"
                self._pending = {"round": int(round_index), "mode": "commit"}
                f = submit(
                    f"plan[{round_index}]:commit", self._commit_plan,
                    round_index, T, entry, fresh,
                )
                self._pending_future = f
                return f
            self.spec_misses += 1
            self._stats(round_index).speculation = "miss"
            self._buffer = []
        return self._submit_fresh(round_index, T, fresh, submit)

    def _submit_fresh(self, round_index: int, T: int, fresh: Problem, submit):
        if self.lookahead <= 0:
            self._pending = None
            self._pending_future = None
            return submit(
                f"plan[{round_index}]", self.server.plan_round, round_index, T, fresh
            )
        problems = [fresh] + [
            self.server.predict_problem(T, s) for s in range(1, self.lookahead)
        ]
        last = round_index + len(problems) - 1
        batch_f = submit(f"spec[{round_index}..{last}]", self._solve_batch, problems)
        self.spec_batches += 1
        self._buffer = [
            _SpecEntry(round_index + s, problems[s], batch_f, s)
            for s in range(1, len(problems))
        ]
        self._pending = {"round": int(round_index), "mode": "solve"}
        f = submit(
            f"plan[{round_index}]", self._plan_from_batch,
            round_index, T, batch_f, 0, fresh,
        )
        self._pending_future = f
        return f

    def _solve_batch(self, problems) -> list:
        sol = self.server.solver.solve(list(problems), check=False)
        return [np.asarray(x, dtype=np.int64) for x in sol.schedules]

    def _plan_from_batch(self, round_index, T, batch_f, index, fresh):
        from .server import RoundPlan

        x = np.asarray(batch_f.result()[index], dtype=np.int64)
        return RoundPlan(
            round_index=int(round_index),
            T=int(T),
            assignments=x.copy(),
            est_cost=float(total_cost(fresh, x)),
            problem=fresh,
        )

    def _commit_plan(self, round_index, T, entry: _SpecEntry, fresh: Problem):
        from .server import RoundPlan

        x = entry.materialize()
        return RoundPlan(
            round_index=int(round_index),
            T=int(T),
            assignments=x.copy(),
            est_cost=float(total_cost(fresh, x)),
            problem=fresh,
        )

    def _replay_pending(self, T, submit):
        from .server import RoundPlan

        pend = self._pending
        x = np.asarray(pend["x"], dtype=np.int64)
        round_index = int(pend["round"])
        fresh = self.server.build_problem(T)

        def restored_plan():
            return RoundPlan(
                round_index=round_index,
                T=int(T),
                assignments=x.copy(),
                est_cost=float(total_cost(fresh, x)),
                problem=fresh,
            )

        f = submit(f"plan[{round_index}]:resume", restored_plan)
        self._pending_future = f
        return f

    def _validates(self, entry: _SpecEntry, fresh: Problem) -> bool:
        """In-band check for a speculative plan, on the MAIN thread: the
        detector's last round must be in-band, the bounds and workload must
        match exactly (a reliability down-weighting or dropout invalidates
        the plan's feasibility envelope), and each client's predicted
        full-capacity cost must sit within ``drift_tolerance`` of the fresh
        snapshot (the tables are whole-table rescales, so the endpoint
        captures the scale deviation)."""
        if self.detector.last_drifted:
            return False
        p = entry.problem
        if int(p.T) != int(fresh.T):
            return False
        if not np.array_equal(p.lower, fresh.lower):
            return False
        if not np.array_equal(p.upper, fresh.upper):
            return False
        for pt, ft, u in zip(p.cost_tables, fresh.cost_tables, fresh.upper):
            u = int(u)
            if u <= 0:
                continue
            ref = abs(float(ft[u]))
            if ref <= 0.0:
                continue
            if abs(float(pt[u]) - float(ft[u])) / ref > self.tolerance:
                return False
        return True

    # ---- telemetry -----------------------------------------------------

    def after_account(self, round_index: int, plan, faults) -> None:
        """Post-accounting telemetry fold (main thread, round order): drains
        the estimator's round innovations into the drift detector and feeds
        crash/straggle outcomes into the reliability scores."""
        innovations = self.server.estimator.drain_innovations()
        zs = np.array([z for (_, _, z) in innovations], dtype=np.float64)
        zbar = float(zs.mean()) if zs.size else 0.0
        drifted = self.detector.update(zbar)
        st = self._stats(round_index)
        st.drifted = bool(drifted)
        st.innovation_mean = zbar
        st.innovation_abs = float(np.abs(zs).mean()) if zs.size else 0.0
        if drifted:
            self.drift_rounds += 1
        if self.reliability is not None:
            x0 = (
                plan.recovery.assignments_original
                if plan.recovery is not None
                else plan.assignments
            )
            participated = [int(i) for i in np.nonzero(np.asarray(x0) > 0)[0]]
            faulty = faults.lost_clients if faults is not None else ()
            self.server.estimator.record_round_outcome(
                participated, faulty, decay=self.reliability
            )

    def handle_faults(self, plan, faults):
        """Round recovery through the adaptive layer. Without a watermark
        quantile this is exactly the reactive path; with one, faults visible
        at the watermark re-solve BEFORE the barrier and late crashes get a
        second post-barrier pass."""
        if faults is None:
            return plan
        if self.watermark_quantile is None:
            return self.server.recover_round(plan, faults)
        x0 = np.asarray(plan.assignments, dtype=np.int64)
        early, late_crashed, wm = watermark_split(faults, x0, self.watermark_quantile)
        if wm is None or early is None:
            # nothing was visible before the barrier: plain reactive recovery
            return self.server.recover_round(plan, faults)
        plan = self.server.recover_round(plan, early)
        self.early_replans += 1
        y = (
            np.asarray(plan.recovery.recovery_assignments, dtype=np.int64)
            if plan.recovery is not None
            else np.zeros_like(x0)
        )
        late_tail = 0.0
        if late_crashed:
            x1 = np.asarray(plan.assignments, dtype=np.int64)
            completed = x1.copy()
            for c in late_crashed:
                completed[c] = min(int(faults.completed[c]), int(x1[c]))
            if int(completed.sum()) < int(x1.sum()):
                late = RoundFaults(
                    round_index=int(faults.round_index),
                    completed=completed,
                    crashed=tuple(late_crashed),
                    stragglers=(),
                )
                plan = self.server.recover_round(plan, late)
                if plan.recovery is not None:
                    y2 = np.asarray(plan.recovery.recovery_assignments, np.int64)
                    late_tail = float(y2.max()) if y2.size else 0.0
        # timing model (batch-time units): reactive recovery dispatches at
        # the barrier, early recovery at the watermark — each survivor's
        # extra work starts when its own window frees up (or at the
        # watermark, whichever is later).
        t_w, t_b = wm.t_watermark, wm.t_barrier
        early_finish = t_b
        for i in np.nonzero(y > 0)[0]:
            early_finish = max(early_finish, max(t_w, float(x0[i])) + float(y[i]))
        if late_crashed:
            # late crashes force post-barrier work either way: report the
            # conservative zero-savings comparison for this round
            early_finish = max(early_finish, t_b + late_tail)
            reactive_finish = early_finish
        else:
            reactive_finish = t_b + (float(y.max()) if y.size else 0.0)
        wm.reactive_finish = reactive_finish
        wm.early_finish = early_finish
        self._stats(plan.round_index).watermark = wm
        self._wm_saved.append(wm.saved)
        self._wm_saved_pct.append(wm.saved_pct)
        return plan

    def round_stats(self, round_index: int) -> Optional[AdaptiveRoundStats]:
        return self._per_round.pop(int(round_index), None)

    def _stats(self, round_index: int) -> AdaptiveRoundStats:
        st = self._per_round.get(int(round_index))
        if st is None:
            st = AdaptiveRoundStats(round_index=int(round_index))
            self._per_round[int(round_index)] = st
        return st

    def summary_stats(self) -> dict:
        """Campaign-level adaptive telemetry (folded into
        :meth:`~repro_torch.fl.pipeline.CampaignHistory.summary`)."""
        validated = self.spec_hits + self.spec_misses
        return {
            "drift_rounds": int(self.drift_rounds),
            "speculation_hits": int(self.spec_hits),
            "speculation_misses": int(self.spec_misses),
            "speculation_batches": int(self.spec_batches),
            "speculation_hit_rate": (
                float(self.spec_hits) / validated if validated else 0.0
            ),
            "early_replans": int(self.early_replans),
            "barrier_wait_saved": float(np.sum(self._wm_saved)) if self._wm_saved else 0.0,
            "barrier_wait_saved_pct_mean": (
                float(np.mean(self._wm_saved_pct)) if self._wm_saved_pct else 0.0
            ),
        }

    # ---- checkpoint ----------------------------------------------------

    def checkpoint_state(self) -> dict:
        """The coordinator's complete restart state, with every in-flight
        speculative schedule materialized (a failed speculative batch drops
        its entries — the resumed campaign re-plans fresh). Consumed by
        ``save_campaign_checkpoint``."""
        entries = []
        for e in self._buffer:
            try:
                x = e.materialize()
            except Exception:
                continue
            entries.append({"round": int(e.round_index), "problem": e.problem, "x": x})
        pending = None
        if self._pending is not None:
            if "x" in self._pending:
                pending = dict(self._pending)
            elif self._pending_future is not None:
                try:
                    xp = np.asarray(
                        self._pending_future.result().assignments, dtype=np.int64
                    )
                    pending = dict(self._pending, x=xp)
                except Exception:
                    pending = None
        return {
            "entries": entries,
            "pending": pending,
            "detector": self.detector.state(),
            "counters": {
                "spec_hits": int(self.spec_hits),
                "spec_misses": int(self.spec_misses),
                "spec_batches": int(self.spec_batches),
                "drift_rounds": int(self.drift_rounds),
                "early_replans": int(self.early_replans),
            },
            "per_round": {int(r): st.as_dict() for r, st in self._per_round.items()},
            "wm_saved": [float(v) for v in self._wm_saved],
            "wm_saved_pct": [float(v) for v in self._wm_saved_pct],
        }

    def load_checkpoint_state(self, state: dict) -> None:
        self._buffer = [
            _SpecEntry(e["round"], e["problem"], None, 0,
                       schedule=np.asarray(e["x"], dtype=np.int64))
            for e in state["entries"]
        ]
        self._pending = state["pending"]
        self._pending_future = None
        self.detector.load_state(state["detector"])
        c = state["counters"]
        self.spec_hits = int(c["spec_hits"])
        self.spec_misses = int(c["spec_misses"])
        self.spec_batches = int(c["spec_batches"])
        self.drift_rounds = int(c["drift_rounds"])
        self.early_replans = int(c["early_replans"])
        self._per_round = {
            int(r): AdaptiveRoundStats.from_dict(d)
            for r, d in state["per_round"].items()
        }
        self._wm_saved = [float(v) for v in state["wm_saved"]]
        self._wm_saved_pct = [float(v) for v in state["wm_saved_pct"]]
