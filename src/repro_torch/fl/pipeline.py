"""Async round pipeline: overlap client training with next-round planning.

The campaign loop (DESIGN.md §11) is ONE code path over the server's round
stages (``plan -> train -> aggregate``; see fl/server.py), parameterized by
a *plan executor* that decides WHERE planning tasks run:

  * :class:`SerialPlanExecutor` — every task runs inline at submit time; the
    reference semantics (identical to the pre-pipeline serial driver).
  * :class:`ThreadPlanExecutor` — a single background planner thread drains
    tasks in FIFO submission order. While round *r*'s clients train on the
    device (enqueued on the main thread's stream), the planner is already
    solving round *r*'s
    what-if scenario batch and round *r+1*'s schedule through the shared
    :class:`~repro_torch.core.sweep.SweepEngine` (via its non-blocking
    ``dispatch``; on the card its plans run on the engine's own stream), so
    no DP solve ever waits on the device on the round hot path. Scenario batches are regime-split (DESIGN.md §13):
    monotone-cost what-ifs resolve on the marginal fast path in
    O(B·nW·log nW), so with monotone energy models the planner's per-round
    work shrinks by the full DP factor — the pipeline then hides estimator
    bookkeeping rather than heavyweight solves.

Every task is handed back as a :class:`PlanFuture`; results materialize only
when the next round actually needs them (``PlanFuture.result()``).

**Why results are bit-identical across executors.** Planning tasks are pure
functions of immutable snapshots: the campaign loop builds every
:class:`~repro_torch.core.problem.Problem` on the main thread (after that round's
``account_round`` folded measurements into the estimator) and submits only
the deterministic solve. The random stream and estimator mutations live
exclusively in ``account_round``, which always runs on the main thread in
round order. So serial and pipelined campaigns consume identical inputs in
identical order — the executors differ only in wall-clock interleaving, and
``tests/test_torch_fl_pipeline.py`` asserts schedules, losses, and energy match
bit-for-bit.

When the server is constructed with a
:class:`~repro_torch.serve.service.SchedulerService`, the planner thread's
scenario solves route through the service's coalescer instead of hitting
the engine directly (``FederatedServer.solve_scenarios`` submits the batch
as one service request): campaign what-if planning and external served
traffic then merge into shared flushes and warm ONE plan cache
(DESIGN.md §14). Bit-identity is preserved — the service pads requests
inertly, exactly like the engine's own bucketing — so the executors'
determinism contract above is unchanged.

Frontier-mode planning (DESIGN.md §15) keeps the same contract:
``PlanPolicy(frontier_mode=...)`` turns each ``plan_round`` into a
batched ε-constraint sweep plus a deterministic frontier-point selection,
but the deadline grid, the sweep, and the selection rule are all pure
functions of the immutable estimator snapshot — so frontier-planned
campaigns pipeline exactly like min-energy ones, bit-identical across
executors. Fleet-mode planning (DESIGN.md §16) joins it:
``PlanPolicy(fleet_clusters=...)`` swaps each ``plan_round`` for the
two-level cluster-then-allocate solve, whose k-means seeding and greedy
residual repair are deterministic in the snapshot and
``policy.fleet_seed`` — thousands-of-client rounds pipeline with the same
bit-identity guarantee.

Overlap accounting: each PlanFuture records the planner time it consumed
(``busy_s``) and the main-thread time spent blocked in ``result()``
(``blocked_s``). The campaign's ``overlap_fraction`` is the share of
planning time hidden off the hot path — 0.0 by construction for the serial
executor, → 1.0 when training fully hides planning. ``chip_smoke.py``
reports it for the JAX package's ``benchmarks/bench_async.py`` configuration
on the card.

On the card the planner thread's engine runs its plans (eager first calls,
CUDA-graph captures with ``capture_error_mode="thread_local"``, replays) on
the engine's own stream while the main thread enqueues client training on
its current stream, so a capture never sees the main thread's launches.

A copy of the JAX package's ``fl/pipeline.py``; its campaign checkpoints
walk the parameters with the port's tree functions.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..checkpoint import (
    array_to_tensor,
    latest_checkpoint,
    load_checkpoint_arrays,
    map_with_paths,
    save_checkpoint,
)
from ..core.problem import Problem, total_cost
from ..core.resilience import is_transient
from ..data.pipeline import lm_round_batches
from .adaptive import AdaptiveCoordinator, AdaptiveRoundStats, DriftInjector, DriftPlan
from .faults import FaultInjector, FaultPlan, proportional_greedy, residual_problem
from .server import (
    FederatedServer,
    FLRoundResult,
    RecoveryInfo,
    RoundPlan,
    ScenarioReport,
)

__all__ = [
    "AsyncCampaignRunner",
    "CampaignHistory",
    "CampaignRunner",
    "PipelineStats",
    "PlanFuture",
    "SerialPlanExecutor",
    "ThreadPlanExecutor",
    "load_campaign_checkpoint",
    "save_campaign_checkpoint",
]


# ---------------------------------------------------------------------------
# plan futures + executors
# ---------------------------------------------------------------------------


class PlanFuture:
    """Handle to one planning task (a schedule solve, a scenario batch).

    ``result()`` blocks until the task finished (re-raising any planner
    exception) and records how long the caller waited — the pipeline's
    overlap accounting. ``busy_s`` is the executor time the task consumed.
    """

    def __init__(self, label: str):
        self.label = label
        self.busy_s = 0.0  # executor time spent computing this task
        self.blocked_s = 0.0  # caller time spent blocked in result()
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _run(self, fn: Callable, args: tuple) -> None:
        t0 = time.perf_counter()
        try:
            self._value = fn(*args)
        except BaseException as e:  # surfaced at result() — see crash test
            self._exc = e
        finally:
            self.busy_s = time.perf_counter() - t0
            self._event.set()

    def result(self):
        """Materializes the task's value, blocking if still in flight."""
        if not self._event.is_set():
            t0 = time.perf_counter()
            self._event.wait()
            self.blocked_s += time.perf_counter() - t0
        if self._exc is not None:
            raise self._exc
        return self._value


class SerialPlanExecutor:
    """Runs every planning task inline at submit time (reference path).

    Inline tasks sit fully on the hot path, so their entire ``busy_s``
    counts as blocked — the serial overlap fraction is exactly 0.
    """

    mode = "serial"

    def submit(self, label: str, fn: Callable, *args) -> PlanFuture:
        f = PlanFuture(label)
        f._run(fn, args)
        f.blocked_s = f.busy_s
        return f

    def shutdown(self) -> None:
        pass


class ThreadPlanExecutor:
    """Single background planner thread, FIFO task order.

    One thread (not a pool): tasks execute in exactly the submission order —
    the same order the serial executor runs them — which keeps estimator
    snapshots/solves sequenced identically and the engine's plan-cache
    accounting race-free.
    """

    mode = "pipelined"

    def __init__(self, name: str = "fl-planner"):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def submit(self, label: str, fn: Callable, *args) -> PlanFuture:
        f = PlanFuture(label)
        self._q.put((f, fn, args))
        return f

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            f, fn, args = item
            f._run(fn, args)

    def shutdown(self) -> None:
        """Drains queued tasks, then joins the planner thread."""
        self._q.put(None)
        self._thread.join()


_EXECUTORS = {"serial": SerialPlanExecutor, "pipelined": ThreadPlanExecutor}


# ---------------------------------------------------------------------------
# round-granular campaign checkpointing (DESIGN.md §17)
#
# A checkpoint is the complete round-r restart state: params, estimator
# tables, the rng bit-generator state, and every completed FLRoundResult
# (recovery provenance included). Arrays ride the npz tree; scalars and
# labels ride the json manifest's ``extra``. Restoring and continuing is
# bit-identical to never having stopped: the rng stream resumes mid-sequence
# and planning is a pure function of the restored estimator snapshot.
# ---------------------------------------------------------------------------


def _problem_to_tree(p: Problem) -> dict:
    tree = {"T": np.int64(p.T), "lower": np.asarray(p.lower), "upper": np.asarray(p.upper)}
    for i, tbl in enumerate(p.cost_tables):
        tree[f"tbl{i:04d}"] = np.asarray(tbl)
    return tree


def _problem_from_arrays(get) -> Problem:
    lower = np.asarray(get("lower"), dtype=np.int64)
    tables = tuple(np.asarray(get(f"tbl{i:04d}"), np.float64) for i in range(len(lower)))
    return Problem(
        T=int(get("T")), lower=lower, upper=np.asarray(get("upper"), np.int64),
        cost_tables=tables,
    )


def _round_to_tree_meta(res: FLRoundResult):
    tree = {"assignments": np.asarray(res.assignments, dtype=np.int64)}
    meta = {
        "round_index": int(res.round_index),
        "mean_loss": float(res.mean_loss),
        "energy_joules": float(res.energy_joules),
        "estimated_joules": float(res.estimated_joules),
        "makespan_joules": float(res.makespan_joules),
        "scen_labels": None,
        "recovery": None,
        "adaptive": None if res.adaptive is None else res.adaptive.as_dict(),
    }
    if res.scenarios is not None:
        meta["scen_labels"] = [str(lbl) for lbl in res.scenarios.labels]
        tree["scen_x"] = np.asarray(res.scenarios.assignments)
        tree["scen_e"] = np.asarray(res.scenarios.energies)
    if res.recovery is not None:
        ri = res.recovery
        meta["recovery"] = {
            "failed_clients": [int(i) for i in ri.failed_clients],
            "straggler_clients": [int(i) for i in ri.straggler_clients],
            "residual_T": int(ri.residual_T),
            "shortfall": int(ri.shortfall),
            "attempts": int(ri.attempts),
            "fallback": bool(ri.fallback),
            "est_cost_original": float(ri.est_cost_original),
            "est_overhead_J": float(ri.est_overhead_J),
            "has_residual_problem": ri.residual_problem is not None,
            "has_problem": ri.problem is not None,
        }
        tree["rec_completed"] = np.asarray(ri.completed, dtype=np.int64)
        tree["rec_x0"] = np.asarray(ri.assignments_original, dtype=np.int64)
        tree["rec_y"] = np.asarray(ri.recovery_assignments, dtype=np.int64)
        if ri.residual_problem is not None:
            tree["rec_q"] = _problem_to_tree(ri.residual_problem)
        if ri.problem is not None:
            tree["rec_p"] = _problem_to_tree(ri.problem)
    return tree, meta


def _round_from_arrays(data: dict, prefix: str, meta: dict) -> FLRoundResult:
    scenarios = None
    if meta["scen_labels"] is not None:
        scenarios = ScenarioReport(
            labels=list(meta["scen_labels"]),
            assignments=np.asarray(data[f"{prefix}/scen_x"]),
            energies=np.asarray(data[f"{prefix}/scen_e"]),
        )
    recovery = None
    rm = meta["recovery"]
    if rm is not None:
        recovery = RecoveryInfo(
            failed_clients=tuple(rm["failed_clients"]),
            straggler_clients=tuple(rm["straggler_clients"]),
            completed=np.asarray(data[f"{prefix}/rec_completed"], np.int64),
            residual_T=int(rm["residual_T"]),
            shortfall=int(rm["shortfall"]),
            attempts=int(rm["attempts"]),
            fallback=bool(rm["fallback"]),
            assignments_original=np.asarray(data[f"{prefix}/rec_x0"], np.int64),
            recovery_assignments=np.asarray(data[f"{prefix}/rec_y"], np.int64),
            residual_problem=(
                _problem_from_arrays(lambda k: data[f"{prefix}/rec_q/{k}"])
                if rm["has_residual_problem"]
                else None
            ),
            problem=(
                _problem_from_arrays(lambda k: data[f"{prefix}/rec_p/{k}"])
                if rm["has_problem"]
                else None
            ),
            est_cost_original=float(rm["est_cost_original"]),
            est_overhead_J=float(rm["est_overhead_J"]),
        )
    return FLRoundResult(
        round_index=int(meta["round_index"]),
        assignments=np.asarray(data[f"{prefix}/assignments"], np.int64),
        mean_loss=float(meta["mean_loss"]),
        energy_joules=float(meta["energy_joules"]),
        estimated_joules=float(meta["estimated_joules"]),
        makespan_joules=float(meta["makespan_joules"]),
        scenarios=scenarios,
        recovery=recovery,
        # .get: checkpoints written without the adaptive layer carry no telemetry
        adaptive=AdaptiveRoundStats.from_dict(meta.get("adaptive")),
    )


def save_campaign_checkpoint(
    directory: str,
    step: int,
    server: FederatedServer,
    rng: np.random.Generator,
    results,
    adaptive: Optional[AdaptiveCoordinator] = None,
) -> str:
    """Persists the round-``step`` restart state (params + estimator state
    + rng state + completed results + any adaptive-coordinator state) via
    :func:`repro_torch.checkpoint.save_checkpoint`. ``step`` is the 0-indexed
    last COMPLETED round. Estimator persistence goes through the public
    :meth:`~repro_torch.fl.energy.EnergyEstimator.state_dict` — table keys keep
    the plain-EMA ``est/{i:04d}`` npz layout, calibration state rides
    ``est/calib_*`` keys alongside."""
    rounds_tree, rounds_meta = {}, []
    for res in results:
        tree_r, meta_r = _round_to_tree_meta(res)
        rounds_tree[f"r{int(res.round_index):06d}"] = tree_r
        rounds_meta.append(meta_r)
    tree = {
        "params": server.params,
        "est": server.estimator.state_dict(),
        "rounds": rounds_tree,
    }
    extra = {
        "round": int(step),
        "rng_state": rng.bit_generator.state,
        "rounds": rounds_meta,
    }
    if adaptive is not None:
        st = adaptive.checkpoint_state()
        atree = {}
        for k, e in enumerate(st["entries"]):
            atree[f"spec{k:02d}"] = {
                "problem": _problem_to_tree(e["problem"]),
                "x": np.asarray(e["x"], dtype=np.int64),
            }
        if st["pending"] is not None:
            atree["pending_x"] = np.asarray(st["pending"]["x"], dtype=np.int64)
        if atree:
            tree["adapt"] = atree
        extra["adaptive"] = {
            "entries": [int(e["round"]) for e in st["entries"]],
            "pending": (
                None
                if st["pending"] is None
                else {k: v for k, v in st["pending"].items() if k != "x"}
            ),
            "detector": st["detector"],
            "counters": st["counters"],
            "per_round": {str(r): d for r, d in st["per_round"].items()},
            "wm_saved": st["wm_saved"],
            "wm_saved_pct": st["wm_saved_pct"],
        }
    return save_checkpoint(directory, int(step), tree, extra)


def load_campaign_checkpoint(
    directory: str,
    server: FederatedServer,
    rng: np.random.Generator,
    adaptive: Optional[AdaptiveCoordinator] = None,
):
    """Restores the latest campaign checkpoint IN PLACE (params, estimator
    state, rng state, adaptive-coordinator state when given one) and
    returns ``(last_completed_round, results)`` — or None when the
    directory holds no checkpoint. The continuation is bit-identical to the
    uninterrupted campaign (tests/test_torch_faults.py,
    tests/test_torch_adaptive.py). Parameters restore in the dtype, shape
    and device of ``server.params`` (bfloat16 bit for bit); a checkpoint
    written by the JAX package's ``save_campaign_checkpoint`` loads too.
    Checkpoints with bare ``est/{i:04d}`` tables and no adaptive block still
    load: calibration state resets to fresh defaults."""
    step = latest_checkpoint(directory)
    if step is None:
        return None
    data, manifest = load_checkpoint_arrays(directory, int(step))
    extra = manifest["extra"]
    dtypes = manifest.get("dtypes", {})
    server.params = map_with_paths(
        lambda path, leaf: array_to_tensor(data["params/" + path], dtypes.get("params/" + path))
        .to(leaf.dtype)
        .reshape(leaf.shape)
        .to(leaf.device),
        server.params,
    )
    est_state = {
        key[len("est/"):]: arr
        for key, arr in data.items()
        if key.startswith("est/")
    }
    server.estimator.load_state_dict(est_state)
    rng.bit_generator.state = extra["rng_state"]
    results = [
        _round_from_arrays(data, f"rounds/r{int(m['round_index']):06d}", m)
        for m in extra["rounds"]
    ]
    am = extra.get("adaptive")
    if adaptive is not None and am is not None:
        entries = []
        for k, rnd in enumerate(am["entries"]):
            prefix = f"adapt/spec{k:02d}"
            prob = _problem_from_arrays(
                lambda key, _p=prefix: data[f"{_p}/problem/{key}"]
            )
            entries.append({
                "round": int(rnd),
                "problem": prob,
                "x": np.asarray(data[f"{prefix}/x"], dtype=np.int64),
            })
        pending = None
        if am["pending"] is not None:
            pending = dict(am["pending"])
            pending["x"] = np.asarray(data["adapt/pending_x"], dtype=np.int64)
        adaptive.load_checkpoint_state({
            "entries": entries,
            "pending": pending,
            "detector": am["detector"],
            "counters": am["counters"],
            "per_round": {int(r): d for r, d in am["per_round"].items()},
            "wm_saved": am["wm_saved"],
            "wm_saved_pct": am["wm_saved_pct"],
        })
    return int(extra["round"]), results


# ---------------------------------------------------------------------------
# campaign history + pipeline stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineStats:
    """Where the campaign's time went, per executor mode.

    ``overlap_fraction`` = share of planning time hidden off the round hot
    path: 1 - blocked/busy (0.0 for serial by construction).
    """

    mode: str
    round_wall_s: List[float] = dataclasses.field(default_factory=list)
    planner_busy_s: float = 0.0
    planner_blocked_s: float = 0.0
    train_block_s: float = 0.0  # main-thread time blocked materializing losses
    tasks: List[dict] = dataclasses.field(default_factory=list)

    @property
    def overlap_fraction(self) -> float:
        if self.planner_busy_s <= 0.0:
            return 1.0 if self.mode == "pipelined" else 0.0
        frac = 1.0 - self.planner_blocked_s / self.planner_busy_s
        return float(min(1.0, max(0.0, frac)))

    def as_dict(self) -> dict:
        return {
            "mode": self.mode,
            "rounds": len(self.round_wall_s),
            "round_wall_s": list(self.round_wall_s),
            "round_wall_mean_s": float(np.mean(self.round_wall_s)) if self.round_wall_s else 0.0,
            "planner_busy_s": self.planner_busy_s,
            "planner_blocked_s": self.planner_blocked_s,
            "train_block_s": self.train_block_s,
            "overlap_fraction": self.overlap_fraction,
        }


@dataclasses.dataclass
class CampaignHistory:
    algorithm: str
    rounds: List[FLRoundResult]
    # sweep-engine counter deltas over the campaign (DESIGN.md §10):
    # hits/misses/compiles/evictions accrued by this campaign's DP solves
    # (``compiles`` counts plan builds). Round shapes repeat, so a healthy
    # campaign shows compiles <= 1 after the first round warmed the bucket —
    # see dp_compiles in summary().
    dp_cache_stats: Optional[dict] = None
    # executor timing (DESIGN.md §11): how much planning the pipeline hid.
    pipeline_stats: Optional[PipelineStats] = None
    # adaptive-layer rollup (DESIGN.md §18): drift rounds, speculation
    # hits/misses, early re-plans, barrier-wait savings. None unless the
    # campaign ran with an AdaptiveCoordinator.
    adaptive_stats: Optional[dict] = None

    @property
    def total_energy(self) -> float:
        return float(sum(r.energy_joules for r in self.rounds))

    @property
    def losses(self) -> np.ndarray:
        return np.array([r.mean_loss for r in self.rounds])

    def summary(self) -> dict:
        out = {
            "algorithm": self.algorithm,
            "rounds": len(self.rounds),
            "total_energy_J": self.total_energy,
            "final_loss": float(self.rounds[-1].mean_loss) if self.rounds else float("nan"),
            "mean_makespan_J": float(np.mean([r.makespan_joules for r in self.rounds])) if self.rounds else 0.0,
        }
        if self.dp_cache_stats is not None:
            out["dp_compiles"] = self.dp_cache_stats["compiles"]
            out["dp_cache_hits"] = self.dp_cache_stats["hits"]
        if self.pipeline_stats is not None:
            out["pipeline_mode"] = self.pipeline_stats.mode
            out["planner_overlap_fraction"] = self.pipeline_stats.overlap_fraction
        # recovery telemetry (DESIGN.md §17) — keyed only when some round
        # actually recovered, so zero-fault summaries are unchanged
        recovered = [r.recovery for r in self.rounds if r.recovery is not None]
        if recovered:
            out["recovered_rounds"] = len(recovered)
            out["recovery_fallbacks"] = sum(1 for ri in recovered if ri.fallback)
            out["recovery_overhead_J"] = float(
                sum(ri.est_overhead_J for ri in recovered)
            )
            out["recovery_shortfall"] = int(sum(ri.shortfall for ri in recovered))
        # adaptive telemetry (DESIGN.md §18) — keyed only for adaptive
        # campaigns, so default-policy summaries are unchanged
        if self.adaptive_stats is not None:
            a = self.adaptive_stats
            out["drift_rounds"] = a["drift_rounds"]
            out["speculation_hits"] = a["speculation_hits"]
            out["speculation_misses"] = a["speculation_misses"]
            out["speculation_batches"] = a["speculation_batches"]
            out["speculation_hit_rate"] = a["speculation_hit_rate"]
            out["replan_rate"] = (
                a["speculation_misses"] / len(self.rounds) if self.rounds else 0.0
            )
            out["early_replans"] = a["early_replans"]
            out["barrier_wait_saved"] = a["barrier_wait_saved"]
            out["barrier_wait_saved_pct_mean"] = a["barrier_wait_saved_pct_mean"]
        return out


# ---------------------------------------------------------------------------
# the (single) campaign loop
# ---------------------------------------------------------------------------


class CampaignRunner:
    """Multi-round FedAvg campaign driver over the server's round stages.

    ``mode`` picks the plan executor: "serial" (inline planning — the
    reference semantics) or "pipelined" (background planner thread). A fresh
    executor is created per :meth:`run` and always shut down — a planner
    exception drains the thread before re-raising in the caller.
    """

    def __init__(self, server: FederatedServer, mode: str = "serial"):
        if mode not in _EXECUTORS:
            raise ValueError(f"unknown pipeline mode {mode!r}; options: {sorted(_EXECUTORS)}")
        self.server = server
        self.mode = mode

    def run(
        self,
        examples_per_client: list,
        num_rounds: int,
        round_T: int,
        batch_size: int,
        rng: np.random.Generator,
        max_steps: Optional[int] = None,
        on_round: Optional[Callable[[FLRoundResult], None]] = None,
        faults: Optional[object] = None,
        drift: Optional[object] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
    ) -> CampaignHistory:
        """Runs the campaign. Beyond the classic knobs (DESIGN.md §11):

        ``faults``: a :class:`~repro_torch.fl.faults.FaultPlan` or
        :class:`~repro_torch.fl.faults.FaultInjector` — client crashes/stragglers
        fire after each round's plan lands and are recovered via
        :meth:`~repro_torch.fl.server.FederatedServer.recover_round` on the MAIN
        thread (recovery mutates nothing, but running it in round order
        keeps the serial/pipelined bit-identity contract auditable);
        transient planner/scenario failures retry inline; overload bursts
        submit extra one-off requests to ``server.service``. ``faults=None``
        leaves every code path bit-identical to the pre-fault-layer loop.

        ``drift``: a :class:`~repro_torch.fl.adaptive.DriftPlan` or
        :class:`~repro_torch.fl.adaptive.DriftInjector` (DESIGN.md §18) — the
        fleet's TRUE energy tables move per the seeded plan, applied on the
        main thread at the top of each round, so serial and pipelined
        campaigns drift identically. The adaptive planning features
        themselves are armed on the server's policy
        (``lookahead`` / ``drift_tolerance`` / ``reliability`` /
        ``watermark_quantile``); with the policy defaults this loop is
        byte-identical to the pre-adaptive one.

        ``checkpoint_dir``: round-granular checkpoint/resume (DESIGN.md
        §17) — the restart state is saved every ``checkpoint_every``
        completed rounds (and on the final round), and a non-empty directory
        resumes from its latest checkpoint, reproducing the uninterrupted
        campaign's params and history exactly (adaptive speculation state
        included).
        """
        server = self.server
        server.round_T = round_T
        if max_steps is None:
            max_steps = max(d.max_batches for d in server.estimator.fleet)
        injector = FaultInjector(faults) if isinstance(faults, FaultPlan) else faults
        drifter = DriftInjector(drift) if isinstance(drift, DriftPlan) else drift
        adaptive = (
            AdaptiveCoordinator(server)
            if AdaptiveCoordinator.enabled(server.policy)
            else None
        )
        stats = PipelineStats(mode=self.mode)
        executor = _EXECUTORS[self.mode]()
        futures: List[PlanFuture] = []
        burst_futures: list = []

        def submit(label, fn, *args):
            f = executor.submit(label, fn, *args)
            futures.append(f)
            return f

        def materialize_plan(plan_f, r):
            # transient planner failures (an injected engine fault caught
            # mid-solve) re-plan inline from the same estimator snapshot —
            # nothing mutated it since submit, so the retry is bit-identical
            try:
                return plan_f.result()
            except Exception as e:
                if injector is None or not is_transient(e):
                    raise
                return self._replan(r, round_T)

        def materialize_scenarios(scen_f, problems, labels):
            try:
                return scen_f.result()
            except Exception as e:
                if injector is None or not is_transient(e):
                    raise
            try:
                return server.solve_scenarios(problems, labels)
            except Exception as e:
                if not is_transient(e):
                    raise
                return None  # persistently failing what-ifs degrade to None

        start_round = 0
        results: List[FLRoundResult] = []
        if checkpoint_dir is not None:
            restored = load_campaign_checkpoint(
                checkpoint_dir, server, rng, adaptive=adaptive
            )
            if restored is not None:
                start_round, results = restored[0] + 1, list(restored[1])
        before = server.engine.cache_stats()
        try:
            if start_round < num_rounds:
                # The first plan has nothing to hide behind — submitted
                # eagerly so the pipelined path still has one entry point.
                # The coordinator's first_plan replays a restored pending
                # decision (bit-identical resume) or opens the speculation
                # window; without a coordinator this is the classic solve.
                if adaptive is not None:
                    plan_f = adaptive.first_plan(start_round, round_T, submit)
                else:
                    plan_f = submit(
                        f"plan[{start_round}]",
                        server.plan_round,
                        start_round,
                        round_T,
                        server.build_problem(round_T),
                    )
            for r in range(start_round, num_rounds):
                t_round = time.perf_counter()
                if drifter is not None:
                    # the world moves first (main thread, round order):
                    # round r's true charging and measurements see the
                    # drifted tables, the planner only ever sees estimates
                    drifter.apply(r, server.estimator.fleet)
                if injector is not None and server.service is not None:
                    for b in range(injector.burst(r)):
                        # chaos traffic: extra one-off requests against the
                        # shared service; overload shedding is the expected
                        # outcome, not a campaign failure
                        try:
                            burst_futures.append(
                                server.service.submit(
                                    injector.burst_problem(r, b), timeout=0.1
                                )
                            )
                        except Exception:
                            pass
                batches = lm_round_batches(examples_per_client, max_steps, batch_size, r)
                plan = materialize_plan(plan_f, r)
                round_faults = None
                if injector is not None:
                    round_faults = injector.round_faults(r, plan.assignments)
                    if round_faults is not None:
                        if adaptive is not None:
                            # watermark path: early-detectable faults
                            # re-solve before the barrier (DESIGN.md §18)
                            plan = adaptive.handle_faults(plan, round_faults)
                        else:
                            plan = server.recover_round(plan, round_faults)
                mean_loss = server.train_round(plan, batches)  # async dispatch
                # CPU-side accounting runs while the device trains; it is
                # the only stage touching rng/estimator state (see server).
                acct = server.account_round(plan, rng)
                if adaptive is not None:
                    # fold round telemetry into detector + reliability
                    # (main thread, round order — same determinism contract
                    # as account_round)
                    adaptive.after_account(r, plan, round_faults)
                else:
                    server.estimator.drain_innovations()  # unused: discard
                # Snapshot next-round planning NOW (post-accounting), hand
                # the solves to the executor, materialize only when needed.
                scen_problems, scen_labels = server.build_scenarios(plan.T)
                scen_f = submit(
                    f"scenarios[{r}]", server.solve_scenarios, scen_problems, scen_labels
                )
                if r + 1 < num_rounds:
                    if adaptive is not None:
                        plan_f = adaptive.next_plan(r + 1, round_T, submit)
                    else:
                        plan_f = submit(
                            f"plan[{r + 1}]",
                            server.plan_round,
                            r + 1,
                            round_T,
                            server.build_problem(round_T),
                        )
                t0 = time.perf_counter()
                loss = float(mean_loss)  # blocks until clients finish
                stats.train_block_s += time.perf_counter() - t0
                res = FLRoundResult(
                    round_index=r,
                    assignments=plan.assignments,
                    mean_loss=loss,
                    energy_joules=acct["energy_joules"],
                    estimated_joules=plan.est_cost,
                    makespan_joules=acct["makespan_joules"],
                    scenarios=materialize_scenarios(scen_f, scen_problems, scen_labels),
                    recovery=plan.recovery,
                    adaptive=(
                        adaptive.round_stats(r) if adaptive is not None else None
                    ),
                )
                results.append(res)
                if checkpoint_dir is not None and (
                    (r + 1) % max(1, int(checkpoint_every)) == 0 or r == num_rounds - 1
                ):
                    save_campaign_checkpoint(
                        checkpoint_dir, r, server, rng, results, adaptive=adaptive
                    )
                stats.round_wall_s.append(time.perf_counter() - t_round)
                if on_round:
                    on_round(res)
            for f in burst_futures:
                # drain injected chaos traffic so close()/stats see a clean
                # service; burst failures are chaos noise, not campaign state
                try:
                    f.result(timeout=60)
                except Exception:
                    pass
        finally:
            executor.shutdown()
        after = server.engine.cache_stats()

        stats.planner_busy_s = float(sum(f.busy_s for f in futures))
        stats.planner_blocked_s = float(sum(f.blocked_s for f in futures))
        stats.tasks = [
            {"label": f.label, "busy_s": f.busy_s, "blocked_s": f.blocked_s}
            for f in futures
        ]
        delta = {k: after[k] - before[k] for k in ("hits", "misses", "compiles", "evictions")}
        delta["entries"] = after["entries"]
        return CampaignHistory(
            algorithm=server.algorithm,
            rounds=results,
            dp_cache_stats=delta,
            pipeline_stats=stats,
            adaptive_stats=adaptive.summary_stats() if adaptive is not None else None,
        )

    def _replan(self, r: int, T: int, max_attempts: int = 3) -> RoundPlan:
        """Inline re-plan after a transient planner failure: bounded retries
        of the normal planning stage, then a guaranteed-feasible greedy plan
        (lower limits honored via the residual construction) when the solver
        stays down — the campaign always gets a valid round plan."""
        server = self.server
        for _ in range(max_attempts):
            try:
                return server.plan_round(r, T, server.build_problem(T))
            except Exception as e:
                if not is_transient(e):
                    raise
        problem = server.build_problem(T)
        res = residual_problem(problem, problem.lower, ())
        x = np.asarray(problem.lower, dtype=np.int64) + proportional_greedy(res)
        return RoundPlan(
            round_index=int(r),
            T=int(T),
            assignments=x,
            est_cost=float(total_cost(problem, x)),
            problem=problem,
        )


class AsyncCampaignRunner(CampaignRunner):
    """Campaign driver with the background planner thread pre-selected:
    round *r+1*'s schedule and scenario solves overlap round *r*'s client
    training, with results bit-identical to :class:`CampaignRunner` in
    serial mode."""

    def __init__(self, server: FederatedServer):
        super().__init__(server, mode="pipelined")
