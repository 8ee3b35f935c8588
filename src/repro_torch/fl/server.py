"""FedAvg server with energy-minimal workload scheduling, after the JAX
package's ``fl/server.py``.

Per round (McMahan et al. [1] + this paper's contribution):
  1. The server asks the :class:`~repro_torch.fl.energy.EnergyEstimator` for the
     fleet's cost tables and solves the Minimal Cost FL Schedule problem for
     the round's workload ``T`` (total mini-batches) — ``x_i`` per client.
  2. Clients train one after another, each exactly its ``x_i`` steps with
     ordinary autograd, in one reusable parameter buffer
     (``fl/client.py``); the reference runs them as one ``vmap`` over a
     masked scan, whose steps past ``x_i`` change nothing.
  3. Aggregation: data-weighted parameter average (weights ``x_i / Σx``),
     summed in float32 in client order and cast to each leaf's dtype;
     clients with ``x_i = 0`` contribute nothing. A round with no work
     (``Σx = 0``) keeps the parameters (the reference's weights make it zero
     them).
  4. The simulator charges each device its TRUE energy for ``x_i`` batches
     (with measurement noise fed back to the estimator).

A round is decomposed into explicit stages (DESIGN.md §11) so serial and
pipelined campaign executors share one code path:

  * :meth:`FederatedServer.build_problem` / :meth:`~FederatedServer.plan_round`
    — snapshot the estimator into a :class:`~repro_torch.core.problem.Problem` and
    solve the schedule (a :class:`RoundPlan`) through the
    :class:`~repro_torch.core.solver.Solver` on the server's engine (whose
    device the planning runs on).
  * :meth:`FederatedServer.train_round` — enqueue the clients' training on
    the parameters' device; returns the UN-materialized device loss, so the
    caller decides when to block.
  * :meth:`FederatedServer.account_round` — pure-CPU energy accounting +
    estimator feedback (the only stage that mutates estimator state / rng).
  * :meth:`FederatedServer.build_scenarios` /
    :meth:`~FederatedServer.solve_scenarios` — what-if snapshot (cheap, must
    run after accounting) split from the batched DP solve (expensive, safe
    to run on a background planner thread).

:meth:`FederatedServer.run_round` composes the stages serially and is the
reference semantics the async pipeline must reproduce bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core._deprecation import warn_deprecated
from ..core.fleet import PlanPolicy
from ..core.pareto import deadline_grid
from ..core.problem import Problem, total_cost
from ..core.resilience import is_transient
from ..core.solver import Solver
from ..core.sweep import default_engine
from ..optim.optimizers import Optimizer, tree_leaves, tree_map
from .client import train_steps
from .energy import EnergyEstimator
from .faults import RoundFaults, proportional_greedy, residual_problem

__all__ = [
    "FLRoundResult",
    "PlanPolicy",
    "RecoveryInfo",
    "RoundPlan",
    "ScenarioReport",
    "FederatedServer",
    "apply_dropout",
]

_UNSET = object()  # sentinel: distinguishes "legacy kwarg passed" from default


@dataclasses.dataclass
class RecoveryInfo:
    """Provenance of a mid-round recovery (DESIGN.md §17): what failed, what
    each client had banked when it did, the exact residual instance the
    survivors were re-planned over, and what the detour cost on the
    planning-time tables. Carried on the recovered :class:`RoundPlan` and
    the round's :class:`FLRoundResult`, so chaos tests (and checkpoints) can
    replay the recovery solve independently."""

    failed_clients: tuple  # crashed mid-round; take no recovery work
    straggler_clients: tuple  # too slow to finish; take no recovery work
    completed: np.ndarray  # (n,) batches banked before recovery kicked in
    residual_T: int  # workload re-planned onto the survivors
    shortfall: int  # residual units the surviving capacity could NOT absorb
    attempts: int  # solver attempts consumed (1 = first try succeeded)
    fallback: bool  # proportional-greedy fallback engaged
    assignments_original: np.ndarray  # the pre-fault plan
    recovery_assignments: np.ndarray  # extra batches per survivor (the y)
    residual_problem: Optional[Problem]  # the exact re-planned instance
    problem: Optional[Problem]  # the planning-time snapshot it derives from
    est_cost_original: float  # pre-fault estimated Joules
    est_overhead_J: float  # est(recovered round) - est(pre-fault plan)


@dataclasses.dataclass
class RoundPlan:
    """Output of the planning stage: the schedule for one round plus what the
    scheduler believed it would cost (on the estimates it planned against)."""

    round_index: int
    T: int  # requested workload (pre-dropout-clipping)
    assignments: np.ndarray  # x_i, sums to the effective workload
    est_cost: float  # estimated Joules under the planning-time tables
    # frontier-mode planning only (DESIGN.md §15): the ε-constraint deadline
    # the chosen frontier point was solved under, and its achieved makespan.
    deadline: Optional[float] = None
    est_time: Optional[float] = None
    # the immutable estimator snapshot this plan was solved against — what
    # mid-round recovery re-plans over, so the residual instance is exact
    # even if the estimator drifted since (DESIGN.md §17)
    problem: Optional[Problem] = None
    recovery: Optional[RecoveryInfo] = None


@dataclasses.dataclass
class ScenarioReport:
    """Per-round what-if analysis (DESIGN.md §9): candidate workloads and
    dropout subsets, ALL solved by one batched (MC)^2MKP DP call."""

    labels: list  # human-readable scenario descriptions, e.g. "T=120", "drop=2,5"
    assignments: np.ndarray  # (B, n) schedule per scenario
    energies: np.ndarray  # (B,) estimated Joules per scenario


@dataclasses.dataclass
class FLRoundResult:
    round_index: int
    assignments: np.ndarray  # x_i
    mean_loss: float  # data-weighted mean client loss
    energy_joules: float  # true total energy charged
    estimated_joules: float  # what the scheduler thought it would cost
    makespan_joules: float  # max per-device energy (OLAR's objective, for contrast)
    scenarios: Optional[ScenarioReport] = None  # what-if planning, if enabled
    recovery: Optional[RecoveryInfo] = None  # mid-round recovery, if it fired
    # an repro_torch.fl.adaptive.AdaptiveRoundStats when the adaptive layer is on
    # (DESIGN.md §18): drift classification, speculation outcome, watermark
    adaptive: Optional[object] = None


def apply_dropout(problem: Problem, dropped) -> Problem:
    """The instance after clients ``dropped`` leave the fleet (paper §6 "loss
    of a device"): their limits collapse to 0 and the workload shrinks to the
    surviving capacity if necessary."""
    dropped = set(int(i) for i in dropped)
    gone = np.array([i in dropped for i in range(problem.n)])
    lower = np.where(gone, 0, problem.lower)
    upper = np.where(gone, 0, problem.upper)
    tables = tuple(
        np.zeros(1) if i in dropped else tbl
        for i, tbl in enumerate(problem.cost_tables)
    )
    T_eff = int(np.clip(problem.T, lower.sum(), upper.sum()))
    return Problem(T=T_eff, lower=lower, upper=upper, cost_tables=tables)


class FederatedServer:
    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        init_params: Any,
        client_optimizer: Optimizer,
        estimator: EnergyEstimator,
        policy: Optional[PlanPolicy] = None,
        algorithm=_UNSET,
        participation_floor=_UNSET,
        round_T=_UNSET,
        scenario_T_candidates=_UNSET,
        scenario_dropouts=_UNSET,
        engine=_UNSET,
        service=_UNSET,
        frontier_mode=_UNSET,
        time_tables=_UNSET,
        frontier_points=_UNSET,
    ):
        """Planning configuration lives in ``policy`` — a
        :class:`~repro_torch.core.fleet.PlanPolicy` (the consolidated planning configuration):

        * ``policy.round_T``: total mini-batches scheduled per round;
          ``None`` defaults to half the round tensor's capacity (and can
          still be set later, e.g. by :func:`repro_torch.fl.rounds.run_campaign`).
        * ``policy.scenario_T_candidates`` / ``policy.scenario_dropouts``
          enable the per-round scenario-planning hook: alternative workloads
          and client-dropout subsets are evaluated against the CURRENT
          energy estimates via one batched DP solve and attached to each
          :class:`FLRoundResult`.
        * ``policy.engine``: the :class:`~repro_torch.core.sweep.SweepEngine` all
          batched DP solves route through (``None``: the process-wide
          default). Round shapes repeat while only the cost *values* drift,
          so round 1 builds the DP's plan and every later round reuses it
          (inspect via ``server.engine.cache_stats()``). The default engine
          is the shared one on the card; ``SweepEngine(device="cpu")``
          plans on the CPU.
        * ``policy.service``: an optional
          :class:`~repro_torch.serve.service.SchedulerService`. When set, scenario
          batches are SUBMITTED to the service instead of dispatched
          directly (DESIGN.md §14); ``engine=None`` then defaults to the
          service's engine so campaign cache accounting observes the shared
          cache.
        * ``policy.frontier_mode``: picks each round's operating point from
          the LIVE (energy, completion-time) Pareto frontier — ``"knee"`` /
          ``"min_energy"`` / ``"min_time"``, or a round-time budget in
          seconds (ε-constraint). Requires ``policy.time_tables``;
          ``policy.frontier_points`` bounds the per-round sweep batch.
        * ``policy.fleet_clusters``: switches round planning to the
          two-level fleet path (DESIGN.md §16) —
          :meth:`~repro_torch.core.solver.Solver.solve_fleet` with
          ``policy.fleet_quantum`` / ``policy.fleet_seed``. Planning remains
          a pure function of the estimator snapshot (deterministic k-means),
          so pipelined campaigns stay bit-identical.

        ``init_params`` is the global model, a tree of tensors (dicts and
        lists); clients train on the device its leaves lie on, and every
        round writes the new parameters into these tensors in place (pass a
        copy to keep the starting point).

        The older constructor kwargs (``algorithm``, ``round_T``,
        ``frontier_mode``, ...) still work bit-identically — each warns
        ``DeprecationWarning`` once per process and is folded into a
        ``PlanPolicy``. Passing both ``policy`` and legacy kwargs raises.
        """
        legacy = {
            name: val
            for name, val in (
                ("algorithm", algorithm),
                ("participation_floor", participation_floor),
                ("round_T", round_T),
                ("scenario_T_candidates", scenario_T_candidates),
                ("scenario_dropouts", scenario_dropouts),
                ("engine", engine),
                ("service", service),
                ("frontier_mode", frontier_mode),
                ("time_tables", time_tables),
                ("frontier_points", frontier_points),
            )
            if val is not _UNSET
        }
        if legacy and policy is not None:
            raise ValueError(
                "pass either policy=PlanPolicy(...) or the legacy kwargs, "
                f"not both (got legacy: {sorted(legacy)})"
            )
        if legacy:
            for name in sorted(legacy):
                warn_deprecated(
                    f"FederatedServer({name}=...)",
                    f"FederatedServer(policy=PlanPolicy({name}=...))",
                    module="repro_torch.fl",
                )
            policy = PlanPolicy(**legacy)
        elif policy is None:
            policy = PlanPolicy()
        self.policy = policy

        self.params = init_params
        self.estimator = estimator
        self.algorithm = policy.algorithm
        self.round_T = policy.round_T
        self.service = policy.service
        engine = policy.engine
        if engine is None and self.service is not None:
            engine = self.service.engine
        self.engine = engine if engine is not None else default_engine()
        self.frontier_mode = policy.frontier_mode
        self.time_tables = None if policy.time_tables is None else [
            np.asarray(t, dtype=np.float64) for t in policy.time_tables
        ]
        self.frontier_points = int(policy.frontier_points)
        self.solver = Solver(
            engine=self.engine, service=self.service, retry=policy.retry
        )
        self.scenario_T_candidates = list(policy.scenario_T_candidates)
        self.scenario_dropouts = [tuple(s) for s in policy.scenario_dropouts]
        self.n_clients = len(estimator.fleet)
        if policy.participation_floor is not None:
            for d in estimator.fleet:
                d.min_batches = policy.participation_floor

        self._loss_fn = loss_fn
        self._client_optimizer = client_optimizer
        self._buffers = None  # (key, client buffer, float32 accumulator)

    # ---- round stages (plan -> train -> aggregate/account) -------------

    def build_problem(self, T: int, unavailable=None) -> Problem:
        """Snapshot stage: the scheduling instance for workload ``T`` under
        the CURRENT estimates (cheap numpy — safe to run on the round hot
        path; the returned Problem is immutable, so a background solver can
        consume it while the estimator keeps drifting).

        With ``policy.reliability`` set, chronically flaky clients get their
        effective ``upper`` down-weighted by the estimator's crash/straggle
        reliability scores (DESIGN.md §18) — in this planning snapshot only,
        never in the true simulator tables."""
        est_problem = self.estimator.problem(T, reliability=self._reliability_weights())
        if unavailable:
            est_problem = apply_dropout(est_problem, unavailable)
        return est_problem

    def predict_problem(self, T: int, steps: int) -> Problem:
        """The PREDICTED planning instance ``steps`` rounds ahead (tables
        extrapolated along the estimator's per-client trend) — what the
        speculative lookahead batch solves. ``steps=0`` is exactly
        :meth:`build_problem` without dropout."""
        return self.estimator.predict_problem(
            T, steps, reliability=self._reliability_weights()
        )

    def _reliability_weights(self):
        if self.policy.reliability is None:
            return None
        return self.estimator.reliability_weights()

    def plan_round(
        self, round_index: int, T: int, est_problem: Optional[Problem] = None
    ) -> RoundPlan:
        """Planning stage: solve the schedule for ``est_problem`` (built via
        :meth:`build_problem` if not given). Deterministic in its inputs —
        running it inline or on a planner thread yields the same plan (the
        frontier path included: the grid, sweep, and point selection are all
        pure functions of the immutable snapshot).

        With ``frontier_mode`` set, the round's operating point comes from
        the live Pareto frontier: one batched ε-constraint sweep over a
        ``frontier_points``-sized deadline grid (ONE engine dispatch — or
        one coalescable served request), then the configured selection rule
        picks the round's (energy, time) trade-off."""
        if est_problem is None:
            est_problem = self.build_problem(T)
        if self.policy.fleet_clusters is not None:
            # fleet-scale rounds (DESIGN.md §16): two-level cluster-then-
            # allocate solve — still a pure function of the snapshot (the
            # k-means is deterministic under policy.fleet_seed), so serial
            # and pipelined campaigns stay bit-identical
            fsol = self.solver.solve_fleet(est_problem, policy=self.policy)
            return RoundPlan(
                round_index=round_index,
                T=int(T),
                assignments=np.asarray(fsol.schedule),
                est_cost=float(fsol.objective),
                problem=est_problem,
            )
        if self.frontier_mode is not None:
            grid = deadline_grid(est_problem, self.time_tables, self.frontier_points)
            front = self.solver.frontier(est_problem, self.time_tables, grid)
            pt = front.select(self.frontier_mode)
            return RoundPlan(
                round_index=round_index,
                T=int(T),
                assignments=np.asarray(pt.schedule),
                est_cost=float(pt.energy),
                deadline=float(pt.deadline),
                est_time=float(pt.time),
                problem=est_problem,
            )
        sol = self.solver.solve(est_problem, algorithm=self.algorithm)
        return RoundPlan(
            round_index=round_index,
            T=int(T),
            assignments=np.asarray(sol.schedule),
            est_cost=float(sol.objective),
            problem=est_problem,
        )

    def recover_round(
        self, plan: RoundPlan, faults: RoundFaults, max_attempts: int = 3
    ) -> RoundPlan:
        """Mid-round recovery (DESIGN.md §17): given round telemetry saying
        which clients crashed or straggled and how many batches each actually
        banked, re-plan the residual workload onto the survivors with ONE
        batched solve through the :class:`~repro_torch.core.solver.Solver` facade.

        The residual instance is exact under the paper's atomic-task model —
        survivor ``i``'s marginal table is ``C_i(c_i + j) - C_i(c_i)`` — so
        the recovered assignment is bit-identical to a fault-free re-plan of
        the surviving cohort (asserted in tests/test_torch_faults.py). Transient
        solver failures retry up to ``max_attempts``; if the solver itself is
        the failing component, the guaranteed-feasible
        :func:`~repro_torch.fl.faults.proportional_greedy` fallback engages. The
        returned plan carries full :class:`RecoveryInfo` provenance; its
        ``est_cost`` is re-stated for the recovered assignment on the same
        planning-time tables, so the recovery overhead is directly readable
        as ``est_cost - recovery.est_cost_original``.
        """
        problem = plan.problem
        if problem is None:
            problem = self.build_problem(plan.T)
        x = np.asarray(plan.assignments, dtype=np.int64)
        completed = np.minimum(np.asarray(faults.completed, dtype=np.int64), x)
        res_problem = residual_problem(problem, completed, faults.lost_clients)
        residual = int(x.sum()) - int(completed.sum())
        if residual <= 0:
            return plan
        attempts, fallback, y = 0, False, None
        while attempts < max_attempts:
            attempts += 1
            try:
                # one batched facade solve — same substrate (engine or
                # service) as round planning, so recovery coalesces with any
                # other traffic exactly like a plan does
                sol = self.solver.solve([res_problem], check=True)
                y = np.asarray(sol.schedules[0], dtype=np.int64)
                break
            except Exception as e:
                if not is_transient(e):
                    break  # solver is the failing component: fall back now
        if y is None:
            y = proportional_greedy(res_problem)
            fallback = True
        effective = completed + y
        est_cost = float(total_cost(problem, effective))
        info = RecoveryInfo(
            failed_clients=tuple(faults.crashed),
            straggler_clients=tuple(faults.stragglers),
            completed=completed,
            residual_T=int(res_problem.T),
            shortfall=residual - int(res_problem.T),
            attempts=attempts,
            fallback=fallback,
            assignments_original=x,
            recovery_assignments=y,
            residual_problem=res_problem,
            problem=problem,
            est_cost_original=float(plan.est_cost),
            est_overhead_J=est_cost - float(plan.est_cost),
        )
        return dataclasses.replace(
            plan, assignments=effective, est_cost=est_cost, recovery=info
        )

    def _round_buffers(self):
        """The reusable client buffer (like the parameters) and float32
        accumulator, made at the first round and kept while the parameters
        keep their shapes, dtypes and device."""
        leaves = tree_leaves(self.params)
        key = tuple((tuple(p.shape), p.dtype, p.device) for p in leaves)
        if self._buffers is None or self._buffers[0] != key:
            self._buffers = None  # free the old pair before making the new
            self._buffers = (
                key,
                tree_map(torch.empty_like, self.params),
                tree_map(lambda p: torch.empty_like(p, dtype=torch.float32), self.params),
            )
        return self._buffers[1], self._buffers[2]

    def train_round(self, plan: RoundPlan, batches) -> torch.Tensor:
        """Training stage: each client with work, in index order, starts
        from the global parameters in the client buffer and runs its ``x_i``
        steps (:func:`~repro_torch.fl.client.train_steps`); ``w_i
        p_i`` is added into a float32 accumulator with ``w_i = x_i / Σx``
        (float32, the reference's weights), and the sum is cast into
        ``self.params`` in place. ``batches`` (``(n, max_steps, B, ...)``,
        integer token ids become int64) moves to the device once.

        Returns the data-weighted mean loss as an UN-materialized float32
        device scalar: the work is enqueued and nothing waits for it, so
        planning can proceed while clients train. A round with no work
        leaves the parameters as they are and returns 0.0."""
        x = np.asarray(plan.assignments, dtype=np.int64)
        device = tree_leaves(self.params)[0].device
        total = int(x.sum())
        if total == 0:
            return torch.zeros((), dtype=torch.float32, device=device)
        w = x.astype(np.float32) / np.float32(total)
        w_dev = torch.from_numpy(w).to(device)
        tb = torch.as_tensor(np.ascontiguousarray(batches)).to(device)
        if not tb.is_floating_point():
            tb = tb.long()
        client, acc = self._round_buffers()
        for a in tree_leaves(acc):
            a.zero_()
        losses = torch.zeros(len(x), dtype=torch.float32, device=device)
        with torch.no_grad():
            for i in np.flatnonzero(x):
                tree_map(lambda c, p: c.copy_(p), client, self.params)
                k = int(x[i])
                losses[i] = train_steps(self._loss_fn, self._client_optimizer, client, tb[i, :k], k)
                tree_map(lambda a, c, wi=float(w[i]): a.add_(c.float(), alpha=wi), acc, client)
            tree_map(lambda p, a: p.copy_(a), self.params, acc)
        return (w_dev * losses).sum()

    def account_round(self, plan: RoundPlan, rng: np.random.Generator) -> dict:
        """Accounting stage: charge each device its TRUE energy and feed
        noisy measurements back into the estimator. Pure CPU, and the ONLY
        stage consuming ``rng`` / mutating estimator state — so stage order
        fixes the random stream and serial vs pipelined campaigns stay
        bit-identical."""
        x = plan.assignments
        true_problem = self.estimator.true_problem(plan.T)
        true_cost = total_cost(true_problem, x)
        per_dev = [true_problem.cost(i, int(x[i])) for i in range(self.n_clients)]
        for i, dev in enumerate(self.estimator.fleet):
            if x[i] > 0:
                self.estimator.observe(i, int(x[i]), dev.measure(int(x[i]), rng))
        return {
            "energy_joules": float(true_cost),
            "makespan_joules": float(max(per_dev)),
        }

    def build_scenarios(self, T: int):
        """What-if snapshot (cheap): the configured candidate workloads and
        dropout subsets as concrete Problems under the current estimates.
        Must run AFTER :meth:`account_round` so scenarios see the freshest
        tables; the expensive solve (:meth:`solve_scenarios`) can then run
        anywhere."""
        if not self.scenario_T_candidates and not self.scenario_dropouts:
            return [], []
        # build_problem (not the raw estimator) so scenario what-ifs see the
        # same reliability-weighted envelope round planning does; with
        # policy.reliability unset this is the estimator snapshot verbatim
        base = self.build_problem(T)
        problems, labels = [], []
        for Tc in self.scenario_T_candidates:
            Tc_eff = int(np.clip(int(Tc), int(base.lower.sum()), int(base.upper.sum())))
            problems.append(self.build_problem(Tc_eff))
            labels.append(f"T={Tc_eff}")
        for sub in self.scenario_dropouts:
            problems.append(apply_dropout(base, sub))
            labels.append("drop=" + ",".join(str(int(i)) for i in sorted(set(sub))))
        return problems, labels

    def solve_scenarios(self, problems, labels) -> Optional[ScenarioReport]:
        """Evaluates the snapshotted what-ifs with ONE regime-split batched
        solve through the engine (the pipelined campaign runs this whole
        stage on the planner thread); returns None when no scenarios are
        configured. Scenarios whose estimated cost tables are monotone —
        e.g. dropout/deadline what-ifs over a linear or DVFS-superlinear
        energy fleet — ride the marginal fast path (DESIGN.md §13) instead
        of paying the pseudo-polynomial DP; arbitrary-regime scenarios
        still batch into the fused DP.

        With a :class:`~repro_torch.serve.service.SchedulerService` configured,
        the whole scenario batch goes through the service as ONE request —
        the coalescer may merge it with same-bucket external traffic into a
        single dispatch, and results stay bit-identical to the direct
        engine path (inert padding)."""
        if not problems:
            return None
        # the facade's batch path: regime-split through the engine, or ONE
        # served request when a service is configured — same dispatch the
        # pre-facade code made, so campaigns stay bit-identical
        res = self.solver.solve(problems, check=False)
        X = np.stack(res.schedules)  # every scenario spans the full fleet
        return ScenarioReport(
            labels=list(labels), assignments=X, energies=res.objectives
        )

    # ---- serial composition --------------------------------------------

    def run_round(
        self,
        round_index: int,
        batches: np.ndarray,
        rng: np.random.Generator,
        unavailable=None,
    ) -> FLRoundResult:
        """One FedAvg round: the stages composed serially (the reference
        code path; ``fl/pipeline.py`` runs the same stages with the DP
        solves moved off the hot path).

        ``unavailable``: optional iterable of client indices that dropped out
        before this round (paper §6 "loss of a device" future-work item):
        their limits collapse to 0 and the workload is rescheduled over the
        remaining fleet — shrunk to the surviving capacity if necessary.
        """
        T = self._round_T(batches)
        plan = self.plan_round(round_index, T, self.build_problem(T, unavailable))
        mean_loss = self.train_round(plan, batches)
        acct = self.account_round(plan, rng)
        # what-if planning for the NEXT round, on the freshest estimates
        scenarios = self.solve_scenarios(*self.build_scenarios(T))
        return FLRoundResult(
            round_index=round_index,
            assignments=plan.assignments,
            mean_loss=float(mean_loss),
            energy_joules=acct["energy_joules"],
            estimated_joules=plan.est_cost,
            makespan_joules=acct["makespan_joules"],
            scenarios=scenarios,
        )

    def _round_T(self, batches) -> int:
        """Round workload: the explicitly configured ``round_T`` if set,
        otherwise half the total capacity of the round tensor."""
        if self.round_T is None:
            n, s = batches.shape[0], batches.shape[1]
            return (n * s) // 2
        return int(self.round_T)
