"""Deterministic fault injection for chaos-testing the campaign runtime.

Every chaos scenario is reproducible from ONE integer seed (DESIGN.md §17):
:meth:`FaultPlan.generate` expands a seed into a concrete, immutable fault
schedule — which client crashes at what fraction of its assignment, which
straggles by what slowdown, which engine dispatch ordinals raise
:class:`~repro_torch.core.resilience.TransientEngineError`, and which rounds see a
burst of extra service traffic. The plan is DATA, not randomness at
injection time, so serial and pipelined campaigns under the same plan see
identical faults.

Pieces:

  * :class:`ClientFault` / :class:`FaultPlan` — the seeded schedule.
  * :class:`FaultInjector` — turns a plan + a round's planned assignments
    into :class:`RoundFaults` telemetry (batches actually completed, which
    clients are lost for the rest of the round), the input to the FL
    server's round recovery.
  * :class:`FlakyEngine` — a :class:`~repro_torch.core.sweep.SweepEngine` wrapper
    that raises at planned dispatch ordinals (transient = a short run the
    retry budget covers; persistent = a run at least as long as the budget),
    delegating everything else to the real engine.
  * :func:`residual_problem` / :func:`proportional_greedy` — the recovery
    math: the residual instance is EXACT under the paper's atomic-task model
    (marginal tables ``C_i(c_i + j) - C_i(c_i)``), and the greedy fallback
    is guaranteed feasible whenever any residual capacity exists.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from ..core.problem import Problem
from ..core.resilience import TransientEngineError

__all__ = [
    "ClientFault",
    "FaultInjector",
    "FaultPlan",
    "FlakyEngine",
    "RoundFaults",
    "proportional_greedy",
    "residual_problem",
]


@dataclasses.dataclass(frozen=True)
class ClientFault:
    """One client-side failure event.

    ``kind="crash"``: the client dies after completing
    ``floor(x_i * severity)`` of its ``x_i`` assigned batches
    (``severity`` in [0, 1)) and takes no recovery work.
    ``kind="straggle"``: the client runs ``severity``x slower (> 1) and only
    finishes ``floor(x_i / severity)`` batches inside the round window; the
    shortfall is re-planned onto the healthy cohort.
    """

    round_index: int
    client: int
    kind: str  # "crash" | "straggle"
    severity: float

    def __post_init__(self):
        if self.kind not in ("crash", "straggle"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "crash" and not (0.0 <= self.severity < 1.0):
            raise ValueError("crash severity is a completed fraction in [0, 1)")
        if self.kind == "straggle" and self.severity <= 1.0:
            raise ValueError("straggle severity is a slowdown factor > 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable chaos schedule, typically built by :meth:`generate`.

    ``engine_faults`` are DISPATCH ORDINALS: the k-th ``dispatch()``/
    ``solve()`` call on a :class:`FlakyEngine` wrapping this plan raises
    :class:`~repro_torch.core.resilience.TransientEngineError` iff ``k`` is
    listed. A run of consecutive ordinals shorter than the retry budget is a
    transient failure; a run at least as long is persistent (the caller's
    retries exhaust and its fallback path must engage).
    ``overload_bursts`` maps round → number of extra one-off service
    requests injected at the top of that round.
    """

    seed: int
    client_faults: tuple = ()
    engine_faults: tuple = ()
    overload_bursts: tuple = ()  # of (round_index, n_requests)

    @classmethod
    def generate(
        cls,
        seed: int,
        num_rounds: int,
        n_clients: int,
        p_crash: float = 0.1,
        p_straggle: float = 0.1,
        engine_fault_rounds: float = 0.0,
        engine_run_len: int = 1,
        dispatch_budget: int = 256,
        p_burst: float = 0.0,
        burst_size: int = 8,
        max_faulty_fraction: float = 0.5,
    ) -> "FaultPlan":
        """Expands ``seed`` into a concrete plan.

        Per round, each client independently crashes with ``p_crash`` (at a
        uniform completed fraction) or straggles with ``p_straggle``
        (slowdown uniform in [1.5, 4]); at most
        ``floor(n_clients * max_faulty_fraction)`` clients fault per round so
        a surviving cohort always exists. ``engine_fault_rounds`` scales how
        many failure RUNS to scatter over ``dispatch_budget`` dispatch
        ordinals, each run ``engine_run_len`` consecutive ordinals long.
        ``p_burst`` adds an ``overload_bursts`` entry of ``burst_size``
        requests per selected round.
        """
        rng = np.random.default_rng(seed)
        faults = []
        cap = max(1, int(n_clients * max_faulty_fraction))
        for r in range(num_rounds):
            hit = []
            for i in range(n_clients):
                u = rng.random()
                if u < p_crash:
                    hit.append(ClientFault(r, i, "crash", float(rng.random() * 0.9)))
                elif u < p_crash + p_straggle:
                    hit.append(
                        ClientFault(r, i, "straggle", float(1.5 + 2.5 * rng.random()))
                    )
            # deterministic cap: keep the earliest-drawn faults
            faults.extend(hit[:cap])
        n_runs = int(round(engine_fault_rounds * num_rounds))
        ordinals = set()
        for _ in range(n_runs):
            start = int(rng.integers(0, max(1, dispatch_budget - engine_run_len)))
            ordinals.update(range(start, start + engine_run_len))
        bursts = tuple(
            (r, int(burst_size)) for r in range(num_rounds) if rng.random() < p_burst
        )
        return cls(
            seed=int(seed),
            client_faults=tuple(faults),
            engine_faults=tuple(sorted(ordinals)),
            overload_bursts=bursts,
        )


@dataclasses.dataclass
class RoundFaults:
    """What a round's telemetry reports after the faults fired: per-client
    batches actually completed, and which clients are lost to recovery
    (crashed clients are gone; stragglers are busy finishing their reduced
    share, so neither can absorb residual work this round)."""

    round_index: int
    completed: np.ndarray  # (n,) int64 batches actually finished
    crashed: tuple
    stragglers: tuple

    @property
    def lost_clients(self) -> tuple:
        return tuple(sorted(set(self.crashed) | set(self.stragglers)))


class FaultInjector:
    """Applies a :class:`FaultPlan` to a running campaign. Stateless across
    rounds apart from the shared dispatch-ordinal counter inside any
    :class:`FlakyEngine` built via :meth:`wrap_engine` — round fault lookup
    is a pure function of (plan, round_index, assignments)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_round: dict = {}
        for f in plan.client_faults:
            self._by_round.setdefault(int(f.round_index), []).append(f)
        self._bursts = {int(r): int(k) for r, k in plan.overload_bursts}

    def wrap_engine(self, engine) -> "FlakyEngine":
        return FlakyEngine(engine, self.plan.engine_faults)

    def round_faults(self, round_index: int, assignments) -> Optional[RoundFaults]:
        """The faults that fire against this round's planned ``assignments``
        — or None when the round is clean (including when every planned
        fault is a no-op because its client had ``x_i = 0``)."""
        hits = self._by_round.get(int(round_index))
        if not hits:
            return None
        x = np.asarray(assignments, dtype=np.int64)
        completed = x.copy()
        crashed, stragglers = [], []
        for f in hits:
            if f.client >= len(x):
                continue
            xi = int(x[f.client])
            if f.kind == "crash":
                completed[f.client] = min(xi, int(np.floor(xi * f.severity)))
                crashed.append(int(f.client))
            else:
                completed[f.client] = min(xi, int(np.floor(xi / f.severity)))
                stragglers.append(int(f.client))
        if int(completed.sum()) == int(x.sum()):
            return None
        return RoundFaults(
            round_index=int(round_index),
            completed=completed,
            crashed=tuple(sorted(set(crashed))),
            stragglers=tuple(sorted(set(stragglers))),
        )

    def burst(self, round_index: int) -> int:
        """Extra one-off service requests to inject at the top of a round."""
        return self._bursts.get(int(round_index), 0)

    def burst_problem(self, round_index: int, i: int) -> Problem:
        """A deterministic small instance for burst request ``i`` of a round
        (seeded off the plan seed — identical across replays)."""
        rng = np.random.default_rng((self.plan.seed, int(round_index), int(i)))
        n, upper = 4, 8
        tables = tuple(
            np.concatenate([[0.0], np.cumsum(rng.random(upper))]) for _ in range(n)
        )
        return Problem(
            T=2 * n,
            lower=np.zeros(n, dtype=np.int64),
            upper=np.full(n, upper, dtype=np.int64),
            cost_tables=tables,
        )


class FlakyEngine:
    """A :class:`~repro_torch.core.sweep.SweepEngine` proxy that raises
    :class:`~repro_torch.core.resilience.TransientEngineError` at the planned
    dispatch ordinals and otherwise delegates verbatim (``cache_stats``,
    ``max_entries``, ... pass straight through, so the wrapped engine drops
    into every engine-shaped seam — ``Solver``, ``SchedulerService``, the FL
    server). The ordinal counter is shared across threads
    (lock-guarded): ordinal k means the k-th dispatch issued anywhere in the
    process against this wrapper."""

    def __init__(self, engine, fail_ordinals: Sequence[int] = ()):
        self._engine = engine
        self._fail = frozenset(int(o) for o in fail_ordinals)
        self._lock = threading.Lock()
        self._calls = 0
        self._injected = 0

    def _tick(self) -> None:
        with self._lock:
            ordinal = self._calls
            self._calls += 1
            if ordinal in self._fail:
                self._injected += 1
                raise TransientEngineError(f"injected engine fault at dispatch {ordinal}")

    def dispatch(self, problems, split_regimes: bool = False):
        self._tick()
        return self._engine.dispatch(problems, split_regimes=split_regimes)

    def solve(self, problems, split_regimes: bool = False):
        self._tick()
        return self._engine.solve(problems, split_regimes=split_regimes)

    def fault_stats(self) -> dict:
        with self._lock:
            return {"dispatches": self._calls, "injected_failures": self._injected}

    def __getattr__(self, name):
        return getattr(self._engine, name)


def residual_problem(problem: Problem, completed, lost) -> Problem:
    """The EXACT residual instance after a partial round: client ``i`` has
    ``completed[i]`` batches banked, clients in ``lost`` can take no more
    work, and the marginal cost of ``j`` extra batches on a survivor is
    ``C_i(c_i + j) - C_i(c_i)`` — exact under the paper's atomic-task model
    (Def. 1: per-batch costs are independent of when the batch runs).

    The residual workload is the shortfall ``T - sum(completed)``, clipped
    to the surviving capacity (a fleet-wide outage can shrink the round,
    mirroring :func:`~repro_torch.fl.server.apply_dropout`). Lower limits are 0:
    participation floors applied to the ORIGINAL plan, and recovery must
    stay feasible on whatever cohort survives.
    """
    completed = np.minimum(
        np.asarray(completed, dtype=np.int64), problem.upper
    )
    lost = set(int(i) for i in lost)
    upper = problem.upper - completed
    gone = np.array([i in lost for i in range(problem.n)])
    upper = np.where(gone, 0, upper)
    tables = []
    for i in range(problem.n):
        if upper[i] == 0:
            tables.append(np.zeros(1))
        else:
            c = int(completed[i])
            tbl = problem.cost_tables[i]
            tables.append(tbl[c : c + int(upper[i]) + 1] - tbl[c])
    residual = int(problem.T) - int(completed.sum())
    T_res = int(np.clip(residual, 0, int(upper.sum())))
    return Problem(
        T=T_res,
        lower=np.zeros(problem.n, dtype=np.int64),
        upper=upper,
        cost_tables=tuple(tables),
    )


def proportional_greedy(problem: Problem) -> np.ndarray:
    """Guaranteed-feasible fallback schedule for a 0-lower-limit residual
    instance: floor-proportional to capacity, then the remainder placed one
    unit at a time on the cheapest-marginal client with headroom (ties →
    lowest index — fully deterministic). Used when the solver itself is the
    failing component; feasibility needs only ``T <= sum(upper)``, which
    :func:`residual_problem` guarantees by construction."""
    upper = np.asarray(problem.upper, dtype=np.int64)
    T = int(problem.T)
    cap = int(upper.sum())
    if T > cap:
        raise ValueError(f"infeasible fallback: T={T} > capacity {cap}")
    if cap == 0 or T == 0:
        return np.zeros(problem.n, dtype=np.int64)
    x = (upper * T) // cap  # floor-proportional, never exceeds upper
    remainder = T - int(x.sum())
    for _ in range(remainder):
        best, best_marg = -1, np.inf
        for i in range(problem.n):
            if x[i] < upper[i]:
                marg = problem.cost_tables[i][int(x[i]) + 1] - problem.cost_tables[i][int(x[i])]
                if marg < best_marg:
                    best, best_marg = i, float(marg)
        x[best] += 1
    return x.astype(np.int64)
