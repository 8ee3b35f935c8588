"""The port's campaign pipeline (``fl/pipeline.py``, ``fl/rounds.py``) on the
CPU: the cases of the reference's ``tests/test_fl_pipeline.py`` (pipelined
== serial bit for bit, planner crashes surface in the caller, the executors'
and futures' contracts), and toy-LM campaigns against the JAX package's.

Against the reference: schedules, true and estimated energies and makespans
exactly; scenario energies within rtol 1e-6; losses within rtol 1e-5;
parameters within atol 1e-5 (``_torch_fl.assert_matches_reference``).
"""

import threading
import time

import numpy as np
import pytest
from _torch_fl import (
    CPU,
    assert_histories_equal,
    assert_matches_reference,
    assert_params_equal,
    build_port,
    build_ref,
)

import repro.fl as jfl
from repro_torch.core import Problem
from repro_torch.core.sweep import SweepEngine
from repro_torch.fl import (
    AsyncCampaignRunner,
    CampaignRunner,
    PlanFuture,
    SerialPlanExecutor,
    ThreadPlanExecutor,
    run_campaign,
)


def _scenarios(T):
    return dict(scenario_T_candidates=[T // 2, T], scenario_dropouts=[[0], [1]])


def _build(seed=0, engine=None, scenarios=True, ref=False):
    build = build_ref if ref else build_port
    _, _, _, T = build_port(seed=seed)  # T depends only on the seeded fleet
    return build(seed=seed, engine=engine, policy_kwargs=_scenarios(T) if scenarios else None)


# ---------------------------------------------------------------------------
# determinism: pipelined == serial, bit for bit; and the reference's numbers
# ---------------------------------------------------------------------------


def test_pipelined_campaign_bit_identical_to_serial():
    server_s, ex_s, rng_s, T = _build(seed=0)
    h_serial = run_campaign(server_s, ex_s, 3, round_T=T, batch_size=4, rng=rng_s)

    server_p, ex_p, rng_p, _ = _build(seed=0)
    h_pipe = AsyncCampaignRunner(server_p).run(ex_p, 3, T, 4, rng_p)

    assert len(h_serial.rounds) == len(h_pipe.rounds) == 3
    assert_histories_equal(h_serial, h_pipe)
    # both plan the same solves: identical engine traffic on fresh engines
    assert h_serial.dp_cache_stats == h_pipe.dp_cache_stats
    # the final models match too (aggregation is part of the shared path)
    assert_params_equal(server_s.params, server_p.params)


@pytest.mark.parametrize("pipelined", [False, True])
def test_three_toy_rounds_match_the_reference(pipelined):
    """Three rounds with scenario planning, port against the JAX package on
    the same fleet, data and starting parameters."""
    server_j, ex_j, rng_j, T = _build(seed=0, ref=True)
    h_j = jfl.run_campaign(server_j, ex_j, 3, round_T=T, batch_size=4, rng=rng_j)
    server_t, ex_t, rng_t, _ = _build(seed=0)
    for a, b in zip(ex_j, ex_t):
        np.testing.assert_array_equal(a, b)
    h_t = run_campaign(server_t, ex_t, 3, round_T=T, batch_size=4, rng=rng_t, pipelined=pipelined)
    assert_matches_reference(h_j, h_t, server_j.params, server_t.params)
    assert h_j.losses[-1] < h_j.losses[0] and h_t.losses[-1] < h_t.losses[0]
    # the same solves, bucket for bucket: one plan build, hits after it
    assert h_t.dp_cache_stats["compiles"] == h_j.dp_cache_stats["compiles"] == 1
    assert h_t.dp_cache_stats["hits"] == h_j.dp_cache_stats["hits"]


def test_pipeline_stats_observability():
    server, ex, rng, T = _build(seed=1)
    hist = run_campaign(server, ex, 2, round_T=T, batch_size=4, rng=rng, pipelined=True)
    stats = hist.pipeline_stats
    assert stats.mode == "pipelined"
    assert len(stats.round_wall_s) == 2
    assert stats.planner_busy_s > 0.0
    assert 0.0 <= stats.overlap_fraction <= 1.0
    # plan + scenario task per round, all recorded by label
    labels = [t["label"] for t in stats.tasks]
    assert labels == ["plan[0]", "scenarios[0]", "plan[1]", "scenarios[1]"]
    summary = hist.summary()
    assert summary["pipeline_mode"] == "pipelined"
    assert "planner_overlap_fraction" in summary
    # serial mode reports zero overlap by construction
    server2, ex2, rng2, _ = _build(seed=1)
    h2 = run_campaign(server2, ex2, 2, round_T=T, batch_size=4, rng=rng2)
    assert h2.pipeline_stats.mode == "serial"
    assert h2.pipeline_stats.overlap_fraction == 0.0


# ---------------------------------------------------------------------------
# crash propagation + thread hygiene
# ---------------------------------------------------------------------------


class _BoomEngine(SweepEngine):
    def __init__(self):
        super().__init__(device=CPU)

    def dispatch(self, problems, split_regimes=False):
        raise RuntimeError("boom: scenario solve exploded")


def _planner_threads():
    return [t for t in threading.enumerate() if t.name.startswith("fl-planner")]


def test_planner_thread_exception_propagates():
    server, ex, rng, T = _build(seed=2, engine=_BoomEngine())
    with pytest.raises(RuntimeError, match="boom"):
        run_campaign(server, ex, 3, round_T=T, batch_size=4, rng=rng, pipelined=True)
    # the planner thread is joined even on failure
    assert _planner_threads() == []


def test_serial_mode_raises_same_error():
    server, ex, rng, T = _build(seed=2, engine=_BoomEngine())
    with pytest.raises(RuntimeError, match="boom"):
        run_campaign(server, ex, 3, round_T=T, batch_size=4, rng=rng)


def test_planner_thread_cleanup_on_success():
    server, ex, rng, T = _build(seed=3)
    AsyncCampaignRunner(server).run(ex, 2, T, 4, rng)
    assert _planner_threads() == []


# ---------------------------------------------------------------------------
# executor / future contracts
# ---------------------------------------------------------------------------


def test_serial_executor_runs_inline_and_counts_blocked():
    ex = SerialPlanExecutor()
    ran = []
    f = ex.submit("t", lambda v: ran.append(v) or v * 2, 21)
    assert ran == [21]  # inline at submit time
    assert f.done() and f.result() == 42
    assert f.blocked_s == f.busy_s  # serial planning is fully on the hot path


def test_thread_executor_fifo_and_shutdown():
    ex = ThreadPlanExecutor(name="fl-planner-test")
    order = []

    def task(i):
        time.sleep(0.005)
        order.append(i)
        return i

    futs = [ex.submit(f"t{i}", task, i) for i in range(5)]
    assert [f.result() for f in futs] == list(range(5))
    assert order == list(range(5))  # FIFO: submission order == execution order
    ex.shutdown()
    assert not any(t.name == "fl-planner-test" for t in threading.enumerate())


def test_plan_future_reraises():
    ex = ThreadPlanExecutor(name="fl-planner-test2")
    try:
        f = ex.submit("bad", lambda: (_ for _ in ()).throw(ValueError("nope")))
        with pytest.raises(ValueError, match="nope"):
            f.result()
        with pytest.raises(ValueError, match="nope"):  # sticky
            f.result()
    finally:
        ex.shutdown()


def test_campaign_runner_rejects_unknown_mode():
    server, _, _, _ = _build(seed=4, scenarios=False)
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        CampaignRunner(server, mode="warp")


# ---------------------------------------------------------------------------
# SweepEngine.dispatch handle
# ---------------------------------------------------------------------------


def test_sweep_dispatch_matches_solve():
    rng = np.random.default_rng(0)
    problems = []
    for _ in range(3):
        n, T = 4, 12
        upper = rng.integers(4, 9, n)
        tables = tuple(np.cumsum(rng.uniform(0.5, 2.0, u + 1)) - 1 for u in upper)
        problems.append(Problem(T=T, lower=np.zeros(n, dtype=int), upper=upper, cost_tables=tables))
    eng = SweepEngine(device=CPU)
    handle = eng.dispatch(problems)
    X = handle.result()
    assert handle.done()
    assert X is handle.result()  # memoized
    np.testing.assert_array_equal(X, eng.solve(problems))
    assert isinstance(PlanFuture, type)  # exported symbol sanity
