"""The port's sweep engine (``core/sweep.py``) against the JAX package's, on
the CPU: bucket math, inert padding, bucketed solves against uncached ones
and against the reference engine (schedules identical, ``k_last`` rows
bit-identical float32, selection objectives within rtol 1e-6), the same
``cache_stats()`` as the reference after the same calls (bucket crossings,
LRU eviction), the regime split's order, and thread safety.

On the CPU a plan is its body, called per dispatch; its CUDA-graph capture
and replay run only on the card (``tests/test_torch_cuda.py``). The JAX
side runs as its own tests run it here (engine backend ``"blocked"``), on a
few small buckets.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import problem as jprob
from repro.core import sweep as jsweep
from repro.core import jax_dp as jdp
from repro_torch.core import problem as tprob
from repro_torch.core import scheduler as tsched
from repro_torch.core import sweep as tsweep
from repro_torch.core import torch_dp as tdp

CPU = "cpu"
REGIMES = ("arbitrary", "linear", "increasing", "decreasing")


def random_mixed_problems(rng, B, max_n=6, max_T=24):
    out = []
    for b in range(B):
        n = int(rng.integers(1, max_n + 1))
        T = int(rng.integers(max(1, n), max_T + 1))
        out.append(jcosts.random_problem(rng, n=n, T=T, regime=REGIMES[b % len(REGIMES)]))
    return out


def drift(problems, factor):
    """Same shapes, scaled costs — the round-over-round estimate drift that
    must stay inside one bucket."""
    return [jprob.Problem(T=p.T, lower=p.lower, upper=p.upper, cost_tables=tuple(t * factor for t in p.cost_tables))
            for p in problems]


def port(probs):
    return [tprob.from_reference(p) for p in probs]


def engines(**kw):
    """A reference engine and a port engine on the CPU, built alike."""
    return jsweep.SweepEngine(**kw), tsweep.SweepEngine(device=CPU, **kw)


def solve_both(je, te, probs, split_regimes=False):
    """One blocking solve on each engine; the schedules must agree."""
    Xj = je.solve(probs, split_regimes=split_regimes)
    Xt = te.solve(port(probs), split_regimes=split_regimes)
    np.testing.assert_array_equal(Xt, Xj)
    return Xt


def assert_same_stats(je, te):
    assert te.cache_stats() == je.cache_stats()


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


# ---------------------------------------------------------------------------
# bucketing + padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 5, 17, 33), (8, 16, 32, 64), (9, 16, 32, 64), (100, 100, 9903, 1001)])
def test_bucket_shape_matches_reference(shape):
    assert tsweep.bucket_shape(*shape) == jsweep.bucket_shape(*shape)
    assert all(d & (d - 1) == 0 and d >= s for d, s in zip(tsweep.bucket_shape(*shape), shape))


@pytest.mark.parametrize("seed", range(3))
def test_request_bucket_matches_reference(seed):
    jb = jprob.ProblemBatch.from_problems(random_mixed_problems(np.random.default_rng(seed), 5))
    tb = tprob.from_reference(jb)
    assert tsweep.request_bucket(tb) == jsweep.request_bucket(jb)
    # the closed form is the 0-lower-limit batch's bucket (what the engine keys on)
    assert tsweep.request_bucket(tb) == jsweep._bucket_axes(jprob.remove_lower_limits(jb))


def test_problem_batch_pad_to_is_inert():
    probs = port(random_mixed_problems(np.random.default_rng(0), 5))
    batch = tprob.ProblemBatch.from_problems(probs)
    padded = batch.pad_to(B=8, n=8, W=batch.W + 5)
    padded.validate()
    assert (padded.B, padded.n, padded.W) == (8, 8, batch.W + 5)
    np.testing.assert_array_equal(padded.costs[: batch.B, : batch.n, : batch.W], batch.costs)
    X = tdp.solve_schedule_dp_batch(padded, device=CPU)
    np.testing.assert_array_equal(X[: batch.B, : batch.n], tdp.solve_schedule_dp_batch(batch, device=CPU))
    assert np.all(X[batch.B :] == 0) and np.all(X[:, batch.n :] == 0)
    assert batch.pad_to() is batch
    with pytest.raises(ValueError):
        batch.pad_to(B=batch.B - 1)


def test_device_pack_of_the_padded_original_is_the_reference_pack():
    """The plans pad the ORIGINAL batch and remove lower limits on the
    device: bit-identical to packing the padded 0-lower-limit batch."""
    jb = jprob.ProblemBatch.from_problems(random_mixed_problems(np.random.default_rng(9), 5))
    nb, _, Wb = jsweep.request_bucket(jb)
    want = jdp.pack_problem(jprob.remove_lower_limits(jb).pad_to(B=8, n=nb, W=Wb))
    got = tdp.pack_batch(tprob.from_reference(jb).pad_to(B=8, n=nb, W=Wb), device=CPU)
    assert_bits_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# plan cache: exactness + counters, call for call with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_cached_solve_matches_reference_and_uncached(seed):
    probs = random_mixed_problems(np.random.default_rng(200 + seed), 9)
    je, te = engines()
    hj, ht = je.dispatch(probs), te.dispatch(port(probs))
    np.testing.assert_array_equal(ht.result(), hj.result())
    np.testing.assert_array_equal(ht.result(), tdp.solve_schedule_dp_batch(port(probs), device=CPU))
    assert_bits_equal(ht.k_last(), hj.k_last())
    assert_bits_equal(ht.objectives(), hj.objectives())
    assert te.cache_stats()["compiles"] == 1
    assert_same_stats(je, te)
    probs2 = drift(probs, 1.07)  # same shapes: a hit, still exact
    X2 = solve_both(je, te, probs2)
    np.testing.assert_array_equal(X2, tdp.solve_schedule_dp_batch(port(probs2), device=CPU))
    s = te.cache_stats()
    per_bucket = s.pop("per_bucket_hits")
    assert s == {"hits": 1, "misses": 1, "compiles": 1, "evictions": 0, "entries": 1, "max_entries": te.max_entries}
    (label,) = per_bucket
    assert label.startswith("dp:B16:") and per_bucket[label] == 1
    assert_same_stats(je, te)


def test_bucket_boundary_crossing_matches_reference_stats():
    base = jcosts.random_problem(np.random.default_rng(3), n=4, T=20, regime="arbitrary", with_lower=False)

    def with_T(t):
        return jprob.Problem(T=t, lower=base.lower, upper=base.upper, cost_tables=base.cost_tables)

    je, te = engines()
    for Ts, compiles in (((12, 16), 1), ((9, 14), 1), ((12, 17), 2)):  # T'max 16, 14 -> T16; 17 -> T32
        solve_both(je, te, [with_T(t) for t in Ts])
        assert te.cache_stats()["compiles"] == compiles
        assert_same_stats(je, te)
    assert set(te.cache_stats()["per_bucket_hits"]) == {"dp:B2:n4:T16:W32"}


def test_lru_eviction_and_recompile_match_reference():
    rng = np.random.default_rng(4)
    small = [jcosts.random_problem(rng, n=2, T=4, regime="linear") for _ in range(2)]
    big = [jcosts.random_problem(rng, n=6, T=20, regime="arbitrary") for _ in range(3)]
    je, te = engines(max_entries=1)
    solve_both(je, te, small)
    solve_both(je, te, big)  # another bucket: evicts `small`'s plan
    s = te.cache_stats()
    assert s["evictions"] == 1 and s["entries"] == 1
    X = solve_both(je, te, small)  # re-enter the evicted bucket: an honest rebuild
    s = te.cache_stats()
    assert s["compiles"] == 3 and s["hits"] == 0
    np.testing.assert_array_equal(X, tdp.solve_schedule_dp_batch(port(small), device=CPU))
    assert_same_stats(je, te)
    te.clear()
    assert te.cache_stats()["compiles"] == 0 and te.cache_stats()["entries"] == 0


def test_lru_evicts_oldest_of_many_buckets_like_the_reference():
    rng = np.random.default_rng(6)
    bucket_a = [jcosts.random_problem(rng, n=2, T=4, regime="linear") for _ in range(2)]
    bucket_b = [jcosts.random_problem(rng, n=6, T=20, regime="arbitrary") for _ in range(2)]
    bucket_c = [jcosts.random_problem(rng, n=3, T=40, regime="increasing") for _ in range(2)]
    je, te = engines(max_entries=2)
    Xa = solve_both(je, te, bucket_a)
    solve_both(je, te, bucket_b)
    solve_both(je, te, bucket_a)  # a hit refreshes a: [b, a]
    solve_both(je, te, bucket_c)  # evicts b, the oldest
    s = te.cache_stats()
    assert s["evictions"] == 1 and s["entries"] == 2 and s["compiles"] == 3
    assert_same_stats(je, te)
    np.testing.assert_array_equal(solve_both(je, te, bucket_a), Xa)  # a survived
    solve_both(je, te, bucket_b)  # b was evicted: rebuilt, exact again
    s = te.cache_stats()
    assert s["compiles"] == 4 and s["evictions"] == 2
    assert sum(s["per_bucket_hits"].values()) == s["hits"]
    assert_same_stats(je, te)


# ---------------------------------------------------------------------------
# the regime split
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split_case():
    """A mixed batch split by both engines (the reference's buckets are
    built once for the module)."""
    probs = random_mixed_problems(np.random.default_rng(12), 8, max_n=8, max_T=16)
    je, te = engines()
    hj, ht = je.dispatch(probs, split_regimes=True), te.dispatch(port(probs), split_regimes=True)
    return probs, je, te, hj, ht


def test_regime_split_matches_reference(split_case):
    probs, je, te, hj, ht = split_case
    assert isinstance(ht, tsweep.RegimeSplitHandle)
    np.testing.assert_array_equal(ht.result(), hj.result())
    assert ht.done()
    np.testing.assert_allclose(ht.objectives(), hj.objectives(), rtol=1e-6)
    for b, p in enumerate(port(probs)):
        x0 = ht.result()[b, : p.n] - p.lower
        assert ht.objectives()[b] == pytest.approx(tprob.total_cost(tprob.remove_lower_limits(p), x0), rel=1e-5, abs=1e-5)
    with pytest.raises(ValueError, match="k_last"):
        ht.k_last()
    assert te.cache_stats()["entries"] >= 2  # at least one DP + one marginal bucket
    assert_same_stats(je, te)


def test_regime_split_order_is_dp_then_selection_then_host(split_case):
    probs, _, _, _, ht = split_case
    algs = tsched.select_algorithm_batch(port(probs))
    kinds = []
    for idx, part in ht._parts:
        kind = {"dp": "dp", "marin": "selection", "marco": "selection"}.get(algs[idx[0]], algs[idx[0]])
        assert all({"dp": "dp", "marin": "selection", "marco": "selection"}.get(algs[b], algs[b]) == kind for b in idx)
        kinds.append(kind)
    order = ["dp", "selection", "mardecun", "mardec"]
    assert kinds == [k for k in order if k in kinds] and len(kinds) >= 3


def test_regime_split_warm_and_pure_dp_paths(split_case):
    probs, je, te, _, ht = split_case
    s1 = te.cache_stats()
    X2 = solve_both(je, te, probs, split_regimes=True)  # same shapes: pure hits
    np.testing.assert_array_equal(X2, ht.result())
    s2 = te.cache_stats()
    assert s2["compiles"] == s1["compiles"] and s2["hits"] > s1["hits"]
    assert_same_stats(je, te)
    # a pure-DP batch takes the plain path: a SweepHandle whose k_last works
    dp_probs = [p for p, a in zip(probs, tsched.select_algorithm_batch(port(probs))) if a == "dp"]
    h_dp = te.dispatch(port(dp_probs), split_regimes=True)
    assert isinstance(h_dp, tsweep.SweepHandle) and h_dp.k_last().shape[0] == len(dp_probs)
    np.testing.assert_array_equal(h_dp.result(), tdp.solve_schedule_dp_batch(port(dp_probs), device=CPU))


def test_unsplit_default_is_the_uncached_dp():
    probs = port(random_mixed_problems(np.random.default_rng(13), 6))
    X = tsweep.SweepEngine(device=CPU).solve(probs)
    np.testing.assert_array_equal(X, tdp.solve_schedule_dp_batch(probs, device=CPU))


# ---------------------------------------------------------------------------
# threads
# ---------------------------------------------------------------------------


def test_dispatch_thread_safe_under_concurrent_producers():
    """Threads dispatching and materializing against ONE engine — including
    threads racing .result()/.k_last() on a SHARED handle — neither crash
    nor corrupt results."""
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(8):
        probs = port(random_mixed_problems(rng, int(rng.integers(1, 5))))
        batches.append((tprob.ProblemBatch.from_problems(probs), tdp.solve_schedule_dp_batch(probs, device=CPU)))
    eng = tsweep.SweepEngine(device=CPU)
    eng.solve(batches[0][0])
    errors = []
    barrier = threading.Barrier(6)

    def producer(tid):
        try:
            barrier.wait(timeout=60)
            for r in range(6):
                batch, X_ref = batches[(tid + r) % len(batches)]
                X = eng.dispatch(batch, split_regimes=bool((tid + r) % 2)).result()
                assert np.array_equal(X[: batch.B, : batch.n], X_ref), (tid, r)
        except BaseException as e:  # surface into the main thread
            errors.append(e)

    shared_batch, shared_ref = batches[1]
    shared_handle = eng.dispatch(shared_batch)

    def drainer():
        try:
            barrier.wait(timeout=60)
            for _ in range(4):
                assert np.array_equal(shared_handle.result()[: shared_batch.B, : shared_batch.n], shared_ref)
                assert shared_handle.k_last().shape[0] == shared_handle.result().shape[0]
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(4)]
    threads += [threading.Thread(target=drainer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "deadlocked thread"
    assert not errors, errors


def test_eight_producers_on_one_bucket_each_get_their_own_answer():
    """Eight threads solve eight different batches of ONE bucket at once:
    the bucket's plan (on the card, its static buffers) is shared, and each
    handle must still hold its own batch's answer."""
    import sys

    rng = np.random.default_rng(8)
    batches = [[tprob.Problem(T=12, lower=np.zeros(5, np.int64), upper=np.full(5, 12),
                              cost_tables=tuple(np.concatenate([[0.0], rng.uniform(0, 10, 12)]) for _ in range(5)))
                for _ in range(3)] for _ in range(8)]
    refs = [tdp.solve_schedule_dp_batch(b, device=CPU) for b in batches]
    eng = tsweep.SweepEngine(device=CPU)
    keys = {("dp", 4) + tsweep.request_bucket(tprob.ProblemBatch.from_problems(b)) for b in batches}
    assert len(keys) == 1
    errors, barrier = [], threading.Barrier(8)

    def producer(i):
        try:
            barrier.wait(timeout=60)
            for _ in range(3):
                h = eng.dispatch(batches[i])
                assert np.array_equal(h.result(), refs[i]), i
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "deadlocked thread"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    s = eng.cache_stats()
    assert s["compiles"] == 1 and s["hits"] + s["misses"] == 24


def test_done_is_true_once_the_solve_has_landed():
    eng = tsweep.SweepEngine(device=CPU)
    probs = port(random_mixed_problems(np.random.default_rng(14), 4))
    h = eng.dispatch(probs)
    h.result()
    assert h.done()
    hs = eng.dispatch(probs, split_regimes=True)
    hs.result()
    assert hs.done()


# ---------------------------------------------------------------------------
# engines shared by the entry points; what is not ported
# ---------------------------------------------------------------------------


def test_schedule_batch_and_deadline_sweep_share_an_engine():
    import warnings

    rng = np.random.default_rng(5)
    jprobs = [jcosts.random_problem(rng, n=4, T=15, regime="arbitrary") for _ in range(4)]
    probs = port(jprobs)
    eng = tsweep.SweepEngine(device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        xs = tsched.schedule_batch(probs, "dp_batch", engine=eng)
        assert eng.cache_stats()["misses"] == 1
        xs2 = tsched.schedule_batch(port(drift(jprobs, 1.02)), "dp_batch", engine=eng)
        s = eng.cache_stats()
        assert s["hits"] == 1 and s["compiles"] == 1
        for p, x, x2 in zip(probs, xs, xs2):
            tprob.validate_schedule(p, x)
            tprob.validate_schedule(p, x2)
        # an explicit engine + a contradicting backend raises rather than
        # silently running the engine's kernel (dp_torch_cuda promises "cuda")
        with pytest.raises(ValueError, match="conflicts with engine.backend"):
            tsched.schedule_batch(probs, "dp_torch_cuda", engine=eng)

        jp = jcosts.random_problem(rng, n=5, T=30, regime="increasing")
        p = tprob.from_reference(jp)
        times = [np.arange(int(u) + 1) / s for u, s in zip(p.upper, rng.uniform(0.5, 3.0, size=5))]
        from repro_torch.core.mc2mkp import solve_schedule_dp

        x_free = solve_schedule_dp(p)
        d_max = max(float(times[i][int(x_free[i])]) for i in range(5))
        deadlines = [d_max * f for f in (1.0, 1.5, 2.5, 10.0)]
        eng2 = tsweep.SweepEngine(device=CPU)
        X1 = tsched.deadline_sweep(p, times, deadlines, engine=eng2)
        X2 = tsched.deadline_sweep(p, times, deadlines, engine=eng2)
        from repro.core import scheduler as jsched

        np.testing.assert_array_equal(X1, jsched.deadline_sweep(jp, times, deadlines))
    np.testing.assert_array_equal(X1, X2)
    s = eng2.cache_stats()
    assert s["compiles"] == 1 and s["hits"] == 1


def test_default_engines_key_on_the_resolved_backend_and_device():
    tsweep.reset_default_engines()
    try:
        eng = tsweep.default_engine("auto", CPU)
        assert eng.backend == "blocked" and eng.device.type == "cpu"
        assert tsweep.default_engine("blocked", "cpu") is eng
        assert tsweep.default_engine("ref", CPU) is not eng
        assert tsweep._resolve_engine(None, None, CPU) is eng
        assert tsweep._resolve_engine("blocked", eng) is eng
        with pytest.raises(ValueError, match="conflicts"):
            tsweep._resolve_engine("ref", eng)
    finally:
        tsweep.reset_default_engines()


def test_multi_gpu_sweeps_raise_not_implemented():
    """The mesh entry points run now (the name is older than them and is
    kept so that test reports stay comparable across the port's history:
    read it as "multi-device sweeps run, and refuse a malformed mesh").
    ``tests/test_torch_multi_device.py`` holds them against the reference."""
    mesh = tsweep.make_sweep_mesh(device=CPU)
    assert mesh.axis_names == ("sweep",) and mesh.shape["sweep"] == mesh.devices.size == 1
    probs = random_mixed_problems(np.random.default_rng(4), 3)
    want = tdp.solve_schedule_dp_batch(probs, device=CPU)
    for kw in ({"mesh": mesh}, {"ring_mesh": mesh}):
        np.testing.assert_array_equal(tsweep.SweepEngine(device=CPU, **kw).solve(probs), want)
    costs = tdp.pack_problem(tprob.remove_lower_limits(tprob.ProblemBatch.from_problems(probs)), CPU)
    t_star = [int(p.T - p.lower.sum()) for p in probs]
    T = max(t_star)
    X, k_last = tdp.solve_fused_batch_ring(costs, t_star, T, "ref", mesh, "sweep")
    Xw, kw = tdp.solve_fused_batch_torch(costs, t_star, T, backend="ref")
    assert torch.equal(X, Xw) and torch.equal(k_last.view(torch.int32), kw.view(torch.int32))
    for kw in ({"mesh": object()}, {"ring_mesh": object()}):
        with pytest.raises((TypeError, ValueError)):
            tsweep.SweepEngine(device=CPU, **kw)
    with pytest.raises((TypeError, ValueError)):
        tdp.solve_fused_batch_ring(costs, t_star, T, "ref", object(), "sweep")
    with pytest.raises(ValueError):
        tsweep.SweepEngine(device=CPU, max_entries=0)
