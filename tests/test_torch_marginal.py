"""The port's monotone-regime algorithms and their dispatch against the JAX
package: the serial MarIn/MarCo/MarDecUn/MarDec and the baselines
(``core/marginal.py``, ``core/baselines.py``, numpy copies), the batched
forms (``core/marginal_torch.py``: the selection as torch ops on CPU
tensors) and the paper Table 2 dispatch, on the same numpy-seeded instances.

Schedules and algorithm names must be identical to the reference's, the
selection's objectives within rtol 1e-6 (a float32 sum taken in another
order), host objectives equal. Parity instances use float32-representable
cost tables (integer-valued or rounded once) where the batched selection is
compared with the float64 serial oracles, as the reference's own tests do.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import marginal as jmarg
from repro.core import marginal_jax as jmj
from repro.core import baselines as jbase
from repro.core import jax_dp as jdp
from repro.core import mc2mkp as jmc
from repro.core import problem as jprob
from repro.core import scheduler as jsched
from repro_torch.core import baselines as tbase
from repro_torch.core import costs as tcosts
from repro_torch.core import marginal as tmarg
from repro_torch.core import marginal_torch as tmt
from repro_torch.core import mc2mkp as tmc
from repro_torch.core import problem as tprob
from repro_torch.core import scheduler as tsched
from repro_torch.core import torch_dp as tdp

CPU = "cpu"
# one fixed envelope for the batched parity tests: the reference's jitted
# selection compiles once for the whole module
ENV_B, ENV_N, ENV_W = 8, 8, 32
REGIMES = ("arbitrary", "linear", "increasing", "decreasing")


@pytest.fixture(autouse=True)
def _quiet_shims():
    """The deprecated shims (``schedule``, ``schedule_batch``, ...) warn once
    per process; these tests read none of their warnings."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def f32_safe(p):
    """The instance the float32 paths actually see (tables rounded once)."""
    return jprob.Problem(
        T=p.T, lower=p.lower, upper=p.upper,
        cost_tables=tuple(t.astype(np.float32).astype(np.float64) for t in p.cost_tables),
    )


def integer_increasing_problem(rng, n, T, max_u=None, max_marginal=6, with_lower=True):
    """Increasing-marginal instance with INTEGER tables: exact in float32
    and riddled with exact marginal ties — the tie-break torture case."""
    max_u = max_u or min(T, ENV_W - 1)
    while True:
        upper = rng.integers(1, max_u + 1, size=n)
        if upper.sum() >= T:
            break
    lower = np.minimum(rng.integers(0, 3, size=n), upper) if with_lower else np.zeros(n, np.int64)
    while lower.sum() > T:
        k = int(rng.integers(0, n))
        lower[k] = max(0, lower[k] - 1)
    tables = tuple(
        np.concatenate([[0.0], np.cumsum(np.sort(rng.integers(0, max_marginal, size=int(u))))]).astype(np.float64)
        for u in upper
    )
    return jprob.Problem(T=T, lower=lower, upper=upper, cost_tables=tables)


def padded(problems):
    return jprob.ProblemBatch.from_problems(problems).pad_to(B=ENV_B, n=ENV_N, W=ENV_W)


def port(obj):
    return tprob.from_reference(obj)


def assert_batched_matches(jfn, tfn, serial, jbatch, probs):
    """The reference's batched function, the port's and the serial oracle
    agree row for row; phantom rows and columns stay empty."""
    Xj = jfn(jbatch)
    Xt = tfn(port(jbatch))
    assert Xt.dtype == np.int64
    np.testing.assert_array_equal(Xt, Xj)
    for b, p in enumerate(probs):
        assert np.array_equal(Xt[b, : p.n], serial(port(p))), (b, Xt[b])
        assert np.all(Xt[b, p.n :] == 0)
    assert np.all(Xt[len(probs) :] == 0)


# ---------------------------------------------------------------------------
# the selection (MarIn / MarCo) against the reference and the serial heap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_marin_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, ENV_B + 1))
    probs = [
        f32_safe(jcosts.random_problem(rng, n=int(rng.integers(1, ENV_N + 1)), T=int(rng.integers(1, 25)),
                                       regime="increasing", max_upper=ENV_W - 1))
        for _ in range(B)
    ]
    assert_batched_matches(jmj.marin_batch, lambda b: tmt.marin_batch(b, device=CPU), tmarg.marin, padded(probs), probs)


@pytest.mark.parametrize("seed", range(6))
def test_marin_batch_integer_tie_breaks(seed):
    rng = np.random.default_rng(100 + seed)
    B = int(rng.integers(1, ENV_B + 1))
    probs = [integer_increasing_problem(rng, n=int(rng.integers(1, ENV_N + 1)), T=int(rng.integers(1, 20)))
             for _ in range(B)]
    assert_batched_matches(jmj.marin_batch, lambda b: tmt.marin_batch(b, device=CPU), tmarg.marin, padded(probs), probs)


@pytest.mark.parametrize("seed", range(4))
def test_marco_batch_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    probs = []
    for _ in range(int(rng.integers(1, ENV_B + 1))):
        n = int(rng.integers(1, ENV_N + 1))
        while True:
            upper = rng.integers(1, ENV_W, size=n)
            T = int(rng.integers(1, 25))
            if upper.sum() >= T:
                break
        # integer per-task marginals with cross-resource ties: MarCo's
        # stable sort order is the thing under test
        tables = tuple(np.arange(int(u) + 1, dtype=np.float64) * int(rng.integers(1, 5)) for u in upper)
        probs.append(jprob.Problem(T=T, lower=np.zeros(n, np.int64), upper=upper, cost_tables=tables))
    assert_batched_matches(jmj.marco_batch, lambda b: tmt.marco_batch(b, device=CPU), tmarg.marco, padded(probs), probs)


def test_signed_zero_marginals_keep_the_heap_order():
    """Marginals of -0.0 and +0.0 tie, as in the serial heap and in the
    reference's sort: the lower resource index goes first. A sort on the
    float's bits would put the -0.0 units of resource 1 first."""
    neg = np.array([0.0, -0.0, -0.0, 3.0])  # marginals -0.0, +0.0, 3.0
    pos = np.array([0.0, 0.0, 0.0, 3.0])  # marginals +0.0, +0.0, 3.0
    for T in (1, 2, 3, 7):
        p = jprob.Problem(T=T, lower=[0, 0, 0], upper=[3, 3, 3], cost_tables=(pos, neg, pos.copy()))
        assert p.regime() == "increasing"
        b0 = tprob.remove_lower_limits(port(jprob.ProblemBatch.from_problems([p])))
        packed = tdp.pack_problem(b0, CPU)
        m = packed[0, 1, 1:] - packed[0, 1, :-1]
        assert torch.signbit(m[0]) and not torch.signbit(m[1])  # both zeros really occur
        want = jmarg.marin(p)
        assert np.array_equal(tmarg.marin(port(p)), want)
        assert np.array_equal(tmt.marin_batch([port(p)], device=CPU)[0], want), T
        assert np.array_equal(jmj.marin_batch([p])[0], want)
        assert T == 7 or want[0] == min(T, 2)  # resource 0's zeros go first
        x, obj = tmt.marginal_select(packed, torch.from_numpy(b0.upper), torch.from_numpy(b0.T))
        assert x[0].tolist() == want.tolist() and float(obj[0]) == (3.0 if T == 7 else 0.0)


def test_signed_zeros_keep_the_heap_order_under_a_sort_on_the_bits(monkeypatch):
    """The card's radix sort orders float32 by their bits (-0.0 before
    +0.0). Under a CPU sort that does the same, the selection still keeps
    the heap's order, because it turns every -0.0 marginal into +0.0."""
    plain_sort = torch.sort

    def sort_on_bits(x, dim=-1, stable=False):
        u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        key = torch.where(u >= 2**31, 0xFFFFFFFF - u, u + 2**31)  # the radix order of float32
        order = plain_sort(key, dim=dim, stable=True).indices
        return x.gather(dim, order), order

    neg = np.array([0.0, -0.0, -0.0, 3.0])
    pos = np.array([0.0, 0.0, 0.0, 3.0])
    probs = [jprob.Problem(T=T, lower=[0, 0, 0], upper=[3, 3, 3], cost_tables=(pos, neg, pos.copy())) for T in (1, 2, 3, 7)]
    b0 = tprob.remove_lower_limits(port(jprob.ProblemBatch.from_problems(probs)))
    packed = tdp.pack_problem(b0, CPU)
    monkeypatch.setattr(torch, "sort", sort_on_bits)
    x, _ = tmt.marginal_select(packed, torch.from_numpy(b0.upper), torch.from_numpy(b0.T))
    assert x.tolist() == [jmarg.marin(p).tolist() for p in probs]


@pytest.mark.parametrize("seed", range(3))
def test_marginal_select_objective_matches_reference(seed):
    """The selected-marginal totals: a float32 sum whose order differs from
    XLA's, held to rtol 1e-6; the picks themselves are identical."""
    rng = np.random.default_rng(300 + seed)
    probs = [f32_safe(jcosts.random_problem(rng, n=int(rng.integers(1, ENV_N + 1)), T=int(rng.integers(1, 25)),
                                            regime="increasing", max_upper=ENV_W - 1)) for _ in range(ENV_B)]
    jb0 = jprob.remove_lower_limits(padded(probs))
    xj, oj = jmj.marginal_select_jax(jdp.pack_problem(jb0), np.asarray(jb0.upper, np.int32), np.asarray(jb0.T, np.int32))
    tb0 = port(jb0)
    xt, ot = tmt.marginal_select(tdp.pack_problem(tb0, CPU), torch.from_numpy(tb0.upper), torch.from_numpy(tb0.T))
    assert xt.dtype == torch.int32 and ot.dtype == torch.float32
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6)


def test_marginal_batch_dp_objective_equality():
    """On monotone instances the fast path and the DP are both optimal:
    integer tables make the equality EXACT (float32 sums below 2^24)."""
    rng = np.random.default_rng(7)
    probs = [port(integer_increasing_problem(rng, n=4, T=14, max_marginal=5)) for _ in range(6)]
    X = tmt.marin_batch(probs, device=CPU)
    X_dp = tdp.solve_schedule_dp_batch(probs, device=CPU)
    for b, p in enumerate(probs):
        tprob.validate_schedule(p, X[b, : p.n])
        assert tprob.total_cost(p, X[b, : p.n]) == tprob.total_cost(p, X_dp[b, : p.n])
        assert tprob.total_cost(p, X[b, : p.n]) == tprob.total_cost(p, tmc.solve_schedule_dp(p))


def test_marin_batch_with_every_resource_pinned():
    """W < 2 after the shift: every resource at its lower limit."""
    p = jprob.Problem(T=3, lower=[1, 2], upper=[1, 2], cost_tables=(np.array([0.0, 1.0]), np.array([0.0, 1.0, 2.0])))
    want = jmj.marin_batch([p])
    np.testing.assert_array_equal(tmt.marin_batch([port(p)], device=CPU), want)


# ---------------------------------------------------------------------------
# MarDecUn / MarDec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_mardecun_batch_matches_reference(seed):
    rng = np.random.default_rng(400 + seed)
    probs = []
    for _ in range(int(rng.integers(1, 7))):
        n, T = int(rng.integers(1, 6)), int(rng.integers(1, 15))
        tables = tuple(jcosts.sublinear_cost(T, float(rng.uniform(5, 40)), float(rng.uniform(2, 20))) for _ in range(n))
        probs.append(jprob.Problem(T=T, lower=np.zeros(n, np.int64), upper=np.full(n, T), cost_tables=tables))
    Xj = jmj.mardecun_batch(probs)
    Xt = tmt.mardecun_batch([port(p) for p in probs])
    np.testing.assert_array_equal(Xt, Xj)
    tb = port(jprob.ProblemBatch.from_problems(probs))
    for b, p in enumerate(probs):
        assert np.array_equal(Xt[b, : p.n], tmarg.mardecun(port(p)))
        # the serial algorithm agrees on the padded materialization too
        assert np.array_equal(Xt[b], tmarg.mardecun(tb.instance(b)))


def test_mardecun_capacity_guard():
    """Zero-capacity resources are ignored (dropout/padding); resources with
    SOME capacity below T still raise, serial and batched alike."""
    tbl = lambda u: np.concatenate([[0.0], 10 - np.arange(1, u + 1, dtype=np.float64) * 0.5]).cumsum()  # noqa: E731
    ok = tprob.Problem(T=6, lower=[0, 0], upper=[6, 0], cost_tables=(tbl(6), np.zeros(1)))
    x = tmarg.mardecun(ok)
    assert np.array_equal(x, tmt.mardecun_batch([ok])[0])
    assert np.array_equal(x, jmarg.mardecun(jprob.Problem(T=6, lower=[0, 0], upper=[6, 0],
                                                          cost_tables=(tbl(6), np.zeros(1)))))
    assert x.sum() == 6 and x[1] == 0
    bad = tprob.Problem(T=6, lower=[0, 0], upper=[6, 3], cost_tables=(tbl(6), tbl(3)))
    with pytest.raises(ValueError, match="MarDecUn requires"):
        tmarg.mardecun(bad)
    with pytest.raises(ValueError, match="MarDecUn requires"):
        tmt.mardecun_batch([bad])


@pytest.mark.parametrize("seed", range(4))
def test_mardec_batch_matches_reference(seed):
    rng = np.random.default_rng(500 + seed)
    probs = [jcosts.random_problem(rng, n=int(rng.integers(1, 5)), T=int(rng.integers(4, 14)), regime="decreasing")
             for _ in range(int(rng.integers(1, 6)))]
    Xj = jmj.mardec_batch(probs)
    Xt = tmt.mardec_batch([port(p) for p in probs])
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(tmt.mardec_batch(port(jprob.ProblemBatch.from_problems(probs))), Xt)
    for b, p in enumerate(probs):
        assert np.array_equal(Xt[b, : p.n], tmarg.mardec(port(p)))


# ---------------------------------------------------------------------------
# one shared dispatch rule (serial == batched, padding-invariant, == reference)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("seed", range(2))
def test_select_algorithm_matches_reference(regime, seed):
    rng = np.random.default_rng(600 + seed)
    probs = [jcosts.random_problem(rng, n=int(rng.integers(1, 6)), T=int(rng.integers(2, 20)), regime=regime)
             for _ in range(4)]
    tps = [port(p) for p in probs]
    batched = tmt.select_algorithm_batch(tps)
    assert batched == jmj.select_algorithm_batch(probs)
    pad = port(jprob.ProblemBatch.from_problems(probs).pad_to(B=8, n=8))
    assert tmt.select_algorithm_batch(pad)[:4] == batched  # padding cannot change dispatch
    for b, p in enumerate(tps):
        assert tsched.select_algorithm(p) == batched[b] == jsched.select_algorithm(probs[b])


def test_dropout_zero_capacity_dispatch():
    """A dropped-out client (U = 0) must not flip the dispatch rule or
    break the selected algorithm (paper §6 'loss of a device')."""
    n, T = 4, 9
    tables = [np.arange(13, dtype=np.float64) * c for c in (2.0, 3.0, 1.0, 2.0)]
    tables[1] = np.zeros(1)  # client 1 dropped: U = 0
    upper = np.array([12, 0, 12, 12])
    p = tprob.Problem(T=T, lower=np.zeros(n, np.int64), upper=upper, cost_tables=tuple(tables))
    jp = jprob.Problem(T=T, lower=np.zeros(n, np.int64), upper=upper, cost_tables=tuple(tables))
    assert p.regime() == "constant"
    assert tsched.select_algorithm(p) == jsched.select_algorithm(jp) == "mardecun"
    x = tsched.schedule(p, "auto", device=CPU)
    tprob.validate_schedule(p, x)
    assert total_equal(p, x, tmc.solve_schedule_dp(p))
    assert np.array_equal(x, tsched.schedule_batch([p], "auto", device=CPU)[0])
    assert np.array_equal(x, jsched.schedule(jp, "auto"))


def total_equal(p, x, y):
    return tprob.total_cost(p, x) == tprob.total_cost(p, y)


# ---------------------------------------------------------------------------
# the serial algorithms and baselines against the reference (paper Thms 2-5)
# ---------------------------------------------------------------------------


def instance(seed, regime, max_n=5, max_T=14):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, max_n + 1))
    T = int(rng.integers(max(1, n), max_T + 1))
    return jcosts.random_problem(rng, n=n, T=T, regime=regime)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("alg,regime", [("marin", "increasing"), ("marco", "linear"), ("mardec", "decreasing")])
def test_monotone_algorithm_matches_reference_and_is_optimal(alg, regime, seed):
    jp = instance(700 + seed, regime)
    p = port(jp)
    x = getattr(tmarg, alg)(p)
    np.testing.assert_array_equal(x, getattr(jmarg, alg)(jp))
    tprob.validate_schedule(p, x)
    assert tprob.total_cost(p, x) == pytest.approx(tprob.total_cost(p, tmc.solve_schedule_dp(p)), rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_mardecun_matches_reference_and_is_optimal(seed):
    rng = np.random.default_rng(800 + seed)
    n, T = int(rng.integers(1, 6)), int(rng.integers(1, 15))
    tables = tuple(jcosts.sublinear_cost(T, float(rng.uniform(5, 40)), float(rng.uniform(2, 20)),
                                         float(rng.uniform(0, 0.2))) for _ in range(n))
    jp = jprob.Problem(T=T, lower=np.zeros(n, int), upper=np.full(n, T), cost_tables=tables)
    p = port(jp)
    x = tmarg.mardecun(p)
    np.testing.assert_array_equal(x, jmarg.mardecun(jp))
    assert tprob.total_cost(p, x) == pytest.approx(tprob.total_cost(p, tmc.solve_schedule_dp(p)), rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("regime", REGIMES)
def test_baselines_match_reference(regime, seed):
    jp = instance(900 + seed, regime)
    p = port(jp)
    for name in ("olar", "uniform", "proportional", "greedy_marginal"):
        x = getattr(tbase, name)(p)
        tprob.validate_schedule(p, x)
        np.testing.assert_array_equal(x, getattr(jbase, name)(jp), err_msg=name)
    np.testing.assert_array_equal(tbase.random_schedule(p, np.random.default_rng(seed)),
                                  jbase.random_schedule(jp, np.random.default_rng(seed)))


def test_baselines_not_total_cost_optimal():
    """On a decreasing-marginal fleet, consolidation wins; spreading
    baselines must be strictly worse somewhere."""
    rng = np.random.default_rng(7)
    worse = {"olar": False, "uniform": False, "proportional": False}
    for _ in range(50):
        p = tcosts.random_problem(rng, n=4, T=12, regime="decreasing")
        opt = tprob.total_cost(p, tmc.solve_schedule_dp(p))
        for name in worse:
            if tprob.total_cost(p, getattr(tbase, name)(p)) > opt + 1e-9:
                worse[name] = True
    assert all(worse.values()), worse


@pytest.mark.parametrize("seed", range(4))
def test_auto_dispatch_matches_reference(seed):
    jp = instance(1000 + seed, REGIMES[seed % 4])
    p = port(jp)
    x, alg = tsched._schedule(p, "auto", device=CPU)
    jx = jsched.schedule(jp, "auto")
    np.testing.assert_array_equal(x, jx)
    assert alg == jsched.select_algorithm(jp)
    assert tprob.total_cost(p, x) == pytest.approx(tprob.total_cost(p, tmc.solve_schedule_dp(p)), rel=1e-9, abs=1e-9)


def test_schedule_with_deadline_matches_reference():
    rng = np.random.default_rng(5)
    n, T = 4, 20
    jp = jcosts.random_problem(rng, n=n, T=T, regime="increasing")
    p = port(jp)
    speeds = rng.uniform(0.5, 3.0, size=n)
    times = [np.arange(int(u) + 1) / s for u, s in zip(p.upper, speeds)]
    x_loose = tsched.schedule_with_deadline(p, times, deadline=1e9, device=CPU)
    np.testing.assert_array_equal(x_loose, jsched.schedule_with_deadline(jp, times, deadline=1e9))
    dl = max(float(times[i][int(x_loose[i])]) for i in range(n)) * 0.9 + 1e-9
    x_tight = tsched.schedule_with_deadline(p, times, deadline=dl, device=CPU)
    np.testing.assert_array_equal(x_tight, jsched.schedule_with_deadline(jp, times, deadline=dl))
    for i in range(n):
        assert times[i][int(x_tight[i])] <= dl + 1e-12
    assert tprob.total_cost(p, x_tight) >= tprob.total_cost(p, x_loose) - 1e-9
    with pytest.raises(ValueError):
        tsched.schedule_with_deadline(p, times, deadline=0.0, device=CPU)


# ---------------------------------------------------------------------------
# the paper's worked example (Section 3.1, Figs. 1-2)
# ---------------------------------------------------------------------------


def paper_problem(T, mod):
    c1 = np.array([0.0, 2, 3.5, 5.5, 8, 10, 12])  # C1(0) unused (L1=1)
    c2 = np.array([0.0, 1.5, 2.5, 4, 7, 9, 11])
    c3 = np.array([0.0, 3, 4, 5, 6, 7])
    return mod.Problem(T=T, lower=[1, 0, 0], upper=[6, 6, 5], cost_tables=(c1, c2, c3))


@pytest.mark.parametrize("T,want_x,want_c", [(5, [2, 3, 0], 7.5), (8, [1, 2, 5], 11.5)])
def test_paper_example(T, want_x, want_c):
    p = paper_problem(T, tprob)
    for alg in ("auto", "dp", "dp_torch", "dp_torch_cuda"):
        x = tsched.schedule(p, alg, device=CPU)
        assert list(x) == want_x, alg
        assert tprob.total_cost(p, x) == pytest.approx(want_c)
    assert list(jsched.schedule(paper_problem(T, jprob), "auto")) == want_x


def test_paper_example_matches_brute_force_and_greedy_insight():
    for T in range(1, 17):
        p = paper_problem(T, tprob)
        assert tprob.total_cost(p, tmc.solve_schedule_dp(p)) == pytest.approx(
            tprob.total_cost(p, tmc.brute_force_schedule(p)))
        assert np.array_equal(tmc.solve_schedule_dp(p), jmc.solve_schedule_dp(paper_problem(T, jprob)))
    # the T=8 optimum does not contain the T=5 optimum: greedy extension fails
    x5 = tmc.solve_schedule_dp(paper_problem(5, tprob))
    x8 = tmc.solve_schedule_dp(paper_problem(8, tprob))
    assert not np.all(x8 >= x5)
