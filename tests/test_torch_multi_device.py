"""The port's multi-device sweeps against the JAX package, on the CPU: the
sweep engine's batch sharding (``SweepEngine(mesh=)``), its class-axis ring
(``SweepEngine(ring_mesh=)``, ``solve_fused_batch_ring``) and the backtrack
wrapper the ring's reverse walk launches.

A sweep mesh here is the CPU repeated (8 positions, the counterpart of the
reference's ``--xla_force_host_platform_device_count=8``), so every position
runs the plain versions. Schedules must be identical to the reference's
single-device solve, ``K_last`` rows bit-identical float32 and
``cache_stats()`` as the reference's tests assert
(``tests/test_sweep_engine.py``, ``tests/test_fleet.py``: the same cases,
in process). The JAX side runs as its own tests run it here: engine backend
``"blocked"``, fused solve backend ``"ref"``.
"""

import numpy as np
import pytest
import torch

from repro.core import Solver as JSolver
from repro.core import SweepEngine as JSweepEngine
from repro.core import costs as jcosts
from repro.core import jax_dp as jdp
from repro.core import problem as jprob
from repro.core import solve_schedule_dp_batch as jsolve_dp_batch
from repro_torch.core import Solver, SweepEngine, from_reference
from repro_torch.core import torch_dp as tdp
from repro_torch.core.sweep import SweepMesh, make_sweep_mesh
from repro_torch.kernels import minplus as mp
from repro_torch.kernels.ref import backtrack_ref
from repro_torch.serve import SchedulerService

CPU = "cpu"
REGIMES = ("arbitrary", "linear", "increasing", "decreasing")


def cpu_mesh(size):
    return SweepMesh([CPU] * size)


def port(probs):
    return [from_reference(p) for p in probs]


def drift(probs, factor):
    return [jprob.Problem(T=p.T, lower=p.lower, upper=p.upper, cost_tables=tuple(t * factor for t in p.cost_tables))
            for p in probs]


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("size", [8, 3])
def test_batch_mesh_matches_the_single_device_solve(size):
    """``tests/test_sweep_engine.py``'s sharded case: B = 5 over 8 positions
    (the pow2 bucket 8, one row a position), a drifted re-solve that stays
    warm, and B = 3, whose bucket rounds up to the mesh; 3 positions round
    the buckets 8 and 4 up to 9 and 6."""
    rng = np.random.default_rng(5)
    probs = [jcosts.random_problem(rng, n=int(rng.integers(2, 6)), T=int(rng.integers(6, 20)),
                                   regime=REGIMES[b % len(REGIMES)]) for b in range(5)]
    mesh = cpu_mesh(size)
    assert mesh.devices.size == mesh.shape["sweep"] == size
    eng, one, jeng = SweepEngine(mesh=mesh, device=CPU), SweepEngine(device=CPU), JSweepEngine()
    h = eng.dispatch(port(probs))
    want = jeng.dispatch(probs)
    np.testing.assert_array_equal(h.result(), np.asarray(want.result()))
    np.testing.assert_array_equal(h.result(), jsolve_dp_batch(probs))
    np.testing.assert_array_equal(h.result(), one.solve(port(probs)))
    np.testing.assert_array_equal(bits(h.k_last()), bits(want.k_last()))
    assert h.done() and len(h._raw) == size

    probs2 = drift(probs, 1.03)
    np.testing.assert_array_equal(eng.solve(port(probs2)), jsolve_dp_batch(probs2))
    jeng.solve(probs2)
    s = eng.cache_stats()
    assert s["compiles"] == 1 and s["hits"] == 1, s
    if size == 8:  # the reference's unsharded bucket is the mesh's
        assert s == jeng.cache_stats()
    else:
        assert [k[:2] for k in eng._cache] == [("dp", 9)]

    np.testing.assert_array_equal(eng.solve(port(probs[:3])), jsolve_dp_batch(probs[:3]))
    s = eng.cache_stats()
    # the pow2 bucket 4 rounds up to 8 positions (the bucket of B = 5: warm)
    # or to 6 of 3 (a bucket of its own)
    assert (s["compiles"], s["hits"]) == ((1, 2) if size == 8 else (2, 1)), s
    assert next(reversed(eng._cache))[1] == (8 if size == 8 else 6)


def test_ring_matches_the_unsharded_reference_engine():
    """``tests/test_fleet.py``'s ring case: six instances over a ring of 8
    positions, against the reference's unsharded engine and uncached
    solve, with ``K_last`` bit for bit and the same ``cache_stats()``."""
    rng = np.random.default_rng(7)
    probs = [jcosts.random_problem(rng, n=int(rng.integers(3, 12)), T=int(rng.integers(8, 30)),
                                   regime=REGIMES[b % len(REGIMES)]) for b in range(6)]
    eng, jeng = SweepEngine(ring_mesh=cpu_mesh(8), device=CPU), JSweepEngine()
    h, want = eng.dispatch(port(probs)), jeng.dispatch(probs)
    np.testing.assert_array_equal(h.result(), np.asarray(want.result()))
    np.testing.assert_array_equal(h.result(), jsolve_dp_batch(probs))
    np.testing.assert_array_equal(bits(h.k_last()), bits(want.k_last()))
    np.testing.assert_array_equal(h.objectives(), np.asarray(want.objectives()))
    assert eng.cache_stats() == jeng.cache_stats()
    # n = 3 rounds its bucket 4 up to the ring: 8 classes, one a position
    small = [jcosts.random_problem(np.random.default_rng(8), n=3, T=9)]
    np.testing.assert_array_equal(eng.solve(port(small)), jsolve_dp_batch(small))
    assert next(reversed(eng._cache))[:3] == ("dp", 1, 8)


@pytest.mark.parametrize("backend", ["ref", "blocked", "cuda"])
@pytest.mark.parametrize("size", [2, 4, 8])
def test_solve_fused_batch_ring_matches_the_reference_fused_solve(size, backend):
    """``X`` and ``K_last`` of the ring against the reference's unsharded
    fused solve (whose own tests prove its ring equal to it); backend
    ``"cuda"`` on CPU tensors runs the wrappers' plain versions."""
    rng = np.random.default_rng(11)
    batch = jprob.ProblemBatch.from_problems(
        [jcosts.random_problem(rng, n=8, T=int(rng.integers(20, 40)), regime=REGIMES[b % 4]) for b in range(3)])
    b0 = jprob.remove_lower_limits(batch)
    costs = np.array(jdp.pack_problem(b0))
    T = int(b0.T.max())
    Xw, Kw = jdp.solve_fused_batch_jax(costs, np.asarray(b0.T, np.int32), T)
    before = mp.launches_backtrack
    X, K = tdp.solve_fused_batch_ring(torch.from_numpy(costs), b0.T, T, backend, cpu_mesh(size), "sweep")
    assert mp.launches_backtrack == before  # the CPU launches nothing
    assert X.dtype == torch.int32 and X.shape == (3, 8) and K.shape == (3, T + 1)
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xw))
    np.testing.assert_array_equal(bits(K.numpy()), bits(Kw))


def test_mesh_and_ring_mesh_are_mutually_exclusive():
    mesh = cpu_mesh(8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        SweepEngine(mesh=mesh, ring_mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match="conflict"):
        SweepEngine(mesh=SweepMesh(["meta"] * 2), device=CPU)
    with pytest.raises(ValueError, match="not an axis"):
        SweepEngine(ring_mesh=mesh, ring_axis="batch", device=CPU)
    with pytest.raises(ValueError, match="one type"):
        SweepMesh([CPU, "meta"])
    m = make_sweep_mesh("batch", device=CPU)
    assert m.axis_names == ("batch",) and m.positions == (torch.device(CPU),)
    assert SweepEngine(mesh=m, mesh_axis="batch", device=CPU).mesh_axis == "batch"


def test_ring_refuses_a_class_axis_it_cannot_split():
    costs = torch.zeros((2, 6, 3))
    with pytest.raises(ValueError, match="not divisible by the ring size 4"):
        tdp.solve_fused_batch_ring(costs, [0, 0], 4, "ref", cpu_mesh(4), "sweep")
    with pytest.raises(ValueError, match="t_star"):
        tdp.solve_fused_batch_ring(costs, [0, 5], 4, "ref", cpu_mesh(2), "sweep")


def test_fleet_on_a_ring_engine_is_exact_at_quantum_one():
    """The reference's fleet-on-ring case: clusters of 4 at ``quantum=1``
    give the flat DP's objective; and the same solution as on one device."""
    jp = jcosts.random_problem(np.random.default_rng(3), n=16, T=40)
    p = from_reference(jp)
    fsol = Solver(engine=SweepEngine(ring_mesh=cpu_mesh(8), device=CPU)).solve_fleet(p, clusters=4, quantum=1)
    flat = JSolver(engine=JSweepEngine()).solve([jp], algorithm="dp_batch")
    assert abs(fsol.objective - float(flat.objectives[0])) <= 1e-6
    one = Solver(engine=SweepEngine(device=CPU)).solve_fleet(p, clusters=4, quantum=1)
    np.testing.assert_array_equal(fsol.schedule, one.schedule)
    np.testing.assert_array_equal(bits(fsol.curves), bits(one.curves))


@pytest.mark.parametrize("kw", [{"mesh": cpu_mesh(4)}, {"ring_mesh": cpu_mesh(4)}])
def test_service_serves_over_a_mesh_engine(kw):
    """The scheduling service dispatches to a mesh engine unchanged."""
    rng = np.random.default_rng(21)
    reqs = [[jcosts.random_problem(rng, n=8, T=24)] for _ in range(6)]
    svc = SchedulerService(engine=SweepEngine(device=CPU, **kw), max_batch=4, max_delay_s=0.001)
    try:
        futs = [svc.submit(port(r)) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
    finally:
        svc.close(timeout=60)
    for r, x in zip(reqs, got):
        np.testing.assert_array_equal(x, jsolve_dp_batch(r))


def test_backtrack_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    n, B, Tp = 9, 5, 40
    I = torch.from_numpy(rng.integers(0, 4, (n, B, Tp)).astype(np.int32))
    t = torch.from_numpy(rng.integers(30, Tp, B).astype(np.int32))
    before = mp.launches_backtrack
    X = mp.minplus_backtrack_cuda(I, t)
    assert mp.launches_backtrack == before
    assert X.dtype == torch.int32 and X.shape == (B, n)
    assert torch.equal(X, backtrack_ref(I, t))
    assert mp.minplus_backtrack_cuda(I[:0], t).shape == (B, 0)
    with pytest.raises(TypeError):
        mp.minplus_backtrack_cuda(I, t.float())
    with pytest.raises(ValueError):
        mp.minplus_backtrack_cuda(I, t[:3])
    with pytest.raises(TypeError):
        mp.minplus_backtrack_cuda(I.long(), t)
