"""Builders and comparisons shared by the FL runtime's parity tests
(``tests/test_torch_fl_*.py``, ``test_torch_adaptive.py``,
``test_torch_faults.py``): the same seeded fleet, client data and toy-LM
starting parameters in the JAX package and in the port.

The toy LM's starting parameters are the JAX package's
``make_tiny_lm(...)[0](PRNGKey(seed))`` as numpy, copied into CPU tensors
for the port (``jax.random`` and torch draw different streams). Planning
runs on the CPU in both: the port's engine is ``SweepEngine(device="cpu")``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import repro.fl as jfl
from repro.core.sweep import SweepEngine as JSweepEngine
from repro.data import client_corpora as j_client_corpora
from repro.data import make_lm_examples as j_make_lm_examples
from repro.fl.toy import make_tiny_lm as j_make_tiny_lm
from repro.optim import sgd as j_sgd
from repro_torch import fl as tfl
from repro_torch.core.sweep import SweepEngine
from repro_torch.data import client_corpora, make_lm_examples
from repro_torch.fl.toy import make_tiny_lm
from repro_torch.optim import sgd

VOCAB = 64
DIM = 16
SEQ = 8
CPU = "cpu"
# toy-LM losses and parameters, port against the reference after a few rounds
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5

j_init, j_loss = j_make_tiny_lm(VOCAB, DIM)
t_init, t_loss = make_tiny_lm(VOCAB, DIM)


def jax_params_np(seed: int) -> dict:
    return {k: np.asarray(v) for k, v in j_init(jax.random.PRNGKey(seed)).items()}


def torch_params(tree: dict) -> dict:
    return {k: torch.tensor(v) for k, v in tree.items()}


def _world(fl, corpora, lm_examples, seed, n_clients, max_batches=8, tokens=400, vocab=VOCAB, seq=SEQ):
    rng = np.random.default_rng(seed)
    fleet = fl.make_fleet(rng, n_clients, max_batches=max_batches)
    est = fl.EnergyEstimator(fleet)
    est.calibrate(rng)
    examples = [lm_examples(c, seq) for c in corpora(rng, n_clients, tokens, vocab)]
    return est, examples, rng, sum(d.max_batches for d in fleet) // 2


def build_port(seed=0, n_clients=5, engine=None, policy_kwargs=None, lr=0.3, params_seed=None, **world):
    """``(server, examples, rng, T)`` of the port: the reference tests'
    ``_build`` with the JAX starting parameters and a CPU engine."""
    est, examples, rng, T = _world(tfl, client_corpora, make_lm_examples, seed, n_clients, **world)
    policy = tfl.PlanPolicy(engine=engine if engine is not None else SweepEngine(device=CPU),
                            **(policy_kwargs or {}))
    params = torch_params(jax_params_np(seed if params_seed is None else params_seed))
    server = tfl.FederatedServer(t_loss, params, sgd(lr), est, policy=policy)
    return server, examples, rng, T


def build_ref(seed=0, n_clients=5, engine=None, policy_kwargs=None, lr=0.3, params_seed=None, **world):
    """The same campaign in the JAX package."""
    est, examples, rng, T = _world(jfl, j_client_corpora, j_make_lm_examples, seed, n_clients, **world)
    policy = jfl.PlanPolicy(engine=engine if engine is not None else JSweepEngine(), **(policy_kwargs or {}))
    params = j_init(jax.random.PRNGKey(seed if params_seed is None else params_seed))
    server = jfl.FederatedServer(j_loss, params, j_sgd(lr), est, policy=policy)
    return server, examples, rng, T


def params_np(params) -> list:
    """The leaves of a JAX or port tree as numpy, in sorted-key order."""
    if isinstance(params, dict) and all(isinstance(v, torch.Tensor) for v in params.values()):
        return [params[k].detach().cpu().numpy() for k in sorted(params)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def assert_histories_equal(a, b):
    """Two port campaigns: bit for bit (the reference tests' helper)."""
    assert len(a.rounds) == len(b.rounds)
    for ra, rb in zip(a.rounds, b.rounds):
        np.testing.assert_array_equal(ra.assignments, rb.assignments)
        assert ra.mean_loss == rb.mean_loss
        assert ra.energy_joules == rb.energy_joules
        assert ra.estimated_joules == rb.estimated_joules
        assert ra.makespan_joules == rb.makespan_joules
        da = None if ra.adaptive is None else ra.adaptive.as_dict()
        db = None if rb.adaptive is None else rb.adaptive.as_dict()
        assert da == db
        assert (ra.scenarios is None) == (rb.scenarios is None)
        if ra.scenarios is not None:
            assert ra.scenarios.labels == rb.scenarios.labels
            np.testing.assert_array_equal(ra.scenarios.assignments, rb.scenarios.assignments)
            np.testing.assert_array_equal(ra.scenarios.energies, rb.scenarios.energies)
    np.testing.assert_array_equal(a.losses, b.losses)
    assert a.total_energy == b.total_energy
    assert a.adaptive_stats == b.adaptive_stats


def assert_params_equal(pa, pb):
    for x, y in zip(params_np(pa), params_np(pb)):
        np.testing.assert_array_equal(x, y)


def assert_matches_reference(ref, port, ref_params=None, port_params=None):
    """A port campaign against the reference's: schedules, true and
    estimated energies, makespans, recoveries and adaptive telemetry exactly;
    scenario energies within rtol 1e-6 (the selection's float32 sums);
    losses within rtol LOSS_RTOL; parameters within atol PARAM_ATOL."""
    assert len(ref.rounds) == len(port.rounds)
    for rj, rt in zip(ref.rounds, port.rounds):
        assert rj.round_index == rt.round_index
        np.testing.assert_array_equal(np.asarray(rj.assignments), np.asarray(rt.assignments))
        assert rj.energy_joules == rt.energy_joules
        assert rj.estimated_joules == rt.estimated_joules
        assert rj.makespan_joules == rt.makespan_joules
        np.testing.assert_allclose(rt.mean_loss, rj.mean_loss, rtol=LOSS_RTOL)
        assert (rj.scenarios is None) == (rt.scenarios is None)
        if rj.scenarios is not None:
            assert rj.scenarios.labels == rt.scenarios.labels
            np.testing.assert_array_equal(rj.scenarios.assignments, rt.scenarios.assignments)
            np.testing.assert_allclose(rt.scenarios.energies, rj.scenarios.energies, rtol=1e-6)
        assert (rj.recovery is None) == (rt.recovery is None)
        if rj.recovery is not None:
            a, b = rj.recovery, rt.recovery
            for f in ("completed", "assignments_original", "recovery_assignments"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert (a.failed_clients, a.straggler_clients, a.residual_T, a.shortfall, a.fallback) == (
                b.failed_clients, b.straggler_clients, b.residual_T, b.shortfall, b.fallback)
            assert a.est_overhead_J == b.est_overhead_J
        da = None if rj.adaptive is None else rj.adaptive.as_dict()
        db = None if rt.adaptive is None else rt.adaptive.as_dict()
        assert da == db
    assert ref.total_energy == port.total_energy
    assert ref.adaptive_stats == port.adaptive_stats
    if ref_params is not None:
        for x, y in zip(params_np(ref_params), params_np(port_params)):
            np.testing.assert_allclose(y, x, rtol=0, atol=PARAM_ATOL)

