"""The port's FL substrate on the CPU: the cases of the reference's
``tests/test_fl_substrate.py`` (optimizers, client training, FedAvg rounds,
energy accounting, the data pipeline, checkpoints) and their parity with
the JAX package, plus the FL launcher on SMOKE gemma2-2b.

Tolerances: SGD and momentum steps bit-identical in bfloat16; toy-LM
optimizer runs and ``local_train`` within atol 1e-6 (float32 reductions in
another order; AdamW 1e-5); schedules within rtol 1e-6; the numpy data pipeline
bit-identical; the SMOKE gemma2-2b round at the train tolerances of
``tests/test_torch_train.py`` (loss 2e-5; parameters rtol 2e-3, atol 2e-5),
its schedule and energies exactly.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fl import CPU, SEQ, VOCAB, build_port, build_ref, j_loss, jax_params_np, t_loss, torch_params

import repro.data as jdata
import repro.fl as jfl
import repro.optim as joptim
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.fl.client import local_train as j_local_train
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
import repro_torch.data as tdata
from repro_torch import optim as toptim
from repro_torch.checkpoint import latest_checkpoint, load_checkpoint, load_checkpoint_arrays, save_checkpoint
from repro_torch.data import client_corpora, dirichlet_sizes, lm_round_batches, make_lm_examples
from repro_torch.fl import EnergyEstimator, load_campaign_checkpoint, make_fleet, run_campaign
from repro_torch.fl.client import local_train, make_client_fn
from repro_torch.launch import train as launcher
from repro_torch.models import config_from_jax, params_from_jax
from repro_torch.optim import adamw, apply_updates, momentum, sgd, tree_leaves


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.int16).copy()).view(torch.bfloat16)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _value_and_grad(loss, params, batch):
    xs = {k: v.detach().requires_grad_() for k, v in params.items()}
    out = loss(xs, batch)
    grads = torch.autograd.grad(out, list(xs.values()))
    return out.detach(), dict(zip(xs, grads))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTS = {
    "sgd": (lambda: sgd(0.5), lambda: joptim.sgd(0.5)),
    "momentum": (lambda: momentum(0.3), lambda: joptim.momentum(0.3)),
    "nesterov": (lambda: momentum(0.3, nesterov=True), lambda: joptim.momentum(0.3, nesterov=True)),
    "adamw": (lambda: adamw(0.05), lambda: joptim.adamw(0.05)),
}


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_optimizers_reduce_loss_and_match_the_reference(opt_name):
    """20 toy-LM steps: the loss falls, and the parameters stay within atol
    1e-6 of the JAX package's on the same starting point and batch (AdamW
    1e-5: its step is lr-sized whatever the gradient, so float32 noise in a
    near-zero gradient moves it by more than it moves the others)."""
    t_opt, j_opt = OPTS[opt_name][0](), OPTS[opt_name][1]()
    tree = jax_params_np(0)
    batch = np.random.default_rng(1).integers(0, VOCAB, (8, SEQ + 1)).astype(np.int32)
    params, tb = torch_params(tree), torch.from_numpy(batch)
    state = t_opt.init(params)
    l0 = float(t_loss(params, tb))
    pj, jb = {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(batch)
    sj = j_opt.init(pj)
    for _ in range(20):
        _, grads = _value_and_grad(t_loss, params, tb)
        updates, state = t_opt.update(grads, state, params)
        params = apply_updates(params, updates)
        gj = jax.grad(j_loss)(pj, jb)
        uj, sj = j_opt.update(gj, sj, pj)
        pj = joptim.apply_updates(pj, uj)
    l1 = float(t_loss(params, tb))
    assert l1 < l0 and np.isfinite(l1)
    for k in tree:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(pj[k]), rtol=0,
                                   atol=1e-5 if opt_name == "adamw" else 1e-6)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "nesterov"])
def test_sgd_and_momentum_round_as_the_reference_in_bfloat16(opt_name):
    """``-lr * g`` with lr in the gradient's dtype, ``beta * m + g`` rounded
    after each operation, ``p + u`` in the parameter's: three bfloat16 steps
    bit for bit."""
    t_opt, j_opt = OPTS[opt_name][0](), OPTS[opt_name][1]()
    rng = np.random.default_rng(4)
    p = rng.normal(size=(4096,)).astype(np.float32)
    gs = [rng.normal(size=(4096,)).astype(np.float32) * 10.0 ** -k for k in range(3)]
    tp, pj = {"w": _bf16(p)}, {"w": jnp.asarray(p, jnp.bfloat16)}
    ts, sj = t_opt.init(tp), j_opt.init(pj)
    for g in gs:
        u, ts = t_opt.update({"w": _bf16(g)}, ts, tp)
        apply_updates(tp, u)
        uj, sj = j_opt.update({"w": jnp.asarray(g, jnp.bfloat16)}, sj, pj)
        pj = joptim.apply_updates(pj, uj)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tp["w"]), _bits(pj["w"]))


def test_adafactor_waits_for_the_moe_family():
    """Adafactor came with the MoE family: on a client-sized tree (a 2-D
    leaf, factored; a 1-D leaf; a list of layers, stacked as the reference
    stacks them) three steps match the reference's updates and moments
    within rtol 1e-6. A list of layers whose stacked layout is not given
    is refused."""
    rng = np.random.default_rng(6)
    shapes = {"w": (32, 16), "b": (16,)}
    p = {"w": rng.normal(size=shapes["w"]).astype(np.float32), "b": rng.normal(size=shapes["b"]).astype(np.float32),
         "layers": {"a": rng.normal(size=(3, 8, 4)).astype(np.float32)}}
    t_opt = toptim.get_optimizer("adafactor", 1e-2, stacks={"layers": (3,)})
    j_opt = joptim.get_optimizer("adafactor", 1e-2)
    to_t = lambda tree: {"w": torch.from_numpy(tree["w"]), "b": torch.from_numpy(tree["b"]),
                         "layers": [{"a": torch.from_numpy(tree["layers"]["a"][i])} for i in range(3)]}
    tp, pj = to_t(p), jax.tree.map(jnp.asarray, p)
    for stacks in ({}, {"layers": (2,)}):
        with pytest.raises(ValueError, match="layers"):
            toptim.get_optimizer("adafactor", 1e-2, stacks=stacks).init(tp)
    ts, sj = t_opt.init(tp), j_opt.init(pj)
    for k in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -k, p)
        u, ts = t_opt.update(to_t(g), ts, tp)
        uj, sj = j_opt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        np.testing.assert_allclose(u["w"].numpy(), np.asarray(uj["w"]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(u["b"].numpy(), np.asarray(uj["b"]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(torch.stack([x["a"] for x in u["layers"]]).numpy(), np.asarray(uj["layers"]["a"]),
                                   rtol=1e-6, atol=0)
        for name in ("w", "b"):
            np.testing.assert_allclose(ts.vr[name].numpy(), np.asarray(sj.vr[name]), rtol=1e-6)
        np.testing.assert_allclose(ts.vc["layers"]["a"].numpy(), np.asarray(sj.vc["layers"]["a"]), rtol=1e-6)
    assert toptim.get_optimizer("sgd", 0.1).init({"w": torch.ones(2)}) == ()


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine", "linear_decay"])
def test_schedules_match_the_reference(name):
    args = {"constant": (0.3,), "cosine": (0.3, 50), "warmup_cosine": (0.3, 10, 50), "linear_decay": (0.3, 50)}[name]
    t_fn, j_fn = getattr(toptim, name)(*args), getattr(joptim, name)(*args)
    steps = np.arange(0, 60, dtype=np.int32)
    got = np.array([float(t_fn(torch.tensor(int(s)))) for s in steps])
    want = np.array([float(j_fn(jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert t_fn(torch.tensor(3)).dtype == torch.float32


# ---------------------------------------------------------------------------
# client training
# ---------------------------------------------------------------------------


def test_local_train_masking_exact():
    """num_steps=k equals a manual k-step run; num_steps=0 changes nothing
    and reports 0.0; the caller's parameters are left as they are."""
    params = torch_params(jax_params_np(0))
    before = {k: v.clone() for k, v in params.items()}
    batches = torch.from_numpy(np.random.default_rng(2).integers(0, VOCAB, (5, 4, SEQ + 1)).astype(np.int32))
    opt = sgd(0.1)

    p3, loss3 = local_train(t_loss, opt, params, batches, 3)
    q, losses = {k: v.clone() for k, v in params.items()}, []
    for s in range(3):
        loss, g = _value_and_grad(t_loss, q, batches[s])
        u, _ = opt.update(g, (), q)
        q = apply_updates(q, u)
        losses.append(loss)
    for k in q:
        assert torch.equal(p3[k], q[k])
        assert torch.equal(params[k], before[k])
    assert loss3.dtype == torch.float32 and loss3.dim() == 0
    assert float(loss3) == float((losses[0] + losses[1] + losses[2]) / 3.0)

    p0, loss0 = make_client_fn(t_loss, opt)(params, batches, torch.tensor(0))
    for k in p0:
        assert torch.equal(p0[k], params[k])
    assert float(loss0) == 0.0


@pytest.mark.parametrize("k", [0, 3, 5])
def test_local_train_matches_the_reference_masked_scan(k):
    tree = jax_params_np(1)
    batches = np.random.default_rng(3).integers(0, VOCAB, (5, 4, SEQ + 1)).astype(np.int32)
    p_t, l_t = local_train(t_loss, sgd(0.3), torch_params(tree), torch.from_numpy(batches), k)
    p_j, l_j = j_local_train(j_loss, joptim.sgd(0.3), jax.tree.map(jnp.asarray, tree), jnp.asarray(batches),
                             jnp.asarray(k))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-6, atol=0)
    for key in tree:
        np.testing.assert_allclose(p_t[key].numpy(), np.asarray(p_j[key]), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# data pipeline: numpy copies, the same draws
# ---------------------------------------------------------------------------


def test_data_pipeline_shapes_and_coverage():
    rng = np.random.default_rng(0)
    corpora = client_corpora(rng, n_clients=4, tokens_per_client=500, vocab_size=VOCAB)
    sizes = dirichlet_sizes(rng, 4, 2000, alpha=0.5)
    assert sizes.sum() == 2000 and np.all(sizes >= 1)
    examples = [make_lm_examples(c, SEQ) for c in corpora]
    for ex in examples:
        assert ex.shape[1] == SEQ + 1 and ex.dtype == np.int32
    b0 = lm_round_batches(examples, max_steps=6, batch_size=4, round_index=0)
    b1 = lm_round_batches(examples, max_steps=6, batch_size=4, round_index=1)
    assert b0.shape == (4, 6, 4, SEQ + 1)
    assert not np.array_equal(b0, b1)  # rounds advance through the corpus


def test_data_pipeline_matches_the_reference():
    outs = []
    for mod in (tdata, jdata):
        rng = np.random.default_rng(5)
        corpora = mod.client_corpora(rng, 3, 50, 1000, heterogeneity=0.4)
        sizes = mod.dirichlet_sizes(rng, 3, 150, alpha=0.3)
        parts = mod.partition_stream(np.concatenate(corpora), sizes)
        ex = [mod.make_lm_examples(c, 16) for c in corpora + [corpora[0][:5]]]
        frames = mod.embedding_frames(rng, 20, 8, 3)
        outs.append(corpora + [sizes] + parts + ex + [mod.lm_round_batches(ex[:3], 4, 2, 3)] + list(frames))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# end-to-end FL
# ---------------------------------------------------------------------------


def _make_campaign(algorithm, n_clients=5, rounds=4, seed=0):
    server, examples, rng, T = build_port(seed=seed, n_clients=n_clients,
                                          policy_kwargs=dict(algorithm=algorithm))
    return run_campaign(server, examples, rounds, round_T=T, batch_size=4, rng=rng)


def test_fl_campaign_trains_and_accounts_energy():
    hist = _make_campaign("auto")
    assert len(hist.rounds) == 4
    assert hist.rounds[-1].mean_loss < hist.rounds[0].mean_loss
    for r in hist.rounds:
        assert r.energy_joules > 0
        assert r.assignments.sum() == hist.rounds[0].assignments.sum()


def test_fl_energy_scheduler_beats_uniform():
    h_opt = _make_campaign("auto", seed=3)
    h_uni = _make_campaign("uniform", seed=3)
    assert h_opt.total_energy < h_uni.total_energy
    assert np.isfinite(h_opt.losses).all()


def test_estimator_tracks_truth():
    rng = np.random.default_rng(1)
    fleet = make_fleet(rng, 4, max_batches=10)
    est = EnergyEstimator(fleet)
    est.calibrate(rng, probe_points=6)
    for i, dev in enumerate(fleet):
        assert est._tables[i][-1] == pytest.approx(dev.true_table()[-1], rel=0.35)


def test_fl_round_with_device_dropout():
    """Dropped devices get zero work; the round still trains and accounts
    energy only for participants (paper §6 future-work item)."""
    server, examples, rng, _ = build_port(seed=9)
    fleet = server.estimator.fleet
    server.round_T = sum(d.max_batches for d in fleet) // 2
    batches = lm_round_batches(examples, max(d.max_batches for d in fleet), 4, 0)
    res = server.run_round(0, batches, rng, unavailable=[1, 3])
    assert res.assignments[1] == 0 and res.assignments[3] == 0
    assert res.assignments.sum() > 0
    assert res.energy_joules > 0
    # extreme: all but one drop -> workload shrinks to survivor capacity
    res2 = server.run_round(1, batches, rng, unavailable=[0, 1, 2, 3])
    assert res2.assignments[4] == res2.assignments.sum() > 0


def test_round_with_no_work_keeps_the_parameters():
    """Σx = 0 (every client unavailable): the port keeps the global model
    and reports loss 0.0. The reference weights clients by ``x / max(Σx, 1)``
    and so sets every parameter to 0 (ROADMAP.md Queue 3, faults in the
    reference); this test records that too."""
    server_t, examples, rng_t, _ = build_port(seed=0, n_clients=3, policy_kwargs=dict(round_T=4))
    before = {k: v.clone() for k, v in server_t.params.items()}
    batches = lm_round_batches(examples, 8, 4, 0)
    res = server_t.run_round(0, batches, rng_t, unavailable=[0, 1, 2])
    assert res.assignments.tolist() == [0, 0, 0] and res.mean_loss == 0.0
    for k in before:
        assert torch.equal(server_t.params[k], before[k])

    server_j, ex_j, rng_j, _ = build_ref(seed=0, n_clients=3, policy_kwargs=dict(round_T=4))
    res_j = server_j.run_round(0, batches, rng_j, unavailable=[0, 1, 2])
    assert res_j.assignments.tolist() == [0, 0, 0] and res_j.mean_loss == 0.0
    assert res_j.energy_joules == res.energy_joules
    assert all(float(jnp.abs(v).max()) == 0.0 for v in server_j.params.values())


def test_server_trains_on_the_parameters_device_and_plans_on_the_engines():
    server, examples, rng, T = build_port(seed=1, n_clients=3)
    assert server.engine.device == torch.device(CPU) and server.solver.engine is server.engine
    res = server.run_round(0, lm_round_batches(examples, 8, 4, 0), rng)
    assert all(p.device.type == CPU and p.dtype == torch.float32 for p in tree_leaves(server.params))
    # no round_T set: half the round tensor's capacity (3 clients x 8 steps)
    assert np.isfinite(res.mean_loss) and res.assignments.sum() == 12 != T


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"emb": torch.randn(5, 3, generator=g), "w": torch.randn(4, generator=g).to(torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.ones(3), {"a": torch.zeros((2, 2)), "n": np.arange(3)}],
        "none": None,
    }


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "hi"})
    assert latest_checkpoint(str(tmp_path)) == 7
    restored, manifest = load_checkpoint(str(tmp_path), 7, tree)
    assert manifest["extra"]["note"] == "hi"
    assert manifest["keys"] == ["nested/0", "nested/1/a", "nested/1/n", "params/emb", "params/w", "step"]
    assert manifest["dtypes"] == {"params/w": "bfloat16"}
    assert restored["none"] is None
    assert restored["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(restored["params"]["w"]), _bits(tree["params"]["w"]))
    for a, b in zip(tree_leaves(tree["params"]) + [tree["step"], tree["nested"][0]],
                    tree_leaves(restored["params"]) + [restored["step"], restored["nested"][0]]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(restored["nested"][1]["n"], np.arange(3))


def test_checkpoints_are_readable_across_the_packages(tmp_path):
    """The port writes the reference's layout (the reference reads its
    float arrays back), and reads the reference's checkpoints, bfloat16
    arrays bit for bit."""
    tree = _tree()
    save_checkpoint(str(tmp_path / "t"), 1, {"params": tree["params"], "nested": tree["nested"]})
    like = {"params": {"emb": jnp.zeros((5, 3)), "w": jnp.zeros(4, jnp.bfloat16)},
            "nested": [jnp.zeros(3), {"a": jnp.zeros((2, 2)), "n": jnp.zeros(3, jnp.int32)}]}
    got, manifest = j_load_checkpoint(str(tmp_path / "t"), 1, like)
    np.testing.assert_array_equal(np.asarray(got["params"]["emb"]), tree["params"]["emb"].numpy())
    assert json.loads((tmp_path / "t" / "ckpt_00000001.json").read_text())["keys"] == manifest["keys"]

    jtree = {"emb": jnp.asarray(np.arange(6.0).reshape(2, 3) / 7, jnp.float32),
             "w": jnp.asarray(np.linspace(-3, 3, 9), jnp.bfloat16), "k": [jnp.asarray(3)]}
    j_save_checkpoint(str(tmp_path / "j"), 2, jtree)
    like_t = {"emb": torch.zeros(2, 3), "w": torch.zeros(9, dtype=torch.bfloat16), "k": [torch.tensor(0)]}
    back, _ = load_checkpoint(str(tmp_path / "j"), 2, like_t)
    np.testing.assert_array_equal(back["emb"].numpy(), np.asarray(jtree["emb"]))
    np.testing.assert_array_equal(_bits(back["w"]), _bits(jtree["w"]))
    assert int(back["k"][0]) == 3 and back["k"][0].dtype == torch.int64
    arrays, _ = load_checkpoint_arrays(str(tmp_path / "j"), 2)
    assert set(arrays) == {"emb", "w", "k/0"}


def test_campaign_checkpoint_restores_bfloat16_parameters_bit_for_bit(tmp_path):
    server, examples, rng, T = build_port(seed=0, n_clients=3)
    server.params = {k: v.to(torch.bfloat16) for k, v in server.params.items()}
    hist = run_campaign(server, examples, 2, round_T=T, batch_size=4, rng=rng, checkpoint_dir=str(tmp_path))
    other, _, rng2, _ = build_port(seed=1, n_clients=3)
    other.params = {k: torch.zeros_like(v) for k, v in server.params.items()}
    last, results = load_campaign_checkpoint(str(tmp_path), other, rng2)
    assert last == 1 and [r.mean_loss for r in results] == hist.losses.tolist()
    for k in server.params:
        assert other.params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(other.params[k]), _bits(server.params[k]))
    assert rng2.bit_generator.state == rng.bit_generator.state


# ---------------------------------------------------------------------------
# the FL launcher and a gemma2-2b round against the reference
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--arch", "gemma2-2b", "--device", CPU, "--clients", "3", "--max-batches", "4",
               "--seq", "16", "--batch", "2", "--rounds", "1"]


def test_smoke_gemma2_round_matches_the_reference():
    """One FL round of SMOKE gemma2-2b through the port's launcher (its
    parameters replaced by the JAX package's initialisation) against the
    reference's ``FederatedServer`` with its ``loss_fn`` on the same fleet and
    data: schedule and energies exactly, loss within 2e-5, parameters within
    rtol 2e-3, atol 2e-5."""
    args = launcher.parse_args(LAUNCH_ARGS)
    campaign = launcher.build_campaign(args, log=lambda _: None)
    cfg_j = jax_get_config("gemma2-2b", smoke=True)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg_j, jax.random.PRNGKey(0)))
    cfg = config_from_jax(cfg_j)
    assert cfg == campaign.cfg
    campaign.server.params = params_from_jax(cfg, tree, device=CPU)
    server_t, hist_t = launcher.run(args, campaign=campaign, log=lambda _: None)

    est_j, ex_j, rng_j = _ref_world(args, cfg.vocab_size)
    T = sum(d.max_batches for d in est_j.fleet) // 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        server_j = jfl.FederatedServer(
            loss_fn=lambda p, b: jax_loss_fn(p, cfg_j, {"tokens": b}),
            init_params=jax.tree.map(jnp.asarray, tree),
            client_optimizer=joptim.sgd(args.lr),
            estimator=est_j,
            algorithm=args.algorithm,
        )
    hist_j = jfl.run_campaign(server_j, ex_j, 1, round_T=T, batch_size=args.batch, rng=rng_j)
    rj, rt = hist_j.rounds[0], hist_t.rounds[0]
    np.testing.assert_array_equal(rj.assignments, rt.assignments)
    assert rt.assignments.sum() == T == campaign.round_T
    assert (rj.energy_joules, rj.estimated_joules, rj.makespan_joules) == (
        rt.energy_joules, rt.estimated_joules, rt.makespan_joules)
    np.testing.assert_allclose(rt.mean_loss, rj.mean_loss, rtol=0, atol=2e-5)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, server_j.params), device=CPU)
    for a, b in zip(tree_leaves(server_t.params), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-5)


def _ref_world(args, vocab):
    """The launcher's fleet, estimator and data drawn in the JAX package."""
    rng = np.random.default_rng(args.seed)
    fleet = jfl.make_fleet(rng, args.clients, max_batches=args.max_batches)
    est = jfl.EnergyEstimator(fleet)
    est.calibrate(rng)
    corpora = jdata.client_corpora(rng, args.clients, args.seq * 120, vocab)
    return est, [jdata.make_lm_examples(c, args.seq) for c in corpora], rng


def test_launcher_runs_on_the_cpu_and_saves_its_checkpoint(tmp_path):
    args = launcher.parse_args(LAUNCH_ARGS + ["--rounds", "2", "--checkpoint-dir", str(tmp_path)])
    lines = []
    server, hist = launcher.run(args, log=lines.append)
    assert len(hist.rounds) == 2 and np.isfinite(hist.losses).all()
    assert lines[0].startswith("arch=gemma2-2b (smoke)") and lines[1].startswith("round   0 loss")
    restored, manifest = load_checkpoint(str(tmp_path), 2, server.params)
    assert manifest["extra"] == {"arch": "gemma2-2b", "algorithm": "auto"}
    for a, b in zip(tree_leaves(restored), tree_leaves(server.params)):
        assert torch.equal(a, b)
    assert launcher.parse_args([]).device == "cuda"  # the card unless asked otherwise
