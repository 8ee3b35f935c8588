"""The port's dense-LM training slice against the JAX package, on the CPU.

``cross_entropy``, AdamW with ``apply_updates``, Adafactor, the gemma2-2b,
deepseek-7b, granite-20b and minitron-8b SMOKE losses and gradients, and three steps of
``build_train_step`` go through both packages on the same numpy inputs. The
JAX side runs its XLA attention route; the port runs its ``"flash"`` route,
which on CPU tensors is the kernels' plain versions (forward and backward).
Gradients of the JAX tree are mapped to the port's layout with
``params_from_jax``. Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models.dense import cross_entropy as jax_cross_entropy
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.optim.optimizers import get_optimizer as jax_get_optimizer
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import build_train_step, value_and_grad
from repro_torch.models import config_from_jax, init_params, layer_stacks, loss_fn, make_dummy_batch, params_from_jax
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.dense import cross_entropy
from repro_torch.optim import adamw, apply_updates, get_optimizer, tree_leaves

ARCHS = ["gemma2-2b", "deepseek-7b", "granite-20b", "minitron-8b"]
# the reference's dense-model tolerance (tests/test_flash_attention.py::
# test_dense_model_with_pallas_attention_matches_xla)
LOSS_ATOL = 2e-5
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)


def _jax_params(cfg_j, seed):
    """JAX init tree as numpy, with noise on the norm gains so (1 + gamma) is
    not 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                         if "ln" in jax.tree_util.keystr(path) else 0),
        jax_init_params(cfg_j, jax.random.PRNGKey(seed)),
    )


def _setup(arch, B=2, S=64):
    cfg_j = jax_get_config(arch, smoke=True)
    tree = _jax_params(cfg_j, 0)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (B, S + 1)).astype(np.int32)
    cfg = config_from_jax(cfg_j.replace(attn_impl="pallas"))
    params = params_from_jax(cfg, tree, device="cpu")
    return cfg_j, tree, {"tokens": jnp.asarray(tokens)}, cfg, params, {"tokens": torch.from_numpy(tokens).long()}


@pytest.mark.parametrize("with_valid", [False, True])
def test_cross_entropy_matches_jax(with_valid):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 9, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (2, 9)).astype(np.int32)
    valid = rng.random((2, 9)) < 0.6 if with_valid else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                             None if valid is None else jnp.asarray(valid))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets).long(),
                        None if valid is None else torch.from_numpy(valid))
    # float32 reductions over 50 logits and 18 positions
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    # and its gradient: softmax minus the one-hot target, over the count
    x = torch.from_numpy(logits).requires_grad_()
    w = None if valid is None else torch.from_numpy(valid)
    g = torch.autograd.grad(cross_entropy(x, torch.from_numpy(targets).long(), w), x)[0]
    gj = jax.grad(lambda x: jax_cross_entropy(x, jnp.asarray(targets), None if valid is None else jnp.asarray(valid)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-7)


def _ulps(got, want):
    """Distance in bfloat16 ulps between bfloat16 tensors (as int16 codes of
    same-signed values)."""
    a = got.view(torch.int16).int()
    b = want.view(torch.int16).int()
    return (a - b).abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_steps(dtype):
    """Parameters, first and second moments after each of three steps from
    the same numpy parameters and gradients. float32: rtol 1e-6 (the float32
    powers in the bias corrections may differ in their last bit). bfloat16:
    within one bfloat16 ulp (parameters and the bfloat16 first moment)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": [(3,), (4, 2)]}
    p_np = {"a": rng.normal(size=shapes["a"]).astype(np.float32) * 0.05,
            "b": [rng.normal(size=s).astype(np.float32) for s in shapes["b"]]}
    grads_np = [{"a": rng.normal(size=shapes["a"]).astype(np.float32) * 10 ** -i,
                 "b": [rng.normal(size=s).astype(np.float32) for s in shapes["b"]]} for i in range(3)]
    jdt = jnp.dtype(dtype)
    to_j = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype=jdt), t)
    to_t = lambda t: jax.tree.map(lambda a: tensor_from_numpy(np.asarray(jnp.asarray(a, dtype=jdt)), "cpu"), t)

    jopt, topt = jax_adamw(3e-4, weight_decay=0.1), adamw(3e-4, weight_decay=0.1)
    jp, tp = to_j(p_np), to_t(p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads_np:
        ju, js = jopt.update(to_j(g), js, jp)
        jp = jax_apply_updates(jp, ju)
        tu, ts = topt.update(to_t(g), ts, tp)
        tp = apply_updates(tp, tu)
        assert int(ts.step) == int(js.step)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                b = tensor_from_numpy(np.asarray(b), device="cpu")
                assert a.dtype == b.dtype
                if a.dtype == torch.bfloat16:
                    assert _ulps(a, b) <= 1
                else:
                    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert ts.nu["a"].dtype == torch.float32 and ts.mu["a"].dtype == tp["a"].dtype


@pytest.mark.parametrize("dtype,mu_dtype", [(torch.float32, None), (torch.bfloat16, None),
                                            (torch.bfloat16, torch.float32)])
def test_adamw_on_cpu_runs_the_plain_version(dtype, mu_dtype):
    """On a CPU tree ``adamw`` launches no kernel (``kernels/adamw.py``'s
    counters stay at 0) and gives, bit for bit, the values of the ATen ops
    it ran before its leaves went through ``adamw_leaf``, written out here
    as they stood: three steps, weight decay 0.1, moments and parameters."""
    from repro_torch.kernels import adamw as kernel

    def old_adamw_steps(params, grads_seq, lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, wd=0.1):
        def as_(x, dt):
            return torch.tensor(x, dtype=dt).item()

        mu = {k: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for k, p in params.items()}
        nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        for i, grads in enumerate(grads_seq):
            t = torch.tensor(i + 1, dtype=torch.int32).float()
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
            for k, p in params.items():
                g, m, v = grads[k], mu[k], nu[k]
                m.mul_(as_(b1, m.dtype)).add_(as_(1 - b1, g.dtype) * g)
                v.mul_(as_(b2, v.dtype)).add_(as_(1 - b2, v.dtype) * g.float().square())
                u = (m.float() / bc1) / ((v / bc2).sqrt() + eps) + as_(wd, p.dtype) * p
                p.add_((-lr * u).to(p.dtype))
        return params, mu, nu

    rng = np.random.default_rng(11)
    shapes = {"w": (33, 17), "b": (5,), "one": (1,)}
    p0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.05).to(dtype) for k, s in shapes.items()}
    grads_seq = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 10 ** -i).to(dtype)
                  for k, s in shapes.items()} for i in range(3)]
    want = old_adamw_steps({k: p.clone() for k, p in p0.items()}, grads_seq)

    before = (kernel.launches, kernel.elements)
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=mu_dtype)
    params = {k: p.clone() for k, p in p0.items()}
    state = opt.init(params)
    for grads in grads_seq:
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
    assert (kernel.launches, kernel.elements) == before == (0, 0)
    for got, exp in zip((params, state.mu, state.nu), want):
        for k in shapes:
            assert got[k].dtype == exp[k].dtype
            assert torch.equal(got[k].view(torch.int16 if got[k].element_size() == 2 else torch.int32),
                               exp[k].view(torch.int16 if exp[k].element_size() == 2 else torch.int32)), k


def test_get_optimizer_names_what_is_not_ported():
    """Every optimizer of the reference is ported: ``get_optimizer`` makes
    each, and refuses a name the reference does not know. Adafactor (ported
    with the MoE family) takes three steps on gemma2-2b's SMOKE tree, its
    ``(n_groups, period)``-stacked layers, within rtol 1e-6 of the
    reference's updates and moments (``test_torch_moe.py`` holds the MoE
    tree)."""
    assert get_optimizer("adamw", 1e-3).init({"w": torch.zeros(2)}).step.dtype == torch.int32
    assert get_optimizer("sgd", 1e-3).init({"w": torch.zeros(2)}) == ()
    assert torch.equal(get_optimizer("momentum", 1e-3).init({"w": torch.ones(2)})["w"], torch.zeros(2))
    with pytest.raises(ValueError):
        get_optimizer("lion", 1e-3)
    cfg_j = jax_get_config("gemma2-2b", smoke=True)
    cfg = config_from_jax(cfg_j)
    tree = _jax_params(cfg_j, 0)
    rng = np.random.default_rng(2)
    jopt, topt = jax_get_optimizer("adafactor", 1e-2), get_optimizer("adafactor", 1e-2, stacks=layer_stacks(cfg))
    jupdate = jax.jit(jopt.update)
    jp = jax.tree.map(jnp.asarray, tree)
    js, tp = jopt.init(jp), params_from_jax(cfg, tree, device="cpu")
    ts = topt.init(tp)
    assert ts.vr["layers"]["ln1"].shape == js.vr["layers"]["ln1"].shape == (cfg.num_layers // 2, 2)
    for k in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -k, tree)
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(cfg, g, device="cpu"), ts, tp)
        want = params_from_jax(cfg, jax.tree.map(np.asarray, ju), device="cpu")
        for a, b in zip(tree_leaves(tu), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        for got, ref in ((ts.vr, js.vr), (ts.vc, js.vc)):
            for name in ("emb", "ln_f"):
                np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-6)
            for name, v in ref["layers"].items():
                if not isinstance(v, dict):
                    np.testing.assert_allclose(got["layers"][name].numpy(), np.asarray(v), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_xla_route(arch):
    """SMOKE models at B = 2, S = 64, float32: the port's flash route (plain
    versions on the CPU) against JAX's ``value_and_grad`` on its XLA route."""
    cfg_j, tree, jbatch, cfg, params, batch = _setup(arch)
    want_loss, want_grads = jax.value_and_grad(jax_loss_fn)(
        jax.tree.map(jnp.asarray, tree), cfg_j.replace(attn_impl="xla"), jbatch)
    assert cfg.attn_impl == "flash"
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    loss, grads = value_and_grad(params, cfg, batch)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before
    assert abs(loss.item() - float(want_loss)) < LOSS_ATOL
    assert torch.equal(loss, loss_fn(params, cfg, batch))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_grads), device="cpu")
    got_l, want_l = tree_leaves(grads), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(params))
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL_GRAD)
    assert not any(p.requires_grad or p.grad is not None for p in tree_leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_losses_match_jax(arch):
    """Three SMOKE steps from the same parameters on one batch: the losses
    agree within rtol 1e-5, and fall."""
    cfg_j, tree, jbatch, cfg, params, batch = _setup(arch)
    jstep, jopt = jax_build_train_step(cfg_j.replace(attn_impl="xla"))
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    losses = []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jbatch)
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert losses[2] < losses[0]
    assert int(state.step) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_matches_none(arch):
    """Checkpointing each layer group recomputes the same forward: the same
    loss and gradients, up to float32 rounding (the CPU's scatter-add into
    the embedding's gradient may sum a repeated token's rows in another
    order from one run to the next)."""
    _, _, _, cfg, params, batch = _setup(arch)
    l0, g0 = value_and_grad(params, cfg.replace(remat="none"), batch)
    l1, g1 = value_and_grad(params, cfg.replace(remat="full"), batch)
    torch.testing.assert_close(l0, l1, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-8)


def test_remat_dots_is_not_ported():
    """``remat="dots"`` was refused before it was ported; it runs now (the
    same loss as without remat, with and without grad mode), and a remat
    the reference does not know is refused."""
    cfg = get_config("gemma2-2b", smoke=True).replace(remat="dots")
    params = init_params(cfg, 0, device="cpu")
    batch = make_dummy_batch(cfg, 1, 8, "train", np.random.default_rng(0), device="cpu")
    want = loss_fn(params, cfg.replace(remat="none"), batch)
    assert torch.equal(loss_fn(params, cfg, batch), want)
    assert torch.equal(value_and_grad(params, cfg, batch)[0], want)
    with pytest.raises(ValueError):
        cfg.replace(remat="everything")


DOTS_ARCHS = ["gemma2-2b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_remat_dots_matches_none(arch):
    """``remat="dots"`` (each layer group checkpointed, the outputs of its
    products without batch dims saved, the rest recomputed from them) gives
    the loss and gradients of no remat bit for bit: the recompute runs the
    same ops on the same inputs. On one CPU thread: with several, the
    embedding's gradient (a scatter-add) may sum a repeated token's rows in
    another order from one run to the next, with or without remat."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, 0, device="cpu")
    batch = make_dummy_batch(cfg, 2, 64, "train", np.random.default_rng(0), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        l0, g0 = value_and_grad(params, cfg.replace(remat="none"), batch)
        l1, g1 = value_and_grad(params, cfg.replace(remat="dots"), batch)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(l0, l1)
    assert len(tree_leaves(g0)) == len(tree_leaves(g1)) == len(tree_leaves(params))
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_training_config_fields_and_config_from_jax():
    for arch in ARCHS:
        full, smoke = get_config(arch), get_config(arch, smoke=True)
        assert (full.remat, full.optimizer, full.learning_rate) == ("full", "adamw", 3e-4)
        assert (smoke.remat, smoke.optimizer, smoke.learning_rate) == ("none", "adamw", 3e-4)
        jcfg = jax_get_config(arch).replace(remat="none", learning_rate=1e-3, optimizer="sgd")
        cfg = config_from_jax(jcfg)
        assert (cfg.remat, cfg.learning_rate, cfg.optimizer) == ("none", 1e-3, "sgd")


def test_logits_softcap_keeps_its_gradient_and_the_prefill_stays_in_place():
    """Under grad mode the logit softcap runs out of place (the in-place
    version overwrites tanh's saved output); without it the prefill's
    in-place version gives the same logits."""
    from repro_torch.models import dense

    cfg = get_config("gemma2-2b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    tokens = make_dummy_batch(cfg, 1, 16, "prefill", np.random.default_rng(1), device="cpu")["tokens"]
    h = dense._embed(cfg, params, tokens)
    x = h.detach().requires_grad_()
    logits = dense._logits(cfg, params, x)
    (g,) = torch.autograd.grad(logits.square().sum(), x)
    assert torch.isfinite(g).all()
    with torch.no_grad():
        in_place = dense._logits(cfg, params, h)
    torch.testing.assert_close(in_place, logits.detach(), rtol=0, atol=0)
