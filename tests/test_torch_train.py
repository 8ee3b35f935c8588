"""The port's dense-LM training slice against the JAX package, on the CPU.

``cross_entropy``, AdamW with ``apply_updates``, the gemma2-2b and
deepseek-7b SMOKE losses and gradients, and three steps of
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
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import build_train_step, value_and_grad
from repro_torch.models import config_from_jax, init_params, loss_fn, make_dummy_batch, params_from_jax
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.dense import cross_entropy
from repro_torch.optim import adamw, apply_updates, get_optimizer, tree_leaves

ARCHS = ["gemma2-2b", "deepseek-7b"]
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


def test_get_optimizer_names_what_is_not_ported():
    assert get_optimizer("adamw", 1e-3).init({"w": torch.zeros(2)}).step.dtype == torch.int32
    for name in ("sgd", "momentum", "adafactor"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_optimizer(name, 1e-3)
    with pytest.raises(ValueError):
        get_optimizer("lion", 1e-3)


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
    cfg = get_config("gemma2-2b", smoke=True).replace(remat="dots")
    params = init_params(cfg, 0, device="cpu")
    batch = make_dummy_batch(cfg, 1, 8, "train", np.random.default_rng(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loss_fn(params, cfg, batch)
    with pytest.raises(ValueError):
        cfg.replace(remat="everything")


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
