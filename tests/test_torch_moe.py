"""The port's MoE family (routing, dispatch, MLA, the MoE models' prefill and
loss) and Adafactor against the JAX package, on the CPU.

olmoe-1b-7b and deepseek-v3-671b SMOKE models (JAX-initialised weights with
noise on the norm gains, float32). The port's prefill runs its ``"flash"``
route (on CPU tensors the kernel's plain version; MLA's v, whose head dim
is below q/k's, zero-padded to theirs) against JAX's XLA route:
logits within 1e-4 (``test_torch_models.py``'s prefill tolerance). Loss
within rtol 1e-5 and gradients within rtol 2e-3, atol 2e-5
(``test_torch_train.py``'s tolerances), deepseek-v3's MTP term included.
Routing: identical expert indices (ties included), gates and aux within
1e-6; the dispatches and MLA's absorbed decode within 1e-5 (float32 products
summed in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import active_param_count as jax_active_param_count
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import param_count as jax_param_count
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import mla as jmla
from repro.models import moe_dispatch as jmd
from repro.optim.optimizers import adafactor as jax_adafactor
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import build_train_step, value_and_grad
from repro_torch.models import (
    active_param_count,
    config_from_jax,
    expert_param_count,
    init_params,
    layer_stacks,
    make_dummy_batch,
    model_flops_per_token,
    param_count,
    params_from_jax,
    prefill_fn,
)
from repro_torch.models import mla as tmla
from repro_torch.models import moe_dispatch as tmd
from repro_torch.optim import adafactor, get_optimizer, tree_leaves

ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)
TOL_OP = dict(rtol=1e-5, atol=1e-5)
# Adafactor's updates against the reference's: relative. The update divides
# by the stack-wide RMS, a mean over up to 24,576 entries here, and by the
# square roots of factored means; the reference sums these in float32 (up to
# about 5e-7 relative error each, measured), the port in float64 (correctly
# rounded), so the two updates differ by the sum of those errors: 1.05e-6 at
# most on this tree. The moments vr, vc (means over at most 48 entries) are
# held to 1e-6.
UPDATE_RTOL = 2e-6


def _jax_params(cfg_j, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                         if "ln" in jax.tree_util.keystr(path) else 0),
        jax_init_params(cfg_j, jax.random.PRNGKey(seed)),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_inputs(arch="deepseek-v3-671b", T=24, seed=0):
    """A SMOKE config, one MoE layer's ``moe`` params (numpy) and tokens."""
    cfg_j = jax_get_config(arch, smoke=True)
    p = jax.tree.map(lambda a: np.asarray(a)[0], _jax_params(cfg_j, seed)["moe_layers"]["moe"])
    x = np.random.default_rng(seed).normal(size=(T, cfg_j.d_model)).astype(np.float32)
    return cfg_j, config_from_jax(cfg_j), p, x


@pytest.mark.parametrize("ties", [False, True])
def test_route_matches_jax(ties):
    """With ``ties``, router columns 1 and 3 are equal (and 0 and 2), so
    pairs of experts have exactly equal probabilities: the lower index must
    come first, as ``jax.lax.top_k`` orders them."""
    cfg_j, cfg, p, x = _moe_inputs(T=64)
    w = p["router"].copy()
    if ties:
        w[:, 3], w[:, 2] = w[:, 1], w[:, 0]
    gw_j, gi_j, aux_j = jmd.route(cfg_j, jnp.asarray(x), jnp.asarray(w))
    gw, gi, aux = tmd.route(cfg, _t(x), _t(w))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(gi_j))
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-6, atol=1e-6)
    if ties:  # the case holds ties at the top k (both of a tied pair chosen, and one of them cut)
        probs = torch.softmax(_t(x) @ _t(w), dim=-1)
        assert bool((probs[:, 1] == probs[:, 3]).all())
        assert bool((gi == 1).any(dim=1).logical_and((gi == 3).any(dim=1)).any())


def test_einsum_dispatch_drops_like_jax():
    """A capacity of 3 slots an expert for 24 tokens x top-2 of 4 experts:
    tokens are dropped, the same ones in both packages."""
    cfg_j, cfg, p, x = _moe_inputs(T=24)
    gw_j, gi_j, _ = jmd.route(cfg_j, jnp.asarray(x), jnp.asarray(p["router"]))
    ex_j = jax.tree.map(jnp.asarray, p["experts"])
    ex = jax.tree.map(_t, p["experts"])
    want = jmd._moe_einsum(cfg_j, jnp.asarray(x), ex_j, gw_j, gi_j, 3)
    got = tmd._moe_einsum(cfg, _t(x), ex, _t(gw_j), _t(gi_j).long(), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_OP)
    full = tmd._moe_dense(cfg, _t(x), ex, _t(gw_j), _t(gi_j).long())
    dropped = ~torch.isclose(got, full, rtol=1e-4, atol=1e-5).all(dim=1)
    assert 0 < int(dropped.sum()) < 24
    assert tmd.einsum_capacity(cfg, 24) == max(8, int(24 * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 8)


@pytest.mark.parametrize("impl", ["dense", "einsum", "a2a"])
def test_moe_ffn_with_shared_expert_matches_jax(impl):
    """deepseek-v3's MoE FFN (shared expert included) in each dispatch; the
    reference runs ``a2a`` without a mesh as ``dense``, and so does the
    port."""
    cfg_j, cfg, p, x = _moe_inputs(T=24)
    x3 = x.reshape(2, 12, -1)
    assert "shared" in p
    want, aux_j = jmd.moe_ffn(cfg_j.replace(moe_impl=impl), jax.tree.map(jnp.asarray, p), jnp.asarray(x3))
    got, aux = tmd.moe_ffn(cfg.replace(moe_impl=impl), jax.tree.map(_t, p), _t(x3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_OP)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-6)
    if impl == "a2a":
        dense, _ = tmd.moe_ffn(cfg.replace(moe_impl="dense"), jax.tree.map(_t, p), _t(x3))
        assert torch.equal(got, dense)


def _mla_setup(T=10):
    cfg_j = jax_get_config("deepseek-v3-671b", smoke=True)
    p = jax.tree.map(lambda a: np.asarray(a)[0], _jax_params(cfg_j, 1)["moe_layers"]["attn_mla"])
    x = np.random.default_rng(2).normal(size=(2, T, cfg_j.d_model)).astype(np.float32)
    return cfg_j, config_from_jax(cfg_j), p, x


def test_mla_decode_step_matches_jax_and_the_non_absorbed_forward():
    """T teacher-forced absorbed steps: each step's output and the latent
    cache against JAX's ``mla_decode_step`` (1e-5), and the outputs against
    the port's non-absorbed ``mla_forward`` over the whole sequence."""
    cfg_j, cfg, p, x = _mla_setup()
    T = x.shape[1]
    pj, pt = jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)
    jcache = jmla.init_mla_cache(cfg_j, 2, T, ())
    cache = tmla.init_mla_cache(cfg, 2, T, (), torch.device("cpu"))
    ys = []
    for t in range(T):
        yj, jcache = jmla.mla_decode_step(cfg_j, pj, jnp.asarray(x[:, t:t + 1]), jcache, jnp.asarray(t, jnp.int32))
        y, cache = tmla.mla_decode_step(cfg, pt, _t(x[:, t:t + 1]), cache, torch.tensor(t))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL_OP)
        ys.append(y)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_OP)
    full, lat = tmla.mla_forward(cfg, pt, _t(x), q_pos=torch.arange(T), collect_cache=True)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), full.numpy(), **TOL_OP)
    want_full, want_lat = jmla.mla_forward(cfg_j, pj, jnp.asarray(x), q_pos=jnp.arange(T), collect_cache=True)
    np.testing.assert_allclose(full.numpy(), np.asarray(want_full), **TOL_OP)
    for a, b in zip(lat, want_lat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_OP)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_matches_jax(arch):
    """B = 2, S = 64: the port's flash route against JAX's XLA route."""
    cfg_j = jax_get_config(arch, smoke=True)
    tree = _jax_params(cfg_j, 0)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 64)).astype(np.int32)
    want = np.asarray(jax_prefill_fn(jax.tree.map(jnp.asarray, tree), cfg_j, {"tokens": jnp.asarray(tokens)}))
    cfg = config_from_jax(cfg_j.replace(attn_impl="pallas"))
    params = params_from_jax(cfg, tree, device="cpu")
    before = fa.launches
    got = prefill_fn(params, cfg, {"tokens": _t(tokens).long()})
    assert fa.launches == before  # CPU: the kernel's plain version
    assert got.shape == (2, 64, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_loss_and_gradients_match_jax(arch):
    """B = 2, S = 32 (plus the MTP shift): loss and every gradient."""
    cfg_j = jax_get_config(arch, smoke=True)
    tree = _jax_params(cfg_j, 0)
    batch_np = {k: np.asarray(v) for k, v in
                jax.tree.map(np.asarray, _dummy(cfg_j, 2, 32)).items()}
    want_loss, want_grads = jax.value_and_grad(jax_loss_fn)(
        jax.tree.map(jnp.asarray, tree), cfg_j, jax.tree.map(jnp.asarray, batch_np))
    cfg = config_from_jax(cfg_j.replace(attn_impl="pallas"))
    params = params_from_jax(cfg, tree, device="cpu")
    batch = {"tokens": _t(batch_np["tokens"]).long()}
    assert batch["tokens"].shape[1] == 32 + (2 if cfg.use_mtp else 1)
    loss, grads = value_and_grad(params, cfg, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_grads), device="cpu")
    got_l, want_l = tree_leaves(grads), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(params))
    for g, w in zip(got_l, want_l):
        torch.testing.assert_close(g, w, **TOL_GRAD)


def _dummy(cfg_j, B, S):
    from repro.models import make_dummy_batch as jax_make_dummy_batch

    return jax_make_dummy_batch(cfg_j, B, S, "train", np.random.default_rng(4))


def test_make_dummy_batch_draws_like_jax_with_mtp():
    cfg_j = jax_get_config("deepseek-v3-671b", smoke=True)
    want = np.asarray(_dummy(cfg_j, 2, 16)["tokens"])
    got = make_dummy_batch(config_from_jax(cfg_j), 2, 16, "train", np.random.default_rng(4), device="cpu")
    assert want.shape == (2, 18)
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_adafactor_matches_jax_on_the_stacked_tree():
    """Three steps on the deepseek-v3 SMOKE tree from the same numpy
    parameters and gradients: updates within rtol UPDATE_RTOL and the
    factored moments ``vr``/``vc`` within rtol 1e-6. The reference factors its stacked leaves: the MoE
    layers' 1-D gains are stacked ``(n_moe, d)`` and factored, and the RMS
    clip (active here: the first step's preconditioned gradient has RMS
    1/sqrt(1 - beta_1) = 1.53) spans every layer of a stack."""
    cfg_j = jax_get_config("deepseek-v3-671b", smoke=True)
    cfg = config_from_jax(cfg_j)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg_j, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -k, tree) for k in range(3)]
    jopt, topt = jax_adafactor(1e-2), adafactor(1e-2, stacks=layer_stacks(cfg))
    jupdate = jax.jit(jopt.update)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = params_from_jax(cfg, tree, device="cpu")
    ts = topt.init(tp)
    n_moe = cfg.num_layers - cfg.dense_prefix_layers
    assert ts.vr["moe_layers"]["ln1"].shape == (n_moe,) and ts.vc["moe_layers"]["ln1"].shape == (cfg.d_model,)
    for g in grads:
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(cfg, g, device="cpu"), ts, tp)
        want = params_from_jax(cfg, jax.tree.map(np.asarray, ju), device="cpu")
        for a, b in zip(tree_leaves(tu), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=UPDATE_RTOL, atol=0)
        for got, ref in ((ts.vr, js.vr), (ts.vc, js.vc)):
            paths = list(_paths(jax.tree.map(np.asarray, ref)))
            assert len(paths) == len(tree_leaves(got))
            for path, want_v in paths:
                np.testing.assert_allclose(_get(got, path).numpy(), want_v, rtol=1e-6, atol=0)
    assert int(ts.step) == 3


def test_deepseek_v3_train_step_uses_adafactor():
    """``build_train_step`` takes the config's optimizer, Adafactor over the
    stacked leaves, and the loss falls over three steps on one batch."""
    cfg = get_config("deepseek-v3-671b", smoke=True)
    assert cfg.optimizer == "adafactor"
    params = init_params(cfg, 0, device="cpu")
    batch = make_dummy_batch(cfg, 2, 16, "train", np.random.default_rng(0), device="cpu")
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    assert state.vr["moe_layers"]["ln1"].shape == (cfg.num_layers - cfg.dense_prefix_layers,)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
    assert losses[2] < losses[0] and int(state.step) == 3
    assert get_optimizer("adafactor", 1e-2).init({"w": torch.zeros(3, 4)}).vc["w"].shape == (4,)


@pytest.mark.parametrize("arch", ["granite-20b", "minitron-8b", "olmoe-1b-7b", "deepseek-v3-671b"])
def test_param_counts_match_jax(arch):
    cfg_j = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg_j, jax.random.PRNGKey(0)))
    cfg = config_from_jax(cfg_j)
    params = params_from_jax(cfg, tree, device="cpu")
    own = init_params(cfg, 0, device="cpu")
    assert param_count(params) == param_count(own) == jax_param_count(tree)
    assert active_param_count(params, cfg) == active_param_count(own, cfg) == jax_active_param_count(tree, cfg_j)
    assert (expert_param_count(params) > 0) == (cfg.family == "moe")
    flops = model_flops_per_token(params, cfg, 128, "train")
    assert flops == 6.0 * active_param_count(params, cfg) + 12.0 * cfg.num_layers * cfg.hd * cfg.num_heads * 64


def test_param_counts_full_configs():
    """The FULL configs' analytic parameter counts in the reference's
    ballparks (tests/test_arch_smoke.py::test_param_counts_full_configs)
    for every ported arch."""
    from test_arch_smoke import _analytic_param_count

    ballparks = {"deepseek-7b": (6e9, 8.5e9), "gemma2-2b": (2e9, 3.5e9), "granite-20b": (18e9, 24e9),
                 "minitron-8b": (7e9, 10.5e9), "olmoe-1b-7b": (6e9, 8e9), "deepseek-v3-671b": (580e9, 720e9)}
    for arch, (lo, hi) in ballparks.items():
        n = _analytic_param_count(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B"
    assert math.isclose(get_config("olmoe-1b-7b").top_k / get_config("olmoe-1b-7b").num_experts, 1 / 8)
