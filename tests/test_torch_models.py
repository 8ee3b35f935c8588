"""The port's dense-LM prefill slice against the JAX package, on the CPU.

Layers, configs, the parameter converter and the whole ``prefill_fn`` of the
gemma2-2b and deepseek-7b SMOKE models go through both packages on the same
numpy inputs. The JAX side runs its flash-attention route
(``attn_impl="pallas"``, interpret mode); the port runs its ``"flash"`` route,
which on CPU tensors is the kernel's plain version. Tolerances are stated at
each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import layers as jl
from repro_torch.configs import ATTN_IMPL_FROM_JAX, get_config, list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import build_prefill_step
from repro_torch.models import (
    config_from_jax,
    init_params,
    make_dummy_batch,
    model_flops_per_token,
    param_count,
    params_from_jax,
    prefill_fn,
)
from repro_torch.models import layers as tl
from repro_torch.models.convert import tensor_from_numpy

ARCHS = ["gemma2-2b", "deepseek-7b"]
# float32 elementwise ops on the same inputs: only the order of the few
# reductions (mean of squares, matrix products) differs
TOL_LAYER = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def test_rms_norm_and_softcap_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(g)).numpy(), _np(jl.rms_norm(jnp.asarray(x), jnp.asarray(g))),
                               **TOL_LAYER)
    np.testing.assert_allclose(tl.softcap(_t(x), 5.0).numpy(), _np(jl.softcap(jnp.asarray(x), 5.0)), **TOL_LAYER)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = np.arange(37)
    sin_j, cos_j = jl.make_rope(jnp.asarray(pos), 64, 10000.0)
    sin_t, cos_t = tl.make_rope(torch.from_numpy(pos), 64, 10000.0)
    # angles up to 36 rad: sin/cos of float32 angles agree to a few ulp of the angle
    np.testing.assert_allclose(sin_t.numpy(), _np(sin_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cos_t.numpy(), _np(cos_j), rtol=1e-5, atol=1e-5)
    x = rng.normal(size=(2, 37, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(tl.apply_rope(_t(x), _t(sin_j), _t(cos_j)).numpy(),
                               _np(jl.apply_rope(jnp.asarray(x), sin_j, cos_j)), **TOL_LAYER)


@pytest.mark.parametrize("kind", ["gated_silu", "gated_gelu", "squared_relu", "gelu"])
def test_mlps_match_jax(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (32, 48)), ("w_in", (32, 48)), ("w_out", (48, 32)))}
    pt = {n: _t(a) for n, a in p.items()}
    pj = {n: jnp.asarray(a) for n, a in p.items()}
    if kind == "gated_silu":
        got, want = tl.mlp_gated(pt, _t(x), torch.nn.functional.silu), jl.mlp_gated(pj, jnp.asarray(x), jax.nn.silu)
    elif kind == "gated_gelu":  # jax.nn.gelu's default is the tanh approximation
        got, want = tl.mlp_gated(pt, _t(x), tl.gelu), jl.mlp_gated(pj, jnp.asarray(x), jax.nn.gelu)
    elif kind == "squared_relu":
        got, want = tl.mlp_act(pt, _t(x), tl.squared_relu), jl.mlp_act(pj, jnp.asarray(x), jl.squared_relu)
    else:
        got, want = tl.mlp_act(pt, _t(x), tl.gelu), jl.mlp_act(pj, jnp.asarray(x), jax.nn.gelu)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_q", [0, 48])
def test_plain_attention_matches_jax(block_q):
    """The plain route, dense and query-blocked (96 = 2 blocks of 48), with
    a prefix mask and a cache-validity mask, against the XLA path."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 96, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
    valid = rng.random((2, 96)) < 0.8
    pos = np.arange(96)
    kw = dict(kind="prefix", attn_softcap=30.0, block_q=block_q)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(pos),
                        kv_pos=jnp.asarray(pos), prefix_len=jnp.asarray(10), kv_valid=jnp.asarray(valid), **kw)
    got = tl.attention(_t(q), _t(k), _t(v), q_pos=_t(pos), kv_pos=_t(pos), prefix_len=torch.tensor(10),
                       kv_valid=_t(valid), impl="plain", **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)


def test_configs_match_jax_and_translate_attn_impl():
    assert list_archs() == sorted(ARCHS)
    for arch in ARCHS:
        for smoke in (False, True):
            jcfg = jax_get_config(arch, smoke=smoke)
            cfg = config_from_jax(jcfg)
            assert cfg == get_config(arch, smoke=smoke)
            assert cfg.attn_impl == "plain" and cfg.hd == jcfg.hd
            assert config_from_jax(jcfg.replace(attn_impl="pallas")).attn_impl == "flash"
    assert ATTN_IMPL_FROM_JAX == {"xla": "plain", "pallas": "flash"}
    assert get_config("gemma2-2b").pdtype() == torch.bfloat16
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("granite-20b")
    with pytest.raises(ValueError):
        get_config("gemma2-2b").replace(param_dtype="float16").pdtype()
    with pytest.raises(ValueError):
        get_config("gemma2-2b").replace(attn_impl="pallas")


def _jax_params(cfg_j, seed):
    """JAX init tree as numpy, with noise on the norm gains so (1 + gamma) is
    not 1."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                         if "ln" in jax.tree_util.keystr(path) else 0),
        jax_init_params(cfg_j, jax.random.PRNGKey(seed)),
    )
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_shapes_dtypes_and_count(arch):
    cfg_j = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg_j, jax.random.PRNGKey(0)))
    cfg = config_from_jax(cfg_j)
    params = params_from_jax(cfg, tree, device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    assert param_count(params) == jax_param_count(tree)
    period = tree["layers"]["ln1"].shape[1]
    for i, layer in enumerate(params["layers"]):
        g, sub = divmod(i, period)
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), tree["layers"]["attn"]["wq"][g, sub])
        assert layer["attn"]["wq"].shape == (cfg.d_model, cfg.num_heads, cfg.hd)
        assert layer["attn"]["wq"].dtype == torch.float32
    assert ("ln1b" in params["layers"][0]) == (arch == "gemma2-2b")
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    # the port's own init: same tree shape, count and distribution
    own = init_params(cfg, 0, device="cpu")
    assert param_count(own) == param_count(params)
    for name, fan_in in (("wq", cfg.d_model), ("wo", cfg.num_heads * cfg.hd)):
        a, b = own["layers"][0]["attn"][name], params["layers"][0]["attn"][name]
        assert a.shape == b.shape and a.dtype == b.dtype
        # a normal truncated at +-2 sigma, sigma = 1/sqrt(fan_in): its std is
        # 0.8796 sigma; 65k draws put the sample std within 1% of that
        sigma = fan_in ** -0.5
        for w in (a, b):
            np.testing.assert_allclose(w.std().item(), 0.8796 * sigma, rtol=0.02)
            assert w.abs().max().item() <= 2 * sigma * (1 + 1e-6)
    flops = model_flops_per_token(params, cfg, 128, "prefill")
    assert flops == 2.0 * param_count(params) + 4.0 * cfg.num_layers * cfg.hd * cfg.num_heads * 128 / 2


def test_params_from_jax_keeps_bfloat16():
    a = np.asarray(jnp.asarray(np.random.default_rng(4).normal(size=(3, 5)), dtype=jnp.bfloat16))
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """gemma2-2b SMOKE (window 32: the sliding layers cut at S = 128) and
    deepseek-7b SMOKE at B = 2, S = 128, float32. Logits agree to 1e-4:
    the matrix products sum in another order in the two packages, and the
    differences pass through two layers and a 512-way head."""
    cfg_j = jax_get_config(arch, smoke=True).replace(attn_impl="pallas", attn_block_q=64)
    tree = _jax_params(cfg_j, 0)
    batch_np = {"tokens": np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 128)).astype(np.int32)}
    want = np.asarray(jax_prefill_fn(jax.tree.map(jnp.asarray, tree), cfg_j,
                                     {"tokens": jnp.asarray(batch_np["tokens"])}))
    assert np.isfinite(want).all()

    cfg = config_from_jax(cfg_j)
    assert cfg.attn_impl == "flash"
    params = params_from_jax(cfg, tree, device="cpu")
    batch = {"tokens": torch.from_numpy(batch_np["tokens"]).long()}
    before = fa.launches
    got = build_prefill_step(cfg)(params, batch)
    assert fa.launches == before  # CPU: the kernel's plain version
    assert got.dtype == torch.float32 and got.shape == (2, 128, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the plain route gives the same logits
    plain = prefill_fn(params, cfg.replace(attn_impl="plain"), batch)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-4, atol=1e-4)


def test_make_dummy_batch_draws_like_jax():
    from repro.models import make_dummy_batch as jax_make_dummy_batch

    cfg_j = jax_get_config("gemma2-2b", smoke=True)
    want = np.asarray(jax_make_dummy_batch(cfg_j, 2, 16, "train", np.random.default_rng(7))["tokens"])
    got = make_dummy_batch(config_from_jax(cfg_j), 2, 16, "train", np.random.default_rng(7), device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma2-2b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dummy_batch(cfg, 1, 8, "prefill", np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prefill_fn({}, cfg.replace(family="moe"), {})


def test_tensor_from_numpy_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """tensor_from_numpy defaults to the card, as the other entry points do,
    and refuses to carry on quietly on the CPU without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensor_from_numpy(np.zeros(3, np.float32))
    assert tensor_from_numpy(np.zeros(3, np.float32), device="cpu").device.type == "cpu"
