"""The port's KV-cache decode and serving path against the JAX package, on
the CPU.

Every ported arch's SMOKE model (JAX-initialised weights, with noise on the
norm gains, carried over by ``params_from_jax``; float32) goes through the
reference's decode cases: ``test_decode_smoke`` (B = 2, S = 32, two steps:
logits within 1e-4, the tolerance of ``test_torch_models.py``'s prefill,
caches within 1e-5), ``test_decode_matches_prefill`` (T = 8, within the
reference's 2e-3) and ``test_gemma2_windowed_decode_matches_prefill``
(window 4, T = 16: the sliding layers' windowed slice), plus the serve
step, the serve launcher's loop and CLI, the in-place cache and
``supports_mode``. MoE configs decode with ``moe_impl="einsum"``, as the
reference's decode test and launcher do.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.models import decode_fn as jax_decode_fn
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import supports_mode as jax_supports_mode
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import build_serve_step
from repro_torch.launch import serve
from repro_torch.models import (
    cache_from_jax,
    cache_to_jax,
    config_from_jax,
    decode_fn,
    init_cache,
    params_from_jax,
    prefill_fn,
    supports_mode,
)
from repro_torch.models.dense import write_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma2-2b", "deepseek-7b", "granite-20b", "minitron-8b", "olmoe-1b-7b", "deepseek-v3-671b"]
B, S = 2, 32
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
TOL_CACHE = dict(rtol=1e-5, atol=1e-5)
TOL_PREFILL = dict(rtol=2e-3, atol=2e-3)  # the reference's test_decode_matches_prefill


def _jax_params(cfg_j, seed):
    """JAX init tree as numpy, with noise on the norm gains so (1 + gamma) is
    not 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                         if "ln" in jax.tree_util.keystr(path) else 0),
        jax_init_params(cfg_j, jax.random.PRNGKey(seed)),
    )


def _setup(arch, **kw):
    cfg_j = jax_get_config(arch, smoke=True).replace(**kw)
    if cfg_j.num_experts:
        cfg_j = cfg_j.replace(moe_impl="einsum")
    tree = _jax_params(cfg_j, 0)
    cfg = config_from_jax(cfg_j)
    return cfg_j, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(cfg, tree, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close_caches(got, want, **tol):
    """A port cache as numpy (``cache_to_jax``) against a JAX cache."""
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_smoke_matches_jax(arch):
    """The reference's decode smoke inputs: two steps of the same token at
    positions 0 and 1 from a zero cache of S = 32 slots."""
    cfg_j, jp, cfg, params = _setup(arch)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jax_decode_fn(p, cfg_j, c, t, pos))
    jcache, cache = jax_init_cache(cfg_j, B, S), init_cache(cfg, B, S, device="cpu")
    outs = []
    for pos in (0, 1):
        want, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, cache = decode_fn(params, cfg, cache, _t(tok), pos)
        assert got.shape == (B, 1, cfg.vocab_size) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
        _close_caches(cache_to_jax(cfg, cache), jcache, **TOL_CACHE)
        outs.append(got.clone())
    assert not torch.allclose(outs[0], outs[1])  # the cache advanced


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode step by step equals the parallel forward (the
    reference's case, T = 8, for every ported arch)."""
    _, _, cfg, params = _setup(arch)
    T = 8
    tokens = _t(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)))
    full = prefill_fn(params, cfg, {"tokens": tokens})
    cache = init_cache(cfg, B, T, device="cpu")
    step = torch.cat([decode_fn(params, cfg, cache, tokens[:, t:t + 1], t)[0] for t in range(T)], dim=1)
    np.testing.assert_allclose(step.numpy(), full.numpy(), **TOL_PREFILL)


def test_gemma2_windowed_decode_matches_prefill_and_jax():
    """window 4, T = 16 > 2 x window: the sliding layers attend to the
    windowed slice of the cache; the result equals the port's prefill
    (2e-3) and JAX's decode (1e-4)."""
    cfg_j, jp, cfg, params = _setup("gemma2-2b", window=4)
    T = 16
    tok_np = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    tokens = _t(tok_np)
    full = prefill_fn(params, cfg, {"tokens": tokens})
    jstep = jax.jit(lambda p, c, t, pos: jax_decode_fn(p, cfg_j, c, t, pos))
    cache, jcache = init_cache(cfg, 2, T, device="cpu"), jax_init_cache(cfg_j, 2, T)
    got, want = [], []
    for t in range(T):
        lg, cache = decode_fn(params, cfg, cache, tokens[:, t:t + 1], t)
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok_np[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        got.append(lg)
        want.append(np.asarray(jl))
    got = torch.cat(got, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL_PREFILL)
    np.testing.assert_allclose(got.numpy(), np.concatenate(want, axis=1), **TOL_LOGITS)
    _close_caches(cache_to_jax(cfg, cache), jcache, **TOL_CACHE)


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_serve_step_matches_the_reference_unsharded(arch):
    """``build_serve_step`` against the reference's ``serve_step`` (jitted,
    no mesh): the same greedy tokens and caches over 6 steps fed back."""
    cfg_j, jp, cfg, params = _setup(arch)
    jstep = jax.jit(jax_build_serve_step(cfg_j))
    step = build_serve_step(cfg)
    tok_np = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jtok, tok = jnp.asarray(tok_np), _t(tok_np)
    jcache, cache = jax_init_cache(cfg_j, B, 8), init_cache(cfg, B, 8, device="cpu")
    for pos in range(6):
        jtok, jcache = jstep(jp, jcache, jtok, jnp.asarray(pos, jnp.int32))
        tok, cache = step(params, cache, tok, pos)
        assert tok.shape == (B, 1) and tok.dtype == torch.int64
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _close_caches(cache_to_jax(cfg, cache), jcache, **TOL_CACHE)


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "deepseek-v3-671b"])
def test_generate_gives_the_tokens_of_a_jax_loop(arch):
    """``launch/serve.py::generate`` with converted weights against the
    reference launcher's loop (teacher-forced prompt, then greedy steps) over
    JAX's ``decode_fn`` on the same weights."""
    cfg_j, jp, cfg, params = _setup(arch)
    P, G = 8, 6
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jax_decode_fn(p, cfg_j, c, t, pos))
    jcache = jax_init_cache(cfg_j, B, P + G)
    for t in range(P):
        lg, jcache = jstep(jp, jcache, jnp.asarray(prompts[:, t:t + 1]), jnp.asarray(t, jnp.int32))
    tok, want = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32), []
    for t in range(P, P + G):
        want.append(np.asarray(tok))
        lg, jcache = jstep(jp, jcache, tok, jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out, cache, times = serve.generate(params, serve.serve_config(cfg), _t(prompts), G)
    np.testing.assert_array_equal(out.numpy(), np.concatenate(want, axis=1))
    assert all(t >= 0 for t in times)
    _close_caches(cache_to_jax(cfg, cache), jcache, **TOL_CACHE)


def test_serve_launcher_cli_on_the_cpu():
    """The reference's ``test_serve_launcher`` invocation, with ``--device
    cpu``."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma2-2b", "--batch", "2", "--prompt-len", "8",
         "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2500:]
    assert "decode" in proc.stdout and "on CPU" in proc.stdout


def test_serve_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma2-2b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma2-2b", "--batch", "1", "--prompt-len", "2", "--gen", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(get_config("olmoe-1b-7b", smoke=True), 1, 4)
    assert init_cache(cfg.replace(family="encoder"), 1, 4, device="cpu") is None  # the reference's
    with pytest.raises(ValueError, match="encoder has no decode step"):
        decode_fn({}, cfg.replace(family="encoder"), None, None, 0)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.serve_config(cfg.replace(family="encoder"))


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
def test_decode_writes_the_cache_in_place(arch):
    """A step returns the same cache tensors, on the same storage, with the
    new keys and values written at ``pos`` and nothing else changed; an int
    and a 0-d tensor position give the same step."""
    _, _, cfg, params = _setup(arch)
    cache = init_cache(cfg, B, 8, device="cpu")
    tensors = jax.tree.leaves(cache)
    ptrs = [t.data_ptr() for t in tensors]
    tok = _t(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 1)))
    before = [t.clone() for t in tensors]
    lg, new = decode_fn(params, cfg, cache, tok, 3)
    assert all(a is b for a, b in zip(jax.tree.leaves(new), tensors))
    assert [t.data_ptr() for t in tensors] == ptrs
    for t, b in zip(tensors, before):  # every cache tensor is (layers, B, S_max, ...)
        written = (t != b).movedim(2, 0).reshape(t.shape[2], -1).any(dim=1)
        assert written.nonzero().flatten().tolist() == [3]
    other = init_cache(cfg, B, 8, device="cpu")
    lg2, _ = decode_fn(params, cfg, other, tok, torch.tensor(3, dtype=torch.int32))
    assert torch.equal(lg, lg2)
    for a, b in zip(jax.tree.leaves(other), tensors):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pos", [0, 5, 6, 7, 9])
def test_write_cache_clamps_like_dynamic_update_slice(pos):
    rng = np.random.default_rng(pos)
    cache = rng.normal(size=(2, 8, 3, 4)).astype(np.float32)
    x = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    want = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(cache), jnp.asarray(x), jnp.asarray(pos), axis=1)
    got = torch.from_numpy(cache.copy())
    out = write_cache(got, torch.from_numpy(x), torch.tensor(pos))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "deepseek-v3-671b"])
def test_cache_converters_round_trip(arch):
    cfg_j, _, cfg, _ = _setup(arch)
    rng = np.random.default_rng(9)
    jcache = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jax_init_cache(cfg_j, B, 5))
    cache = cache_from_jax(cfg, jcache, device="cpu")
    if cfg.family == "dense":
        assert cache[0].shape == (cfg.num_layers, B, 5, cfg.num_kv_heads, cfg.hd)
        period = jcache[0].shape[1]
        for i in range(cfg.num_layers):
            np.testing.assert_array_equal(cache[0][i].numpy(), jcache[0][i // period, i % period])
    back = cache_to_jax(cfg, cache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(a, b)


def test_supports_mode_matches_jax_for_every_ported_arch():
    ported = ARCHS + ["xlstm-1.3b", "zamba2-2.7b", "hubert-xlarge", "paligemma-3b"]
    assert list_archs() == jax_list_archs() == sorted(ported)
    for arch in ported:
        for smoke in (False, True):
            cfg_j = jax_get_config(arch, smoke=smoke)
            for shape in INPUT_SHAPES.values():
                assert supports_mode(config_from_jax(cfg_j), shape) == jax_supports_mode(cfg_j, shape), (arch, shape)
