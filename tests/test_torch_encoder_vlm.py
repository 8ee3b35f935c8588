"""The port's encoder (HuBERT) and vlm (PaliGemma) families against the JAX
package, on the CPU.

hubert-xlarge and paligemma-3b SMOKE (float32; JAX-initialised weights with
noise on the norm gains, carried over by ``params_from_jax``) go through the
JAX functions and the port's on the same numpy inputs: logits within 1e-4
(the tolerance of ``test_torch_models.py``), losses within rtol 1e-5 and
gradients within rtol 2e-3, atol 2e-5 (``test_torch_train.py``'s), KV caches
within 1e-5 and decode logits within 1e-4 (``test_torch_decode.py``'s),
decode against prefill within the reference's 2e-3
(``test_arch_smoke.py::test_decode_matches_prefill``). Beside them: the
prefix-LM mask of ``layers.attention``, ``make_dummy_batch``'s draws, the
parameter trees, the cache converters, the training step and the launchers.
The JAX results each test compares with are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.models import encoder as jax_encoder
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models import loss_fn as jax_loss_fn
from repro.models import make_dummy_batch as jax_make_dummy_batch
from repro.models import param_count as jax_param_count
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import vlm as jax_vlm
from repro_torch.configs import get_config
from repro_torch.launch import build_prefill_step, build_train_step, serve, value_and_grad
from repro_torch.launch import train as fl_launcher
from repro_torch.models import (
    cache_from_jax,
    cache_to_jax,
    config_from_jax,
    decode_fn,
    init_cache,
    init_params,
    layer_stacks,
    loss_fn,
    make_dummy_batch,
    param_count,
    params_from_jax,
    prefill_fn,
)
from repro_torch.models import encoder, layers, vlm
from repro_torch.optim import tree_leaves

HUBERT, PALIGEMMA = "hubert-xlarge", "paligemma-3b"
ARCHS = [HUBERT, PALIGEMMA]
B, S = 2, 40  # paligemma SMOKE: 16 patches + 24 text tokens
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
TOL_CACHE = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)
TOL_PREFILL = dict(rtol=2e-3, atol=2e-3)  # the reference's test_decode_matches_prefill


def _jax_params(cfg_j, seed):
    """JAX init tree as numpy, with noise on the norm gains so (1 + gamma) is
    not 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                         if "'ln" in jax.tree_util.keystr(path) else 0),
        jax.jit(jax_init_params, static_argnums=0)(cfg_j, jax.random.PRNGKey(seed)),
    )


def _port_batch(batch):
    """A JAX batch of numpy arrays as the port's tensors (integers int64)."""
    return {k: torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype.kind == "i"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


class Ref:
    """One arch's SMOKE configs and weights in both packages, a train batch
    from the reference's ``make_dummy_batch`` (numpy), and the JAX results,
    computed on first use."""

    def __init__(self, arch):
        self.cfg_j = jax_get_config(arch, smoke=True)
        self.tree = _jax_params(self.cfg_j, 0)
        self.jp = jax.tree.map(jnp.asarray, self.tree)
        self.cfg = config_from_jax(self.cfg_j)
        self.params = params_from_jax(self.cfg, self.tree, device="cpu")
        self.batch = jax.tree.map(np.asarray, jax_make_dummy_batch(self.cfg_j, B, S, "train",
                                                                   np.random.default_rng(1)))
        self.tb = _port_batch(self.batch)
        self._memo = {}

    def memo(self, name, fn):
        if name not in self._memo:
            self._memo[name] = fn()
        return self._memo[name]

    def loss_and_grads(self):
        fn = jax.jit(jax.value_and_grad(lambda p, b: jax_loss_fn(p, self.cfg_j, b)))
        return self.memo("grads", lambda: fn(self.jp, self.batch))


@pytest.fixture(scope="module")
def refs():
    return {arch: Ref(arch) for arch in ARCHS}


def _close_tree(got, want, **tol):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# hubert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_hubert_forward_matches_jax(refs, masked):
    r = refs[HUBERT]
    mask = r.batch["mask"] if masked else None
    want = jax.jit(lambda p, f, m: jax_encoder.hubert_forward(p, r.cfg_j, f, m))(r.jp, r.batch["frames"], mask)
    got = encoder.hubert_forward(r.params, r.cfg, r.tb["frames"], r.tb["mask"] if masked else None)
    assert got.dtype == torch.float32 and got.shape == (B, S, r.cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL_LOGITS)
    if not masked:  # prefill_fn passes no mask, as the reference's does
        np.testing.assert_allclose(prefill_fn(r.params, r.cfg, r.tb).numpy(), got.detach().numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(jax.jit(lambda p, b: jax_prefill_fn(p, r.cfg_j, b))(r.jp, r.batch)),
                                   np.asarray(want), rtol=0, atol=0)
    else:  # the mask changes the masked frames' logits
        assert not np.allclose(got.detach().numpy(), encoder.hubert_forward(r.params, r.cfg, r.tb["frames"]).numpy())


def test_hubert_flash_route_matches_the_plain_route(refs):
    """The bidirectional layers on the flash route (the kernel's plain
    version on CPU tensors) give the plain route's logits."""
    r = refs[HUBERT]
    calls = []
    inner = layers.flash_attention

    def spy(*args, **kw):
        calls.append(args[3])
        return inner(*args, **kw)

    layers.flash_attention = spy
    try:
        got = prefill_fn(r.params, r.cfg.replace(attn_impl="flash"), r.tb)
    finally:
        layers.flash_attention = inner
    assert calls == ["bidirectional"] * r.cfg.num_layers
    np.testing.assert_allclose(got.numpy(), prefill_fn(r.params, r.cfg, r.tb).numpy(), **TOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(refs, arch):
    r = refs[arch]
    want_loss, want_grads = r.loss_and_grads()
    loss, grads = value_and_grad(r.params, r.cfg, r.tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(loss_fn(r.params, r.cfg, r.tb).item(), loss.item(), rtol=1e-6)
    want = params_from_jax(r.cfg, jax.tree.map(np.asarray, want_grads), device="cpu")
    got_l, want_l = tree_leaves(grads), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(r.params))
    for g, w in zip(got_l, want_l):
        torch.testing.assert_close(g, w, **TOL_GRAD)


def test_hubert_loss_counts_only_the_masked_frames(refs):
    r = refs[HUBERT]
    labels = r.tb["labels"].clone()
    labels[~r.tb["mask"]] = (labels[~r.tb["mask"]] + 1) % r.cfg.vocab_size
    assert loss_fn(r.params, r.cfg, {**r.tb, "labels": labels}).item() == loss_fn(r.params, r.cfg, r.tb).item()


def test_encoder_has_no_cache_and_no_decode_step(refs):
    r = refs[HUBERT]
    assert init_cache(r.cfg, B, 8, device="cpu") is None and jax_init_cache(r.cfg_j, B, 8) is None
    assert cache_from_jax(r.cfg, None, device="cpu") is None and cache_to_jax(r.cfg, None) is None
    with pytest.raises(ValueError, match="encoder has no decode step"):
        decode_fn(r.params, r.cfg, None, r.tb["labels"][:, :1], 0)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", HUBERT, "--device", "cpu"])


# ---------------------------------------------------------------------------
# paligemma
# ---------------------------------------------------------------------------


def _pali_forward(r):
    def run():
        fn = jax.jit(lambda p, x, t: jax_vlm.paligemma_forward(p, r.cfg_j, x, t, collect_cache=True))
        lg, caches = fn(r.jp, r.batch["patches"], r.batch["tokens"][:, :-1])
        return np.asarray(lg), jax.tree.map(np.asarray, caches)

    return r.memo("forward", run)


def test_paligemma_forward_and_caches_match_jax(refs):
    """Text logits (the image positions dropped) and every layer's keys and
    values over image and text, collected by the prefill."""
    r = refs[PALIGEMMA]
    want, want_caches = _pali_forward(r)
    P, St = r.cfg.num_patches, r.tb["tokens"].shape[1] - 1
    logits, caches = vlm.paligemma_forward(r.params, r.cfg, r.tb["patches"], r.tb["tokens"][:, :-1],
                                           collect_cache=True)
    assert logits.shape == (B, St, r.cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL_LOGITS)
    assert caches[0].shape == (r.cfg.num_layers, B, P + St, r.cfg.num_kv_heads, r.cfg.hd)
    _close_tree(cache_to_jax(r.cfg, tuple(c.detach() for c in caches)), want_caches, **TOL_CACHE)
    got = prefill_fn(r.params, r.cfg, {"patches": r.tb["patches"], "tokens": r.tb["tokens"][:, :-1]})
    np.testing.assert_allclose(got.numpy(), logits.detach().numpy(), rtol=0, atol=0)
    batch = {"patches": r.batch["patches"], "tokens": r.batch["tokens"][:, :-1]}
    np.testing.assert_allclose(np.asarray(jax.jit(lambda p, b: jax_prefill_fn(p, r.cfg_j, b))(r.jp, batch)), want,
                               rtol=0, atol=0)


def test_paligemma_decode_step_matches_jax_on_the_converted_cache(refs):
    """One decode step after the image + text prefill, on JAX's collected
    keys and values moved into a longer cache: logits within 1e-4, the cache
    within 1e-5 and written at ``pos`` in place."""
    r = refs[PALIGEMMA]
    _, want_caches = _pali_forward(r)
    n = want_caches[0].shape[3]  # (n_groups, period, B, S, Hkv, hd)
    jcache = tuple(np.zeros(c.shape[:3] + (n + 4,) + c.shape[4:], np.float32) for c in want_caches)
    for dst, src in zip(jcache, want_caches):
        dst[:, :, :, :n] = src
    tok = r.batch["tokens"][:, -1:]
    want, want_new = jax.jit(lambda p, c, t, pos: jax_vlm.paligemma_decode_step(p, r.cfg_j, c, t, pos))(
        r.jp, tuple(map(jnp.asarray, jcache)), jnp.asarray(tok), jnp.asarray(n, jnp.int32))
    cache = cache_from_jax(r.cfg, jcache, device="cpu")
    ptrs = [c.data_ptr() for c in cache]
    got, new = decode_fn(r.params, r.cfg, cache, r.tb["tokens"][:, -1:], n)
    assert [c.data_ptr() for c in new] == ptrs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
    _close_tree(cache_to_jax(r.cfg, new), jax.tree.map(np.asarray, want_new), **TOL_CACHE)


def test_paligemma_decode_matches_its_prefill(refs):
    """The reference's test_decode_matches_prefill case: a collect-cache
    prefill of the image and the first 8 text tokens fills the cache, 8
    teacher-forced decode steps continue causally, and their logits match
    the prefill of image and all 16 tokens at those positions."""
    r = refs[PALIGEMMA]
    P, n0, T = r.cfg.num_patches, 8, 8
    tokens, patches = r.tb["tokens"][:, :n0 + T], r.tb["patches"]
    full, _ = vlm.paligemma_forward(r.params, r.cfg, patches, tokens)
    _, (k, v) = vlm.paligemma_forward(r.params, r.cfg, patches, tokens[:, :n0], collect_cache=True)
    cache = init_cache(r.cfg, B, P + n0 + T, device="cpu")
    cache[0][:, :, :P + n0].copy_(k)
    cache[1][:, :, :P + n0].copy_(v)
    outs = []
    for t in range(n0, n0 + T):
        lg, cache = decode_fn(r.params, r.cfg, cache, tokens[:, t:t + 1], P + t)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full[:, n0:].detach().numpy(), **TOL_PREFILL)


def test_paligemma_serve_matches_a_jax_text_only_loop(refs):
    """``launch/serve.py::generate`` (text only, as the reference's launcher
    serves a VLM: 6 prompt tokens teacher-forced, then 3 greedy steps)
    against the same loop over the reference's serve step, and the cache."""
    r = refs[PALIGEMMA]
    Pr, G = 6, 3
    prompts = r.batch["tokens"][:, :Pr]
    jstep = jax.jit(jax_build_serve_step(r.cfg_j))
    jcache = jax_init_cache(r.cfg_j, B, Pr + G)
    for t in range(Pr):
        tok, jcache = jstep(r.jp, jcache, jnp.asarray(prompts[:, t:t + 1]), jnp.asarray(t, jnp.int32))
    want = []
    for t in range(Pr, Pr + G):
        want.append(np.asarray(tok))
        tok, jcache = jstep(r.jp, jcache, tok, jnp.asarray(t, jnp.int32))
    out, cache, _ = serve.generate(r.params, serve.serve_config(r.cfg), r.tb["tokens"][:, :Pr], G)
    np.testing.assert_array_equal(out.numpy(), np.concatenate(want, axis=1))
    _close_tree(cache_to_jax(r.cfg, cache), jax.tree.map(np.asarray, jcache), **TOL_CACHE)


# ---------------------------------------------------------------------------
# the prefix mask, batches, parameters, converters, steps, launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_q", [0, 16])
def test_prefix_attention_matches_jax_and_stays_off_the_kernel(block_q):
    """``attention(kind="prefix", prefix_len=P)`` (bidirectional over the
    first P positions, causal after; MQA) against the reference, whole and
    query-blocked; with ``impl="flash"`` it takes the plain route, as the
    reference's does."""
    rng = np.random.default_rng(block_q)
    Sq, P = 48, 12
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sq, 1, 16)).astype(np.float32) for _ in range(2))
    pos = np.arange(Sq)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(pos),
                        kv_pos=jnp.asarray(pos), kind="prefix", prefix_len=jnp.asarray(P, jnp.int32),
                        block_q=block_q)
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, pos))
    calls = []
    inner = layers.flash_attention
    layers.flash_attention = lambda *a, **kw: calls.append(a) or inner(*a, **kw)
    try:
        outs = [layers.attention(tq, tk, tv, q_pos=tp, kv_pos=tp, kind="prefix", prefix_len=P, block_q=block_q,
                                 impl=impl) for impl in ("plain", "flash")]
    finally:
        layers.flash_attention = inner
    assert calls == []
    for got in outs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # the image rows see the whole image block: bidirectional attention over it
    bidir = layers.attention(tq[:, :P], tk[:, :P], tv[:, :P], q_pos=tp[:P], kv_pos=tp[:P], kind="bidirectional")
    np.testing.assert_allclose(outs[0][:, :P].numpy(), bidir.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_dummy_batch_draws_as_the_reference(arch, mode):
    cfg_j = jax_get_config(arch, smoke=True)
    for S_ in (S, 20):  # paligemma: S - num_patches, and the floor of 16 text tokens
        want = jax_make_dummy_batch(cfg_j, B, S_, mode, np.random.default_rng(7))
        got = make_dummy_batch(config_from_jax(cfg_j), B, S_, mode, np.random.default_rng(7), device="cpu")
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            w = np.asarray(w)
            assert got[key].shape == w.shape
            assert got[key].dtype == {"i": torch.int64, "b": torch.bool, "f": torch.float32}[w.dtype.kind]
            np.testing.assert_array_equal(got[key].numpy(), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_trees_match_jax(refs, arch):
    r = refs[arch]
    own = init_params(r.cfg, 0, device="cpu")
    assert param_count(r.params) == param_count(own) == jax_param_count(r.tree)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for name, x in tree.items() for k, v in shapes(x, f"{path}/{name}").items()}
        if isinstance(tree, list):
            return {k: v for i, x in enumerate(tree) for k, v in shapes(x, f"{path}/{i}").items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    assert shapes(own) == shapes(r.params)
    assert layer_stacks(r.cfg) == {"layers": (r.cfg.num_layers, 1)}
    assert all(a.shape[:2] == (r.cfg.num_layers, 1) for a in jax.tree.leaves(r.tree["layers"]))
    extra = {HUBERT: {"frame_proj", "mask_emb", "head"}, PALIGEMMA: {"patch_proj", "emb"}}[arch]
    assert extra <= set(own)


def test_vlm_cache_converters_round_trip(refs):
    r = refs[PALIGEMMA]
    rng = np.random.default_rng(9)
    jcache = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jax_init_cache(r.cfg_j, B, 5))
    cache = cache_from_jax(r.cfg, jcache, device="cpu")
    assert [t.shape for t in cache] == [t.shape for t in init_cache(r.cfg, B, 5, device="cpu")]
    for a, b in zip(cache_to_jax(r.cfg, cache), jcache):
        np.testing.assert_array_equal(a, b)


def test_unknown_family_raises_value_error(refs):
    cfg = refs[HUBERT].cfg.replace(family="audio")
    for call in (lambda: init_params(cfg, 0, device="cpu"), lambda: layer_stacks(cfg),
                 lambda: params_from_jax(cfg, {}, device="cpu"), lambda: cache_from_jax(cfg, (), device="cpu"),
                 lambda: init_cache(cfg, 1, 4, device="cpu"), lambda: loss_fn({}, cfg, {})):
        with pytest.raises(ValueError, match="audio"):
            call()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_prefill_steps_run_both_families(arch):
    """``build_train_step`` (AdamW, remat "full") lowers the loss over three
    steps on one batch; ``build_prefill_step`` gives ``prefill_fn``'s
    logits."""
    cfg = get_config(arch, smoke=True).replace(remat="full")
    params = init_params(cfg, 0, device="cpu")
    batch = make_dummy_batch(cfg, 2, 32, "train", np.random.default_rng(2), device="cpu")
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[2] < losses[0], losses
    pb = make_dummy_batch(cfg, 2, 32, "prefill", np.random.default_rng(3), device="cpu")
    torch.testing.assert_close(build_prefill_step(cfg)(params, pb), prefill_fn(params, cfg, pb), rtol=0, atol=0)


def test_serve_launcher_runs_paligemma_on_the_cpu(capsys):
    serve.main(["--arch", PALIGEMMA, "--batch", "2", "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={PALIGEMMA} batch=2 prompt=4 gen=3" in out and "on CPU" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_fl_launcher_refuses_the_non_lm_families(arch):
    with pytest.raises(SystemExit, match="not an LM"):
        fl_launcher.main(["--arch", arch, "--device", "cpu"])


def test_param_counts_full_configs():
    """The FULL configs' analytic parameter counts in the reference's
    ballparks (tests/test_arch_smoke.py::test_param_counts_full_configs)."""
    from test_arch_smoke import _analytic_param_count

    for arch, (lo, hi) in {HUBERT: (0.8e9, 1.3e9), PALIGEMMA: (2.2e9, 3.5e9)}.items():
        n = _analytic_param_count(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B"
