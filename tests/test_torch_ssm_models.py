"""The port's xLSTM (``ssm``) and Zamba2 (``hybrid``) families against the
JAX package, on the CPU.

xlstm-1.3b and zamba2-2.7b SMOKE (float32; JAX-initialised weights with
noise on the norm gains, carried over by ``params_from_jax``) go through the
reference's cases of ``tests/test_arch_smoke.py``: prefill logits within
1e-4 (the tolerance of ``test_torch_models.py``), the loss within rtol 1e-5
and its gradients within rtol 2e-3, atol 2e-5 (``test_torch_train.py``'s),
decode logits within 1e-4 of JAX's and its states within 1e-5, teacher-forced
decode within the reference's 2e-3 of the prefill, and the parameter counts.
Beside them: a collect-state prefill continued by decode, the cache
converters, Adafactor on the stacked xLSTM tree, the training step, the
serve and FL launchers, and ``model_flops_per_token`` for every ported arch.
The JAX results each test compares with are computed once per module.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_fn as jax_decode_fn
from repro.models import hybrid as jax_hybrid
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import model_flops_per_token as jax_model_flops_per_token
from repro.models import param_count as jax_param_count
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import xlstm as jax_xlstm
from repro.optim.optimizers import adafactor as jax_adafactor
from repro_torch.configs import get_config
from repro_torch.launch import build_serve_step, build_train_step, serve, value_and_grad
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
    model_flops_per_token,
    param_count,
    params_from_jax,
    prefill_fn,
)
from repro_torch.models import hybrid, xlstm
from repro_torch.optim import adafactor, tree_leaves

ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
PORTED = ["gemma2-2b", "deepseek-7b", "granite-20b", "minitron-8b", "olmoe-1b-7b", "deepseek-v3-671b"] + ARCHS + [
    "hubert-xlarge", "paligemma-3b"]
B, S, T = 2, 32, 8
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
# recurrent states, like the logits, carry the rounding of every earlier step
# and layer (test_torch_decode.py's KV caches, one projection deep, are held
# to 1e-5)
TOL_STATE = dict(rtol=1e-4, atol=1e-4)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)
TOL_PREFILL = dict(rtol=2e-3, atol=2e-3)  # the reference's test_decode_matches_prefill
UPDATE_RTOL = 2e-6  # test_torch_moe.py's Adafactor limit (its comment gives the derivation)


def _jax_params(cfg_j, seed):
    """JAX init tree as numpy, with noise on the norm gains so (1 + gamma) is
    not 1."""
    rng = np.random.default_rng(seed)
    noisy = ("'ln", "'gn")
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape).astype(np.float32) * 0.1
                                         if any(k in jax.tree_util.keystr(path) for k in noisy) else 0),
        jax.jit(jax_init_params, static_argnums=0)(cfg_j, jax.random.PRNGKey(seed)),
    )


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


class Ref:
    """One arch's SMOKE configs and weights in both packages, the tokens, and
    the JAX results, computed on first use."""

    def __init__(self, arch):
        self.cfg_j = jax_get_config(arch, smoke=True)
        self.tree = _jax_params(self.cfg_j, 0)
        self.jp = jax.tree.map(jnp.asarray, self.tree)
        self.cfg = config_from_jax(self.cfg_j)
        self.params = params_from_jax(self.cfg, self.tree, device="cpu")
        self.tokens = np.random.default_rng(1).integers(0, self.cfg.vocab_size, (B, S + 1)).astype(np.int32)
        self.jstep = jax.jit(lambda p, c, t, pos: jax_decode_fn(p, self.cfg_j, c, t, pos))
        self._memo = {}

    def memo(self, name, fn):
        if name not in self._memo:
            self._memo[name] = fn()
        return self._memo[name]

    def prefill(self):
        fn = jax.jit(lambda p, t: jax_prefill_fn(p, self.cfg_j, {"tokens": t}))
        return self.memo("prefill", lambda: np.asarray(fn(self.jp, jnp.asarray(self.tokens[:, :S]))))

    def loss_and_grads(self):
        fn = jax.jit(jax.value_and_grad(lambda p, t: jax_loss_fn(p, self.cfg_j, {"tokens": t})))
        return self.memo("grads", lambda: fn(self.jp, jnp.asarray(self.tokens)))

    def decode(self):
        """T steps from a zero cache: logits (B, T, V) and the final cache."""
        def run():
            cache, outs = jax_init_cache(self.cfg_j, B, T), []
            for t in range(T):
                lg, cache = self.jstep(self.jp, cache, jnp.asarray(self.tokens[:, t:t + 1]), jnp.asarray(t, jnp.int32))
                outs.append(np.asarray(lg))
            return np.concatenate(outs, axis=1), jax.tree.map(np.asarray, cache)

        return self.memo("decode", run)


@pytest.fixture(scope="module")
def refs():
    return {arch: Ref(arch) for arch in ARCHS}


def _close_caches(got, want, **tol):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(refs, arch):
    r = refs[arch]
    got = prefill_fn(r.params, r.cfg, {"tokens": _t(r.tokens[:, :S])})
    assert got.dtype == torch.float32 and got.shape == (B, S, r.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), r.prefill(), **TOL_LOGITS)
    if arch == "zamba2-2.7b":  # the shared block's flash route: its plain version on the CPU
        flash = prefill_fn(r.params, r.cfg.replace(attn_impl="flash"), {"tokens": _t(r.tokens[:, :S])})
        np.testing.assert_allclose(flash.numpy(), got.numpy(), **TOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(refs, arch):
    r = refs[arch]
    want_loss, want_grads = r.loss_and_grads()
    loss, grads = value_and_grad(r.params, r.cfg, {"tokens": _t(r.tokens)})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(loss_fn(r.params, r.cfg, {"tokens": _t(r.tokens)}).item(), loss.item(), rtol=1e-6)
    want = params_from_jax(r.cfg, jax.tree.map(np.asarray, want_grads), device="cpu")
    got_l, want_l = tree_leaves(grads), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(r.params))
    for g, w in zip(got_l, want_l):
        torch.testing.assert_close(g, w, **TOL_GRAD)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_prefill(refs, arch):
    """T = 8 teacher-forced steps from a zero state: each step's logits
    within 1e-4 of JAX's decode, the final state within 1e-5, and the steps
    within 2e-3 of the port's prefill of the same tokens."""
    r = refs[arch]
    want, want_cache = r.decode()
    cache = init_cache(r.cfg, B, T, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = decode_fn(r.params, r.cfg, cache, _t(r.tokens[:, t:t + 1]), t)
        assert lg.shape == (B, 1, r.cfg.vocab_size) and lg.dtype == torch.float32
        outs.append(lg)
    got = torch.cat(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), want, **TOL_LOGITS)
    _close_caches(cache_to_jax(r.cfg, cache), want_cache, **TOL_STATE)
    full = prefill_fn(r.params, r.cfg, {"tokens": _t(r.tokens[:, :T])})
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL_PREFILL)


@pytest.mark.parametrize("arch", ARCHS)
def test_collect_state_prefill_then_decode(refs, arch):
    """A collect-state prefill of the first 16 tokens (one chunk) gives the
    reference's state; decode continues from it (for zamba2 its keys and
    values copied into a longer cache) and matches the prefill of all 32
    tokens at positions 16-23."""
    r = refs[arch]
    P = 16
    head = _t(r.tokens[:, :P])
    port_fwd, jax_fwd = ((xlstm.xlstm_forward, jax_xlstm.xlstm_forward) if arch == "xlstm-1.3b"
                         else (hybrid.zamba_forward, jax_hybrid.zamba_forward))
    logits, state = port_fwd(r.params, r.cfg, head, collect_state=True)
    want_logits, want_state = jax.jit(lambda p, t: jax_fwd(p, r.cfg_j, t, collect_state=True))(
        r.jp, jnp.asarray(r.tokens[:, :P]))
    if arch == "zamba2-2.7b":
        with pytest.raises(ValueError, match="exactly S"):  # the reference's contract
            hybrid.zamba_forward(r.params, r.cfg, head, state=init_cache(r.cfg, B, P + 1, device="cpu"),
                                 collect_state=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL_LOGITS)
    _close_caches(cache_to_jax(r.cfg, jax.tree.map(lambda x: x.detach(), state)), want_state, **TOL_STATE)
    if arch == "zamba2-2.7b":
        cache = init_cache(r.cfg, B, S, device="cpu")
        cache = {"mamba": state["mamba"], "attn": cache["attn"]}
        for dst, src in zip(cache["attn"], state["attn"]):
            dst[:, :, :P].copy_(src)
    else:
        cache = state
    outs = []
    for t in range(P, P + T):
        lg, cache = decode_fn(r.params, r.cfg, cache, _t(r.tokens[:, t:t + 1]), t)
        outs.append(lg)
    full = prefill_fn(r.params, r.cfg, {"tokens": _t(r.tokens[:, :S])})
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full[:, P:P + T].numpy(), **TOL_PREFILL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_converters_round_trip(refs, arch):
    r = refs[arch]
    rng = np.random.default_rng(9)
    jcache = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jax_init_cache(r.cfg_j, B, 5))
    cache = cache_from_jax(r.cfg, jcache, device="cpu")
    own = init_cache(r.cfg, B, 5, device="cpu")
    assert [t.shape for t in jax.tree.leaves(cache)] == [t.shape for t in jax.tree.leaves(own)]
    if arch == "xlstm-1.3b":
        per = r.cfg.slstm_every - 1
        conv = jcache["mlstm"][0]
        for i in range(conv.shape[0] * per):
            np.testing.assert_array_equal(cache["mlstm"][0][i].numpy(), conv[i // per, i % per])
    else:
        per = r.cfg.shared_attn_every
        ssd = jcache["mamba"][1]
        for i in range(r.cfg.num_layers):
            np.testing.assert_array_equal(cache["mamba"][1][i].numpy(), ssd[i // per, i % per])
    back = cache_to_jax(r.cfg, cache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(a, b)


def test_zamba_decode_writes_the_kv_cache_in_place_and_replaces_the_states(refs):
    r = refs["zamba2-2.7b"]
    cache = init_cache(r.cfg, B, 8, device="cpu")
    k, v = cache["attn"]
    ptrs = [k.data_ptr(), v.data_ptr()]
    states = [t.clone() for t in cache["mamba"]]
    _, new = decode_fn(r.params, r.cfg, cache, _t(r.tokens[:, :1]), 3)
    assert new["attn"][0] is k and new["attn"][1] is v and [k.data_ptr(), v.data_ptr()] == ptrs
    for t in (k, v):
        written = (t != 0).movedim(2, 0).reshape(8, -1).any(dim=1)
        assert written.nonzero().flatten().tolist() == [3]
    for old, b in zip(cache["mamba"], states):
        assert torch.equal(old, b)  # the given states are left as they were
    assert all(a is not b and not torch.equal(a, b) for a, b in zip(new["mamba"], states))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(refs, arch):
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
    stacks = layer_stacks(r.cfg)
    for name, lead in stacks.items():
        assert len(own[name]) == math.prod(lead)


def test_param_counts_full_configs():
    """The FULL configs' analytic parameter counts in the reference's
    ballparks (tests/test_arch_smoke.py::test_param_counts_full_configs)."""
    from test_arch_smoke import _analytic_param_count

    for arch, (lo, hi) in {"xlstm-1.3b": (1.0e9, 1.8e9), "zamba2-2.7b": (2.2e9, 3.4e9)}.items():
        n = _analytic_param_count(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B"


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", PORTED)
def test_model_flops_per_token_matches_jax(arch, mode):
    """For every ported arch: the reference's accounting on the same
    parameter shapes, the attention term only for the attention families."""
    cfg_j = jax_get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda: jax_init_params(cfg_j, jax.random.PRNGKey(0)))
    cfg = config_from_jax(cfg_j)
    params = init_params(cfg, 0, device="cpu")
    got = model_flops_per_token(params, cfg, 256, mode)
    assert got == jax_model_flops_per_token(shapes, cfg_j, 256, mode)
    if cfg.family in ("ssm", "hybrid"):  # no attention term
        assert got == (6.0 if mode == "train" else 2.0) * param_count(params)


def test_adafactor_matches_jax_on_the_xlstm_tree():
    """Three steps on the xlstm SMOKE tree from the same numpy parameters and
    gradients: the reference stacks the mLSTM blocks ``(n_groups, period -
    1)`` and the sLSTM blocks ``(n_groups,)``, and ``layer_stacks`` hands the
    port the same axes; updates within rtol UPDATE_RTOL, moments within
    rtol 1e-6."""
    cfg_j = jax_get_config("xlstm-1.3b", smoke=True)
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
    G = cfg.num_layers // cfg.slstm_every
    assert ts.vr["mlstm"]["ln"].shape == (G, cfg.slstm_every - 1) and ts.vr["slstm"]["rz"].shape[0] == G
    for g in grads:
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(cfg, g, device="cpu"), ts, tp)
        want = params_from_jax(cfg, jax.tree.map(np.asarray, ju), device="cpu")
        for a, b in zip(tree_leaves(tu), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=UPDATE_RTOL, atol=0)
        for got, ref in ((ts.vr, js.vr), (ts.vc, js.vc)):
            np.testing.assert_allclose(got["mlstm"]["w_up"].numpy(), np.asarray(ref["groups"]["mlstm"]["w_up"]),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(got["slstm"]["rz"].numpy(), np.asarray(ref["groups"]["slstm"]["rz"]),
                                       rtol=1e-6, atol=0)
    assert int(ts.step) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_lowers_the_loss(arch):
    """``build_train_step`` with the config's optimizer (AdamW) and with
    Adafactor over ``layer_stacks``, remat "full": three steps on one batch
    lower the loss."""
    for kw in ({"remat": "full"}, {"optimizer": "adafactor"}):
        cfg = get_config(arch, smoke=True).replace(**kw)
        params = init_params(cfg, 0, device="cpu")
        batch = {"tokens": _t(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17)))}
        step, opt = build_train_step(cfg)
        state = opt.init(params)
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state, batch)
            losses.append(loss.item())
        assert np.isfinite(losses).all() and losses[2] < losses[0], (kw, losses)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_and_generate_give_the_tokens_of_a_jax_loop(refs, arch):
    """``launch/serve.py::generate`` (a prompt of 8 teacher-forced, then 4
    greedy steps) against the same loop over JAX's ``decode_fn``, and the
    serve step's token against its logits' argmax."""
    r = refs[arch]
    P, G = 8, 4
    prompts = r.tokens[:, :P]
    jcache = jax_init_cache(r.cfg_j, B, P + G)
    for t in range(P):
        lg, jcache = r.jstep(r.jp, jcache, jnp.asarray(prompts[:, t:t + 1]), jnp.asarray(t, jnp.int32))
    tok, want = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32), []
    for t in range(P, P + G):
        want.append(np.asarray(tok))
        lg, jcache = r.jstep(r.jp, jcache, tok, jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out, cache, _ = serve.generate(r.params, serve.serve_config(r.cfg), _t(prompts), G)
    np.testing.assert_array_equal(out.numpy(), np.concatenate(want, axis=1))
    _close_caches(cache_to_jax(r.cfg, cache), jax.tree.map(np.asarray, jcache), **TOL_STATE)
    tok, _ = build_serve_step(r.cfg)(r.params, init_cache(r.cfg, B, 4, device="cpu"), _t(prompts[:, :1]), 0)
    lg, _ = decode_fn(r.params, r.cfg, init_cache(r.cfg, B, 4, device="cpu"), _t(prompts[:, :1]), 0)
    assert tok.dtype == torch.int64 and torch.equal(tok, lg[:, -1].argmax(dim=-1, keepdim=True))


def test_serve_launcher_runs_xlstm_on_the_cpu(capsys):
    serve.main(["--arch", "xlstm-1.3b", "--batch", "2", "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b batch=2 prompt=4 gen=3" in out and "on CPU" in out


def test_fl_launcher_runs_xlstm_on_the_cpu():
    """The FL launcher's campaign with xlstm SMOKE clients: two rounds of
    three clients, finite losses, the whole workload assigned each round."""
    args = fl_launcher.parse_args(["--arch", "xlstm-1.3b", "--device", "cpu", "--clients", "3", "--max-batches",
                                   "4", "--seq", "16", "--batch", "2", "--rounds", "2"])
    lines = []
    server, hist = fl_launcher.run(args, log=lines.append)
    assert lines[0].startswith("arch=xlstm-1.3b (smoke)")
    assert len(hist.rounds) == 2 and np.isfinite(hist.losses).all()
    assert all(int(r.assignments.sum()) == fl_launcher.make_world(args, 512)[3] for r in hist.rounds)
    assert all(torch.isfinite(p).all() for p in tree_leaves(server.params))
