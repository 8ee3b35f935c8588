"""The port's model sharding at 8 CPU ranks against the JAX package on one
device (the reference's ``tests/test_distribution.py`` cases).

One module fixture computes the reference's side here (jitted, one device),
writes the inputs with ``np.savez`` and runs ``tests/_torch_dist_ranks.py``
once in a subprocess, which spawns 8 gloo ranks on a (2, 4) ``("data",
"model")`` mesh (a ``FileStore`` in the test's directory, no TCP port) and
imports no JAX. Each test reads rank 0's results:

  * ``moe_impl="a2a"`` (olmoe-1b-7b SMOKE, experts on "model") against the
    reference's dense dispatch, its aux loss, and its input and expert
    gradients against ``jax.grad`` of the dense path;
  * a process group with no active mesh runs a2a as dense;
  * the sharded ``build_train_step`` of deepseek-7b SMOKE, and of gemma2-2b
    SMOKE on the flash route with ``remat="full"`` and ``remat="dots"``
    (GQA with H = 4, Hkv = 2 on a model axis of 4: replicated KV), against
    JAX's step;
  * two sharded serve steps of gemma2-2b SMOKE against JAX's unsharded ones.

The einsum dispatch against dense runs in this process.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import make_dummy_batch as jax_make_dummy_batch
from repro.models.moe_dispatch import moe_ffn as jax_moe_ffn
from repro_torch.models import config_from_jax, params_from_jax
from repro_torch.models.convert import cache_from_jax
from repro_torch.models.moe_dispatch import moe_ffn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_dist_ranks.py")
sys.path.insert(0, os.path.dirname(HELPER))
from _torch_dist_ranks import flat  # noqa: E402

# the reference's limits (tests/test_distribution.py)
MOE_ATOL = 2e-4
LOSS_ATOL = 2e-4
TOL_PARAMS = dict(rtol=3e-3, atol=3e-4)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)
CACHE_ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_flat(arch, tree, prefix):
    """The port's parameter tree of a JAX tree, flattened to ``{prefix/path:
    numpy}``."""
    cfg = config_from_jax(jax_get_config(arch, smoke=True))
    return {f"{prefix}/{k}": v.numpy() for k, v in flat(params_from_jax(cfg, _np(tree), device="cpu")).items()}


def _jax_moe(inp):
    """Writes the a2a case's inputs into ``inp``; returns the thunk that
    computes the reference's results."""
    cfg = jax_get_config("olmoe-1b-7b", smoke=True).replace(capacity_factor=4.0)
    layer = jax.tree.map(lambda a: a[0], jax_init_params(cfg, jax.random.PRNGKey(0))["moe_layers"])["moe"]
    x = np.random.default_rng(0).normal(size=(8, 16, cfg.d_model)).astype(np.float32) * np.float32(0.3)
    c = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    inp.update({"moe/x": x, "moe/c": c})
    inp.update({f"moe/p/{k}": v for k, v in flat(_np(layer)).items()})
    dense = cfg.replace(moe_impl="dense")

    def f(x, experts):
        y, _ = jax_moe_ffn(dense, {**layer, "experts": experts}, x)
        return jnp.sum(y * c)

    def want():
        y, aux = jax_moe_ffn(dense, layer, jnp.asarray(x))
        gx, ge = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), layer["experts"])
        return {"y": np.asarray(y), "aux": float(aux), "g/x": np.asarray(gx),
                **{f"g/{k}": np.asarray(v) for k, v in ge.items()}}

    return want


def _jax_train(inp, tag, arch, **replace):
    cfg = jax_get_config(arch, smoke=True).replace(**replace)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    batch = jax_make_dummy_batch(cfg, 8, 32, "train", np.random.default_rng(0))
    inp[f"{tag}/tokens"] = np.asarray(batch["tokens"])
    inp.update(_port_flat(arch, params, f"{tag}/p"))

    def want():
        step, opt = jax_build_train_step(cfg)
        p1, _, loss = jax.jit(step)(params, opt.init(params), batch)
        return {"loss": float(loss), "params": _port_flat(arch, p1, f"{tag}/p")}

    return want


def _jax_serve(inp):
    cfg = jax_get_config("gemma2-2b", smoke=True)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    B, S = 8, 64

    def want():
        step = jax.jit(jax_build_serve_step(cfg))
        cache = jax_init_cache(cfg, B, S)
        tok, toks = jnp.zeros((B, 1), jnp.int32), []
        for pos in range(2):
            tok, cache = step(params, cache, tok, jnp.asarray(pos, jnp.int32))
            toks.append(np.asarray(tok))
        k, v = cache_from_jax(config_from_jax(cfg), _np(cache), device="cpu")
        return {"tok": np.stack(toks), "k": k.numpy(), "v": v.numpy()}

    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(want, got)``: the reference's results and rank 0's. The ranks run
    while the reference's side computes."""
    d = tmp_path_factory.mktemp("ranks")
    inp = {}
    thunks = {
        "moe": _jax_moe(inp),
        "ds": _jax_train(inp, "ds", "deepseek-7b"),
        "gm": _jax_train(inp, "gm", "gemma2-2b", remat="full"),
        "gd": _jax_train(inp, "gd", "gemma2-2b", remat="dots"),
        "sv": _jax_serve(inp),
    }
    np.savez(d / "inputs.npz", **inp)
    proc = subprocess.Popen([sys.executable, HELPER, str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        want = {k: f() for k, f in thunks.items()}
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"ranks failed:\n{out[-2000:]}\n{err[-6000:]}"
    return want, dict(np.load(d / "out.npz"))


def test_moe_a2a_matches_dense(ranks):
    want, got = ranks
    np.testing.assert_allclose(got["moe/y"], want["moe"]["y"], rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(float(got["moe/aux"]), want["moe"]["aux"], rtol=1e-6)
    assert bool(got["moe/experts_on_model"])


def test_moe_a2a_gradients_match_jax_grad_of_dense(ranks):
    want, got = ranks
    for name in ("x", "w_gate", "w_in", "w_out"):
        np.testing.assert_allclose(got[f"moe/g/{name}"], want["moe"][f"g/{name}"], **TOL_GRAD, err_msg=name)


def test_moe_a2a_without_a_mesh_runs_dense(ranks):
    """The reference chooses a2a by an active mesh, not by a process group."""
    _, got = ranks
    assert bool(got["moe/no_mesh_equal"])


def test_moe_einsum_matches_dense():
    cfg_j = jax_get_config("olmoe-1b-7b", smoke=True).replace(capacity_factor=8.0)
    layer = jax.tree.map(lambda a: np.asarray(a[0]), jax_init_params(cfg_j, jax.random.PRNGKey(0))["moe_layers"])
    x = np.random.default_rng(1).normal(size=(4, 8, cfg_j.d_model)).astype(np.float32) * np.float32(0.3)
    want, _ = jax_moe_ffn(cfg_j.replace(moe_impl="dense"), jax.tree.map(jnp.asarray, layer["moe"]), jnp.asarray(x))
    cfg = config_from_jax(cfg_j)
    got, _ = moe_ffn(cfg.replace(moe_impl="einsum"), jax.tree.map(torch.from_numpy, layer["moe"]), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MOE_ATOL)


@pytest.mark.parametrize("tag", ["ds", "gm", "gd"])
def test_sharded_train_step_matches_single_device(ranks, tag):
    """deepseek-7b (``ds``) and gemma2-2b on the flash route with
    ``remat="full"`` (``gm``) and ``remat="dots"`` (``gd``, against the
    reference's step under ``checkpoint_dots_with_no_batch_dims``; the
    products are saved as DTensors, the redistributions before them
    recomputed): the loss, every parameter after the step, and the
    placements that ``train_shardings`` gives."""
    want, got = ranks
    assert abs(float(got[f"{tag}/loss"]) - want[tag]["loss"]) < LOSS_ATOL
    assert bool(got[f"{tag}/placed"])
    for k, v in want[tag]["params"].items():
        np.testing.assert_allclose(got[k], v, **TOL_PARAMS, err_msg=k)
    # the flash route on local shards: each layer once forward, once recomputed
    n_layers = jax_get_config("gemma2-2b", smoke=True).num_layers
    assert int(got[f"{tag}/flash_calls"]) == (2 * n_layers if tag in ("gm", "gd") else 0)


def test_sharded_serve_step_matches_unsharded(ranks):
    want, got = ranks
    np.testing.assert_array_equal(got["sv/tok"], want["sv"]["tok"])
    np.testing.assert_allclose(got["sv/k"], want["sv"]["k"], rtol=0, atol=CACHE_ATOL)
    np.testing.assert_allclose(got["sv/v"], want["sv"]["v"], rtol=0, atol=CACHE_ATOL)
    assert bool(got["sv/in_place"])
