"""The rest of the LM zoo over ``torch.distributed`` at 8 CPU ranks against
the JAX package on one device: the ssm, hybrid, encoder and vlm families on
a mesh, the MoE a2a train steps (deepseek-v3 under Adafactor, over two
expert axes), the serve steps of xlstm, zamba2 and paligemma, and the
sequence-sharded long-context decode cache.

One module fixture computes the reference's side here (jitted, one device),
writes the inputs with ``np.savez`` and runs ``tests/_torch_dist_ranks.py
DIR zoo`` once in a subprocess, which spawns 8 gloo ranks on a (2, 4) and an
(8, 1) ``("data", "model")`` mesh and imports no JAX. Each test reads rank
0's results:

  * the SSM cells on DTensors, each under one ``local_map`` over batch and
    heads (channels for the convs), against the reference's cells;
  * a2a's flattened group over ("data", "model") holds the expert blocks
    in order;
  * several rows written into a cache split on its sequence dim land as in
    a plain cache;
  * the sharded train steps of xlstm-1.3b, zamba2-2.7b, hubert-xlarge and
    paligemma-3b SMOKE on (2, 4), and of granite-20b and paligemma-3b
    (MQA: one KV head) on (8, 1), against JAX's single-device step, with
    every parameter, optimizer-state and batch leaf placed as
    ``train_shardings`` says;
  * the a2a train steps of olmoe-1b-7b SMOKE and of deepseek-v3-671b SMOKE
    with 8 experts (one per rank, ``expert = ("data", "model")``, MLA, MTP,
    Adafactor with DTensor state) against JAX's dense step, at a capacity
    where nothing is dropped;
  * the einsum dispatch on (2, 4): one layer's ``moe_ffn`` of olmoe-1b-7b
    SMOKE (experts on "model"; with 6 experts, which the model axis does
    not divide, whole on every rank) and of deepseek-v3-671b SMOKE with 8
    experts (on ("data", "model")) against the reference's unsharded
    einsum, at a capacity of 11 slots, which neither mesh axis divides,
    with pairs dropped; two serve steps of olmoe-1b-7b SMOKE with it (B =
    8: 13 slots);
  * the serve steps of xlstm-1.3b, zamba2-2.7b and paligemma-3b on (2, 4),
    and the long-context decode at B = 1 (gemma2-2b ``long_context`` and
    zamba2-2.7b, a cache of 128 slots split over "data", positions 63 and
    64, one in each block, so that the writes and, at 64, gemma2's window
    of 32 straddle the two blocks),
    against JAX's unsharded serve steps, the caches placed by
    ``cache_pspecs`` and the KV caches written in place.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import make_dummy_batch as jax_make_dummy_batch
from repro.models import ssm as J
from repro.models.moe_dispatch import moe_ffn as jax_moe_ffn
from repro.models.moe_dispatch import route as jax_route
from repro_torch.models import config_from_jax, params_from_jax
from repro_torch.models.convert import cache_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_dist_ranks.py")
sys.path.insert(0, os.path.dirname(HELPER))
from _torch_dist_ranks import flat  # noqa: E402

# the reference's limits (tests/test_distribution.py), and the decode's
LOSS_ATOL = 2e-4
TOL_PARAMS = dict(rtol=3e-3, atol=3e-4)
TOL_CACHE = dict(rtol=1e-5, atol=1e-5)
TOL_STATE = dict(rtol=1e-4, atol=1e-4)  # recurrent states: tests/test_torch_ssm_models.py's, unsharded
EPS32 = 2.0 ** -23
TOL_OP = dict(rtol=1e-6, atol=1e-6)
MOE_ATOL = 2e-4  # tests/test_torch_distribution.py's, the reference's

TRAIN = {  # tag: (arch, config replacements of the reference's dense step)
    "xl": ("xlstm-1.3b", {}),
    "zb": ("zamba2-2.7b", {}),
    "hb": ("hubert-xlarge", {}),
    "pg": ("paligemma-3b", {}),
    "gr8": ("granite-20b", {}),
    "pg8": ("paligemma-3b", {}),
    "om": ("olmoe-1b-7b", {"moe_impl": "dense", "capacity_factor": 8.0}),
    "dv": ("deepseek-v3-671b", {"moe_impl": "dense", "num_experts": 8, "capacity_factor": 8.0}),
}
SAME = {"pg8": "pg"}  # paligemma's step on (8, 1) is the one on (2, 4): one reference run
SERVE = {  # tag: (arch, B, S, first position, steps, random KV cache, config replacements)
    "sxl": ("xlstm-1.3b", 8, 32, 0, 2, False, {}),
    "szb": ("zamba2-2.7b", 8, 32, 0, 2, False, {}),
    "spg": ("paligemma-3b", 8, 32, 20, 2, True, {}),
    "lgm": ("gemma2-2b", 1, 128, 63, 2, True, {"long_context": True}),
    "lzb": ("zamba2-2.7b", 1, 128, 63, 2, True, {}),
    "som": ("olmoe-1b-7b", 8, 32, 20, 2, True, {"moe_impl": "einsum"}),
}
EINSUM = {  # tag: (arch, B, S, config replacements): top 2 of 4, 8 or 6 experts, a capacity of 11 slots
    "eom": ("olmoe-1b-7b", 4, 8, {"capacity_factor": 0.2}),
    "edv": ("deepseek-v3-671b", 4, 16, {"num_experts": 8, "capacity_factor": 0.2}),
    "eor": ("olmoe-1b-7b", 4, 16, {"num_experts": 6, "capacity_factor": 0.15}),  # 6 experts whole on every rank
}
CELLS = ("conv", "conv_step", "ssd", "ssd_step", "mlstm", "mlstm_step", "slstm", "slstm_step")
CHUNKED = {"ssd": 8, "mlstm": 8}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(cfg):
    """The reference's ``init_params`` at key 0, jitted (one compile, the same
    values as its eager run, faster than compiling each operation)."""
    return jax.jit(jax_init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))


def _port_flat(cfg_j, tree, prefix):
    """The port's parameter tree of a JAX tree, flattened to ``{prefix/path:
    numpy}``."""
    cfg = config_from_jax(cfg_j)
    return {f"{prefix}/{k}": v.numpy() for k, v in flat(params_from_jax(cfg, _np(tree), device="cpu")).items()}


def _cache_flat(cfg_j, cache, prefix):
    cfg = config_from_jax(cfg_j)
    return {f"{prefix}/{k}": v.numpy() for k, v in flat(cache_from_jax(cfg, _np(cache), device="cpu")).items()}


def _jax_cells(inp):
    """Writes the cells' inputs into ``inp``; returns the thunk that computes
    the reference's outputs and final states."""
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    B, L, H, P, N, C = 4, 32, 4, 8, 6, 16
    a = {"cx": f(B, L, C), "cx1": f(B, 1, C), "cw": f(4, C), "cs": f(B, 3, C),
         "x": f(B, L, H, P), "dt": rng.uniform(0.01, 0.5, (B, L, H)).astype(np.float32),
         "A": -rng.uniform(0.1, 1.0, (H,)).astype(np.float32), "B": f(B, L, N), "C": f(B, L, N), "s": f(B, H, P, N),
         "x1": f(B, H, P), "dt1": rng.uniform(0.01, 0.5, (B, H)).astype(np.float32), "B1": f(B, N), "C1": f(B, N),
         "q": f(B, L, H, P), "k": f(B, L, H, P), "v": f(B, L, H, P), "i": f(B, L, H), "f": f(B, L, H) + 2.0,
         "mS": f(B, H, P, P), "mn": f(B, H, P), "mm": f(B, H), "q1": f(B, H, P), "k1": f(B, H, P), "v1": f(B, H, P),
         "i1": f(B, H), "f1": f(B, H) + 2.0,
         "z": f(B, 16, H, P), "zi": f(B, 16, H, P), "zf": f(B, 16, H, P), "zo": f(B, 16, H, P),
         "rz": f(H, P, P) * 0.1, "ri": f(H, P, P) * 0.1, "rf": f(H, P, P) * 0.1, "ro": f(H, P, P) * 0.1,
         "sc": f(B, H, P), "sn": np.abs(f(B, H, P)) + 1.0, "sm": f(B, H, P), "sh": f(B, H, P),
         "z1": f(B, H, P), "zi1": f(B, H, P), "zf1": f(B, H, P), "zo1": f(B, H, P)}
    inp.update({f"cell/{k}": v for k, v in a.items()})

    def want():
        j = {k: jnp.asarray(v) for k, v in a.items()}
        r = {g: j[g] for g in ("rz", "ri", "rf", "ro")}
        outs = {
            "conv": J.causal_conv1d(j["cx"], j["cw"], j["cs"]),
            "conv_step": J.causal_conv1d_step(j["cx1"], j["cw"], j["cs"]),
            "ssd": J.ssd_chunked(j["x"], j["dt"], j["A"], j["B"], j["C"], 8, j["s"]),
            "ssd_step": J.ssd_step(j["x1"], j["dt1"], j["A"], j["B1"], j["C1"], j["s"]),
            "mlstm": J.mlstm_chunked(j["q"], j["k"], j["v"], j["i"], j["f"], 8, (j["mS"], j["mn"], j["mm"])),
            "mlstm_step": J.mlstm_step(j["q1"], j["k1"], j["v1"], j["i1"], j["f1"], (j["mS"], j["mn"], j["mm"])),
            "slstm": J.slstm_scan(j["z"], j["zi"], j["zf"], j["zo"], r, (j["sc"], j["sn"], j["sm"], j["sh"])),
            "slstm_step": J.slstm_step(j["z1"], j["zi1"], j["zf1"], j["zo1"], (j["sc"], j["sn"], j["sm"])),
        }
        return {name: (np.asarray(y), [np.asarray(x) for x in (s if isinstance(s, tuple) else (s,))])
                for name, (y, s) in outs.items()}

    return want


def _jax_train(inp, tag):
    arch, rep = TRAIN[tag]
    cfg = jax_get_config(arch, smoke=True).replace(**rep)
    params = _init(cfg)
    batch = jax_make_dummy_batch(cfg, 8, 32, "train", np.random.default_rng(0))
    inp.update({f"{tag}/b/{k}": np.asarray(v) for k, v in batch.items()})
    inp.update(_port_flat(cfg, params, f"{tag}/p"))

    def want():
        step, opt = jax_build_train_step(cfg)
        p1, _, loss = jax.jit(step)(params, opt.init(params), batch)
        return {"loss": float(loss), "params": _port_flat(cfg, p1, f"{tag}/p")}

    return want


def _jax_serve(inp, tag):
    arch, B, S, pos0, steps, random_kv, rep = SERVE[tag]
    cfg = jax_get_config(arch, smoke=True).replace(**rep)
    params = _init(cfg)
    cache = jax_init_cache(cfg, B, S)
    if random_kv:  # the dense and hybrid KV caches hold random keys and values
        rng = np.random.default_rng(11)
        kv = lambda c: jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.5, x.dtype), c)  # noqa: E731
        cache = {**cache, "attn": kv(cache["attn"])} if isinstance(cache, dict) and "attn" in cache else kv(cache)
    tok = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    inp[f"{tag}/tok"] = tok
    inp.update(_port_flat(cfg, params, f"{tag}/p"))
    inp.update(_cache_flat(cfg, cache, f"{tag}/c"))

    def want():
        step = jax.jit(jax_build_serve_step(cfg))
        c, t, toks = cache, jnp.asarray(tok), []
        for pos in range(pos0, pos0 + steps):
            t, c = step(params, c, t, jnp.asarray(pos, jnp.int32))
            toks.append(np.asarray(t))
        return {"tok": np.stack(toks), "cache": _cache_flat(cfg, c, f"{tag}/c")}

    return want


def _jax_einsum(inp, tag):
    """One MoE layer of the reference (its first) with the einsum dispatch;
    the thunk gives its output, aux, capacity and the number of (token,
    choice) pairs the capacity drops."""
    arch, B, S, rep = EINSUM[tag]
    cfg = jax_get_config(arch, smoke=True).replace(moe_impl="einsum", **rep)
    params = _init(cfg)
    layer = jax.tree.map(lambda a: a[0], params["moe_layers"])["moe"]
    x = np.random.default_rng(13).normal(size=(B, S, cfg.d_model)).astype(np.float32) * np.float32(0.3)
    inp[f"{tag}/x"] = x
    head = f"{tag}/moe_layers/0/moe/"
    inp.update({f"{tag}/p/{k[len(head):]}": v for k, v in _port_flat(cfg, params, tag).items() if k.startswith(head)})

    def want():
        y, aux = jax_moe_ffn(cfg, layer, jnp.asarray(x))
        _, idx, _ = jax_route(cfg, jnp.asarray(x.reshape(-1, cfg.d_model)), layer["router"])
        T = x.shape[0] * x.shape[1]
        cap = max(8, int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 8)
        load = np.bincount(np.asarray(idx).reshape(-1), minlength=cfg.num_experts)
        return {"y": np.asarray(y), "aux": float(aux), "capacity": cap,
                "dropped": int(np.maximum(load - cap, 0).sum())}

    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(want, got)``: the reference's results and rank 0's. The ranks start
    first; each case's inputs are written (``inputs_<tag>.npz``, by a
    rename) in the order the ranks run the cases, and the reference's side
    of each case computes (three at a time: XLA's compiles overlap) while
    the later inputs are made and the ranks run."""
    d = tmp_path_factory.mktemp("zoo")
    proc = subprocess.Popen([sys.executable, HELPER, str(d), "zoo"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        futures, inputs = {}, {}
        makers = ([("cell", _jax_cells)] + [(t, _jax_train) for t in TRAIN] + [(t, _jax_serve) for t in SERVE]
                  + [(t, _jax_einsum) for t in EINSUM])
        with ThreadPoolExecutor(3) as pool:
            for tag, make in makers:
                inp = {}
                if tag in SAME:  # the same step as another case's, on another mesh: its inputs renamed
                    inp = {f"{tag}/{k.split('/', 1)[1]}": v for k, v in inputs[SAME[tag]].items()}
                else:
                    futures[tag] = pool.submit(make(inp) if tag == "cell" else make(inp, tag))
                inputs[tag] = inp
                with open(d / "part.npz", "wb") as f:
                    np.savez(f, **inp)
                os.replace(d / "part.npz", d / f"inputs_{tag}.npz")
            want = {k: f.result() for k, f in futures.items()}
        for tag, like in SAME.items():
            want[tag] = {**want[like], "params": {f"{tag}/{k.split('/', 1)[1]}": v
                                                  for k, v in want[like]["params"].items()}}
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"ranks failed:\n{out[-2000:]}\n{err[-6000:]}"
    return want, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_local_shards_match_jax(ranks, cell):
    """Each cell on DTensors runs under one ``local_map``: its output comes
    back split over batch and heads (channels), equal to the reference's
    cell within its single-device tolerances (tests/test_torch_ssm.py)."""
    want, got = ranks
    y, states = want["cell"][cell]
    assert bool(got["cell/split"])
    for i, w in enumerate([y] + states):
        g = got[f"cell/{cell}/y" if i == 0 else f"cell/{cell}/s{i - 1}"]
        if cell in CHUNKED:
            np.testing.assert_allclose(g, w, rtol=0, atol=CHUNKED[cell] * EPS32 * float(np.abs(w).max()))
        else:
            np.testing.assert_allclose(g, w, **TOL_OP)


def test_flattened_expert_group_holds_the_expert_blocks_in_order(ranks):
    _, got = ranks
    assert bool(got["grp/ok"])


def test_rows_written_into_a_sequence_split_cache(ranks):
    """Several rows written into a cache split on its sequence dim (a
    prefill into a long-context cache) land as they do in a plain cache,
    across the two blocks and at a clamped start, in place."""
    _, got = ranks
    np.testing.assert_array_equal(got["wr/got"], got["wr/want"])
    assert bool(got["wr/in_place"])


@pytest.mark.parametrize("tag", ["xl", "zb", "hb", "pg", "gr8", "pg8", "om", "dv"])
def test_sharded_train_step_matches_single_device(ranks, tag):
    """The loss and every parameter after one sharded step against JAX's
    single-device step (``om``, ``dv``: a2a against the dense dispatch), and
    the placements of every parameter, optimizer-state and batch leaf."""
    want, got = ranks
    assert abs(float(got[f"{tag}/loss"]) - want[tag]["loss"]) < LOSS_ATOL
    assert bool(got[f"{tag}/placed"])
    for k, v in want[tag]["params"].items():
        np.testing.assert_allclose(got[k], v, **TOL_PARAMS, err_msg=k)


@pytest.mark.parametrize("tag", list(EINSUM))
def test_einsum_dispatch_on_the_mesh_matches_the_reference(ranks, tag):
    """The einsum dispatch on DTensors (experts split on the ``expert``
    rule's axes, the dispatch under ``local_map``) against the reference's
    einsum on one device: a capacity of 11 slots, which neither mesh axis
    divides (DTensor's own einsum splits the slots and cannot flatten
    them), and (token, choice) pairs dropped, the same as the reference
    drops."""
    want, got = ranks
    assert want[tag]["capacity"] == 11 and want[tag]["dropped"] > 0
    assert bool(got[f"{tag}/split"]) and bool(got[f"{tag}/whole"]) == (tag == "eor")
    np.testing.assert_allclose(got[f"{tag}/y"], want[tag]["y"], rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(float(got[f"{tag}/aux"]), want[tag]["aux"], rtol=1e-6)


@pytest.mark.parametrize("tag", list(EINSUM))
def test_einsum_dispatch_gradients_on_the_mesh_match_unsharded(ranks, tag):
    """The einsum dispatch's backward on DTensors (the tokens' gather split
    over "data", the experts over the ``expert`` axes): the gradients of
    ``sum(y * r) + aux`` with respect to the tokens and every parameter
    against the same dispatch unsharded, within the reference's MoE
    limit."""
    _, got = ranks
    n = sum(k.startswith(f"{tag}/grad1/") for k in got)
    assert n > 4
    for i in range(n):
        np.testing.assert_allclose(got[f"{tag}/grad/{i}"], got[f"{tag}/grad1/{i}"], rtol=0, atol=MOE_ATOL,
                                   err_msg=str(i))


@pytest.mark.parametrize("tag", list(SERVE))
def test_sharded_serve_steps_match_unsharded(ranks, tag):
    """Greedy tokens identical to JAX's unsharded serve steps, the KV caches
    after the steps within 1e-5 and the recurrent states within the
    single-device decode's 1e-4 (xLSTM's sLSTM state amplifies the rounding
    of the sharded products: 4e-5 after 3 steps), every cache leaf
    placed by ``cache_pspecs`` (``lgm``, ``lzb``: B = 1, so the KV caches'
    sequence dim is split over "data") and the KV caches written in
    place."""
    want, got = ranks
    np.testing.assert_array_equal(got[f"{tag}/tok"], want[tag]["tok"])
    assert bool(got[f"{tag}/placed"]) and bool(got[f"{tag}/in_place"])
    for k, v in want[tag]["cache"].items():
        recurrent = SERVE[tag][0] == "xlstm-1.3b" or "/mamba/" in k
        np.testing.assert_allclose(got[k], v, **(TOL_STATE if recurrent else TOL_CACHE), err_msg=k)
