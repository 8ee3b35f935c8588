"""The port's public surface against the reference's frozen one
(``tests/test_public_api.py``): every facade name resolves in
``repro_torch`` and is defined in the port, ``repro_torch.__all__`` stays
sorted, ``repro_torch.fl`` and ``repro_torch.launch`` export every name of
the reference's ``fl`` and ``launch``, every ``__all__`` of the reference's
modules has its counterpart in the port's (under the same name or a rename
listed in ``RENAMES``), and importing the port emits no DeprecationWarning.
The names that came last get value checks here: ``minplus_blocked``,
``gqa_attention``, ``dense_init`` and ``init_layer_stack``."""

from __future__ import annotations

import importlib
import math
import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from test_public_api import FACADE, FL_ALL

import repro
import repro_torch
import repro_torch.fl
import repro_torch.launch
from repro import launch as ref_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", FACADE)
def test_facade_names_resolve_in_the_port(name):
    assert name in repro_torch.__all__
    obj = getattr(repro_torch, name)
    assert obj.__module__.startswith("repro_torch.")


def test_port_all_is_sorted_and_holds_the_facade():
    assert sorted(repro_torch.__all__) == list(repro_torch.__all__)
    assert set(FACADE) <= set(repro_torch.__all__)
    # beyond the facade: the port's two solver entry points
    assert set(repro_torch.__all__) - set(FACADE) == {"solve_schedule_dp_batch", "solve_schedule_dp_torch"}


def test_fl_exports_every_reference_name():
    assert FL_ALL <= set(repro_torch.fl.__all__)
    for name in repro_torch.fl.__all__:
        assert getattr(repro_torch.fl, name).__module__.startswith("repro_torch.")


def test_launch_exports_every_reference_name():
    """The mesh context and sharding names (``set_mesh``, ``shard`` ...)
    beside the step builders, which load on first use."""
    assert set(ref_launch.__all__) <= set(repro_torch.launch.__all__)
    for name in repro_torch.launch.__all__:
        assert getattr(repro_torch.launch, name).__module__.startswith("repro_torch.launch.")


def test_import_emits_no_deprecation_warning():
    proc = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         "import repro_torch, repro_torch.core, repro_torch.fl, repro_torch.serve, repro_torch.launch.train"],
        capture_output=True, text=True, timeout=240, env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]


# reference module -> the port's module holding its names (else the same path
# under repro_torch)
MODULES = {
    "repro.core.jax_dp": "repro_torch.core.torch_dp",
    "repro.core.marginal_jax": "repro_torch.core.marginal_torch",
    "repro.kernels.gpu": "repro_torch.kernels.minplus",  # the Pallas-GPU kernel folded into the CUDA one
}
# (reference module, name) -> the port's name: the JAX-named solvers and the
# Pallas wrappers have torch- and CUDA-named counterparts; the HLO walker's
# counterpart is the dispatch-mode counter
RENAMES = {
    ("repro.core", "solve_fused_batch_jax"): "solve_fused_batch_torch",
    ("repro.core", "solve_schedule_dp_jax"): "solve_schedule_dp_torch",
    ("repro.core.jax_dp", "solve_fused_batch_jax"): "solve_fused_batch_torch",
    ("repro.core.jax_dp", "solve_schedule_dp_jax"): "solve_schedule_dp_torch",
    ("repro.core.jax_dp", "dp_tables_jax"): "dp_tables_batch",
    ("repro.core.jax_dp", "dp_tables_batch_jax"): "dp_tables_batch",
    ("repro.core.marginal_jax", "marginal_select_jax"): "marginal_select",
    ("repro.kernels", "minplus_pallas"): "minplus_cuda",
    ("repro.kernels", "minplus_pallas_batch"): "minplus_cuda_batch",
    ("repro.kernels", "minplus_pallas_gpu"): "minplus_cuda",
    ("repro.kernels", "minplus_pallas_gpu_batch"): "minplus_cuda_batch",
    ("repro.kernels", "tpu_tuned_bt"): "hopper_tile_sizes",
    ("repro.kernels.minplus", "minplus_pallas"): "minplus_cuda",
    ("repro.kernels.minplus", "minplus_pallas_batch"): "minplus_cuda_batch",
    ("repro.kernels.minplus", "tpu_tuned_bt"): "hopper_tile_sizes",
    ("repro.kernels.gpu", "minplus_pallas_gpu"): "minplus_cuda",
    ("repro.kernels.gpu", "minplus_pallas_gpu_batch"): "minplus_cuda_batch",
    ("repro.kernels.gpu", "GPU_DEFAULT_BT"): "DEFAULT_BT",
    ("repro.kernels.gpu", "GPU_DEFAULT_BW"): "DEFAULT_BW",
    ("repro.launch.hlo_analysis", "analyze_hlo"): "CostCounter",
}
# names the port keeps as a module of the package rather than a re-export
MODULE_NAMES = {("repro.kernels", "flash_attention")}


def _reference_alls() -> dict:
    """``{module: __all__}`` of every module of the reference that has one
    (the reference's dry run sets XLA_FLAGS when imported: restored)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    out = {}
    try:
        for info in pkgutil.walk_packages(repro.__path__, "repro."):
            mod = importlib.import_module(info.name)
            if hasattr(mod, "__all__"):
                out[info.name] = list(mod.__all__)
        out["repro"] = list(repro.__all__)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return out


REFERENCE_ALLS = _reference_alls()


@pytest.mark.parametrize("module", sorted(REFERENCE_ALLS))
def test_every_reference_all_has_its_counterpart(module):
    port_name = MODULES.get(module, "repro_torch" + module[len("repro"):])
    port = importlib.import_module(port_name)
    missing = []
    for name in REFERENCE_ALLS[module]:
        if (module, name) in MODULE_NAMES:
            ok = importlib.import_module(f"{port_name}.{name}") is not None
        else:
            want = RENAMES.get((module, name), name)
            ok = want in port.__all__ and getattr(port, want, None) is not None
        if not ok:
            missing.append(name)
    assert not missing, f"{port_name} lacks the counterparts of {module}: {missing}"


def test_renames_name_only_reference_names():
    for (module, name), _ in RENAMES.items():
        assert name in REFERENCE_ALLS[module], (module, name)


def test_minplus_blocked_is_bit_identical_to_the_reference():
    from repro.kernels.blocked import minplus_blocked as ref_minplus_blocked

    from repro_torch.kernels import minplus_blocked

    rng = np.random.default_rng(0)
    T, W = 200, 33
    kprev = rng.uniform(0, 10, T + 1).astype(np.float32)
    kprev[rng.random(T + 1) < 0.2] = 1e30
    cost = rng.uniform(0, 5, W).astype(np.float32)
    cost[-2:] = 1e30
    for bt, bw in ((None, None), (16, 8)):  # the default blocks; ragged ones
        want_k, want_i = ref_minplus_blocked(kprev, cost, BT=bt, BW=bw)
        got_k, got_i = minplus_blocked(torch.from_numpy(kprev), torch.from_numpy(cost), BT=bt, BW=bw)
        assert np.array_equal(got_k.numpy(), np.asarray(want_k)) and got_k.dtype == torch.float32
        assert np.array_equal(got_i.numpy(), np.asarray(want_i)) and got_i.dtype == torch.int32


@pytest.mark.parametrize("kind,softcap", [("causal", 0.0), ("sliding", 30.0), ("bidirectional", 0.0)])
def test_gqa_attention_matches_the_reference(kind, softcap):
    """Converted weights, float32, the reference's attention tolerance
    (``tests/test_flash_attention.py``: rtol 2e-5, atol 2e-5)."""
    from repro.models import layers as ref_layers

    from repro_torch.models import layers

    rng = np.random.default_rng(1)
    B, S, d, H, Hkv, hd = 2, 48, 64, 4, 2, 16
    p = {"wq": rng.normal(size=(d, H, hd)), "wk": rng.normal(size=(d, Hkv, hd)),
         "wv": rng.normal(size=(d, Hkv, hd)), "wo": rng.normal(size=(H, hd, d))}
    p = {k: (v / math.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    kw = {"kind": kind, "window": 16, "attn_softcap": softcap}
    want = ref_layers.gqa_attention({k: jax.numpy.asarray(v) for k, v in p.items()}, jax.numpy.asarray(x),
                                    (H, Hkv, hd), rope_sincos=ref_layers.make_rope(jax.numpy.arange(S), hd), **kw)
    got = layers.gqa_attention({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), (H, Hkv, hd),
                               rope_sincos=layers.make_rope(torch.arange(S), hd), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_dense_init_and_init_layer_stack():
    """Shapes and dtypes as the reference's; values within +-2 standard
    deviations of ``scale / sqrt(fan_in)``; the stack equal to
    ``init_dense``'s layers drawn from the same generator state."""
    from repro.configs import get_config as ref_get_config
    from repro.models.dense import init_layer_stack as ref_init_layer_stack

    from repro_torch.configs import get_config
    from repro_torch.models import dense
    from repro_torch.models.layers import dense_init

    gen = torch.Generator().manual_seed(0)
    t = dense_init(gen, (512, 256), fan_in=128, dtype=torch.bfloat16, scale=2.0)
    std = 2.0 / math.sqrt(128)
    assert t.shape == (512, 256) and t.dtype == torch.bfloat16
    assert t.float().abs().max() <= 2 * std * (1 + 2 ** -8) and t.float().std() > 0.8 * std
    assert dense.dense_init is dense_init
    for arch in ("gemma2-2b", "deepseek-7b"):
        cfg, ref_cfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
        want = jax.eval_shape(lambda: ref_init_layer_stack(ref_cfg, jax.random.PRNGKey(0)))
        got = dense.init_layer_stack(cfg, torch.Generator().manual_seed(3))
        flat_w = {"/".join(str(getattr(k, "key", k)) for k in path): v
                  for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_g = {}

        def walk(tree, path=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{path}{k}/")
                else:
                    flat_g[f"{path}{k}"] = v

        walk(got)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in flat_g.items()} == {
            k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in flat_w.items()}
        layers = dense.init_dense(cfg, torch.Generator().manual_seed(3))
        ref_gen = torch.Generator().manual_seed(3)
        dense_init(ref_gen, (cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model)  # the embedding drawn first
        again = dense.init_layer_stack(cfg, ref_gen)
        period = len(dense.attn_pattern(cfg))
        for i, layer in enumerate(layers["layers"]):
            assert torch.equal(layer["attn"]["wq"], again["attn"]["wq"][i // period, i % period])
