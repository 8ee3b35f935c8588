"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and importing it builds nothing and imports no ``triton``."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_importing_every_port_module_pulls_in_no_jax():
    mods = _port_modules()
    assert {
        "repro_torch.core.torch_dp", "repro_torch.kernels.minplus", "repro_torch.kernels.build",
        "repro_torch.kernels.flash_attention", "repro_torch.configs", "repro_torch.models.dense",
        "repro_torch.models.layers", "repro_torch.models.model", "repro_torch.models.convert",
        "repro_torch.launch.steps", "repro_torch.optim", "repro_torch.optim.optimizers",
        "repro_torch.core.marginal", "repro_torch.core.marginal_torch", "repro_torch.core.sweep",
        "repro_torch.core.scheduler", "repro_torch.core.solver", "repro_torch.core.pareto",
        "repro_torch.core.resilience", "repro_torch.core.baselines", "repro_torch.core._deprecation",
        "repro_torch.core.fleet", "repro_torch.serve", "repro_torch.serve.coalesce", "repro_torch.serve.service",
        "repro_torch.fl", "repro_torch.fl.faults", "repro_torch.fl.energy",
        "repro_torch.fl.server", "repro_torch.fl.client", "repro_torch.fl.pipeline", "repro_torch.fl.rounds",
        "repro_torch.fl.adaptive", "repro_torch.fl.toy", "repro_torch.optim.schedules",
        "repro_torch.data", "repro_torch.data.synthetic", "repro_torch.data.partition", "repro_torch.data.pipeline",
        "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint", "repro_torch.launch.train",
        "repro_torch.launch.serve", "repro_torch.models.moe", "repro_torch.models.moe_dispatch",
        "repro_torch.models.mla", "repro_torch.configs.granite_20b", "repro_torch.configs.minitron_8b",
        "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.deepseek_v3_671b", "repro_torch.models.ssm",
        "repro_torch.models.xlstm", "repro_torch.models.hybrid", "repro_torch.configs.xlstm_1_3b",
        "repro_torch.configs.zamba2_2_7b", "repro_torch.models.encoder", "repro_torch.models.vlm",
        "repro_torch.configs.hubert_xlarge", "repro_torch.configs.paligemma_3b",
        "repro_torch.launch", "repro_torch.launch.sharding", "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis", "repro_torch.launch.roofline",
    } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "from repro_torch.kernels import adamw, build, minplus, flash_attention\n"
        "assert not build._loaded and minplus._launch is None, 'import built or loaded a kernel'\n"
        "assert adamw._launch is None, 'import loaded the adamw kernel'\n"
        "assert flash_attention._launch is None, 'import loaded the flash kernel'\n"
        "assert flash_attention._bwd_fns is None, 'import loaded the flash backward kernels'\n"
        "print(','.join(bad))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=str(ROOT)
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imports pulled in: {out.stdout.strip()}"


def _imports(node, in_function=False):
    """(module name, runs at import time) for every absolute import under
    ``node``; an import runs at import time unless it sits in a function."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Import):
            for a in child.names:
                yield a.name, not in_function
        elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
            yield child.module, not in_function
        nested = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        yield from _imports(child, nested)


def test_no_source_imports_jax_or_the_jax_package():
    examples = sorted((ROOT / "examples_torch").glob("*.py"))
    assert [f.name for f in examples] == sorted(f.name for f in (ROOT / "examples").glob("*.py"))
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) >= 16
    for f in files:
        for name, top_level in _imports(ast.parse(f.read_text(), str(f))):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"
            assert not (root == "triton" and top_level), f"{f.relative_to(ROOT)} imports triton at top level"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present: the example's default device is there")
def test_an_example_without_a_card_raises_rather_than_running_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "examples_torch/heterogeneous_cluster.py"], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode != 0
    assert "device='cuda' requested but torch.cuda.is_available() is False" in out.stderr
    assert "global batch" not in out.stdout
