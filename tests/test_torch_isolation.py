"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and importing it builds nothing and imports no ``triton``."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

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
    } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "from repro_torch.kernels import build, minplus, flash_attention\n"
        "assert not build._loaded and minplus._launch is None, 'import built or loaded a kernel'\n"
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 12
    for f in files:
        for name, top_level in _imports(ast.parse(f.read_text(), str(f))):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"
            assert not (root == "triton" and top_level), f"{f.relative_to(ROOT)} imports triton at top level"
