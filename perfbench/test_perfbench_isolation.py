"""What the benchmark loads: the harness neither JAX nor the JAX package
``repro`` (names compared whole: ``repro_torch`` is the port), and the
reference nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

PROBE = r"""
import importlib.util, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import perfbench.reference.decoder, perfbench.compare, perfbench.weights, perfbench.work
reference_only = sorted({m.split(".")[0] for m in sys.modules})
import perfbench.trace, perfbench.faults
from perfbench import registry
from perfbench.modes import train
for w in registry.load_benchmark()["workloads"]:
    registry.plan(w["name"])
import repro_torch.launch.steps, repro_torch.configs
spec = importlib.util.spec_from_file_location("perfbench_run", sys.argv[1] + "/perfbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
spec = importlib.util.spec_from_file_location("perfbench_control", sys.argv[1] + "/perfbench/control.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"reference_only": reference_only, "all": sorted({m.split(".")[0] for m in sys.modules}),
                  "run_sees": run.forbidden_modules()}))
"""


def test_harness_and_reference_load_neither_jax_nor_the_jax_package():
    import json

    done = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True, text=True, timeout=180)
    assert done.returncode == 0, done.stderr
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert not set(out["all"]) & set(FORBIDDEN), out["all"]
    assert "repro_torch" in out["all"]
    assert out["run_sees"] == []
    assert "repro_torch" not in out["reference_only"], "the reference loaded the program"


def test_reference_sources_import_nothing_of_the_program():
    for path in [*(BENCH / "reference").glob("*.py"), BENCH / "weights.py", BENCH / "compare.py", BENCH / "work.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (*FORBIDDEN, "repro_torch"), f"{path.name} imports {name}"


def test_run_refuses_a_process_that_loaded_the_jax_package(monkeypatch):
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location("perfbench_run_probe", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("repro_torch_probe"))
    assert "repro_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert "repro.core" in run.forbidden_modules()
