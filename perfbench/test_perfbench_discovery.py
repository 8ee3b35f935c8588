"""The harness finds cells, configurations, modes and per-layer metrics by
name: a copy of the benchmark takes a new cell, configuration and metric as
new files (and their entries in BENCHMARK.json) with no file of the
harness edited, and names what it cannot resolve."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import compare, registry

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench import registry
out = {}
p = registry.plan("toy-dense.train-1k", sys.argv[1])
out["mode"] = p["mode"].__file__
out["config"] = p["config"]["name"]
out["end_to_end"] = [m["name"] for m in p["end_to_end"]]
out["per_layer"] = sorted(p["per_layer"])
out["read"] = p["per_layer"]["steps_seen.train"][1]({"window": {"steps": 7}})
for bad in ("toy-dense.no-mode", "toy-dense.no-metric"):
    try:
        registry.plan(bad, sys.argv[1])
        out[bad] = "resolved"
    except registry.HarnessError as e:
        out[bad] = str(e)
print(json.dumps(out))
"""


def _copy(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _add_cell(root: Path, bench: dict, name: str, mode: str):
    cell = json.loads((root / "perfbench" / "workloads" / "deepseek-7b.train-4k.json").read_text())
    cell.update(config="toy-dense", traffic=name.split(".", 1)[1], mode=mode, seq_len=1024)
    (root / "perfbench" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": name, "config": "toy-dense", "traffic": cell["traffic"], "chips": 1,
                               "why": "a cell added as data"})


def test_new_cell_config_and_metric_are_found_as_files(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "perfbench" / "configs" / "deepseek-7b.json").read_text())
    config.update(name="toy-dense", model=dict(config["model"], num_layers=2))
    (root / "perfbench" / "configs" / "toy-dense.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "toy-dense", "source": config["source"], "reduced": ["num_layers"],
                             "file": "perfbench/configs/toy-dense.json", "why": "a configuration added as data"})
    _add_cell(root, bench, "toy-dense.train-1k", "train")
    _add_cell(root, bench, "toy-dense.no-mode", "serve")
    _add_cell(root, bench, "toy-dense.no-metric", "train")
    (root / "perfbench" / "metrics" / "steps_seen.train.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(run):\n    return run["window"]["steps"]\n')
    bench["per_layer"] += [
        {"name": "steps_seen.train", "unit": "steps", "better": "higher", "source": "host_clock", "layer": "device",
         "moves": "train_tokens_per_s", "workloads": ["toy-dense.train-1k"]},
        {"name": "nope.train", "unit": "%", "better": "higher", "source": "host_clock", "layer": "device",
         "moves": "train_tokens_per_s", "workloads": ["toy-dense.no-metric"]},
    ]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    done = subprocess.run([sys.executable, "-c", PROBE, str(root)], capture_output=True, text=True, timeout=120,
                          cwd=root)
    assert done.returncode == 0, done.stderr
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["mode"] == str(root / "perfbench" / "modes" / "train.py")
    assert out["config"] == "toy-dense"
    assert out["end_to_end"] == ["train_tokens_per_s", "train_peak_mem_gib", "setup_s"]
    assert out["per_layer"] == ["steps_seen.train"]  # the benchmark's own metrics list their cells
    assert out["read"] == 7
    assert "unknown mode 'serve'" in out["toy-dense.no-mode"]
    assert "unknown per-layer metric 'nope.train'" in out["toy-dense.no-metric"]


def test_the_benchmarks_cells_resolve():
    bench = registry.load_benchmark(ROOT)
    for w in bench["workloads"]:
        p = registry.plan(w["name"], ROOT)
        assert p["mode"].__name__ == "perfbench.modes." + p["cell"]["mode"]
        assert {m["name"] for m in p["end_to_end"]} >= {"setup_s"}
        assert set(p["per_layer"]) == {m["name"] for m in bench["per_layer"] if w["name"] in m.get("workloads", [])}
        assert set(p["cell"]["limits"]) <= set(compare.NUMBERS)
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        assert entry["file"] == f"perfbench/configs/{w['config']}.json"
        assert set(entry["reduced"]) == set(p["config"]["reduced"])


def test_unknown_workload_is_named():
    with pytest.raises(registry.HarnessError, match="unknown workload 'no-such.cell'"):
        registry.plan("no-such.cell", ROOT)
