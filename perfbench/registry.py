"""Finds a cell's pieces by name, so that a cell, a configuration or a
per-layer metric is added as files and no file of the harness is edited.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics. For a cell ``<name>``:

* ``perfbench/workloads/<name>.json``: its ``config``, ``traffic`` and
  ``chips`` (as ``BENCHMARK.json`` has them), its ``mode``, its shapes and
  traffic parameters, and the ``limits`` of its correctness check;
* ``perfbench/configs/<config>.json``: the configuration as it is run;
* ``perfbench/modes/<mode>.py``: the code that drives the program in that
  mode; it defines ``run(ctx) -> dict``;
* ``perfbench/metrics/<metric>.py`` for each per-layer metric that
  ``BENCHMARK.json`` gives the cell: a reader that defines ``read(run)``
  and returns the metric's value, or ``None`` where the run has nothing for
  it to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "HarnessError", "load_benchmark", "plan"]

ROOT = Path(__file__).resolve().parents[1]


class HarnessError(Exception):
    """A cell, configuration, mode or metric that the files do not resolve."""


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise HarnessError(f"{what}: no file {path.name} in {path.parent}")
    with path.open() as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json", "the benchmark")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise HarnessError(f"unknown per-layer metric {name!r}: no reader perfbench/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise HarnessError(f"per-layer metric {name!r}: perfbench/metrics/{name}.py defines no read(run)")
    return module.read


def plan(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs: ``{"cell", "config",
    "mode" (module), "end_to_end" [metric entries], "per_layer" {name:
    (entry, read)}}``. Raises :class:`HarnessError` with the missing piece."""
    root = Path(root)
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise HarnessError(f"unknown workload {name!r}; BENCHMARK.json lists {sorted(entries)}")
    entry = entries[name]
    cell = _json(root / "perfbench" / "workloads" / f"{name}.json", f"workload {name!r}")
    for key in ("config", "traffic", "chips"):
        if cell.get(key) != entry[key]:
            raise HarnessError(f"workload {name!r}: its file says {key} {cell.get(key)!r}, BENCHMARK.json "
                               f"{entry[key]!r}")
    cell = {**cell, "name": name}
    config = _json(root / "perfbench" / "configs" / f"{cell['config']}.json", f"configuration {cell['config']!r}")
    mode_name = cell.get("mode")
    if not mode_name or not (root / "perfbench" / "modes" / f"{mode_name}.py").is_file():
        raise HarnessError(f"workload {name!r}: unknown mode {mode_name!r}: no perfbench/modes/{mode_name}.py")
    mode = importlib.import_module(f"perfbench.modes.{mode_name}")
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = {m["name"]: (m, _reader(root, m["name"])) for m in bench["per_layer"] if _applies(m, name)}
    return {"cell": cell, "config": config, "mode": mode, "end_to_end": end_to_end, "per_layer": per_layer}
