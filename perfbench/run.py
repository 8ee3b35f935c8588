"""Runs one cell of the benchmark of the PyTorch and CUDA port once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The cell's
files are found by name (:mod:`perfbench.registry`); its mode drives the
program, measures the window, and checks what the timed path produced
against the plain reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers are the
last lines of standard error.

Exits 2 without a result when the cell does not resolve or the machine has
fewer CUDA cards than the cell asks for, and 3 when the process has loaded
JAX or the JAX package. Build and kernel caches stay in fixed directories
under ``build/`` inside the checkout.
"""

import time

_T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BREAKDOWN_TOP = 10
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _breakdown(traced: dict) -> dict:
    ops = sorted(traced["by_name"].items(), key=lambda kv: -kv[1])
    kinds = sorted(traced["by_kind"].items(), key=lambda kv: -kv[1])
    device_ops = [[f"kind:{k}", s] for k, s in kinds] + [[n[:160], s] for n, s in ops]
    gaps = sorted(traced["idle_by_host_op"].items(), key=lambda kv: -kv[1])
    return {"device_ops": device_ops[:BREAKDOWN_TOP], "idle_gaps": [[n[:160], s] for n, s in gaps[:BREAKDOWN_TOP]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import registry, work

    try:
        plan = registry.plan(args.workload, ROOT)
    except registry.HarnessError as e:
        _log(f"perfbench: {e}")
        return 2
    cell = plan["cell"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        _log(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
             f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    _log(f"[card] {kind}; nvidia-smi: {_power_limit()}; peaks used: {work.PEAK_BF16_FLOPS:.4g} bf16 FLOP/s, "
         f"{work.PEAK_BYTES_PER_S:.4g} B/s; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = plan["mode"].run({"seed": args.seed, "seconds": args.seconds, "trace": args.trace, "cell": cell,
                            "config": plan["config"], "device": "cuda", "t_start": _T_START, "log": _log})

    if args.trace:
        metrics = {}
        for name, (entry, read) in plan["per_layer"].items():
            value = read(out["record"])
            if value is not None:
                metrics[name] = {"value": value, "unit": entry["unit"]}
    else:
        missing = [m["name"] for m in plan["end_to_end"] if m["name"] not in out["end_to_end"]]
        if missing:
            _log(f"perfbench: mode {cell['mode']!r} measured no {missing}")
            return 2
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]} for m in plan["end_to_end"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device}
    if args.trace:
        traced = out["record"]["trace"]
        device["busy_s"], device["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = _breakdown(traced)
    result["checks"] = out["checks"]

    bad = forbidden_modules()
    if bad:
        _log(f"perfbench: the process loaded {bad}: the benchmark may load neither JAX nor the JAX package")
        return 3
    for name, c in out["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
