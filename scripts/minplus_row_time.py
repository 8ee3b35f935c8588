"""Device time of the exact solver's min-plus row kernel at the main shape,
for one or more checkouts of this repo, each timed in a process of its own.

    python3 scripts/minplus_row_time.py TREE [TREE ...]

Each TREE is the root of a checkout; its ``src/repro_torch`` is imported and
its kernels are built into its own ``build/``. The trees run in the order
given, so comparing two versions in turns reads ``OLD NEW NEW OLD``. Each run
calls ``repro_torch.kernels.minplus.minplus_cuda_batch`` on the same inputs
(numpy seed 0; B = 16, T+1 = 10,001, W = 1,001, as ``chip_smoke.py`` phase 5),
checks the result bit for bit against that tree's
``kernels.ref.minplus_step_ref_batch``, and takes the profiler's device time
of the launches of every kernel whose name holds ``minplus`` over 20 calls
after 3 warm-up calls. The wrapper's own counter must show one launch a call;
``ms`` is the mean over the launches the profiler recorded (it may drop one).
Prints the card's name and power limit, then one JSON line per run:
``{"tree", "kernel", "launches", "profiled", "ms"}``. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

B, TP, W, CALLS, WARMUP = 16, 10_001, 1_001, 20, 3


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels.ref import BIG, minplus_step_ref_batch

    if not Path(mp.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {mp.__file__}, not the one under {tree}")
    rng = np.random.default_rng(0)
    kprev = rng.uniform(0, 100, (B, TP)).astype(np.float32)
    cost = rng.uniform(0, 10, (B, W)).astype(np.float32)
    kprev[rng.random((B, TP)) < 0.3] = BIG
    kprev[:, 0] = 0.0
    cost[rng.random((B, W)) < 0.2] = BIG
    kprev, cost = torch.from_numpy(kprev).cuda(), torch.from_numpy(cost).cuda()
    out = torch.empty_like(kprev)
    iout = torch.empty(kprev.shape, dtype=torch.int32, device="cuda")
    for _ in range(WARMUP):
        mp.minplus_cuda_batch(kprev, cost, out=out, iout=iout)
    want_v, want_i = minplus_step_ref_batch(kprev, cost)
    if not (torch.equal(out.view(torch.int32), want_v.view(torch.int32)) and torch.equal(iout, want_i)):
        raise SystemExit(f"{tree}: the row kernel differs from its plain version")
    torch.cuda.synchronize()
    before = mp.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            mp.minplus_cuda_batch(kprev, cost, out=out, iout=iout)
        torch.cuda.synchronize()
    launches = mp.launches - before
    names, total, count = set(), 0.0, 0
    for e in prof.key_averages():
        if "minplus" in e.key:
            names.add(e.key)
            total += getattr(e, "device_time_total", None) or e.cuda_time_total
            count += e.count
    if launches != CALLS or not 0 < count <= CALLS:
        raise SystemExit(f"{tree}: {launches} row-kernel launches counted and {count} profiled in {CALLS} calls")
    return {"tree": str(tree), "kernel": " ".join(sorted(names)), "launches": launches, "profiled": count,
            "ms": total / 1e3 / count}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("minplus_row_time: torch.cuda.is_available() is False; this needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
