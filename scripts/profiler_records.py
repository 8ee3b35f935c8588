"""How often ``torch.profiler`` loses the records of short kernel launches,
with and without a margin of host time at each end of its window.

    python3 scripts/profiler_records.py [SESSIONS]

Builds the port's kernels and calls the min-plus row kernel
(``repro_torch.kernels.minplus.minplus_cuda_batch``) at ``chip_smoke.py``
phase 5's main shape (B = 16, T+1 = 10,001, W = 1,001, numpy seed 0) CALLS
times in each of SESSIONS profiler sessions (default 60), as
``chip_smoke.py``'s ``device_ms_by`` does: the calls and a synchronize
inside ``profile(activities=[CUDA])``, the launches counted by the
wrapper's counter. It runs the sessions in turns: no margin, then
``chip_smoke.PROFILER_MARGIN_S`` of host sleep after the window opens and
before it closes. For each margin it prints one JSON line: the sessions,
the launches the counter saw, the records the profiler kept, the sessions
that lost at least one record, and the launch counts those sessions saw
(with their session index, to show whether the first session of the
process is the one that loses them). Needs a CUDA card; prints the card's
name and power limit first.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, TP, W, CALLS = 16, 10_001, 1_001, 5


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import minplus as mp

    if not torch.cuda.is_available():
        print("profiler_records: needs a CUDA card", file=sys.stderr)
        return 1
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    print(chip_smoke.gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    mp._launch_fns()
    dev = torch.device("cuda")
    kprev, cost = chip_smoke.band_inputs(np.random.default_rng(0), B, TP, W, dev)
    out_k, out_i = torch.empty_like(kprev), torch.empty(kprev.shape, dtype=torch.int32, device=dev)

    def row():
        mp.minplus_cuda_batch(kprev, cost, out=out_k, iout=out_i)

    row()
    torch.cuda.synchronize()
    margins = (0.0, chip_smoke.PROFILER_MARGIN_S)
    seen = {m: [] for m in margins}
    for i in range(sessions):
        for m in margins:
            before = mp.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(m)
                for _ in range(CALLS):
                    row()
                torch.cuda.synchronize()
                time.sleep(m)
            launched = mp.launches - before
            kept = sum(e.count for e in prof.key_averages() if "minplus_row_kernel" in e.key)
            seen[m].append((i, launched, kept))
    for m, runs in seen.items():
        lost = [(i, kept) for i, launched, kept in runs if kept != launched]
        print(json.dumps({"margin_s": m, "sessions": len(runs), "launches": sum(r[1] for r in runs),
                          "records": sum(r[2] for r in runs), "sessions_losing_records": len(lost),
                          "lost_sessions": lost[:20]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
