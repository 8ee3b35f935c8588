"""The readings that the DeepSeek-V3 cell's correctness limits are set
from, on the card at the cell's own size, all seeds in one process:

    python3 perfbench/control_v3.py --seeds 1,2,... [--control-seeds 1,2,3] \\
        [--fault-seeds 1,2,3] [--route-fault-seeds 1,2,3] [--out FILE]

For each seed, the program's first ``CHECK_STEPS`` steps (the window's own
call and feed, the routing recorded) against the reference forced to the
program's choices; on the control seeds, the control (the reference with
float8 products, :mod:`perfbench.reference.deepseek_v3`, routing on its own)
in the program's place; on the fault seeds, the program with each fault of
:mod:`perfbench.faults` planted; on the route-fault seeds, the reference
with the bias left out of its selection in the program's place. Each side
is judged against the float32 reference forced to that side's choices.
One JSON line per (seed, side): the numbers of :mod:`perfbench.compare` and
``route_agreement``. The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "deepseek-v3.train-4k"


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--route-fault-seeds", type=_ints, default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import faults, registry, weights, weights_v3
    from perfbench.modes import train_v3
    from perfbench.reference import deepseek_v3

    plan = registry.plan(WORKLOAD, ROOT)
    cell, config = plan["cell"], plan["config"]
    model, hp = config["model"], config["train"]
    device = torch.device("cuda")
    names = ["/".join(map(str, p)) for p, _, _ in weights_v3.param_layout(weights_v3.layout(model))]
    out = args.out.open("a") if args.out else None

    def emit(seed, side, prog, ref, seconds):
        _, checks, numbers = train_v3.judge(prog, ref, cell, names)
        line = json.dumps({"workload": WORKLOAD, "seed": seed, "side": side, "seconds": seconds, **numbers,
                           "route_agreement": ref["route_agreement"], "losses": prog["losses"],
                           "ref_losses": ref["losses"], "grad_norms": prog["grad_norms"].tolist(),
                           "ref_grad_norms": ref["grad_norms"].tolist()})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program_side(seed, batches, build=None):
        obj = train_v3.build(config, model, seed, device, build)
        prog, choices, _, _ = train_v3.program_first_steps(obj, batches, seed, hp, device)
        del obj
        gc.collect()
        torch.cuda.empty_cache()
        return prog, choices

    from repro_torch.launch.steps import build_train_step

    every = set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds) | set(args.route_fault_seeds)
    for seed in sorted(every):
        pool = weights.batch_pool(seed, cell["steps_drawn"], cell["batch"], cell["seq_len"], model["vocab_size"],
                                  device)
        batches = [pool[i] for i in range(train_v3.CHECK_STEPS)]
        t0 = time.perf_counter()
        sides = {}
        if seed in args.seeds:
            sides["program"] = program_side(seed, batches)
        for fault in (faults.FAULTS if seed in args.fault_seeds else ()):
            sides[f"fault_{fault}"] = program_side(seed, batches, faults.FAULTS[fault](build_train_step))
        if seed in args.control_seeds:
            got = deepseek_v3.follow(model, hp, seed, batches, device, precision="fp8")
            sides["control"] = got, got["choices"]
        if seed in args.route_fault_seeds:
            got = deepseek_v3.follow(model, hp, seed, batches, device, route_fault="no_bias")
            sides["fault_route_no_bias"] = got, got["choices"]
        for side, (got, choices) in sides.items():
            t1 = time.perf_counter()
            ref = deepseek_v3.follow(model, hp, seed, batches, device, choices=choices)
            emit(seed, side, got, ref, time.perf_counter() - t1)
            torch.cuda.empty_cache()
        print(f"[control_v3] seed {seed}: {time.perf_counter() - t0:.1f} s, sides {sorted(sides)}", file=sys.stderr,
              flush=True)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro"))
    if bad:
        print(f"the process loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
