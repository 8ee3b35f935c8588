"""The readings that a training cell's correctness limits are set from, on
the card at the cell's own size, all seeds in one process:

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

For each seed, the program's first ``CHECK_STEPS`` steps (the window's own
call and feed) against the reference's; on the control seeds, the control
(the reference computed with float8 products, :mod:`perfbench.reference.decoder`)
in the program's place against the reference; on the fault seeds, the
program with each fault of :mod:`perfbench.faults` planted. One JSON line
per (seed, side): the numbers of :mod:`perfbench.compare`. The benchmark's
own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import compare, faults, registry, weights
    from perfbench.modes import train
    from perfbench.reference import decoder

    plan = registry.plan(args.workload, ROOT)
    cell, config = plan["cell"], plan["config"]
    model, hp = config["model"], config["train"]
    device = torch.device("cuda")
    names = ["/".join(map(str, p)) for p, _, _ in weights.layout(model)]
    out = args.out.open("a") if args.out else None

    def emit(seed, side, numbers, seconds):
        line = json.dumps({"workload": args.workload, "seed": seed, "side": side, "seconds": seconds, **numbers})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program_side(seed, batches, build=None):
        obj = train.build(config, model, seed, device, build)
        prog, _, _ = train.program_first_steps(obj["step"], obj["params"], obj["state"], batches, obj["lay"], seed,
                                               hp, device, obj["cfg"].pdtype())
        del obj
        gc.collect()
        torch.cuda.empty_cache()
        return prog

    from repro_torch.launch.steps import build_train_step

    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        pool = weights.batch_pool(seed, cell["steps_drawn"], cell["batch"], cell["seq_len"], model["vocab_size"],
                                  device)
        batches = [pool[i] for i in range(train.CHECK_STEPS)]
        t0 = time.perf_counter()
        sides = {}
        if seed in args.seeds:
            sides["program"] = program_side(seed, batches)
        for fault in (faults.FAULTS if seed in args.fault_seeds else ()):
            sides[f"fault_{fault}"] = program_side(seed, batches, faults.FAULTS[fault](build_train_step))
        t1 = time.perf_counter()
        ref = decoder.follow(model, hp, seed, batches, device)
        t_ref = time.perf_counter() - t1
        if seed in args.control_seeds:
            sides["control"] = decoder.follow(model, hp, seed, batches, device, precision="fp8")
        keep = compare.counted(ref["grad_norms"])
        for side, got in sides.items():
            emit(seed, side, {**compare.readings(got, ref, names), "losses": got["losses"],
                              "ref_losses": ref["losses"],
                              "leaf_grad_gaps": compare.leaf_gaps(got["grad_norms"], ref["grad_norms"],
                                                                  torch.ones_like(keep)).tolist(),
                              "leaf_change_gaps": compare.leaf_gaps(got["change_norms"], ref["change_norms"],
                                                                    keep).tolist(),
                              "grad_norms": got["grad_norms"].tolist(), "ref_grad_norms": ref["grad_norms"].tolist(),
                              "change_norms": got["change_norms"].tolist(),
                              "ref_change_norms": ref["change_norms"].tolist()}, t_ref)
        print(f"[control] seed {seed}: {time.perf_counter() - t0:.1f} s (program sides {t1 - t0:.1f} s, "
              f"reference {t_ref:.1f} s)", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro"))
    if bad:
        print(f"the process loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
