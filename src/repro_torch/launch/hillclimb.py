"""Sharding hill-climb of the port: one (arch x input-shape) step traced on
the production mesh under a named variant of the config and the sharding
rules, its roofline terms recorded, after the reference's
``scripts/hillclimb.py``.

Run it as its own process, as :mod:`repro_torch.launch.dryrun` (it opens
the default process group, a ``"fake"`` one of 256 or 512 ranks):

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch deepseek-7b --shape train_4k --variant fsdp_only --mesh pod

``--device cpu`` traces with CPU stand-ins (the default is ``cuda``, and
without a card it fails: there is no fallback to the CPU), ``--smoke``
takes the arch's SMOKE config, ``--out`` defaults to
``build/perf/{arch}.{shape}.{variant}.json``. The result is
:func:`repro_torch.launch.dryrun.lower_one`'s, with ``"variant"`` added;
the last line printed is the reference's summary (``compute= memory=
collective= dominant=``).

The reference's ``--save-hlo`` is not offered: the port has no program
text to save (its dry run traces the step eagerly on fake tensors).
"""

from __future__ import annotations

import argparse
import json
import os

from ..configs import INPUT_SHAPES
from .dryrun import lower_one

__all__ = ["VARIANTS", "main", "run_variant"]

# variant -> (cfg_overrides, rules_overrides), as the reference names them
VARIANTS = {
    # paper-faithful baseline: uniform 2-D fsdp+tp sharding
    "baseline": ({}, {}),
    # pure FSDP over all 256 chips: batch & weight shards over ('data','model'),
    # no tensor parallelism, no sequence-parallel gathers
    "fsdp_only": (
        {},
        {"batch": ("data", "model"), "fsdp": ("data", "model"), "tensor": None, "act_seq": None},
    ),
    # keep TP but drop sequence-parallel residuals (trades memory for gathers)
    "no_actseq": ({}, {"act_seq": None}),
    # TP=4 hybrid: fsdp gets 4x more devices via a reshaped logical mapping is
    # not expressible on the fixed mesh; approximate with fsdp over both axes
    # but tensor kept for the FFN only via act_seq off
    "fsdp_tp_noseq": ({}, {"batch": ("data",), "act_seq": None}),
    # remat policy: save dots (more memory, less recompute)
    "remat_dots": ({"remat": "dots"}, {}),
    # bigger attention query blocks (fewer scan trips, bigger tiles)
    "blockq_1024": ({"attn_block_q": 1024}, {}),
    # MoE: einsum dispatch instead of a2a (hypothesis: a2a wins at train scale)
    "moe_einsum": ({"moe_impl": "einsum"}, {}),
    # MoE: lower capacity factor (less padding waste)
    "cap_1_0": ({"capacity_factor": 1.0}, {}),
    # expert-parallel over 'model' only (ds-v3: 16 experts/device instead of 1)
    "ep_model": ({}, {"expert": ("model",)}),
    # fsdp_only + tight MoE capacity (less dispatch-buffer padding traffic)
    "fsdp_cap10": (
        {"capacity_factor": 1.0},
        {"batch": ("data", "model"), "fsdp": ("data", "model"), "tensor": None, "act_seq": None},
    ),
}


def run_variant(arch: str, shape: str, variant: str, multi_pod: bool = False, *, device="cuda",
                smoke: bool = False, verbose: bool = False) -> dict:
    """:func:`repro_torch.launch.dryrun.lower_one` of the combo under
    ``VARIANTS[variant]``, with ``"variant"`` added."""
    cfg_o, rules_o = VARIANTS[variant]
    result = lower_one(arch, shape, multi_pod, verbose, cfg_overrides=cfg_o, rules_overrides=rules_o,
                       device=device, smoke=smoke)
    result["variant"] = variant
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--device", default="cuda", help="the stand-ins' device: cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    ap.add_argument("--out", default=None, help="default build/perf/{arch}.{shape}.{variant}.json")
    args = ap.parse_args()

    result = run_variant(args.arch, args.shape, args.variant, args.mesh == "multipod", device=args.device,
                         smoke=args.smoke, verbose=True)
    out = args.out or os.path.join("build", "perf", f"{args.arch}.{args.shape}.{args.variant}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    r = result.get("roofline", {})
    print(
        f"\n{args.arch} {args.shape} [{args.variant}]: "
        f"compute={r.get('t_compute_s', 0):.3e} memory={r.get('t_memory_s', 0):.3e} "
        f"collective={r.get('t_collective_s', 0):.3e} dominant={r.get('dominant')}"
    )


if __name__ == "__main__":
    main()
