"""Roofline terms of one step on the H100, after the JAX package's
``launch/roofline.py``.

Three terms per (arch, shape, mesh), in seconds per training or serving
step, from the per-device cost that :mod:`repro_torch.launch.hlo_analysis`
counts on the local shards:

  compute    = FLOPs / peak_flops
  memory     = bytes / hbm_bw
  collective = collective_bytes / link_bw

``HW`` holds the H100 SXM5's figures (NVIDIA H100 Tensor Core GPU
datasheet, SXM5 column; the card of this port's chip runs is "NVIDIA H100
80GB HBM3"):

  peak_flops 989e12  dense bfloat16 on the tensor cores (the datasheet's
                     1,979 TFLOP/s is with 2:4 sparsity; ``chip_smoke.py``
                     bounds its bf16 kernels by the same figure)
  hbm_bw     3.35e12 B/s of HBM3
  link_bw    50e9 B/s: one 400 Gb/s NDR InfiniBand NIC per GPU, the
             usual DGX H100 / HGX pod fabric. Every 16-wide axis of a
             (16, 16) mesh of 256 GPUs spans two 8-GPU nodes, so a ring
             over it crosses the NICs, and the ring runs at the slowest
             link. NVLink 4 gives 900 GB/s per GPU (both directions
             together, 450 GB/s each way) inside a node; it would serve
             only an axis of at most 8 GPUs, which the production meshes
             do not have.

Collective bytes: for each collective the counter records the op, its
local result bytes and its group size, and the reference's ring-algorithm
multipliers apply (the group size clamped at 2, as the reference's HLO
parser clamps it):

  all-gather         bytes ~ result * (n-1)/n
  all-reduce         bytes ~ 2 * size * (n-1)/n
  reduce-scatter     bytes ~ result * (n-1)
  all-to-all         bytes ~ result * (n-1)/n
  collective-permute bytes ~ result
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

__all__ = ["HW", "collective_bytes", "ring_bytes", "roofline_terms", "roofline_terms_from_cost"]

HW = {
    "peak_flops": 989e12,  # bf16 dense, tensor cores, per H100 SXM
    "hbm_bw": 3.35e12,  # bytes/s, HBM3
    "link_bw": 50e9,  # bytes/s, one 400 Gb/s NDR NIC per GPU
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def ring_bytes(op: str, size: float, n: int) -> float:
    """Per-device traffic of one collective ``op`` whose local result is
    ``size`` bytes over a group of ``n`` (clamped at 2)."""
    n = max(int(n), 2)
    if op == "all-gather":
        return size * (n - 1) / n
    if op == "all-reduce":
        return 2 * size * (n - 1) / n
    if op == "reduce-scatter":
        return size * (n - 1)
    if op == "all-to-all":
        return size * (n - 1) / n
    if op == "collective-permute":
        return float(size)
    raise ValueError(f"not a collective: {op!r}")


def collective_bytes(records: Iterable[Tuple[str, int, int]]) -> Dict[str, float]:
    """Per-op-type per-device collective traffic in bytes from the
    counter's records ``(op, local result bytes, group size)``
    (:attr:`repro_torch.launch.hlo_analysis.CostCounter.records`): the
    reference's dict, one entry per op, ``_counts`` and ``total``."""
    out = {op: 0.0 for op in COLLECTIVES}
    counts = {op: 0 for op in COLLECTIVES}
    for op, size, n in records:
        out[op] += ring_bytes(op, size, n)
        counts[op] += 1
    out["_counts"] = counts
    out["total"] = float(sum(v for k, v in out.items() if k in COLLECTIVES))
    return out


def _dominant(t_compute: float, t_memory: float, t_coll: float) -> str:
    return max(("compute", t_compute), ("memory", t_memory), ("collective", t_coll), key=lambda kv: kv[1])[0]


def roofline_terms_from_cost(c) -> Dict[str, float]:
    """The roofline terms of a counted step, from an
    :class:`repro_torch.launch.hlo_analysis.HloCost` (the reference's
    ``roofline_terms_from_hlo`` reads the same record from HLO text)."""
    t_compute = c.flops / HW["peak_flops"]
    t_memory = c.mem_bytes / HW["hbm_bw"]
    t_coll = c.coll_total / HW["link_bw"]
    return {
        "hlo_flops_per_device": c.flops,
        "hlo_bytes_per_device": c.mem_bytes,
        "collective_bytes_per_device": c.coll_total,
        "collective_bytes_by_type": dict(c.coll_bytes),
        "collective_counts": dict(c.coll_counts),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": _dominant(t_compute, t_memory, t_coll),
    }


def roofline_terms(cost: dict, coll: Dict[str, float]) -> Dict[str, float]:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / HW["peak_flops"]
    t_memory = byts / HW["hbm_bw"]
    t_coll = coll["total"] / HW["link_bw"]
    return {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": byts,
        "collective_bytes_per_device": coll["total"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": _dominant(t_compute, t_memory, t_coll),
    }
