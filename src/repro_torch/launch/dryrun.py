"""Dry run of the port: one (arch x input-shape) step traced on the production
mesh over a fake process group, its per-device cost counted, after the JAX
package's ``launch/dryrun.py``.

Run it as its own process: it opens torch.distributed's default process
group (a ``"fake"`` one of 256 or 512 ranks, this process rank 0), and a
process has one. One combo per invocation:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch deepseek-7b --shape train_4k --mesh pod \\
        --out build/dryrun/deepseek-7b.train_4k.pod.json

``--mesh pod`` = (data=16, model=16); ``--mesh multipod`` = (pod=2, 16, 16).
:mod:`repro_torch.launch.hillclimb` runs :func:`lower_one` under the
reference's named variants of the config and the rules.
``--device cpu`` traces with CPU stand-ins (no card needed; the default is
``cuda``), ``--smoke`` takes the arch's SMOKE config, ``--unsharded`` also
counts the same step without a mesh (under the result's ``"unsharded"``).

Where the reference lowers and compiles the SPMD program and reads its HLO,
the port traces the step once, eagerly, on fake tensors
(:func:`repro_torch.models.model.fake_mode`): parameters, optimizer state,
batch and cache come from :func:`repro_torch.launch.steps.abstract_params`,
``abstract_opt_state`` and :func:`repro_torch.models.input_specs`, placed
on the mesh as the sharded steps place them (``param_pspecs``,
``opt_state_pspecs``, ``batch_pspecs``, ``cache_pspecs`` through
``distribute_tree``), and the step runs under
:class:`repro_torch.launch.hlo_analysis.CostCounter`, which counts what
rank 0 runs on its local shards. Nothing is allocated and no kernel runs.

The result keeps the reference's keys. ``lower_s`` is the trace's seconds
and ``compile_s`` 0.0 (nothing is compiled). ``memory``: ``argument_bytes``
and ``output_bytes`` are rank 0's local bytes of the step's arguments and
results; ``temp_bytes`` and ``peak_bytes`` are ``None`` (an eager trace
has no buffer assignment to read them from). ``roofline`` and
``roofline_static`` hold the same terms: the reference's differ because
``cost_analysis()`` counts a ``while`` body once, and the port's trace has
no loop body counted once.

A config with ``attn_impl="flash"`` is refused: the kernel's ctypes launch
cannot run on fake tensors, and counting no FLOPs for attention would be
wrong. The dry run's configs keep the default plain route (the reference's
``"xla"``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from ..configs import INPUT_SHAPES, get_config
from ..configs.base import InputShape, ModelConfig
from ..core.torch_dp import resolve_device
from ..models import moe_dispatch
from ..models.model import _batch_struct, fake_mode, input_specs, supports_mode
from . import sharding as shd
from .hlo_analysis import CostCounter
from .mesh import make_production_mesh
from .roofline import collective_bytes, roofline_terms, roofline_terms_from_cost
from .steps import (
    abstract_opt_state,
    abstract_params,
    batch_pspecs,
    build_prefill_step,
    build_serve_step,
    build_train_step,
    cache_pspecs,
    distribute_tree,
)

__all__ = ["configure", "count_step", "lower_one", "main", "open_fake_group"]


def configure(arch: str, shape: InputShape, smoke: bool = False) -> tuple:
    """Per-(arch, shape) config tweaks and sharding rules (the reference's
    ``configure``; ``smoke`` takes the arch's SMOKE config)."""
    cfg = get_config(arch, smoke=smoke)
    rules = {}
    if shape.mode in ("train", "prefill"):
        rules["act_seq"] = "model"  # sequence-parallel residual activations
    if cfg.num_experts:
        cfg = cfg.replace(moe_impl="a2a" if shape.mode in ("train", "prefill") else "einsum")
        if cfg.num_experts >= 256:
            rules["expert"] = ("data", "model")  # one expert per device
    if shape.name == "long_500k" and cfg.attn_kind == "local_global":
        cfg = cfg.replace(long_context=True)  # gemma2: all-sliding serving mode
    return cfg, rules


def open_fake_group(world_size: int):
    """Opens the default process group as a ``"fake"`` one of
    ``world_size`` ranks, this process rank 0 (collectives return at once
    and move nothing), or checks that an open group has that size.
    ``FakeStore`` is a private torch module, imported here on first use."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"the open process group has {dist.get_world_size()} ranks, not {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on this rank (a DTensor's local
    shard)."""
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(x) for x in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(x) for x in tree)
    return 0


def count_step(cfg: ModelConfig, shape: InputShape, mesh=None, rules=None, device="cuda"):
    """``(counter, seconds, memory)``: one step of ``shape``'s mode (train,
    prefill or serve) on fake stand-ins, placed on ``mesh`` under ``rules``
    (unsharded without a mesh), traced under a
    :class:`repro_torch.launch.hlo_analysis.CostCounter`; the trace's
    seconds; rank 0's ``argument_bytes`` and ``output_bytes``."""
    if cfg.attn_impl == "flash":
        raise ValueError("the dry run traces on fake tensors, which the flash kernel's launch cannot take; "
                         "use attn_impl='plain'")
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    with shd.mesh_context(mesh, rules):
        params = abstract_params(cfg, dev)
        if mesh is not None:
            with fake_mode():
                params = distribute_tree(params, shd.param_pspecs(params), mesh)
            if cfg.num_experts and cfg.moe_impl == "a2a":
                # the expert group (a flattened DeviceMesh for several axes)
                # is made once per mesh; made inside the fake mode, its
                # coordinates would be fake tensors
                ep = shd.rules()["expert"]
                moe_dispatch._ep_group(mesh, (ep,) if isinstance(ep, str) else tuple(ep))

        def placed(tree, specs):  # a batch or a cache, placed as the sharded steps place it
            if mesh is None:
                return tree
            with fake_mode():
                return distribute_tree(tree, specs(tree), mesh)

        def batch_specs(tree):
            return batch_pspecs(cfg, tree, B)

        if shape.mode == "train":
            step, _ = build_train_step(cfg)
            batch = placed(_batch_struct(cfg, B, S, "train", dev), batch_specs)
            args = (params, abstract_opt_state(cfg, params), batch)
        elif shape.mode == "prefill":
            step = build_prefill_step(cfg)
            args = (params, placed(_batch_struct(cfg, B, S, "prefill", dev), batch_specs))
        else:
            step = build_serve_step(cfg)
            spec = input_specs(cfg, shape, dev)
            args = (params, placed(spec["cache"], lambda t: cache_pspecs(cfg, t, B, S)),
                    placed(spec["tokens"], batch_specs), spec["pos"])
        counter = CostCounter()
        t0 = time.perf_counter()
        with fake_mode(), counter:
            out = step(*args)
        seconds = time.perf_counter() - t0
    memory = {"argument_bytes": _local_bytes(args), "output_bytes": _local_bytes(out), "temp_bytes": None,
              "peak_bytes": None}
    return counter, seconds, memory


def lower_one(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
              cfg_overrides: dict = None, rules_overrides: dict = None, *, device="cuda", smoke: bool = False,
              unsharded: bool = False) -> dict:
    """The dry run of one combo (the reference's ``lower_one``): the result
    dict, with ``status`` ``"skipped"`` where :func:`supports_mode` refuses
    the combo. ``unsharded`` adds the same step's count without a mesh."""
    shape = INPUT_SHAPES[shape_name]
    cfg, rules = configure(arch, shape, smoke=smoke)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if rules_overrides:
        rules.update(rules_overrides)
    ok, reason = supports_mode(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16", "mode": shape.mode}
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        return result

    open_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=resolve_device(device).type)
    n_chips = mesh.size()

    counter, t_lower, memory = count_step(cfg, shape, mesh, rules, device)
    cost = {"flops": counter.cost.flops, "bytes accessed": counter.cost.mem_bytes}
    coll = collective_bytes(counter.records)
    terms = roofline_terms_from_cost(counter.cost)
    result.update(
        status="ok",
        n_chips=n_chips,
        lower_s=round(t_lower, 2),
        compile_s=0.0,
        memory=memory,
        cost=cost,
        collectives=coll,
        roofline=terms,
        roofline_static=roofline_terms(cost, coll),
    )
    if unsharded:
        c1, t1, _ = count_step(cfg, shape, None, None, device)
        result["unsharded"] = {"flops": c1.cost.flops, "bytes accessed": c1.cost.mem_bytes, "lower_s": round(t1, 2)}
    if verbose:
        print(json.dumps({k: result[k] for k in ("arch", "shape", "mesh", "status")}))
        print(f"  trace {t_lower:.1f}s")
        print(f"  memory (rank 0): {memory}")
        print("  roofline: compute %.3es memory %.3es collective %.3es -> %s"
              % (terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"], terms["dominant"]))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="the stand-ins' device: cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    ap.add_argument("--unsharded", action="store_true", help="also count the step without a mesh")
    args = ap.parse_args()

    mesh_name = "2x16x16" if args.mesh == "multipod" else "16x16"
    try:
        result = lower_one(args.arch, args.shape, args.mesh == "multipod", device=args.device, smoke=args.smoke,
                           unsharded=args.unsharded)
    except Exception as e:  # record failures as artifacts too
        result = {
            "arch": args.arch, "shape": args.shape, "mesh": mesh_name,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(result["error"])

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if result["status"] == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
