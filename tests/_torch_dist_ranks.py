"""The port's sharded cases at 8 CPU ranks over gloo, for
``tests/test_torch_distribution.py``.

    python tests/_torch_dist_ranks.py DIR

reads ``DIR/inputs.npz`` (numpy arrays keyed by case and parameter path),
spawns 8 ranks that meet through a ``FileStore`` in ``DIR`` (no TCP port),
builds a (2, 4) ``("data", "model")`` mesh, runs each case on DTensors and
writes rank 0's results to ``DIR/out.npz``. It imports no JAX: the test
computes the reference's side in its own process.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

WORLD = 8
MESH = (2, 4)


def flat(tree, prefix=""):
    """``{path: tensor}`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, x in items:
        out.update(flat(x, f"{prefix}/{k}" if prefix else str(k)))
    return out


def fill(like, arrays, prefix):
    """``like``'s tree with each leaf replaced by ``arrays[prefix/path]``."""
    from repro_torch.optim.optimizers import tree_map

    paths = iter(flat(like))
    return tree_map(lambda _: torch.tensor(arrays[f"{prefix}/{next(paths)}"]), like)


def gathered(tree, prefix):
    """``{prefix/path: numpy}`` of a tree of DTensors, gathered whole."""
    return {f"{prefix}/{k}": x.full_tensor().detach().numpy() for k, x in flat(tree).items()}


def placements(tree) -> list:
    """The placement lists of a tree that ``train_shardings`` gives, in
    :func:`flat`'s order."""
    from torch.distributed.tensor import Placement

    if isinstance(tree, list) and tree and all(isinstance(p, Placement) for p in tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [pl for x in items for pl in placements(x)]


def moe_case(inp, mesh, shd):
    """olmoe-1b-7b SMOKE, one layer's ``moe_ffn``: a2a on the mesh
    (experts over "model"), its output, aux and gradients."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.moe_dispatch import moe_ffn

    cfg = get_config("olmoe-1b-7b", smoke=True).replace(capacity_factor=4.0)
    p = fill(init_params(cfg, 0, device="cpu")["moe_layers"][0]["moe"], inp, "moe/p")
    x, c = torch.from_numpy(inp["moe/x"]), torch.from_numpy(inp["moe/c"])
    out = {}
    # a process group with no active mesh: a2a runs the dense dispatch
    y_nm, _ = moe_ffn(cfg.replace(moe_impl="a2a"), p, x)
    y_dense, _ = moe_ffn(cfg.replace(moe_impl="dense"), p, x)
    out["moe/no_mesh_equal"] = np.asarray(torch.equal(y_nm, y_dense))
    with shd.mesh_context(mesh, {"expert": ("model",)}):
        pd = shd.distribute_params({"moe": p})["moe"]
        rep = [Replicate()] * mesh.ndim
        xd = distribute_tensor(x, mesh, rep).requires_grad_()
        leaves = [xd] + [pd["experts"][n].requires_grad_() for n in ("w_gate", "w_in", "w_out")]
        y, aux = moe_ffn(cfg.replace(moe_impl="a2a"), pd, xd)
        grads = torch.autograd.grad((y * distribute_tensor(c, mesh, rep)).sum(), leaves)
    out["moe/y"] = y.full_tensor().detach().numpy()
    out["moe/aux"] = aux.full_tensor().detach().numpy()
    for name, g in zip(("x", "w_gate", "w_in", "w_out"), grads):
        out[f"moe/g/{name}"] = g.full_tensor().numpy()
    out["moe/experts_on_model"] = np.asarray(list(pd["experts"]["w_gate"].placements) == [Replicate(), Shard(0)])
    return out


def train_case(inp, mesh, shd, tag, arch, **replace):
    """One sharded ``build_train_step`` of ``arch`` SMOKE (B = 8, S = 32,
    ``act_seq`` on "model"), parameters placed by ``distribute_params``,
    the batch by ``batch_pspecs``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import batch_pspecs, build_train_step, train_shardings
    from repro_torch.models import layers
    from repro_torch.models.model import init_params

    cfg = get_config(arch, smoke=True).replace(**replace)
    params = fill(init_params(cfg, 0, device="cpu"), inp, f"{tag}/p")
    batch = {"tokens": torch.from_numpy(inp[f"{tag}/tokens"]).long()}
    step, opt = build_train_step(cfg)
    calls = [0]
    inner = layers._flash_bshd

    def counted(*args, **kw):
        calls[0] += 1
        return inner(*args, **kw)

    layers._flash_bshd = counted
    try:
        with shd.mesh_context(mesh, {"act_seq": "model"}):
            B = batch["tokens"].shape[0]
            p_pl, o_pl, b_pl = train_shardings(cfg, params, None, batch, B)
            pd = shd.distribute_params(params)
            od = opt.init(pd)
            bd = {k: distribute_tensor(v, mesh, shd.spec_to_placements(s, mesh))
                  for (k, v), s in zip(batch.items(), batch_pspecs(cfg, batch, B).values())}
            placed = all(list(x.placements) == pl for x, pl in zip(flat(pd).values(), placements(p_pl)))
            placed &= all(list(x.placements) == pl for x, pl in zip(flat(od.mu).values(), placements(o_pl.mu)))
            placed &= all(list(x.placements) == pl for x, pl in zip(bd.values(), placements(b_pl)))
            pd, od, loss = step(pd, od, bd)
    finally:
        layers._flash_bshd = inner
    out = gathered(pd, f"{tag}/p")
    out[f"{tag}/loss"] = loss.full_tensor().numpy()
    out[f"{tag}/placed"] = np.asarray(placed)
    out[f"{tag}/flash_calls"] = np.asarray(calls[0])
    return out


def serve_case(inp, mesh, shd):
    """gemma2-2b SMOKE, two sharded serve steps (B = 8, S = 64) from zero
    tokens, the cache placed by ``cache_pspecs`` and written in place."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import batch_pspecs, build_serve_step, cache_pspecs
    from repro_torch.models.model import init_cache, init_params

    cfg = get_config("gemma2-2b", smoke=True)
    B, S = 8, 64
    params = fill(init_params(cfg, 0, device="cpu"), inp, "gm/p")
    step = build_serve_step(cfg)
    with shd.mesh_context(mesh):
        pd = shd.distribute_params(params)
        cache = init_cache(cfg, B, S, device="cpu")
        cache = tuple(distribute_tensor(c, mesh, shd.spec_to_placements(s, mesh))
                      for c, s in zip(cache, cache_pspecs(cfg, cache, B, S)))
        ptrs = [c.to_local().data_ptr() for c in cache]
        tok = torch.zeros((B, 1), dtype=torch.long)
        tok = distribute_tensor(tok, mesh, shd.spec_to_placements(batch_pspecs(cfg, tok, B), mesh))
        toks, in_place = [], True
        for pos in range(2):
            tok, cache = step(pd, cache, tok, pos)
            toks.append(tok.full_tensor().numpy())
            in_place &= [c.to_local().data_ptr() for c in cache] == ptrs
    return {"sv/tok": np.stack(toks), "sv/k": cache[0].full_tensor().numpy(), "sv/v": cache[1].full_tensor().numpy(),
            "sv/in_place": np.asarray(in_place)}


def run(rank, d):
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}", rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    try:
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_smoke_mesh

        inp = dict(np.load(os.path.join(d, "inputs.npz")))
        mesh = make_smoke_mesh(MESH, device_type="cpu")
        out, times = {}, {}
        for name, case in (
            ("moe", lambda: moe_case(inp, mesh, shd)),
            ("gm", lambda: train_case(inp, mesh, shd, "gm", "gemma2-2b", attn_impl="flash", remat="full")),
            ("ds", lambda: train_case(inp, mesh, shd, "ds", "deepseek-7b")),
            ("sv", lambda: serve_case(inp, mesh, shd)),
        ):
            t0 = time.perf_counter()
            out.update(case())
            times[name] = time.perf_counter() - t0
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), **out)
            print("case seconds:", {k: round(v, 1) for k, v in times.items()}, flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=WORLD)
