"""The port's sharded cases at 8 CPU ranks over gloo, for
``tests/test_torch_distribution.py`` and
``tests/test_torch_distribution_zoo.py``.

    python tests/_torch_dist_ranks.py DIR [base|zoo]

reads ``DIR/inputs.npz`` (numpy arrays keyed by case and parameter path),
spawns 8 ranks that meet through a ``FileStore`` in ``DIR`` (no TCP port),
builds a (2, 4) ``("data", "model")`` mesh (and for ``zoo`` an (8, 1) one),
runs the named list of cases (``base`` by default) on DTensors and writes
rank 0's results to ``DIR/out.npz``. It imports no JAX: the tests compute
the reference's side in their own process. Every rank holds DTensor's
views to the stricter rule of torch 2.11 (:func:`strict_views`).
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


def placed(tree, pl_tree) -> bool:
    """Every DTensor leaf of ``tree`` in the placements at the same place
    of ``pl_tree``; the only plain leaf allowed is an optimizer's 0-d step
    count (a plain tensor in both optimizers)."""
    from torch.distributed.tensor import DTensor

    ok = True
    for x, pl in zip(flat(tree).values(), placements(pl_tree)):
        ok &= list(x.placements) == pl if isinstance(x, DTensor) else x.dim() == 0
    return bool(ok)


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
            pd = shd.distribute_params(params)
            od = opt.init(pd)
            p_pl, o_pl, b_pl = train_shardings(cfg, params, od, batch, B)
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


# -- the rest of the zoo (tests/test_torch_distribution_zoo.py) ---------------


class Inputs:
    """The zoo cases' inputs: ``DIR/inputs_<tag>.npz``, read when a case
    first asks for a key ``<tag>/...``. The test writes each file (by a
    rename) while the ranks start and run the cases before it, and a rank
    waits for a file that is not there yet."""

    def __init__(self, d):
        self.d, self.arrays, self.tags = d, {}, set()

    def prefixed(self, prefix) -> dict:
        self._load(prefix.split("/")[0])
        return {k: v for k, v in self.arrays.items() if k.startswith(prefix)}

    def __getitem__(self, key):
        self._load(key.split("/")[0])
        return self.arrays[key]

    def _load(self, tag):
        if tag in self.tags:
            return
        path, t0 = os.path.join(self.d, f"inputs_{tag}.npz"), time.perf_counter()
        while not os.path.exists(path):
            if time.perf_counter() - t0 > 600:
                raise TimeoutError(f"no {path}")
            time.sleep(0.05)
        self.arrays.update(np.load(path))
        self.tags.add(tag)


def batch_of(inp, tag):
    """The batch of case ``tag`` (``tag/b/<key>``), token ids as int64."""
    out = {}
    for k, v in inp.prefixed(f"{tag}/b/").items():
        t = torch.from_numpy(v)
        out[k[len(tag) + 3:]] = t.long() if v.dtype.kind == "i" else t
    return out


def zoo_train_case(inp, mesh, shd, tag, arch, rules, **replace):
    """One sharded ``build_train_step`` of ``arch`` SMOKE under ``rules``:
    the loss, every parameter after the step, and whether every
    parameter, optimizer-state and batch leaf is placed as
    ``train_shardings`` says."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import batch_pspecs, build_train_step, distribute_tree, train_shardings
    from repro_torch.models.model import init_params

    cfg = get_config(arch, smoke=True).replace(**replace)
    params = fill(init_params(cfg, 0, device="cpu"), inp, f"{tag}/p")
    batch = batch_of(inp, tag)
    B = next(iter(batch.values())).shape[0]
    step, opt = build_train_step(cfg)
    with shd.mesh_context(mesh, rules):
        pd = shd.distribute_params(params)
        od = opt.init(pd)
        p_pl, o_pl, b_pl = train_shardings(cfg, params, od, batch, B)
        bd = distribute_tree(batch, batch_pspecs(cfg, batch, B))
        ok = placed(pd, p_pl) and placed(od, o_pl) and placed(bd, b_pl)
        pd, od, loss = step(pd, od, bd)
    out = gathered(pd, f"{tag}/p")
    out[f"{tag}/loss"] = loss.full_tensor().numpy()
    out[f"{tag}/placed"] = np.asarray(ok)
    return out


def zoo_serve_case(inp, mesh, shd, tag, arch, B, S, pos0, steps, **replace):
    """``steps`` sharded serve steps of ``arch`` SMOKE from position
    ``pos0``, the cache (``tag/c/<path>``) placed by ``cache_pspecs``: the
    tokens, the cache after the steps, whether every cache leaf was placed
    as ``cache_pspecs`` says and whether the KV caches kept their local
    storage (written in place)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (_map_tensors, batch_pspecs, build_serve_step, cache_pspecs,
                                          distribute_tree, spec_leaves)
    from repro_torch.models.model import init_cache, init_params

    cfg = get_config(arch, smoke=True).replace(**replace)
    params = fill(init_params(cfg, 0, device="cpu"), inp, f"{tag}/p")
    cache = init_cache(cfg, B, S, device="cpu")
    paths = iter(flat(cache))
    cache = _map_tensors(lambda _: torch.from_numpy(inp[f"{tag}/c/{next(paths)}"]), cache)
    tok = torch.from_numpy(inp[f"{tag}/tok"]).long()
    step = build_serve_step(cfg)
    kv = lambda c: next((c[k] for k in ("attn", "moe") if k in c), ()) if isinstance(c, dict) else (  # noqa: E731
        c if isinstance(c, tuple) else ())
    with shd.mesh_context(mesh):
        pd = shd.distribute_params(params)
        specs = cache_pspecs(cfg, cache, B, S)
        cd = distribute_tree(cache, specs)
        ok = [list(x.placements) for x in flat(cd).values()] == [
            shd.spec_to_placements(s, mesh, x.shape) for s, x in zip(spec_leaves(specs), flat(cache).values())]
        ptrs = [x.to_local().data_ptr() for x in kv(cd)]
        td = distribute_tensor(tok, mesh, shd.spec_to_placements(batch_pspecs(cfg, tok, B), mesh, tok.shape))
        toks = []
        for pos in range(pos0, pos0 + steps):
            td, cd = step(pd, cd, td, pos)
            toks.append(td.full_tensor().numpy())
        in_place = [x.to_local().data_ptr() for x in kv(cd)] == ptrs
    return {f"{tag}/tok": np.stack(toks), f"{tag}/placed": np.asarray(ok), f"{tag}/in_place": np.asarray(in_place),
            **gathered(cd, f"{tag}/c")}


def einsum_case(inp, mesh, shd, tag, arch, rules, **replace):
    """One layer's ``moe_ffn`` of ``arch`` SMOKE with the einsum dispatch on
    the mesh under ``rules``, the tokens' batch on "data": its output and
    aux, whether the experts lay as the ``expert`` rule places them
    (``spec_to_placements`` replicates them where its axes do not divide
    them) and whether they lay whole on every rank; and the gradients of
    ``sum(y * r) + aux`` (``r`` from a seeded generator) with respect to
    ``x`` and every parameter, on the mesh and unsharded on each rank."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.moe_dispatch import moe_ffn
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = get_config(arch, smoke=True).replace(moe_impl="einsum", **replace)
    p = fill(init_params(cfg, 0, device="cpu")["moe_layers"][0]["moe"], inp, f"{tag}/p")
    x = torch.from_numpy(inp[f"{tag}/x"])
    with shd.mesh_context(mesh, rules):
        want = shd.spec_to_placements(shd.logical_to_mesh("expert", None, None), mesh, p["experts"]["w_in"].shape)
        pd = shd.distribute_params({"moe": p})["moe"]
        leaves = [xd := distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_()]
        leaves += [w.requires_grad_() for w in tree_leaves(pd)]
        y, aux = moe_ffn(cfg, pd, xd)
        r = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
        grads = torch.autograd.grad((y * distribute_tensor(r, mesh, list(y.placements))).sum() + aux, leaves)
    p1 = tree_map(lambda w: w.detach().clone().requires_grad_(), p)
    xl = x.clone().requires_grad_()
    y1, aux1 = moe_ffn(cfg, p1, xl)
    grads1 = torch.autograd.grad((y1 * r).sum() + aux1, [xl, *tree_leaves(p1)])
    placements = [list(w.placements) for w in pd["experts"].values()]
    return {f"{tag}/y": y.full_tensor().detach().numpy(), f"{tag}/aux": aux.full_tensor().detach().numpy(),
            f"{tag}/split": np.asarray(all(pl == want for pl in placements)),
            f"{tag}/whole": np.asarray(all(pl == [Replicate()] * mesh.ndim for pl in placements)),
            **{f"{tag}/grad/{i}": g.full_tensor().numpy() for i, g in enumerate(grads)},
            **{f"{tag}/grad1/{i}": g.numpy() for i, g in enumerate(grads1)}}


def cells_case(inp, mesh, shd):
    """The SSM cells on DTensors (each under one ``local_map``): outputs and
    final states, and whether the outputs come back split over batch
    ("data") and heads or channels ("model")."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import ssm

    rep = [Replicate()] * mesh.ndim

    def d(*names):
        return [distribute_tensor(torch.from_numpy(inp[f"cell/{n}"]), mesh, rep) for n in names]

    out, split = {}, True
    with shd.mesh_context(mesh):
        runs = {
            "conv": lambda: ssm.causal_conv1d(*d("cx", "cw", "cs")),
            "conv_step": lambda: ssm.causal_conv1d_step(*d("cx1", "cw", "cs")),
            "ssd": lambda: ssm.ssd_chunked(*d("x", "dt", "A", "B", "C"), 8, *d("s")),
            "ssd_step": lambda: ssm.ssd_step(*d("x1", "dt1", "A", "B1", "C1", "s")),
            "mlstm": lambda: ssm.mlstm_chunked(*d("q", "k", "v", "i", "f"), 8, tuple(d("mS", "mn", "mm"))),
            "mlstm_step": lambda: ssm.mlstm_step(*d("q1", "k1", "v1", "i1", "f1"), tuple(d("mS", "mn", "mm"))),
            "slstm": lambda: ssm.slstm_scan(*d("z", "zi", "zf", "zo"), dict(zip(("rz", "ri", "rf", "ro"),
                                                                                d("rz", "ri", "rf", "ro"))),
                                            tuple(d("sc", "sn", "sm", "sh"))),
            "slstm_step": lambda: ssm.slstm_step(*d("z1", "zi1", "zf1", "zo1"), tuple(d("sc", "sn", "sm"))),
        }
        for name, fn in runs.items():
            y, state = fn()
            # (B, L, C) conv outputs split channels (dim 2); (B, L, H, P) and
            # (B, H, P) cell outputs split heads (dim 2 and dim 1)
            head_dim = 2 if name in ("conv", "conv_step") or y.dim() == 4 else 1
            split &= list(y.placements) == [Shard(0), Shard(head_dim)]
            out[f"cell/{name}/y"] = y.full_tensor().numpy()
            for i, x in enumerate(state if isinstance(state, tuple) else (state,)):
                out[f"cell/{name}/s{i}"] = x.full_tensor().numpy()
    out["cell/split"] = np.asarray(split)
    return out


def cache_write_case(mesh, shd):
    """``write_cache`` of several rows (a prefill into the cache) into a
    ``(1, 128)`` cache split on its sequence dim over "data" (heads over
    "model"), at slots 61-65 (across the two blocks) and at 126 (clamped to
    123-127), against the same writes into a plain cache; and whether the
    split cache kept its local storage."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.dense import write_cache

    gen = torch.Generator().manual_seed(5)
    want = torch.randn(1, 128, 4, 8, generator=gen)
    rep = [Replicate()] * mesh.ndim
    with shd.mesh_context(mesh):
        got = distribute_tensor(want.clone(), mesh, [Shard(1), Shard(2)])
        ptr = got.to_local().data_ptr()
        for pos in (61, 126):
            x = torch.randn(1, 5, 4, 8, generator=gen)
            write_cache(want, x, torch.tensor(pos))
            got = write_cache(got, distribute_tensor(x, mesh, [Replicate(), Shard(2)]),
                              distribute_tensor(torch.tensor(pos), mesh, rep))
        in_place = got.to_local().data_ptr() == ptr
    return {"wr/got": got.full_tensor().numpy(), "wr/want": want.numpy(), "wr/in_place": np.asarray(in_place)}


def group_case(mesh, shd):
    """a2a's flattened expert group over ("data", "model") on the real
    mesh: its ranks in the order of the expert blocks that the experts'
    ``[Shard(0), Shard(0)]`` placement gives each rank (every rank's block
    offset, gathered)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.models.moe_dispatch import _ep_group

    w = distribute_tensor(torch.zeros(16, 2), mesh, [Shard(0), Shard(0)])
    block = compute_local_shape_and_global_offset(w.shape, mesh, w.placements)[1][0] // 2
    group = _ep_group(mesh, ("data", "model"))
    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, (dist.get_rank(), block))
    order = dist.get_process_group_ranks(group)
    return {"grp/ok": np.asarray(all(order[b] == r for r, b in blocks) and _ep_group(mesh, ("data", "model")) is group)}


def zoo_cases(inp, mesh, mesh81, shd):
    seq = {"act_seq": "model"}
    two = {"act_seq": "model", "expert": ("data", "model")}
    return (
        ("cell", lambda: cells_case(inp, mesh, shd)),
        ("grp", lambda: group_case(mesh, shd)),
        ("wr", lambda: cache_write_case(mesh, shd)),
        ("xl", lambda: zoo_train_case(inp, mesh, shd, "xl", "xlstm-1.3b", seq)),
        ("zb", lambda: zoo_train_case(inp, mesh, shd, "zb", "zamba2-2.7b", seq)),
        ("hb", lambda: zoo_train_case(inp, mesh, shd, "hb", "hubert-xlarge", seq)),
        ("pg", lambda: zoo_train_case(inp, mesh, shd, "pg", "paligemma-3b", seq)),
        ("gr8", lambda: zoo_train_case(inp, mesh81, shd, "gr8", "granite-20b", seq)),
        ("pg8", lambda: zoo_train_case(inp, mesh81, shd, "pg8", "paligemma-3b", seq)),
        ("om", lambda: zoo_train_case(inp, mesh, shd, "om", "olmoe-1b-7b", seq, moe_impl="a2a", capacity_factor=8.0)),
        ("dv", lambda: zoo_train_case(inp, mesh, shd, "dv", "deepseek-v3-671b", two, moe_impl="a2a",
                                      num_experts=8, capacity_factor=8.0)),
        ("sxl", lambda: zoo_serve_case(inp, mesh, shd, "sxl", "xlstm-1.3b", 8, 32, 0, 2)),
        ("szb", lambda: zoo_serve_case(inp, mesh, shd, "szb", "zamba2-2.7b", 8, 32, 0, 2)),
        ("spg", lambda: zoo_serve_case(inp, mesh, shd, "spg", "paligemma-3b", 8, 32, 20, 2)),
        ("lgm", lambda: zoo_serve_case(inp, mesh, shd, "lgm", "gemma2-2b", 1, 128, 63, 2, long_context=True)),
        ("lzb", lambda: zoo_serve_case(inp, mesh, shd, "lzb", "zamba2-2.7b", 1, 128, 63, 2)),
        ("som", lambda: zoo_serve_case(inp, mesh, shd, "som", "olmoe-1b-7b", 8, 32, 20, 2, moe_impl="einsum")),
        ("eom", lambda: einsum_case(inp, mesh, shd, "eom", "olmoe-1b-7b", {}, capacity_factor=0.2)),
        ("edv", lambda: einsum_case(inp, mesh, shd, "edv", "deepseek-v3-671b", {"expert": ("data", "model")},
                                    num_experts=8, capacity_factor=0.2)),
        ("eor", lambda: einsum_case(inp, mesh, shd, "eor", "olmoe-1b-7b", {}, num_experts=6, capacity_factor=0.15)),
    )


def strict_views():
    """Holds every DTensor view (``view``, ``_unsafe_view``: a matrix
    product's flatten of its leading dims among them) to the rule of torch
    2.11, which the card runs: it refuses a view that flattens a sharded dim
    into any but the first place of a group, flattens an unevenly sharded
    dim, or splits a sharded dim whose first part the mesh axis does not
    divide. Later torch passes the first kind as a ``_StridedShard``, so
    without this the ranks here would accept what the card refuses."""
    from torch.distributed.tensor._ops import _view_ops as vo
    from torch.distributed.tensor.placement_types import Shard, _StridedShard

    inner = vo.propagate_shape_and_sharding

    def held(placements, shape, rule, mesh_sizes, strict_view=False):
        def mesh_dims(dim):
            return [m for m, p in enumerate(placements) if isinstance(p, (Shard, _StridedShard)) and p.dim == dim]

        def in_dim(cmd):
            if isinstance(cmd, vo.InputDim):
                return cmd.input_dim
            if isinstance(cmd, vo.Flatten):
                for i, d in enumerate(cmd.input_dims):
                    ms = mesh_dims(d.input_dim)[:1]
                    if ms and (i > 0 or shape[d.input_dim] % mesh_sizes[ms[0]]):
                        raise RuntimeError(f"torch 2.11 refuses this view: it flattens dim {d.input_dim} of "
                                           f"{tuple(shape)}, sharded {tuple(placements)}")
                return cmd.input_dims[0].input_dim
            if isinstance(cmd, vo.Split):
                d = in_dim(cmd.input_dim)
                ms = mesh_dims(d)[:1] if cmd.split_id == 0 and d is not None else []
                if ms and cmd.group_shape[0] % mesh_sizes[ms[0]]:
                    raise RuntimeError(f"torch 2.11 refuses this view: it splits dim {d} of {tuple(shape)}, sharded "
                                       f"{tuple(placements)}, into {cmd.group_shape}")
                return d if cmd.split_id == 0 else None
            if isinstance(cmd, vo.Repeat):
                in_dim(cmd.input_dim)
            return None

        if strict_view:
            for cmd in rule:
                in_dim(cmd)
        return inner(placements, shape, rule, mesh_sizes, strict_view)

    vo.propagate_shape_and_sharding = held


def run(rank, d, which):
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}", rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    strict_views()
    try:
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_smoke_mesh

        mesh = make_smoke_mesh(MESH, device_type="cpu")
        out, times = {}, {}
        if which == "zoo":
            cases = zoo_cases(Inputs(d), mesh, make_smoke_mesh((WORLD, 1), device_type="cpu"), shd)
        else:
            inp = dict(np.load(os.path.join(d, "inputs.npz")))
            cases = (
                ("moe", lambda: moe_case(inp, mesh, shd)),
                ("gm", lambda: train_case(inp, mesh, shd, "gm", "gemma2-2b", attn_impl="flash", remat="full")),
                ("gd", lambda: train_case(inp, mesh, shd, "gd", "gemma2-2b", attn_impl="flash", remat="dots")),
                ("ds", lambda: train_case(inp, mesh, shd, "ds", "deepseek-7b")),
                ("sv", lambda: serve_case(inp, mesh, shd)),
            )
        for name, case in cases:
            t0 = time.perf_counter()
            out.update(case())
            times[name] = time.perf_counter() - t0
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), **out)
            print("case seconds:", {k: round(v, 1) for k, v in times.items()}, flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "base"), nprocs=WORLD)
