"""AdamW's leaf kernel (``kernels/csrc/adamw.cu``) on the card against its
plain version (``kernels/adamw.py::adamw_leaf_ref``) run on the same card,
bit for bit: the new first and second moments, the update and the
parameters after it, over the dtype pairs the kernel takes, leaf sizes
from 1 to the deepseek-7b head's 102,400 x 4,096, views whose pointers start
off the 16-byte grid, weight decay 0 and 0.1, steps 1-3 and 10,000 (bias
corrections at 1). Also: the wrapper's refusals, a DTensor tree at world
size 1, an optimizer step that makes no host sync, the launch and
element counters of one SMOKE training step, and the dry run's cost
counter, which counts the kernel on the card as on fake tensors.

Every test here needs a CUDA card and ``nvcc`` (the kernel has no CPU mode),
is marked ``cuda`` and skips without them. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw_kernel.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as K
from repro_torch.optim import adamw, apply_updates, tree_leaves
from repro_torch.optim.optimizers import _as

pytestmark = pytest.mark.cuda

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 3e-4
# (p and g, mu)
PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
         (torch.float32, torch.bfloat16)]
SIZES = [1, 7, 4096, 4097, 1_000_003, 102_400 * 4096]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _consts(dt, mdt, wd):
    return dict(b1=_as(B1, mdt), c1=_as(1 - B1, dt), b2=_as(B2, torch.float32), c2=_as(1 - B2, torch.float32),
                eps=EPS, wd=_as(wd, dt), lr=LR)


def _corrections(step, device):
    t = torch.tensor(float(step), device=device)
    f32 = torch.float32
    return 1 - torch.full((), B1, dtype=f32, device=device) ** t, 1 - torch.full((), B2, dtype=f32, device=device) ** t


def _leaf(n, dt, mdt, gen, device, offsets=(0, 0, 0, 0)):
    """g, p, m, v of n elements, each a view ``offsets[k]`` elements into a
    larger tensor; the moments as after some steps."""
    def draw(scale, dtype, off):
        x = torch.randn(n + off, generator=gen, device=device, dtype=torch.float32).mul_(scale).to(dtype)
        return x[off:]

    g, p, m = draw(1e-2, dt, offsets[0]), draw(0.05, dt, offsets[1]), draw(1e-3, mdt, offsets[2])
    v = draw(1e-2, torch.float32, offsets[3]).square_()
    return g, p, m, v


def _check_steps(n, dt, mdt, wd, device, offsets=(0, 0, 0, 0)):
    """Steps 1, 2, 3 and 10,000 of one leaf, the kernel and the plain
    version each on its own copy of the state, compared after every step."""
    gen = torch.Generator(device=device).manual_seed(n % 100_003 + 7)
    g, p, m, v = _leaf(n, dt, mdt, gen, device, offsets)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    kw = _consts(dt, mdt, wd)
    for step in (1, 2, 3, 10_000):
        bc1, bc2 = _corrections(step, device)
        u = K.adamw_leaf(g, m, v, p, bc1, bc2, **kw)
        u2 = K.adamw_leaf_ref(g, m2, v2, p2, bc1, bc2, **kw)
        p.add_(u)
        p2.add_(u2)
        for got, want, name in ((u, u2, "update"), (m, m2, "mu"), (v, v2, "nu"), (p, p2, "p")):
            assert _same(got, want), f"{name} differs at step {step} (n={n}, {dt}, mu {mdt}, wd {wd})"
        g = torch.randn(n, generator=gen, device=device).mul_(1e-2).to(dt)
    torch.cuda.synchronize()


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dt,mdt", PAIRS, ids=lambda d: str(d).split(".")[-1])
def test_adamw_kernel_matches_plain_version_bit_for_bit(cuda, dt, mdt, n, wd):
    before = (K.launches, K.elements)
    _check_steps(n, dt, mdt, wd, cuda)
    assert (K.launches, K.elements) == (before[0] + 4, before[1] + 4 * n)


@pytest.mark.parametrize("offsets", [(1, 1, 1, 1), (3, 0, 0, 0), (0, 0, 0, 1), (8, 8, 8, 8)],
                         ids=["all-by-1", "g-by-3", "v-by-1", "all-by-8"])
@pytest.mark.parametrize("dt,mdt", PAIRS, ids=lambda d: str(d).split(".")[-1])
def test_adamw_kernel_unaligned_views(cuda, dt, mdt, offsets):
    """Views into larger tensors: at an offset that leaves an array off the
    16-byte grid every element takes the scalar path, at 8 elements the
    vector path. Either way bit for bit."""
    _check_steps(1_000_003, dt, mdt, 0.1, cuda, offsets)


def test_adamw_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    g, p, m, v = _leaf(64, torch.bfloat16, torch.bfloat16, gen, cuda)
    bc1, bc2 = _corrections(1, cuda)
    kw = _consts(torch.bfloat16, torch.bfloat16, 0.0)
    with pytest.raises(TypeError):
        K.adamw_leaf(g.half(), m, v, p.half(), bc1, bc2, **kw)
    with pytest.raises(TypeError):
        K.adamw_leaf(g.float(), m, v, p, bc1, bc2, **kw)
    with pytest.raises(TypeError):
        K.adamw_leaf(g, m, v.bfloat16(), p, bc1, bc2, **kw)
    with pytest.raises(ValueError):
        K.adamw_leaf(g.view(8, 8), m.view(8, 8), v.view(8, 8), p.view(8, 8).t(), bc1, bc2, **kw)
    with pytest.raises(ValueError):
        K.adamw_leaf(g[:32], m[:32], v[:32], p[::2], bc1, bc2, **kw)
    with pytest.raises(ValueError):
        K.adamw_leaf(g, m, v, p, bc1.reshape(1), bc2, **kw)
    with pytest.raises(ValueError):
        K.adamw_leaf(g, m, v, p, bc1.cpu(), bc2, **kw)


def _tree(device, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (64, 48), "layers": [{"w": (48, 96), "ln": (48,)}, {"w": (48, 96), "ln": (48,)}], "b": (1,)}

    def make(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.05).to(device=device, dtype=dtype)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(x) for k, x in s.items()}
        if isinstance(s, list):
            return [walk(x) for x in s]
        return make(s)

    return walk(shapes)


def test_adamw_step_makes_no_host_sync(cuda):
    """One ``update`` and ``apply_updates`` of a bfloat16 tree under
    ``set_sync_debug_mode("error")``: nothing in the step waits on the
    host (the bias corrections' bases are device fills, not copies)."""
    opt = adamw(LR, weight_decay=0.1)
    params = _tree(cuda, torch.bfloat16, 0)
    state = opt.init(params)
    grads = _tree(cuda, torch.bfloat16, 1)
    K.adamw_leaf(*(torch.zeros(1, device=cuda) for _ in range(4)), *_corrections(1, cuda),
                 **_consts(torch.float32, torch.float32, 0.0))  # builds and binds the kernel outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(state.step) == 1


def test_adamw_dtensor_tree_at_world_size_1(cuda, tmp_path):
    """A tree of DTensors (one leaf replicated, the others sharded on the
    mesh's one rank) takes the same three steps as the plain tensors: the
    kernel runs on the local shards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
        opt = adamw(LR, weight_decay=0.1)

        def place(tree):  # the layers split on dim 0, the embedding on dim 1, "b" whole
            return {k: [{n: distribute_tensor(x, mesh, [Shard(0)]) for n, x in layer.items()} for layer in v]
                    if k == "layers" else distribute_tensor(v, mesh, [Replicate() if k == "b" else Shard(1)])
                    for k, v in tree.items()}

        params = _tree(cuda, torch.bfloat16, 0)
        placed = place(_tree(cuda, torch.bfloat16, 0))
        state, dstate = opt.init(params), opt.init(placed)
        before = K.launches
        for seed in (1, 2, 3):
            grads = _tree(cuda, torch.bfloat16, seed)
            dgrads = place(grads)
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
            dupdates, dstate = opt.update(dgrads, dstate, placed)
            placed = apply_updates(placed, dupdates)
        n_leaves = len(tree_leaves(params))
        assert K.launches == before + 2 * 3 * n_leaves
        for tree, dtree in ((params, placed), (state.mu, dstate.mu), (state.nu, dstate.nu)):
            for a, b in zip(tree_leaves(tree), tree_leaves(dtree)):
                assert _same(a, b.full_tensor())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek-7b", "olmoe-1b-7b"])
def test_smoke_train_step_goes_through_the_kernel(cuda, arch):
    """One SMOKE training step (float32, AdamW) launches the kernel once a
    leaf and updates every parameter through it; olmoe's expert gradients
    arrive strided and are made contiguous first."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_train_step
    from repro_torch.models import init_params, make_dummy_batch

    cfg = get_config(arch, smoke=True)
    assert cfg.optimizer == "adamw"
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 2, 64, "train", np.random.default_rng(2), device="cuda")
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    before = (K.launches, K.elements)
    params, state, loss = step(params, state, batch)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    assert (K.launches - before[0], K.elements - before[1]) == (len(leaves), sum(p.numel() for p in leaves))
    assert torch.isfinite(loss)


def test_cost_counter_counts_the_kernel_on_the_card_as_on_fake_tensors(cuda):
    """The dry run's counter sees no ctypes launch, so the wrapper counts the
    kernel's bytes itself: one SMOKE deepseek-7b training step (plain
    attention) run on the card under a ``CostCounter`` counts the FLOPs and
    bytes of the same step traced on fake CUDA stand-ins, the kernel once a
    leaf by the bytes it reads and writes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import build_train_step
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.models import init_params, make_dummy_batch

    cfg = get_config("deepseek-7b", smoke=True).replace(attn_impl="plain")
    fake, _, _ = count_step(cfg, InputShape("smoke", 64, 2, "train"), device="cuda")
    params = init_params(cfg, 0, device="cuda")
    batch = make_dummy_batch(cfg, 2, 64, "train", np.random.default_rng(0), device="cuda")
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    with CostCounter() as real:
        step(params, state, batch)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    # reads g, p, mu, nu; writes mu, nu and the update
    moved = sum(3 * p.nbytes + 2 * m.nbytes + 2 * v.nbytes
                for p, m, v in zip(leaves, tree_leaves(state.mu), tree_leaves(state.nu)))
    assert real.by_op["adamw_kernel"] == fake.by_op["adamw_kernel"] == [len(leaves), 0.0, float(moved)]
    assert (real.cost.flops, real.cost.mem_bytes) == (fake.cost.flops, fake.cost.mem_bytes)
