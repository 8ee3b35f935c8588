"""The port's min-plus kernels package against the JAX package, on the CPU.

Every case feeds the same seeded numpy inputs to a JAX function and to its
port counterpart and asserts bit-identical float32 values and identical
int32 argmins:

  * the dense oracle ``minplus_step_ref_batch`` over the shape grid of
    ``tests/test_kernels_minplus.py``;
  * the blocked backend at its default and at odd block sizes;
  * ``minplus_cuda_batch`` on CPU tensors (its plain path) against the TPU
    and Pallas-GPU kernels in interpret mode;
  * the all-BIG argmin-0 convention.

It also checks the Hopper tile choice against its shared-memory budget, the
wrapper's input checks, the dispatch table and the nvcc flags. The kernel
itself runs only on a CUDA card: its tests are in ``test_torch_cuda.py``,
which imports no JAX, so that they also run where only PyTorch is installed.
"""

import jax
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro_torch import kernels as tk
from repro_torch.kernels import (
    BIG,
    auto_block_sizes,
    hopper_tile_sizes,
    minplus_cuda,
    minplus_cuda_batch,
    minplus_step,
    minplus_step_batch,
    minplus_step_ref,
    resolve_backend,
)
from repro_torch.kernels import build
from repro_torch.kernels import minplus as mp

# one compile per shape instead of one per eager op
jax_ref_batch = jax.jit(jk.minplus_step_ref_batch)
jax_blocked_batch = jax.jit(jk.minplus_blocked_batch, static_argnames=("BT", "BW"))


def band_inputs(rng, B, Tp, W, frac_inf=0.3):
    """A DP row + cost stack with BIG sprinkled in both (band edges, padded
    tails and saturation are all exercised)."""
    kprev = rng.uniform(0, 100, (B, Tp)).astype(np.float32)
    kprev[rng.random((B, Tp)) < frac_inf] = float(BIG)
    kprev[:, 0] = 0.0
    cost = rng.uniform(0, 10, (B, W)).astype(np.float32)
    cost[rng.random((B, W)) < 0.2] = float(BIG)
    return kprev, cost


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_bit_identical(got, want):
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.dtype == np.float32 and wv.dtype == np.float32
    assert gi.dtype == np.int32 and wi.dtype == np.int32
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("Tp", [1, 7, 64, 255, 1024, 1500])
@pytest.mark.parametrize("W", [1, 5, 130, 700])
def test_ref_matches_jax_ref(Tp, W):
    rng = np.random.default_rng(Tp * 1000 + W)
    kprev, cost = band_inputs(rng, 3, Tp, W)
    assert_bit_identical(
        tk.minplus_step_ref_batch(T(kprev), T(cost)), jax_ref_batch(kprev, cost)
    )


@pytest.mark.parametrize(
    "B,Tp,W,BT,BW",
    [
        (2, 200, 40, None, None),  # auto_block_sizes
        (3, 150, 60, 7, 5),
        (1, 97, 33, 33, 17),
        (2, 64, 100, 1, 2),
    ],
)
def test_blocked_matches_jax_blocked(B, Tp, W, BT, BW):
    rng = np.random.default_rng(B + Tp + W)
    kprev, cost = band_inputs(rng, B, Tp, W)
    got = tk.minplus_blocked_batch(T(kprev), T(cost), BT=BT, BW=BW)
    assert_bit_identical(got, jax_blocked_batch(kprev, cost, BT=BT, BW=BW))
    assert_bit_identical(got, tk.minplus_step_ref_batch(T(kprev), T(cost)))


def test_auto_block_sizes_match_jax():
    for shape in [(1, 1, 1), (2, 513, 77), (8, 8193, 512), (16, 10001, 1001)]:
        assert auto_block_sizes(*shape) == jk.auto_block_sizes(*shape)


def test_cuda_wrapper_cpu_path_matches_pallas_tpu_interpret():
    rng = np.random.default_rng(255 + 130)
    kprev, cost = band_inputs(rng, 2, 255, 130)
    before = mp.launches
    got = minplus_cuda_batch(T(kprev), T(cost))
    assert mp.launches == before  # the CPU path launches nothing
    assert_bit_identical(got, jk.minplus_pallas_batch(kprev, cost, BT=64, interpret=True))


def test_cuda_wrapper_cpu_path_matches_pallas_gpu_interpret():
    rng = np.random.default_rng(64 + 16)
    kprev, cost = band_inputs(rng, 2, 64, 16)
    got = minplus_cuda_batch(T(kprev), T(cost), BT=32, BW=8)
    assert_bit_identical(
        got, jk.minplus_pallas_gpu_batch(kprev, cost, BT=32, BW=8, interpret=True)
    )


@pytest.mark.parametrize("impl", ["ref", "blocked", "cuda"])
def test_all_big_keeps_argmin_zero(impl):
    B, Tp, W = 2, 37, 11
    kprev = np.full((B, Tp), float(BIG), dtype=np.float32)
    cost = np.full((B, W), float(BIG), dtype=np.float32)
    fn = {
        "ref": lambda k, c: tk.minplus_step_ref_batch(k, c),
        "blocked": lambda k, c: tk.minplus_blocked_batch(k, c, BT=8, BW=3),
        "cuda": lambda k, c: minplus_cuda_batch(k, c, BT=8, BW=3),
    }[impl]
    bv, bi = fn(T(kprev), T(cost))
    assert bool((bv == float(BIG)).all()) and bool((bi == 0).all())
    assert_bit_identical((bv, bi), jax_ref_batch(kprev, cost))


def test_single_row_forms_match_batch():
    rng = np.random.default_rng(3)
    kprev, cost = band_inputs(rng, 1, 90, 20)
    want = jax_ref_batch(kprev, cost)
    for fn in (minplus_step_ref, minplus_cuda, lambda k, c: minplus_step(k, c, backend="auto")):
        v, i = fn(T(kprev[0]), T(cost[0]))
        assert_bit_identical((v[None], i[None]), want)


def test_out_buffers_are_written():
    rng = np.random.default_rng(4)
    kprev, cost = band_inputs(rng, 2, 50, 9)
    out = torch.empty((2, 50), dtype=torch.float32)
    iout = torch.empty((2, 50), dtype=torch.int32)
    for backend in ("ref", "blocked", "cuda"):
        out.fill_(-1.0)
        iout.fill_(-1)
        v, i = minplus_step_batch(T(kprev), T(cost), backend=backend, out=out, iout=iout)
        assert v.data_ptr() == out.data_ptr() and i.data_ptr() == iout.data_ptr()
        assert_bit_identical((out, iout), jax_ref_batch(kprev, cost))


@pytest.mark.parametrize("Tp,W", [(1, 1), (7, 5), (255, 130), (1500, 700), (10001, 1001),
                                  (1_000_001, 5000), (100, 100_000)])
def test_hopper_tile_sizes_respect_smem_budget(Tp, W):
    BT, BW = hopper_tile_sizes(Tp, W)
    assert BT & (BT - 1) == 0 and BW & (BW - 1) == 0  # powers of two
    assert 1 <= BT <= mp.MAX_BT and BW >= 1
    assert BT <= max(1, 1 << (Tp - 1).bit_length())  # never overshoots the padded row
    assert BW <= max(1, 1 << (W - 1).bit_length())
    assert mp.smem_bytes(BT, BW) <= mp.SMEM_BUDGET_BYTES
    # the formula the kernel allocates with: the row window of the block's
    # span (warps of 8 outputs a lane, side by side along t), one pad word
    # after every 8 entries, rounded to a float4, then the costs, with BW
    # rounded up to a multiple of 8; at least one value and index a thread
    span = next(32 * 8 * g for g in (1, 2, 4) if 32 * 8 * g >= BT)
    bw8 = -(-BW // 8) * 8
    nk = span + bw8 - 1
    window = -(-(nk + (nk - 1) // 8) // 4) * 4
    assert mp.smem_bytes(BT, BW) == 4 * max(window + bw8, 2 * mp.MAX_THREADS)
    # a tighter budget still holds
    BT2, BW2 = hopper_tile_sizes(Tp, W, smem_budget=2048)
    assert mp.smem_bytes(BT2, BW2) <= 2048


def test_cuda_wrapper_rejects_bad_input():
    rng = np.random.default_rng(5)
    kprev, cost = band_inputs(rng, 2, 40, 8)
    k, c = T(kprev), T(cost)
    with pytest.raises(TypeError, match="float32"):
        minplus_cuda_batch(k.double(), c)
    with pytest.raises(TypeError, match="float32"):
        minplus_cuda_batch(k, c.double())
    with pytest.raises(ValueError, match="contiguous"):
        minplus_cuda_batch(T(np.ones((40, 2), np.float32)).t(), c)
    with pytest.raises(ValueError, match="contiguous"):
        minplus_cuda_batch(k, T(np.ones((8, 2), np.float32)).t())
    with pytest.raises(ValueError, match="shapes"):
        minplus_cuda_batch(k, c[:1])
    with pytest.raises(ValueError, match="2-D"):
        minplus_cuda_batch(k[0], c[0])
    with pytest.raises(ValueError, match="overlaps"):
        minplus_cuda_batch(k, c, out=k)
    with pytest.raises(ValueError, match="iout"):
        minplus_cuda_batch(k, c, iout=torch.empty((2, 40), dtype=torch.int64))
    with pytest.raises(ValueError, match="BT"):
        minplus_cuda_batch(k, c, BT=mp.MAX_BT + 1)
    with pytest.raises(ValueError, match="shared memory"):
        minplus_cuda_batch(k, c, BT=256, BW=20_000)


def test_dispatch_resolves_by_device():
    assert resolve_backend("auto", "cpu") == "blocked"
    assert resolve_backend(None, torch.device("cpu")) == "blocked"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("auto", "cuda:0") == "cuda"
    assert resolve_backend("ref", "cuda") == "ref"  # explicit names pass through
    with pytest.raises(ValueError, match="no min-plus backend"):
        resolve_backend("auto", "meta")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas_tpu", "cpu")
    # the auto path on a CPU tensor really runs the blocked backend
    rng = np.random.default_rng(0)
    kprev, cost = band_inputs(rng, 2, 200, 40)
    assert_bit_identical(
        minplus_step_batch(T(kprev), T(cost), backend="auto"),
        tk.minplus_blocked_batch(T(kprev), T(cost)),
    )


def test_nvcc_flags_keep_ieee_float32():
    flags = build.NVCC_FLAGS
    assert "--use_fast_math" not in flags and "-use_fast_math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert (build.CSRC / "minplus.cu").is_file()
    # the build directory is keyed by the sources: stable across calls
    assert build.build_dir() == build.build_dir()
    assert build.build_dir().parent.name == "repro_torch_kernels"

