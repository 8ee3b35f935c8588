#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths on one CUDA card and holds
each kernel against its plain PyTorch version.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device     — a CUDA card is present; prints its name and power limit.
2. build      — loads the kernels, which builds every
                ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc each, all
                started together), and prints ptxas's registers and spills
                (the tensor-core kernels' in one line each; it fails if the
                dK/dV one spills at D = 256); counts the tensor-core
                instructions (HGMMA, HMMA) in the SASS of every kernel of
                libflash_fwd.so and libflash_bwd.so (``cuobjdump -sass``) and
                fails if a bfloat16 tensor-core kernel (forward, dQ, dK/dV;
                one per head dimension each) has none.
3. kernel     — ``minplus_cuda_batch`` against ``minplus_step_ref_batch`` on
                the card over a grid of shapes, ties and all-BIG rows:
                bit-identical float32 values and identical int32 argmins;
                then the class scan in one host call
                (``minplus_scan_cuda``) and the backtrack kernel it
                launches after the row kernels against the plain scan and
                backtrack over n x B x Tp x W = {1, 2, 7, 100} x {1, 3, 16,
                17} x {1, 7, 1500, 10001} x {1, 5, 1001}: last row, argmin
                slab and schedules identical; and the busiest block's
                candidates against the mean at the main shape.
4. main       — solves 16 random instances (n = 100 clients, T = 10,000
                tasks, W <= 1,001) through ``solve_schedule_dp_batch``:
                exactly n row launches, one host call into the scan and one
                backtrack launch; the device pack bit-identical to the host
                pack; X, K_last and the argmin slab bit-identical to the
                plain path on the card; feasible, within rtol 1e-5 of the
                float64 host DP; then the paper's worked example.
5. times      — the row kernel (the profiler's device time: one wrapper call
                from Python now takes longer than the kernel, so CUDA events
                around back-to-back calls would time the host) and its plain
                version per class step beside the bound (4 lane instructions
                per candidate over 132 SMs x 128 lanes x clocks.max.sm); the
                scan, its row kernels' device time and the backtrack; the warm solve
                split into host part, device pack, scan and backtrack, timed
                in turns with the previous orchestration (host lower-limit
                removal and packing, a Python loop of ``minplus_cuda_batch``,
                the plain backtrack).
6. flash      — ``flash_attention`` against ``flash_attention_ref`` on the
                card over mask kinds, softcaps, GQA ratios, head dims and
                lengths (ragged ones included), and at the main path's
                causal and sliding shapes: float32 (CUDA cores) at rtol =
                atol = 2e-5; bfloat16 I/O (tensor cores: wgmma, TMA) within
                2e-2 of the plain output and within the limit the kernel's
                roundings give of its float32 value (2^-8 |o32| + 2^-8 P|V|/l
                + 2e-5: o and P each rounded once), lse within 2e-5.
7. prefill    — gemma2-2b at full width and depth (26 layers, bfloat16,
                random weights from ``torch.Generator`` seed 0) prefills
                B = 2 prompts of S = 8,192 tokens through
                ``build_prefill_step``: exactly one kernel launch per layer,
                each on the tensor-core route, finite logits, the last
                position's logits close to the plain attention route's; then
                2 layers in float32 against the plain route at 1e-4.
8. flash times — the kernel at the causal and sliding shapes beside the
                previous kernel (the float32 CUDA-core route on the same
                inputs widened to float32, timed in turns with it; the
                tensor-core kernel must be at least 5x faster at the causal
                shape), the plain version, the bound and
                ``scaled_dot_product_attention`` (causal; sliding with a
                boolean band mask); the warm prefill in ms and tokens/s, and
                the kernel's share.
9. flash bwd  — ``flash_attention_bwd`` (the dQ and dK/dV kernels) against
                ``flash_attention_bwd_ref`` on the card over mask kinds,
                softcaps, GQA ratios, head dims and lengths, and at the
                training shapes (causal and sliding(4096)): float32 at rtol
                3e-4, atol 3e-5; bfloat16 I/O within 2^-8 relative of the
                plain version's float32 gradients plus 1e-5 of their largest
                entry, beside the error one wrongly visited tile would make.
10. train     — gemma2-2b at full width and depth (26 layers, bfloat16,
                remat "full", AdamW, random weights from ``torch.Generator``
                seed 0) takes one cold and three warm steps on one batch of
                B = 1, S = 8,192 tokens through ``build_train_step``: per step
                exactly 52 forward, 26 dQ and 26 dK/dV launches (all on the
                tensor-core route), finite losses
                that fall, the peak device memory; then 2 layers in float32 at
                full width, kernel route against plain route (loss within
                2e-5, gradients within rtol 2e-3, atol 2e-5).
11. train times — warm step and tokens/s, the profiler's device time by
                kernel and the card's busy share; dQ and dK/dV per launch at
                the causal and sliding shapes beside the plain backward,
                their bounds and the backward of
                ``scaled_dot_product_attention``, and each beside the previous
                (float32 CUDA-core) kernel on the widened inputs, in turns
                (at least 5x faster at the causal shape).
12. facade    — the scheduler layers through ``Solver(device="cuda")``:
                (a) phase 4's batch with ``algorithm="dp_batch"`` three
                times: one plan build (an eager warm-up, then one CUDA-graph
                capture) and two replays (``compiles`` 1, ``hits`` 2), X
                identical to phase 4's, K_last's first T'max + 1 columns
                bit-identical, 3 x n_b row launches and 3 backtracks, and by
                the profiler one warm replay = n_b = 128 row kernels and 1
                backtrack kernel; (b) a mixed batch of 16 (4 each of the
                increasing, linear, decreasing and arbitrary regimes, n =
                100, T = 10,000, numpy seed 1) through ``solve``: paper
                Table 2's algorithms, schedules identical to the same call
                with ``device="cpu"``, objectives within rtol 1e-6 of the
                serial float64 algorithm (host DP for the arbitrary ones);
                (c) ``Solver.sweep`` of phase 4's instance 0 over a
                100-point deadline grid in one dispatch: feasible, the
                float32 DP objective never rising as deadlines loosen, the
                first and last points identical to
                ``solve_schedule_dp_batch`` of their tightened instances,
                and the peak device memory; (d) ``Solver.frontier`` over 64
                deadlines of that instance: the points assembled from
                ``solve_schedule_dp_batch`` of the tightened instances, and,
                at a cut size (n = 100, T = 1,000, U <= 100), the CPU's
                points; (e) times beside the card's name and power limit:
                the cold plan build and capture, the warm bucketed DP solve
                in turns with ``solve_schedule_dp_batch`` split into host
                pad, copy and replay, the warm mixed solve by part, and the
                warm 100-point sweep.

The line before the last is a JSON object of every kernel with its launch
count and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import re
import itertools
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# Main-path shape: the production shape of the JAX package's design notes.
B_MAIN, N_MAIN, T_MAIN, U_MAIN = 16, 100, 10_000, 1_000
# Prefill: gemma2-2b FULL, B prompts of S tokens (S > window, so the sliding
# layers cut); the float32 check runs F32_LAYERS layers of it.
ARCH, B_PREFILL, S_PREFILL, F32_LAYERS = "gemma2-2b", 2, 8192, 2
FLASH_GRID_S = (128, 200, 640, 1024)
FLASH_GRID_D = (64, 128, 256)
# A head dim between the built ones (hubert-xlarge's and zamba2-2.7b's D = 80),
# which the wrapper runs on the next built instance on zero-padded inputs:
# (B, GQA group, S, D, kind, window, softcap), H = 8.
HEAD_DIM_CASES = ((2, 2, 640, 80, "causal", 0, 0.0), (1, 4, 1024, 80, "sliding", 37, 50.0))
# Training: gemma2-2b FULL (remat "full", AdamW), one batch of B_TRAIN prompts
# of S_TRAIN tokens (S > window, so the sliding layers cut), one cold and
# TRAIN_STEPS - 1 warm steps; the float32 check runs F32_LAYERS layers of it.
B_TRAIN, S_TRAIN, TRAIN_STEPS = 1, 8192, 4
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# bfloat16 on the tensor cores (dense), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# The last position's logits of the kernel route against the plain route,
# bfloat16 over 26 layers: relative L2 distance. The routes round the
# attention probabilities differently (plain: to bfloat16 before the value
# product; kernel: float32 until the output), about 2^-8 relative per
# sublayer; a random walk over 52 sublayers gives ~0.03. A masking or routing
# fault moves the logits by O(1).
PREFILL_REL_L2 = 0.1
# The flash kernel against its plain version. float32: the reference's
# forward tolerance. bfloat16 I/O (the tensor-core route): the kernel forms
# the scores, the softmax and every sum in float32 from the same (exactly
# widened) inputs as the plain version, rounds P to bfloat16 once for P.V and
# o once on output. So, with o32 the plain version's float32 o and P, l its
# float32 probabilities and row sums,
#   |o - o32| <= BF16_O_RTOL |o32| + BF16_P_RTOL (P @ |V|) / l + F32_TOL:
# the first term is o rounded once (half a bfloat16 ulp, 2^-8 relative); the
# second is P rounded to bfloat16 (at most 2^-9 relative per entry, with a
# factor 2 of room), computed as the plain version's o on |v|; F32_TOL is
# float32 summation-order noise. lse is float32 in both and held to F32_TOL:
# a K/V tile skipped or visited wrongly moves it by ~1e-2 at the main shape.
# BF16_GRID_TOL is the looser limit that the grid's cases are also held to
# against the plain version's bfloat16 output.
F32_TOL = 2e-5
BF16_O_RTOL = 2.0 ** -8
BF16_P_RTOL = 2.0 ** -8
BF16_GRID_TOL = 2e-2
# The min-plus row update: lane instructions per candidate (an add, a
# compare, a select of the value and one of the index), issued by 4
# schedulers x 32 lanes per SM each clock.
OPS_PER_CANDIDATE = 4
LANES_PER_SM = 128
# The class scan and backtrack grid of phase 3.
SCAN_GRID = tuple(itertools.product((1, 2, 7, 100), (1, 3, 16, 17), (1, 7, 1500, 10001), (1, 5, 1001)))
# The flash backward kernels against their plain version. float32: the
# reference's gradient tolerance. bfloat16 I/O: both compute in float32 from
# the same widened inputs and the kernels round once, so their gradients lie
# within half a bfloat16 ulp (2^-8 relative) of the plain version's float32
# gradients, plus float32 summation-order noise over up to S terms, held to
# BWD_BF16_ATOL_REL times the gradient's largest entry.
GRAD_RTOL, GRAD_ATOL = 3e-4, 3e-5
BWD_BF16_RTOL, BWD_BF16_ATOL_REL = 2.0 ** -8, 1e-5
# A tile visited wrongly must move some gradient entry by at least this many
# times the largest deviation the check allows on that tile's rows.
TILE_MARGIN_MIN = 2.0
# The bfloat16 tensor-core kernels (forward, dQ, dK/dV) against the previous,
# float32 CUDA-core kernels on the same inputs widened to float32, in one run
# at the causal main shape: at least this many times faster.
TC_SPEEDUP_MIN = 5.0
# The dense model's loss and gradients, kernel route against plain route: the
# reference's test_dense_model_with_pallas_attention_matches_xla.
LOSS_ATOL, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL = 2e-5, 2e-3, 2e-5
# Phase 12: the mixed batch's regimes (4 instances each) and the algorithm
# paper Table 2 gives each (upper limits bind: U <= 1,000 < T'); the deadline
# grids of the sweep and the frontier; the frontier's CPU comparison at a cut
# size (n clients, T tasks, U <= max_upper), where the CPU's DP takes
# seconds, not the tens of minutes of the full instance; the selection's
# float32 objectives against the serial float64 algorithms.
MIXED_TABLE2 = {"increasing": "marin", "linear": "marco", "decreasing": "mardec", "arbitrary": "dp"}
SWEEP_POINTS, FRONTIER_POINTS = 100, 64
FRONTIER_CPU_N, FRONTIER_CPU_T, FRONTIER_CPU_U = 100, 1_000, 100
FACADE_RTOL = 1e-6


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg):
    print(msg, flush=True)


def gpu_line(fields="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_ops(build, name):
    """``{kernel function: ({opcode: count}, {opcode: predicated count})}``
    from the SASS of every kernel of ``lib<name>.so`` (``cuobjdump -sass``)."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build_dir() / f"lib{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            out[fn] = ({}, {})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line) if fn else None
        if m:
            for counts, hit in zip(out[fn], (True, bool(m.group(1)))):
                if hit:
                    counts[m.group(2)] = counts.get(m.group(2), 0) + 1
    return out


def tensor_core_counts(build, name):
    """``{kernel function: (HGMMA, HMMA)}``: the tensor-core instructions in
    the SASS of every kernel of ``lib<name>.so``."""
    return {fn: (ops.get("HGMMA", 0), ops.get("HMMA", 0)) for fn, (ops, _) in sass_ops(build, name).items()}


def ptxas_usage(log_text):
    """``{kernel function: (registers, spill stores, spill loads)}`` from an
    nvcc build log written with ``-Xptxas -v``."""
    usage, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = [0, 0, 0]
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage[fn][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def tc_kernels(per_fn):
    """``{(tensor-core kernel, head dim): value}`` from ``{mangled kernel
    function: value}``: the ``flash_*_tc_kernel<D>`` instances only."""
    out = {}
    for fn, val in per_fn.items():
        m = re.search(r"(flash_[a-z]+_tc_kernel)ILi(\d+)E", fn)
        if m:
            out[(m.group(1), int(m.group(2)))] = val
    return out


def band_inputs(rng, B, Tp, W, dev, ties=False):
    """A DP row + cost stack with BIG sprinkled in both; with ``ties`` the
    values are small integers, so many candidates tie."""
    from repro_torch.kernels.ref import BIG

    if ties:
        kprev = rng.integers(0, 8, (B, Tp)).astype(np.float32)
        cost = rng.integers(0, 4, (B, W)).astype(np.float32)
    else:
        kprev = rng.uniform(0, 100, (B, Tp)).astype(np.float32)
        cost = rng.uniform(0, 10, (B, W)).astype(np.float32)
    kprev[rng.random((B, Tp)) < 0.3] = BIG
    kprev[:, 0] = 0.0
    cost[rng.random((B, W)) < 0.2] = BIG
    return torch.from_numpy(kprev).to(dev), torch.from_numpy(cost).to(dev)


def bit_identical(got, want) -> bool:
    (gv, gi), (wv, wi) = got, want
    return bool(torch.equal(gv.view(torch.int32), wv.view(torch.int32)) and torch.equal(gi, wi))


def candidates(B, Tp, W) -> int:
    """Valid (t, j) pairs of one row update: j < W and j <= t."""
    t = np.arange(Tp, dtype=np.int64)
    return int(B * np.minimum(t + 1, W).sum())


def bound_ms(B, Tp, W, sms, max_mhz):
    """Least time for one row update: the larger of its bytes (inputs read
    once, outputs written once) over HBM bandwidth and its lane instructions
    (OPS_PER_CANDIDATE per candidate) over ``sms`` x LANES_PER_SM lanes at
    ``max_mhz`` (the card's clocks.max.sm). Returns (ms, 'bytes'|'operations')."""
    nbytes = 4 * B * Tp + 4 * B * W + (4 + 4) * B * Tp
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = OPS_PER_CANDIDATE * candidates(B, Tp, W) / (sms * LANES_PER_SM * max_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def backtrack_bound_ms(n, B):
    """Least time for the backtrack by the contract's count: the n entries a
    walk reads of the slab for each instance, t_star, and the (B, n) int32
    schedules written, over HBM bandwidth. (The kernel is bound by the
    latency of n dependent reads instead.) Returns (ms, 'bytes')."""
    return 1e3 * (4 * n * B + 8 * B + 4 * n * B) / PEAK_BYTES_PER_S, "bytes"


def block_balance(B, Tp, W, BT):
    """(busiest block's candidates / mean, blocks) of one row launch with
    tiles of BT outputs: a block's valid candidates are sum min(t + 1, W)
    over its tile."""
    per_t = np.minimum(np.arange(Tp, dtype=np.int64) + 1, W)
    tiles = np.add.reduceat(per_t, np.arange(0, Tp, BT))
    return float(tiles.max() / tiles.mean()), B * len(tiles)


def median_event_ms(fn, reps, per_rep=1, warmup=3):
    """Median over ``reps`` of the device time of ``per_rep`` back-to-back
    runs of ``fn`` between two CUDA events, divided by ``per_rep``. With
    several runs per pair the queue stays full, so host enqueue time does
    not show up as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def median_wall_ms(fn, reps):
    """Median host-clock time of ``fn`` followed by a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def paper_problem(T, Problem):
    # paper §3.1: R = {1,2,3}; U = {6,6,5}; L = {1,0,0}
    c1 = np.array([0.0, 2, 3.5, 5.5, 8, 10, 12])
    c2 = np.array([0.0, 1.5, 2.5, 4, 7, 9, 11])
    c3 = np.array([0.0, 3, 4, 5, 6, 7])
    return Problem(T=T, lower=[1, 0, 0], upper=[6, 6, 5], cost_tables=(c1, c2, c3))


def attn_pairs(B, H, S, kind, window) -> int:
    """Unmasked (q, k) pairs of one attention layer at Sq = Sk = S."""
    q = np.arange(S, dtype=np.int64)
    if kind == "causal":
        per_row = q + 1
    elif kind == "sliding":
        per_row = np.minimum(q + 1, window)
    else:
        per_row = np.full(S, S, dtype=np.int64)
    return int(B * H * per_row.sum())


def flash_bound_ms(B, H, Hkv, S, D, kind, window, itemsize):
    """Least time for one flash-attention forward: the larger of its bytes
    (q, k, v read once, o and lse written once) over HBM bandwidth and its
    4·D flops per unmasked pair over the peak of the input type (bfloat16 on
    the tensor cores, float32 outside them). Returns (ms, 'bytes'|'operations')."""
    flops = 4 * D * attn_pairs(B, H, S, kind, window)
    t_ops = flops / (PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS)
    nbytes = itemsize * (2 * B * H * S * D + 2 * B * Hkv * S * D) + 4 * B * H * S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_inputs(gen, B, H, Hkv, S, D, dtype, dev):
    """q (B, H, S, D), k and v (B, Hkv, S, D), entries N(0, 0.25) as in the
    reference's flash tests, in ``dtype`` on ``dev``."""
    return tuple((torch.randn((B, h, S, D), generator=gen, device=dev) * 0.5).to(dtype) for h in (H, Hkv, Hkv))


def flash_err(fa, got, q, k, v, kind, window, softcap):
    """Holds the kernel's ``(o, lse)`` against the plain version on the same
    inputs. Returns (ok, max |o - o_plain|, max |o - o_plain32|, max |lse -
    lse_plain|), where o_plain is the plain version's output in q's dtype and
    o_plain32 the float32 value it rounds from.

    float32: o and lse within rtol = atol = F32_TOL. bfloat16 I/O: o within
    BF16_GRID_TOL of o_plain, and, sized to what is compared, o within the
    limit derived from the kernel's roundings (BF16_O_RTOL, BF16_P_RTOL,
    F32_TOL) of o_plain32, and lse within F32_TOL.
    """
    o, lse = got
    # the plain version widens its inputs to float32 first, so on the widened
    # inputs it gives o_plain32 and the same lse
    o32, lse32 = fa.flash_attention_ref(q.float(), k.float(), v.float(), kind, window, softcap)
    o, o_plain = o.float(), o32.to(q.dtype).float()
    close_lse = bool(torch.allclose(lse, lse32, rtol=F32_TOL, atol=F32_TOL))
    if q.dtype == torch.float32:
        ok = close_lse and bool(torch.allclose(o, o32, rtol=F32_TOL, atol=F32_TOL))
    else:
        pv_abs = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(), kind, window, softcap)[0]
        limit = pv_abs.mul_(BF16_P_RTOL).add_(o32.abs(), alpha=BF16_O_RTOL).add_(F32_TOL)
        ok = (close_lse and bool(torch.allclose(o, o_plain, rtol=BF16_GRID_TOL, atol=BF16_GRID_TOL))
              and bool(((o - o32).abs() <= limit).all()))
        del pv_abs, limit
    return ok, float((o - o_plain).abs().max()), float((o - o32).abs().max()), float((lse - lse32).abs().max())


def padded_head_dims(fa) -> str:
    """What the HEAD_DIM_CASES run on, for the log."""
    return ", ".join(sorted({f"D = {c[3]} on the D = {fa.kernel_head_dim(c[3])} kernels, zero-padded"
                             for c in HEAD_DIM_CASES}))


def flash_phase(fa, dev):
    """Phase 6: the flash kernel against its plain version on the card.
    Returns the main path's causal and sliding inputs and the largest
    |o - o_ref| at those shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for di, D in enumerate(FLASH_GRID_D):
        for kind, window in (("causal", 0), ("sliding", 37), ("bidirectional", 0)):
            for softcap in (0.0, 50.0):
                for si, S in enumerate(FLASH_GRID_S):
                    G = (1, 2, 4, 8)[(si + di) % 4]  # 8 = MQA at H = 8
                    for dtype in (torch.float32, torch.bfloat16):
                        cases.append((2 if S <= 640 else 1, 8, 8 // G, S, D, kind, window, softcap, dtype))
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(1, 2, 1, 8192, 256, "causal", 0, 50.0, dtype), (1, 2, 1, 8192, 256, "sliding", 4096, 50.0, dtype),
                  (1, 2, 2, 8192, 128, "bidirectional", 0, 0.0, dtype)]
        cases += [(B, 8, 8 // G, S, D, kind, window, softcap, dtype) for B, G, S, D, kind, window, softcap in HEAD_DIM_CASES]
    worst = {torch.float32: [0.0] * 3, torch.bfloat16: [0.0] * 3}
    for B, H, Hkv, S, D, kind, window, softcap, dtype in cases:
        q, k, v = flash_inputs(gen, B, H, Hkv, S, D, dtype, dev)
        got = fa.flash_attention(q, k, v, kind, window, softcap)
        torch.cuda.synchronize()
        ok, *errs = flash_err(fa, got, q, k, v, kind, window, softcap)
        check(ok, f"flash kernel != plain at B={B} H={H} Hkv={Hkv} S={S} D={D} {kind} w={window} "
                  f"softcap={softcap} {dtype} (max |do|, |do32|, |dlse| {errs})")
        worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]
    f32, b16 = worst[torch.float32], worst[torch.bfloat16]
    log(f"[flash] {len(cases)} cases ({padded_head_dims(fa)} among them) within tolerance of the plain version: "
        f"float32 rtol=atol={F32_TOL} on o and "
        f"lse (largest |do| {f32[1]:.3e}, |dlse| {f32[2]:.3e}); bfloat16 I/O o within {BF16_GRID_TOL} of the plain "
        f"output (largest {b16[0]:.3e}) and within {BF16_O_RTOL:.3e} |o32| + {BF16_P_RTOL:.3e} (P|V|)/l + {F32_TOL} "
        f"of its float32 value o32 (largest |o - o32| {b16[1]:.3e}), lse within {F32_TOL} (largest {b16[2]:.3e})")

    cfg_shape = (B_PREFILL, 8, 4, S_PREFILL, 256)
    main = {}
    worst = [0.0] * 3
    for kind, window in (("causal", 0), ("sliding", 4096)):
        q, k, v = flash_inputs(gen, *cfg_shape, torch.bfloat16, dev)
        got = fa.flash_attention(q, k, v, kind, window, 50.0)
        torch.cuda.synchronize()
        ok, *errs = flash_err(fa, got, q, k, v, kind, window, 50.0)
        check(ok, f"flash kernel != plain at the main path's {kind} shape (max |do|, |do32|, |dlse| {errs})")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        main[kind] = (q, k, v, window)
        torch.cuda.empty_cache()
    log(f"[flash] main-path shapes B={cfg_shape[0]} H=8 Hkv=4 S={S_PREFILL} D=256 bfloat16 softcap 50, causal "
        f"and sliding(4096): o within {BF16_O_RTOL:.3e} |o32| + {BF16_P_RTOL:.3e} (P|V|)/l + {F32_TOL} of the plain "
        f"version's float32 value (largest |do32| {worst[1]:.3e}), lse within rtol=atol={F32_TOL} (largest |dlse| "
        f"{worst[2]:.3e}); "
        f"max_abs_err against its bfloat16 output {worst[0]:.3e}")
    return main, worst[0]


def prefill_phase(fa, mp, dev):
    """Phase 7: gemma2-2b FULL prefill through the kernel route, checked
    against the plain route. Returns (cfg, params, batch, step, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_prefill_step
    from repro_torch.models import init_params, make_dummy_batch, param_count, prefill_fn

    cfg = get_config(ARCH).replace(attn_impl="flash")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = make_dummy_batch(cfg, B_PREFILL, S_PREFILL, "prefill", np.random.default_rng(SEED), device=dev)
    step = build_prefill_step(cfg)
    log(f"[prefill] {cfg.arch}: {cfg.num_layers} layers, d={cfg.d_model}, H={cfg.num_heads}, Hkv={cfg.num_kv_heads}, "
        f"hd={cfg.hd}, V={cfg.vocab_size}, {cfg.param_dtype}; {param_count(params)} parameters initialised on the "
        f"card in {init_s:.2f} s; tokens {tuple(batch['tokens'].shape)}")

    torch.cuda.reset_peak_memory_stats()
    mp.launches = fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_tc = fa.launches_dq_tc = fa.launches_dkv_tc = 0
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = fa.launches
    check(launches == cfg.num_layers, f"{launches} flash launches in one prefill, expected {cfg.num_layers}")
    check(fa.launches_fwd_tc == cfg.num_layers, f"{fa.launches_fwd_tc} tensor-core forward launches in one prefill")
    check(mp.launches == 0, f"the prefill launched the min-plus kernel {mp.launches} times")
    check(fa.launches_dq == fa.launches_dkv == 0, "the prefill launched a backward kernel")
    check(tuple(logits.shape) == (B_PREFILL, S_PREFILL, cfg.vocab_size) and logits.dtype == torch.float32,
          f"logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    last = logits[:, -1].clone()
    del logits
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[prefill] kernel route: {launches} flash launches (one per layer, {fa.launches_fwd_tc} on the tensor "
        f"cores), first call {cold_s:.3f} s, logits finite, peak device memory {peak_gb:.2f} GB")

    plain = prefill_fn(params, cfg.replace(attn_impl="plain"), batch)
    last_p = plain[:, -1].clone()
    del plain
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(last_p).all()), "non-finite logits on the plain route")
    rel = float((last - last_p).norm() / last_p.norm())
    max_abs = float((last - last_p).abs().max())
    log(f"[prefill] last position vs the plain route (block_q={cfg.attn_block_q}): relative L2 {rel:.3e} (limit "
        f"{PREFILL_REL_L2}), max |dlogit| {max_abs:.3e} (logit std {float(last_p.std()):.3f}); greedy next token "
        f"kernel {last.argmax(-1).tolist()} plain {last_p.argmax(-1).tolist()}")
    check(rel <= PREFILL_REL_L2, f"kernel route's logits differ from the plain route's: relative L2 {rel}")

    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    b32 = {"tokens": batch["tokens"][:1]}
    rows = [0, cfg.window - 1, cfg.window, S_PREFILL - 1]  # both sides of the sliding cut
    n0, n0_tc = fa.launches, fa.launches_fwd_tc
    l32 = prefill_fn(p32, cfg32, b32)[:, rows].clone()
    check(fa.launches == n0 + F32_LAYERS, "float32 prefill did not launch the kernel once per layer")
    check(fa.launches_fwd_tc == n0_tc, "float32 prefill launched the tensor-core kernel")
    l32p = prefill_fn(p32, cfg32.replace(attn_impl="plain"), b32)[:, rows].clone()
    err32 = float((l32 - l32p).abs().max())
    check(bool(torch.allclose(l32, l32p, rtol=1e-4, atol=1e-4)), f"float32 prefill: max |dlogit| {err32}")
    del p32, l32, l32p
    torch.cuda.empty_cache()
    log(f"[prefill] float32, {F32_LAYERS} layers at full width, B=1 S={S_PREFILL}: positions {rows} within "
        f"rtol=atol=1e-4 of the plain route (max |dlogit| {err32:.3e})")
    return cfg, params, batch, step, launches


def device_time_table(step, params, batch, top=8):
    """Device time by kernel over one call of ``step``, from torch.profiler:
    the events that ran on the card (not the CPU-side operators, which carry
    their kernels' time too, and not CUPTI's "Command Buffer Full" marker
    for a full launch queue). Returns (total ms, the top [(ms, count,
    name)], {kind: ms}) with kinds: the port's flash kernels, cuBLAS's
    products (``nvjet``) and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Command Buffer"):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0) if t is None else t
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    kinds = {"flash kernels": 0.0, "cuBLAS (nvjet)": 0.0, "the rest": 0.0}
    for t, _, name in rows:
        kinds["flash kernels" if "flash_" in name else "cuBLAS (nvjet)" if "nvjet" in name else "the rest"] += t
    return sum(r[0] for r in rows), rows[:top], kinds


LIBRARY_MASK = {"causal": "", "sliding": ", boolean band mask"}


def library_attention(fa, F, q, k, v, kind, window):
    """``scaled_dot_product_attention`` on the same inputs, the yardstick of
    the flash kernels (no softcap: it has none): ``is_causal`` for a causal
    mask, a boolean ``(S, S)`` band for a sliding one."""
    if kind == "causal":
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    mask = fa.flash_mask(q.shape[2], k.shape[2], kind, window, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def in_turns(new, prev, rounds=2):
    """The tensor-core kernel ``new`` and the previous kernel ``prev`` timed
    in turns (new, prev, new, prev, ...), each with ``median_event_ms``.
    Returns the medians of the rounds, (new ms, prev ms)."""
    t_new, t_prev = [], []
    for _ in range(rounds):
        t_new.append(median_event_ms(new, reps=5, per_rep=3))
        t_prev.append(median_event_ms(prev, reps=2, per_rep=1, warmup=1))
    return statistics.median(t_new), statistics.median(t_prev)


TC_ROUTE = "bfloat16 tensor cores (wgmma, TMA-fed K/V ring)"
TC_ROUTE_BWD = {"dq": TC_ROUTE, "dkv": "bfloat16 tensor cores (wgmma, resident K/V, TMA-fed Q/dO ring, dV and dK in "
                                       "two warpgroups, P and dS as hi + lo bfloat16)"}
PREV_ROUTE = "float32 CUDA cores, the same inputs widened to float32"


def flash_times(fa, main, cfg, params, batch, step, card):
    """Phase 8: kernel, previous kernel, plain version, bound and library
    call at the main path's shapes; the warm prefill. Returns the flash
    kernel's JSON fields."""
    import torch.nn.functional as F

    from repro_torch.models.dense import attn_pattern

    res = {}
    for kind, (q, k, v, window) in main.items():
        B, H, S, D = q.shape
        q32, k32, v32 = q.float(), k.float(), v.float()
        ms, prev_ms = in_turns(lambda: fa.flash_attention(q, k, v, kind, window, 50.0),
                               lambda: fa.flash_attention(q32, k32, v32, kind, window, 50.0))
        del q32, k32, v32
        clocks = gpu_line("clocks.sm,power.draw")
        plain_ms = median_event_ms(lambda: fa.flash_attention_ref(q, k, v, kind, window, 50.0), reps=3, warmup=1)
        torch.cuda.empty_cache()
        b_ms, b_by = flash_bound_ms(B, H, k.shape[1], S, D, kind, window, q.element_size())
        lib_ms = median_event_ms(lambda: library_attention(fa, F, q, k, v, kind, window), reps=5, per_rep=3)
        torch.cuda.empty_cache()
        res[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, prev_ms=prev_ms)
        lib = f"{lib_ms:.4f} ms (scaled_dot_product_attention, same shape, no softcap{LIBRARY_MASK[kind]})"
        log(f"[times] flash_attention {kind}{f'({window})' if kind == 'sliding' else ''} B={B} H={H} "
            f"Hkv={k.shape[1]} S={S} D={D} bfloat16 softcap 50, route {TC_ROUTE}: {ms:.4f} ms per launch (median "
            f"of 2 rounds of 5 runs of 3 launches; clocks.sm, power.draw after: {clocks}); previous kernel "
            f"({PREV_ROUTE}, in turns) {prev_ms:.4f} ms, {prev_ms / ms:.2f}x slower; plain version {plain_ms:.4f} "
            f"ms; bound {b_ms:.4f} ms ({b_by}, {attn_pairs(B, H, S, kind, window)} unmasked pairs), kernel at "
            f"{ms / b_ms:.2f}x the bound ({b_ms / ms:.3f} of the bf16 peak); library {lib}")
    check(res["causal"]["prev_ms"] >= TC_SPEEDUP_MIN * res["causal"]["ms"],
          f"the tensor-core forward is not {TC_SPEEDUP_MIN}x faster than the previous kernel at the causal shape")

    pattern = attn_pattern(cfg)
    per_kind = {kd: sum(pattern[i % len(pattern)] == kd for i in range(cfg.num_layers)) for kd in res}
    n0 = fa.launches
    prefill_ms = median_wall_ms(lambda: step(params, batch), reps=3)
    check(fa.launches - n0 == 3 * cfg.num_layers, f"{fa.launches - n0} flash launches in 3 prefills")
    kernel_ms = sum(per_kind[kd] * res[kd]["ms"] for kd in res)
    tokens = B_PREFILL * S_PREFILL
    log(f"[times] {card}")
    log(f"[times] warm prefill {ARCH} B={B_PREFILL} S={S_PREFILL}: {prefill_ms:.3f} ms (host clock, median of 3) = "
        f"{tokens / prefill_ms * 1e3:.1f} tokens/s; flash kernel {per_kind} x ms per launch = {kernel_ms:.3f} ms = "
        f"{kernel_ms / prefill_ms:.3f} of the prefill")
    total, rows, kinds = device_time_table(step, params, batch)
    if total == 0:
        log("[times] torch.profiler recorded no device time")
    else:
        log(f"[times] torch.profiler, one prefill: {total:.3f} ms of kernel time on the card ({total / prefill_ms:.3f} "
            f"of the warm prefill); by kind {', '.join(f'{k} {t:.3f} ms' for k, t in kinds.items())}; top kernels "
            f"by device time:")
        for t, n, name in rows:
            log(f"[times]   {t:10.3f} ms  {t / total:.3f}  x{n:<5d} {name[:90]}")
    return res["causal"]


def bwd_inputs(fa, gen, B, H, Hkv, S, D, dtype, dev, kind, window, softcap):
    """``flash_inputs`` plus the forward kernel's ``o`` and ``lse`` and a
    cotangent ``do`` with entries N(0, 1)."""
    q, k, v = flash_inputs(gen, B, H, Hkv, S, D, dtype, dev)
    o, lse = fa.flash_attention(q, k, v, kind, window, softcap)
    return q, k, v, o, lse, torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)


def bwd_limits(want, dtype):
    """``(rtol, atol)`` of a backward kernel's gradient against the plain
    version's float32 gradient ``want``."""
    if dtype == torch.float32:
        return GRAD_RTOL, GRAD_ATOL
    return BWD_BF16_RTOL, BWD_BF16_ATOL_REL * float(want.abs().max())


def bwd_err(fa, got, args, kind, window, softcap):
    """Holds the kernels' ``(dq, dk, dv)`` against the plain backward on the
    widened inputs. Returns (ok, [max |g - want|], want)."""
    q, k, v, o, lse, do = args
    want = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse, do.float(), kind, window,
                                      softcap)
    ok, errs = True, []
    for g, w in zip(got, want):
        rtol, atol = bwd_limits(w, q.dtype)
        d = (g.float() - w).abs()
        ok = ok and g.dtype == q.dtype and g.shape == w.shape and bool((d <= atol + rtol * w.abs()).all())
        errs.append(float(d.max()))
    return ok, errs, want


def tile_margins(fa, args, want, kind, window, softcap):
    """What one tile visited wrongly would do at this shape, beside the limit.

    For every q tile, the contribution to dq of its diagonal K/V tile (the
    last one the dQ kernel visits); for every K/V tile, the contributions to
    dk and dv of its diagonal q tile (the first one the dK/dV kernel
    visits). Skipping, repeating or mis-masking such a tile moves the
    gradient by that contribution. Returns, for dq, dk and dv, the smallest
    over the tiles of (its contribution's largest entry, that entry over the
    largest deviation the check allows on the tile's rows)."""
    q, k, v, o, lse, do = args
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G, scale = H // Hkv, D ** -0.5
    # the tiles of the kernels that ran: the tensor-core tiles for bfloat16,
    # the CUDA-core tile otherwise
    tc = q.dtype == torch.bfloat16
    dq_tile = (fa.DQ_TC_BLOCK_Q, fa.DQ_TC_BLOCK_K) if tc else (fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K)
    dkv_tile = (fa.DKV_TC_BLOCK_Q, fa.DKV_TC_BLOCK_K) if tc else (fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K)
    qf = (q.float() * scale).reshape(B, Hkv, G, S, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dof = do.float().reshape(B, Hkv, G, S, D)
    delta = (dof * o.float().reshape(B, Hkv, G, S, D)).sum(-1, keepdim=True)
    lse5 = lse.reshape(B, Hkv, G, S, 1)
    mask = fa.flash_mask(S, S, kind, window, q.device)
    limits = [bwd_limits(w, q.dtype) for w in want]
    dq_w = want[0].reshape(B, Hkv, G, S, D)

    def tile(r0, c0, BQ, BK):  # p and dS on rows [r0, r0 + BQ) x keys [c0, c0 + BK)
        r1, c1 = min(r0 + BQ, S), min(c0 + BK, S)
        s = qf[..., r0:r1, :] @ kf[..., c0:c1, :].transpose(-1, -2)
        t = torch.tanh(s / softcap) if softcap else None
        m = mask[r0:r1, c0:c1]
        p = torch.exp(torch.where(m, softcap * t if softcap else s, fa.NEG_INF) - lse5[..., r0:r1, :])
        ds = p * (dof[..., r0:r1, :] @ vf[..., c0:c1, :].transpose(-1, -2) - delta[..., r0:r1, :])
        if softcap:
            ds = ds * (1 - t * t)
        return r1, c1, p, torch.where(m, ds, 0.0)

    def margin(contrib, w, i):
        rtol, atol = limits[i]
        c = float(contrib.abs().max())
        return c, c / (atol + rtol * float(w.abs().max()))

    out = {"dq": [], "dk": [], "dv": []}
    BQ, BK = dq_tile
    for r0 in range(0, S, BQ):
        c0 = (min(r0 + BQ, S) - 1) // BK * BK
        r1, c1, _, ds = tile(r0, c0, BQ, BK)
        out["dq"].append(margin(ds @ kf[..., c0:c1, :] * scale, dq_w[..., r0:r1, :], 0))
    BQ, BK = dkv_tile
    for c0 in range(0, S, BK):
        r0 = c0 // BQ * BQ
        r1, c1, p, ds = tile(r0, c0, BQ, BK)
        out["dk"].append(margin((ds.transpose(-1, -2) @ qf[..., r0:r1, :]).sum(2), want[1][:, :, c0:c1], 1))
        out["dv"].append(margin((p.transpose(-1, -2) @ dof[..., r0:r1, :]).sum(2), want[2][:, :, c0:c1], 2))
    return {name: (min(c for c, _ in vals), min(m for _, m in vals)) for name, vals in out.items()}


def flash_bwd_phase(fa, dev):
    """Phase 9: the dQ and dK/dV kernels against the plain backward on the
    card. Returns the training shape's causal and sliding inputs and the
    largest |dq - dq_plain| and |dk, dv - plain| there."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    for di, D in enumerate(FLASH_GRID_D):
        for kind, window in (("causal", 0), ("sliding", 37), ("bidirectional", 0)):
            for softcap in (0.0, 50.0):
                for si, S in enumerate(FLASH_GRID_S):
                    G = (1, 2, 4)[(si + di) % 3]
                    for dtype in (torch.float32, torch.bfloat16):
                        cases.append((2 if S <= 640 else 1, 8, 8 // G, S, D, kind, window, softcap, dtype))
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(B, 8, 8 // G, S, D, kind, window, softcap, dtype) for B, G, S, D, kind, window, softcap in HEAD_DIM_CASES]
    worst = {torch.float32: [0.0] * 3, torch.bfloat16: [0.0] * 3}
    for B, H, Hkv, S, D, kind, window, softcap, dtype in cases:
        args = bwd_inputs(fa, gen, B, H, Hkv, S, D, dtype, dev, kind, window, softcap)
        got = fa.flash_attention_bwd(*args, kind, window, softcap)
        torch.cuda.synchronize()
        ok, errs, _ = bwd_err(fa, got, args, kind, window, softcap)
        check(ok, f"flash backward != plain at B={B} H={H} Hkv={Hkv} S={S} D={D} {kind} w={window} "
                  f"softcap={softcap} {dtype} (max |d dq|, |d dk|, |d dv| {errs})")
        worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]
    f32, b16 = worst[torch.float32], worst[torch.bfloat16]
    log(f"[flash bwd] {len(cases)} cases ({padded_head_dims(fa)} among them) within tolerance of the plain "
        f"backward: float32 rtol={GRAD_RTOL} "
        f"atol={GRAD_ATOL} (largest |d dq|, |d dk|, |d dv| {f32[0]:.3e}, {f32[1]:.3e}, {f32[2]:.3e}); bfloat16 I/O "
        f"within rtol={BWD_BF16_RTOL:.3e} of the float32 gradients + {BWD_BF16_ATOL_REL} of their largest entry "
        f"(largest {b16[0]:.3e}, {b16[1]:.3e}, {b16[2]:.3e})")

    shape = (B_TRAIN, 8, 4, S_TRAIN, 256)
    main, worst = {}, [0.0] * 3
    for kind, window in (("causal", 0), ("sliding", 4096)):
        args = bwd_inputs(fa, gen, *shape, torch.bfloat16, dev, kind, window, 50.0)
        got = fa.flash_attention_bwd(*args, kind, window, 50.0)
        torch.cuda.synchronize()
        ok, errs, want = bwd_err(fa, got, args, kind, window, 50.0)
        del got
        check(ok, f"flash backward != plain at the training {kind} shape (max |d dq|, |d dk|, |d dv| {errs})")
        margins = tile_margins(fa, args, want, kind, window, 50.0)
        scales = [float(w.abs().max()) for w in want]
        del want
        torch.cuda.empty_cache()
        for i, name in enumerate(("dq", "dk", "dv")):
            c, m = margins[name]
            log(f"[flash bwd] training shape {kind}: {name} largest |g| {scales[i]:.4e}, limit rtol="
                f"{BWD_BF16_RTOL:.3e} + atol {BWD_BF16_ATOL_REL * scales[i]:.3e}, largest error {errs[i]:.4e}; one "
                f"wrongly visited tile would move it by at least {c:.4e}, {m:.1f}x the limit on that tile")
            check(m >= TILE_MARGIN_MIN, f"{kind} {name}: a one-tile error would be only {m:.2f}x the limit")
        worst = [max(a, b) for a, b in zip(worst, errs)]
        main[kind] = (args, window)
    log(f"[flash bwd] training shapes B={shape[0]} H=8 Hkv=4 S={S_TRAIN} D=256 bfloat16 softcap 50, causal and "
        f"sliding(4096): within the limits (largest |d dq| {worst[0]:.3e}, |d dk| {worst[1]:.3e}, |d dv| "
        f"{worst[2]:.3e})")
    return main, worst[0], max(worst[1:])


def train_phase(fa, mp, dev, card):
    """Phase 10 (and the step's part of 11): gemma2-2b FULL training steps
    through the kernel route, then one profiled step. Frees the model and
    returns (cfg, tokens, launches over the run, step figures)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_train_step
    from repro_torch.models import init_params, make_dummy_batch, param_count

    cfg = get_config(ARCH).replace(attn_impl="flash")
    check(cfg.remat == "full" and cfg.optimizer == "adamw", f"{ARCH} FULL trains with {cfg.remat}, {cfg.optimizer}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, B_TRAIN, S_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    torch.cuda.synchronize()
    log(f"[train] {cfg.arch}: {cfg.num_layers} layers, {param_count(params)} parameters ({cfg.param_dtype}), remat "
        f"{cfg.remat}, {cfg.optimizer} lr {cfg.learning_rate}; parameters and optimizer state "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, made in {time.perf_counter() - t0:.2f} s; tokens "
        f"{tuple(batch['tokens'].shape)}")

    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    mp.launches = fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_tc = fa.launches_dq_tc = fa.launches_dkv_tc = 0
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        n0 = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per = (fa.launches - n0[0], fa.launches_dq - n0[1], fa.launches_dkv - n0[2])
        check(per == (2 * L, L, L), f"step {i + 1}: (forward, dQ, dK/dV) launches {per}, expected {(2 * L, L, L)}")
        per_tc = (fa.launches_fwd_tc - n0[3], fa.launches_dq_tc - n0[4], fa.launches_dkv_tc - n0[5])
        check(per_tc == (2 * L, L, L),
              f"step {i + 1}: tensor-core (forward, dQ, dK/dV) launches {per_tc}, expected {(2 * L, L, L)}")
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"step {i + 1}: loss {losses[-1]}")
    launches = {"flash_attention": fa.launches, "flash_dq": fa.launches_dq, "flash_dkv": fa.launches_dkv}
    check(mp.launches == 0, f"training launched the min-plus kernel {mp.launches} times")
    check(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps on one batch: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm_ms = 1e3 * statistics.median(secs[1:])
    log(f"[train] {TRAIN_STEPS} steps, per step exactly {2 * L} forward (with the remat recompute), {L} dQ and {L} "
        f"dK/dV launches, all on the tensor cores, min-plus 0; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; peak device memory {peak_gb:.2f} GB; first step {secs[0]:.3f} s")

    total, rows, kinds = device_time_table(lambda p, b: step(p, state, b), params, batch, top=12)
    tokens = B_TRAIN * S_TRAIN
    log(f"[times] {card}")
    log(f"[times] warm train step {ARCH} B={B_TRAIN} S={S_TRAIN}: {warm_ms:.3f} ms (host clock, median of "
        f"{TRAIN_STEPS - 1}; steps {', '.join(f'{1e3 * x:.3f}' for x in secs[1:])}) = {tokens / warm_ms * 1e3:.1f} "
        f"tokens/s")
    if total == 0:
        log("[times] torch.profiler recorded no device time")
    else:
        log(f"[times] torch.profiler, one step: {total:.3f} ms of kernel time on the card, busy {total / warm_ms:.3f} "
            f"of the warm step; by kind {', '.join(f'{k} {t:.3f} ms' for k, t in kinds.items())}; top kernels by "
            f"device time:")
        for t, n, name in rows:
            log(f"[times]   {t:10.3f} ms  {t / total:.3f}  x{n:<5d} {name[:90]}")
    tok = batch["tokens"]
    del params, state, batch, step, opt
    torch.cuda.empty_cache()
    return cfg, tok, launches, dict(losses=losses, warm_ms=warm_ms, peak_gb=peak_gb, device_ms=total)


def train_f32_check(fa, dev, cfg, tokens):
    """Phase 10, float32 part: F32_LAYERS layers at full width on the same
    tokens, loss and gradients of the kernel route against the plain
    route."""
    from repro_torch.launch import value_and_grad
    from repro_torch.models import init_params
    from repro_torch.optim import tree_leaves

    check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
          "float32 products must run in full float32, not TF32")
    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    b32 = {"tokens": tokens}
    n0 = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc)
    loss_k, g_k = value_and_grad(p32, cfg32, b32)
    per = (fa.launches - n0[0], fa.launches_dq - n0[1], fa.launches_dkv - n0[2])
    check(per == (2 * F32_LAYERS, F32_LAYERS, F32_LAYERS), f"float32 step launches {per}")
    check((fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc) == n0[3:],
          "the float32 step launched a tensor-core kernel")
    loss_p, g_p = value_and_grad(p32, cfg32.replace(attn_impl="plain"), b32)
    dloss = abs(float(loss_k) - float(loss_p))
    worst, ok = 0.0, True
    for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)):
        d = (a - b).abs()
        ok = ok and bool((d <= MODEL_GRAD_ATOL + MODEL_GRAD_RTOL * b.abs()).all())
        worst = max(worst, float(d.max()))
    del p32, g_k, g_p
    torch.cuda.empty_cache()
    log(f"[train] float32, {F32_LAYERS} layers at full width, B={tokens.shape[0]} S={tokens.shape[1] - 1}: loss "
        f"{float(loss_k):.6f} vs plain route {float(loss_p):.6f} (|d| {dloss:.3e}, limit {LOSS_ATOL}); gradients "
        f"within rtol={MODEL_GRAD_RTOL}, atol={MODEL_GRAD_ATOL} of the plain route (largest |d| {worst:.3e})")
    check(dloss < LOSS_ATOL and ok, f"float32 training: loss |d| {dloss}, gradients within limits: {ok}")


def flash_bwd_bound_ms(B, H, Hkv, S, D, kind, window, itemsize, which):
    """Least time for one dQ or dK/dV launch: the larger of its bytes (q, k,
    v, dO read once, lse and delta read once, its outputs written once) over
    HBM bandwidth and its flops per unmasked pair (dQ 6·D, dK/dV 8·D) over the
    peak of the input type. Returns (ms, 'bytes'|'operations')."""
    flops = (6 if which == "dq" else 8) * D * attn_pairs(B, H, S, kind, window)
    t_ops = flops / (PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS)
    outs = B * H * S * D if which == "dq" else 2 * B * Hkv * S * D
    nbytes = itemsize * (2 * B * H * S * D + 2 * B * Hkv * S * D + outs) + 8 * B * H * S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bwd_times(fa, main, card):
    """Phase 11, kernels: dQ and dK/dV per launch at the training shapes
    beside the plain backward, the bounds and the backward of
    ``scaled_dot_product_attention``. Returns each kernel's JSON fields at
    the causal shape."""
    import torch.nn.functional as F

    res = {}
    for kind, (args, window) in main.items():
        q, k, v, o, lse, do = args
        B, H, S, D = q.shape
        Hkv, scale = k.shape[1], D ** -0.5
        do_c, delta = fa._bwd_rows(o, do)
        wide = [x.float() for x in (q, k, v, do_c)]
        ms, prev_ms = {}, {}
        for which in ("dq", "dkv"):
            ms[which], prev_ms[which] = in_turns(
                lambda: fa._launch_bwd(which, q, k, v, do_c, lse, delta, kind, window, 50.0, scale),
                lambda: fa._launch_bwd(which, *wide, lse, delta, kind, window, 50.0, scale))
        del wide
        clocks = gpu_line("clocks.sm,power.draw")
        plain_ms = median_event_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do, kind, window, 50.0),
                                   reps=3, warmup=1)
        torch.cuda.empty_cache()
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = library_attention(fa, F, qg, kg, vg, kind, window)  # the forward, outside the timed window
        lib_ms = median_event_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                                 reps=5, per_rep=3)
        del out, qg, kg, vg
        torch.cuda.empty_cache()
        for which in ("dq", "dkv"):
            b_ms, b_by = flash_bwd_bound_ms(B, H, Hkv, S, D, kind, window, q.element_size(), which)
            res[(which, kind)] = dict(ms=ms[which], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=lib_ms, prev_ms=prev_ms[which])
            route = (f"route {TC_ROUTE_BWD[which]}; previous kernel ({PREV_ROUTE}, in turns) {prev_ms[which]:.4f} "
                     f"ms, {prev_ms[which] / ms[which]:.2f}x slower")
            log(f"[times] flash_{which} {kind}{f'({window})' if kind == 'sliding' else ''} B={B} H={H} Hkv={Hkv} "
                f"S={S} D={D} bfloat16 softcap 50: {ms[which]:.4f} ms per launch (clocks.sm, power.draw after: "
                f"{clocks}); {route}; plain backward (dq, dk and dv) {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}), kernel at {ms[which] / b_ms:.2f}x the bound ({b_ms / ms[which]:.3f} of the bf16 peak); "
                f"library {lib_ms:.4f} ms (backward of "
                f"scaled_dot_product_attention, dq, dk and dv, same shape, no softcap{LIBRARY_MASK[kind]})")
    log(f"[times] {card}")
    for which in ("dq", "dkv"):
        r = res[(which, "causal")]
        check(r["prev_ms"] >= TC_SPEEDUP_MIN * r["ms"], f"the tensor-core {which} kernel is not {TC_SPEEDUP_MIN}x "
                                                         f"faster than the previous kernel at the causal shape")
    return res[("dq", "causal")], res[("dkv", "causal")]


def scan_inputs(rng, n, B, Tp, W, dev):
    """A start row, a (B, n, W) cost view of an (n, B, W) array (so the scan
    reads it with its strides) and ragged starting points for the
    backtrack."""
    from repro_torch.kernels.ref import BIG

    k0 = band_inputs(rng, B, Tp, 1, dev)[0]
    by_class = rng.uniform(0, 10, (n, B, W)).astype(np.float32)
    by_class[rng.random(by_class.shape) < 0.2] = BIG
    costs = torch.from_numpy(by_class).to(dev).transpose(0, 1)
    t_star = torch.from_numpy(rng.integers(0, Tp, B)).to(dev)
    return k0, costs, t_star


def minplus_phase(mp, dev):
    """Phase 3: the row kernel, the scan and the backtrack against their
    plain versions on the card. Returns the main-shape row inputs (kept for
    timing) and the row kernel's largest value error there."""
    from repro_torch.kernels.ref import BIG, backtrack_ref, minplus_scan_ref, minplus_step_ref_batch

    rng = np.random.default_rng(SEED)
    cases = [(3, Tp, W, None, None, False)
             for Tp in (1, 7, 64, 255, 1024, 1500, 10001) for W in (1, 5, 130, 700, 1001)]
    # explicit tiles: 1, 2 and 4 warps along t, band chunks not a multiple of 8, odd edges
    cases += [(2, 1500, 700, BT, BW, False)
              for BT, BW in ((1, 1), (33, 7), (256, 64), (600, 100), (1024, 256))]
    cases += [(4, 3000, 400, None, None, True), (2, 1500, 700, 33, 7, True),
              (3, 10001, 5000, None, None, True)]  # tie-heavy; the last in 5 band chunks
    n_ok = 0
    for B, Tp, W, BT, BW, ties in cases:
        kprev, cost = band_inputs(rng, B, Tp, W, dev, ties=ties)
        got = mp.minplus_cuda_batch(kprev, cost, BT=BT, BW=BW)
        torch.cuda.synchronize()
        want = minplus_step_ref_batch(kprev, cost)
        check(bit_identical(got, want), f"kernel != plain at B={B} Tp={Tp} W={W} BT={BT} BW={BW} ties={ties}")
        n_ok += 1
    # all-BIG: values stay BIG, argmin keeps 0
    kprev = torch.full((2, 37), BIG, dtype=torch.float32, device=dev)
    cost = torch.full((2, 11), BIG, dtype=torch.float32, device=dev)
    for BT, BW in ((None, None), (8, 3), (512, 64)):
        got = mp.minplus_cuda_batch(kprev, cost, BT=BT, BW=BW)
        check(bit_identical(got, minplus_step_ref_batch(kprev, cost)), "all-BIG case differs")
        check(bool((got[0] == BIG).all()) and bool((got[1] == 0).all()), "all-BIG convention broken")
        n_ok += 1
    # the main-path shape, kept for timing
    kprev_m, cost_m = band_inputs(rng, B_MAIN, T_MAIN + 1, U_MAIN + 1, dev)
    got = mp.minplus_cuda_batch(kprev_m, cost_m)
    want = minplus_step_ref_batch(kprev_m, cost_m)
    check(bit_identical(got, want), "kernel != plain at the main-path shape")
    max_abs_err = float((got[0] - want[0]).abs().max())
    bt_m, bw_m = mp.hopper_tile_sizes(T_MAIN + 1, U_MAIN + 1)
    log(f"[kernel] {n_ok + 1} row cases bit-identical to the plain version (values and argmins), ties and "
        f"all-BIG rows included; main shape B={B_MAIN} Tp={T_MAIN + 1} W={U_MAIN + 1} BT={bt_m} BW={bw_m}, "
        f"max_abs_err {max_abs_err}")

    t0 = time.perf_counter()
    for n, B, Tp, W in SCAN_GRID:
        k0, costs, t_star = scan_inputs(rng, n, B, Tp, W, dev)
        I = torch.empty((n, B, Tp), dtype=torch.int32, device=dev)
        k_last, X = mp.minplus_scan_cuda(k0.clone(), costs, I, t_star=t_star)
        torch.cuda.synchronize()
        I_ref = torch.empty_like(I)
        k_ref = minplus_scan_ref(k0.clone(), costs, I_ref)
        X_ref = backtrack_ref(I_ref, t_star)
        where = f"n={n} B={B} Tp={Tp} W={W}"
        check(torch.equal(k_last.view(torch.int32), k_ref.view(torch.int32)), f"scan's last row != plain at {where}")
        check(torch.equal(I, I_ref), f"scan's argmin slab != plain at {where}")
        check(torch.equal(X, X_ref), f"backtrack after the scan != plain at {where}")
    ratio, blocks = block_balance(B_MAIN, T_MAIN + 1, U_MAIN + 1, bt_m)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[kernel] scan (one host call) and backtrack: {len(SCAN_GRID)} cases over n x B x Tp x W = "
        f"{{1, 2, 7, 100}} x {{1, 3, 16, 17}} x {{1, 7, 1500, 10001}} x {{1, 5, 1001}}, last row, argmin slab "
        f"and schedules identical to the plain scan and backtrack ({time.perf_counter() - t0:.1f} s)")
    log(f"[kernel] balance at the main shape: {blocks} blocks of {mp.MAX_THREADS} threads on {sms} SMs "
        f"({blocks / sms:.2f} per SM); busiest block's candidates / mean {ratio:.4f}")
    return (kprev_m, cost_m), max_abs_err


def solver_phase(mp, fa, dev):
    """Phase 4: the main path through the entry point, its launches, and
    bit-identity to the plain path on the card."""
    from repro_torch.core import (
        Problem,
        ProblemBatch,
        random_problem,
        remove_lower_limits,
        solve_fused_batch_torch,
        solve_schedule_dp,
        solve_schedule_dp_batch,
        solve_schedule_dp_torch,
        total_cost,
        validate_schedule_batch,
    )
    from repro_torch.core.torch_dp import _backtrack_batch, dp_tables_batch, pack_batch, pack_problem

    prng = np.random.default_rng(SEED)
    batch = ProblemBatch.from_problems([random_problem(prng, n=N_MAIN, T=T_MAIN, regime="arbitrary",
                                                       max_upper=U_MAIN) for _ in range(B_MAIN)])
    b0 = remove_lower_limits(batch)
    log(f"[main] batch B={batch.B} n={batch.n} T={T_MAIN} W'={b0.W} (after lower-limit removal)")
    mp.launches = mp.launches_scan = mp.launches_backtrack = fa.launches = 0
    t0 = time.perf_counter()
    X = solve_schedule_dp_batch(batch, device="cuda")
    cold_s = time.perf_counter() - t0
    launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
    check(launches["row"] == batch.n, f"{launches['row']} row launches in the main solve, expected n={batch.n}")
    check(launches["scan"] == 1, f"{launches['scan']} host calls into the scan, expected 1")
    check(launches["backtrack"] == 1, f"{launches['backtrack']} backtrack launches, expected 1")
    check(fa.launches == 0, f"the solve launched the flash kernel {fa.launches} times")
    validate_schedule_batch(batch, X)
    log(f"[main] solve_schedule_dp_batch: {launches['row']} row launches (n={batch.n}) in {launches['scan']} host "
        f"call into the scan, {launches['backtrack']} backtrack launch, first call {cold_s:.3f} s, every schedule "
        f"sums to T and lies in [L, U]")

    costs = pack_batch(batch, dev)
    check(torch.equal(costs.view(torch.int32), pack_problem(b0, dev).view(torch.int32)),
          "the device pack differs from the host pack")
    t_star = torch.from_numpy(b0.T).to(dev)
    Tmax = int(b0.T.max())
    Xc, Kc = solve_fused_batch_torch(costs, t_star, Tmax, backend="cuda")
    Xr, Kr = solve_fused_batch_torch(costs, t_star, Tmax, backend="ref")
    check(torch.equal(Xc, Xr), "schedules differ between the kernels and the plain path")
    check(torch.equal(Kc.view(torch.int32), Kr.view(torch.int32)), "K_last differs between kernels and plain path")
    check(np.array_equal(X, Xc.cpu().numpy().astype(np.int64) + batch.lower), "entry point != fused solver")
    Kc, Ic = dp_tables_batch(costs, Tmax, backend="cuda")
    Kr, Ir = dp_tables_batch(costs, Tmax, backend="ref")
    check(torch.equal(Ic, Ir), "the argmin slab differs between the kernels and the plain path")
    bt_err = int((Xc - _backtrack_batch(Ir, t_star)).abs().max())
    check(bt_err == 0, "the backtrack kernel differs from the plain backtrack")
    log("[main] device pack bit-identical to the host pack; X, K_last and the argmin slab bit-identical to "
        "backend='ref' on the card")

    worst = 0.0
    for b in (0, 1):
        p = batch.instance(b)
        c64 = total_cost(p, solve_schedule_dp(p))
        cgpu = total_cost(p, X[b])
        gap = abs(cgpu - c64) / abs(c64)
        check(gap <= 1e-5, f"instance {b}: GPU cost {cgpu} vs float64 host DP {c64} (rel gap {gap})")
        worst = max(worst, gap)
    log(f"[main] float64 host DP on instances 0, 1: largest relative cost gap {worst:.3e} (limit 1e-5)")

    for T, want_x, want_c in ((5, [2, 3, 0], 7.5), (8, [1, 2, 5], 11.5)):
        p = paper_problem(T, Problem)
        x = solve_schedule_dp_torch(p, device="cuda")
        check(list(x) == want_x and abs(total_cost(p, x) - want_c) < 1e-9, f"paper example T={T}: {x}")
    log("[main] paper example: T=5 -> [2, 3, 0] cost 7.5, T=8 -> [1, 2, 5] cost 11.5")
    return batch, X, launches, bt_err


def device_ms_by(fn, kernels, calls=1):
    """The profiler's device time of the kernels whose name holds each of
    ``kernels`` over ``calls`` calls of ``fn`` after one warm-up call:
    {kernel: (total ms, launches)}. Unlike CUDA events around back-to-back
    calls, it does not count the gaps a host-bound caller leaves between
    launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {k: (0.0, 0) for k in kernels}
    for e in prof.key_averages():
        for k in kernels:
            if k in e.key:
                ms, count = out[k]
                out[k] = (ms + (getattr(e, "device_time_total", None) or e.cuda_time_total) / 1e3, count + e.count)
    return out


def device_ms(fn, kernel, calls=1):
    """:func:`device_ms_by` of one kernel: (total ms, launches)."""
    return device_ms_by(fn, (kernel,), calls)[kernel]


def per_launch_ms(fn, kernel, calls=20):
    """Device time per launch of ``kernel`` over ``calls`` calls of ``fn``
    that launch it once each."""
    total, count = device_ms(fn, kernel, calls)
    check(count == calls, f"the profiler saw {count} launches of {kernel} in {calls} calls")
    return total / count


def solver_times(mp, minplus_main, batch, X, dev, card):
    """Phase 5: the row kernel against its bound, the scan, the backtrack,
    and the warm solve with its split, in turns with the previous
    orchestration."""
    from repro_torch.core import remove_lower_limits, restore_lower_limits, solve_schedule_dp_batch
    from repro_torch.core.torch_dp import _backtrack_batch, _pack_on_device, pack_problem
    from repro_torch.kernels.ref import BIG, minplus_step_ref_batch

    kprev_m, cost_m = minplus_main
    out_k = torch.empty_like(kprev_m)
    out_i = torch.empty(kprev_m.shape, dtype=torch.int32, device=dev)
    row = lambda **kw: mp.minplus_cuda_batch(kprev_m, cost_m, out=out_k, iout=out_i, **kw)  # noqa: E731
    kernel_ms = per_launch_ms(row, "minplus_row_kernel", calls=20)
    clocks = gpu_line("clocks.sm,power.draw")
    call_ms = median_event_ms(row, reps=15, per_rep=20)
    plain_ms = median_event_ms(lambda: minplus_step_ref_batch(kprev_m, cost_m), reps=5, per_rep=4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_mhz = float(gpu_line("clocks.max.sm").split()[0])
    b_ms, b_by = bound_ms(B_MAIN, T_MAIN + 1, U_MAIN + 1, sms, max_mhz)
    bt_m, bw_m = mp.hopper_tile_sizes(T_MAIN + 1, U_MAIN + 1)
    sweep = []
    for BT in (256, 512, 1024):
        for BW in (128, 256, 512, 1024):
            ms = per_launch_ms(lambda: row(BT=BT, BW=BW), "minplus_row_kernel", calls=5)
            sweep.append(f"{BT}x{BW}={ms:.4f}")
    log(f"[times] {card}")
    log(f"[times] minplus_cuda per class step (B={B_MAIN}, Tp={T_MAIN + 1}, W={U_MAIN + 1}, BT={bt_m}, BW={bw_m}): "
        f"{kernel_ms:.4f} ms (the profiler's device time over 20 launches; clocks.sm, power.draw after: {clocks}); "
        f"one call of the wrapper from Python {call_ms:.4f} ms (CUDA events over 20 back-to-back calls: the host's "
        f"pace where it exceeds the kernel's); plain version {plain_ms:.4f} ms; bound {1e3 * b_ms:.2f} us ({b_by}: {OPS_PER_CANDIDATE} lane instructions x "
        f"{candidates(B_MAIN, T_MAIN + 1, U_MAIN + 1)} candidates over {sms} SMs x {LANES_PER_SM} lanes x "
        f"{max_mhz:.0f} MHz), kernel at {kernel_ms / b_ms:.2f}x the bound; library_ms: none")
    log(f"[times] tiles BTxBW=ms at the main shape (device time over 5 launches): {' '.join(sweep)}")

    # the main solve's own inputs, on the card
    b0 = remove_lower_limits(batch)
    costs = pack_problem(b0, dev)
    t_star = torch.from_numpy(b0.T).to(dev)
    Tp = int(b0.T.max()) + 1
    n = batch.n
    k0 = torch.full((batch.B, Tp), BIG, dtype=torch.float32, device=dev)
    k0[:, 0] = 0.0
    I = torch.empty((n, batch.B, Tp), dtype=torch.int32, device=dev)
    scan_ms = median_event_ms(lambda: mp.minplus_scan_cuda(k0, costs, I), reps=5, warmup=1)
    rows_ms, rows_count = device_ms(lambda: mp.minplus_scan_cuda(k0, costs, I), "minplus_row_kernel")
    check(rows_count == n, f"the profiler saw {rows_count} row kernels in one scan, expected {n}")
    # the backtrack's device time, from the scan calls that launch it after their row kernels
    bt_ms = per_launch_ms(lambda: mp.minplus_scan_cuda(k0, costs, I, t_star=t_star), "minplus_backtrack_kernel",
                          calls=20)
    plain_bt_ms = median_event_ms(lambda: _backtrack_batch(I, t_star), reps=5, per_rep=4)
    bt_b_ms, bt_b_by = backtrack_bound_ms(n, batch.B)
    log(f"[times] scan in one host call (n={n}): {scan_ms:.4f} ms (CUDA events, median of 5); its {rows_count} row "
        f"kernels {rows_ms:.4f} ms of device time (profiler) = {rows_ms / n:.4f} ms each; outside the row steps "
        f"{(scan_ms - rows_ms) / scan_ms:.4f} of the scan")
    log(f"[times] backtrack kernel {bt_ms:.4f} ms = {1e3 * bt_ms / n:.3f} us per dependent read (the profiler's "
        f"device time over 20 launches, each after its scan's row kernels, as in a solve); plain backtrack {plain_bt_ms:.4f} ms; bound by the bytes it must move {1e3 * bt_b_ms:.5f} us")

    # the warm solve and its split
    costs64 = torch.from_numpy(batch.costs).to(dev)
    lower, upper = (torch.from_numpy(a).to(dev) for a in (batch.lower, batch.upper))
    pack_ms = median_event_ms(lambda: _pack_on_device(costs64, lower, upper), reps=15, per_rep=5)
    h2d_ms = median_wall_ms(lambda: (torch.from_numpy(batch.costs).to(dev), torch.from_numpy(batch.lower).to(dev),
                                     torch.from_numpy(batch.upper).to(dev)), reps=5)
    X_dev = torch.from_numpy(X - batch.lower).to(dev)

    def host_part():
        batch.validate()
        t_prime = batch.T - batch.lower.sum(axis=1)
        torch.from_numpy(t_prime).to(dev)
        return restore_lower_limits(batch, X_dev.cpu().numpy().astype(np.int64))

    host_ms = median_wall_ms(host_part, reps=5)

    def previous_solve():
        """The previous orchestration: host lower-limit removal and packing,
        a Python loop of minplus_cuda_batch over the transposed costs, the
        plain backtrack."""
        batch.validate()
        p0 = remove_lower_limits(batch)
        c = pack_problem(p0, dev)
        T = int(p0.T.max())
        by_class = c.transpose(0, 1).contiguous()
        rows = (torch.full((batch.B, T + 1), BIG, dtype=torch.float32, device=dev),
                torch.empty((batch.B, T + 1), dtype=torch.float32, device=dev))
        rows[0][:, 0] = 0.0
        slab = torch.empty((batch.n, batch.B, T + 1), dtype=torch.int32, device=dev)
        for i in range(batch.n):
            mp.minplus_cuda_batch(rows[i % 2], by_class[i], out=rows[(i + 1) % 2], iout=slab[i])
        Xp = _backtrack_batch(slab, torch.from_numpy(p0.T).to(dev))
        return restore_lower_limits(batch, Xp.cpu().numpy().astype(np.int64))

    check(np.array_equal(previous_solve(), X), "the previous orchestration gives other schedules")
    new_solve = lambda: solve_schedule_dp_batch(batch, device="cuda")  # noqa: E731
    walls = {"new": [], "previous": []}
    for name, fn in (("previous", previous_solve), ("new", new_solve), ("new", new_solve),
                     ("previous", previous_solve)):
        walls[name].append(median_wall_ms(fn, reps=5))
    e2e_ms, prev_ms = (statistics.mean(walls[k]) for k in ("new", "previous"))
    log(f"[times] warm solve_schedule_dp_batch {e2e_ms:.3f} ms (host clock, mean of two medians of 5, in turns "
        f"previous, new, new, previous: {walls}); the previous orchestration {prev_ms:.3f} ms, "
        f"{prev_ms / e2e_ms:.2f}x slower")
    log(f"[times] the solve = host part (validate, T', restore) {host_ms:.3f} ms + float64 tables and limits to "
        f"the card {h2d_ms:.3f} ms + device pack {pack_ms:.4f} ms + scan {scan_ms:.4f} ms + backtrack "
        f"{bt_ms:.4f} ms + rest {e2e_ms - host_ms - h2d_ms - pack_ms - scan_ms - bt_ms:.3f} ms; row kernel time "
        f"{n * kernel_ms:.3f} ms = {n * kernel_ms / e2e_ms:.3f} of the solve")
    return {
        "row": {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
        "backtrack": {"ms": bt_ms, "plain_ms": plain_bt_ms, "bound_ms": bt_b_ms, "bound_by": bt_b_by,
                      "library_ms": None},
    }


def time_tables(p, seed):
    """Per-device time tables as benchmarks/bench_pareto.py builds them:
    sorted uniform(0.05, 1.0) seconds for 1..U_i batches, 0 for none."""
    rng = np.random.default_rng(seed)
    tt = [np.sort(rng.uniform(0.05, 1.0, int(u) + 1)) for u in p.upper]
    for t in tt:
        t[0] = 0.0
    return tt


def same_frontier(a, b) -> bool:
    return len(a) == len(b) and all(
        (p.time, p.energy, p.deadline) == (q.time, q.energy, q.deadline) and np.array_equal(p.schedule, q.schedule)
        for p, q in zip(a, b))


def dispatch_split(plan, batch, shape, reps=5):
    """A warm dispatch of ``batch`` to its bucket's captured ``plan``, step by
    step as ``SweepEngine`` runs it, synchronized after each step: medians
    over ``reps`` of the host pad, the copy into the static buffers, the
    replay, and the clone, copy to the host and restore of the schedules
    (ms, host clock)."""
    Bb, nb, _, Wb = shape
    steps = {"host pad": [], "copy in": [], "replay": [], "clone, copy out, restore": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        padded = batch.pad_to(B=Bb, n=nb, W=Wb)
        arrays = (padded.costs, padded.lower, padded.upper, padded.T - padded.lower.sum(axis=1))
        t1 = time.perf_counter()
        for buf, a in zip(plan.inputs, arrays):
            buf.copy_(torch.from_numpy(a))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        plan.graph.replay()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        X = plan.outputs[0].clone().cpu().numpy()[: batch.B, : batch.n] + batch.lower
        t4 = time.perf_counter()
        for k, a, b in zip(steps, (t0, t1, t2, t3), (t1, t2, t3, t4)):
            steps[k].append(1e3 * (b - a))
    check(X.shape == (batch.B, batch.n), "the step-by-step dispatch lost its shape")
    return {k: statistics.median(v) for k, v in steps.items()}


def split_text(split):
    return " + ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f" = {sum(split.values()):.3f} ms"


def facade_host_split(plist, X, reps=5):
    """The facade's host work around one dispatch of ``plist`` (ms, host
    clock, medians): the regimes it reports, the dense batch the engine
    builds from the instances, and the validation and float64 objectives of
    the ``(B, n)`` schedules ``X``."""
    from repro_torch.core import ProblemBatch, total_cost, validate_schedule

    def objectives():
        for p, x in zip(plist, X):
            validate_schedule(p, x[: p.n])
            total_cost(p, x[: p.n])

    return {
        "regimes": median_wall_ms(lambda: [p.regime() for p in plist], reps),
        "dense batch": median_wall_ms(lambda: ProblemBatch.from_problems(plist), reps),
        "validation and objectives": median_wall_ms(objectives, reps),
    }


def facade_phase(mp, dev, card, batch, X):
    """Phase 12: the scheduler layers through the Solver facade on the card.
    Returns the launches of the DP batch path, (a), counted from 0."""
    from repro_torch.core import (
        ProblemBatch,
        Solver,
        deadline_grid,
        marco,
        mardec,
        mardecun,
        marin,
        random_problem,
        select_algorithm_batch,
        solve_schedule_dp,
        solve_schedule_dp_batch,
        tighten_for_deadline,
        total_cost,
    )
    from repro_torch.core.pareto import assemble_frontier
    from repro_torch.core.sweep import request_bucket, reset_default_engines
    from repro_torch.core.torch_dp import pack_batch, solve_fused_batch_torch

    reset_default_engines()
    solver = Solver(device="cuda")
    eng = solver.engine
    Tp = batch.T - batch.lower.sum(axis=1)
    Tmax = int(Tp.max())
    nb, Tb, Wb = request_bucket(batch)
    _, K4 = solve_fused_batch_torch(pack_batch(batch, dev), torch.from_numpy(Tp).to(dev), Tmax, backend="cuda")
    K4 = K4.cpu().numpy()  # phase 4's final rows

    # (a) the DP batch: one plan build (eager warm-up, capture), two replays
    mp.launches = mp.launches_scan = mp.launches_backtrack = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = [solver.solve(batch, algorithm="dp_batch")]
    cold_ms = 1e3 * (time.perf_counter() - t0)
    sols += [solver.solve(batch, algorithm="dp_batch") for _ in range(2)]
    launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
    check(launches == {"row": 3 * nb, "scan": 1, "backtrack": 3},
          f"three dp_batch solves launched {launches}; expected {3 * nb} rows in 1 scan call (the warm-up) and 3 "
          f"backtracks")
    stats = eng.cache_stats()
    check((stats["compiles"], stats["hits"], stats["misses"]) == (1, 2, 1), f"cache_stats {stats}")
    (key, plan), = eng._cache.items()
    check(plan.graph is not None, "the bucket's plan captured no CUDA graph")
    for sol in sols:
        check(np.array_equal(np.stack(sol.schedules), X), "the facade's schedules differ from phase 4's")
        check(sol.k_last.shape == (batch.B, Tb + 1), f"k_last shape {sol.k_last.shape}")
        check(np.array_equal(sol.k_last[:, : Tmax + 1].view(np.int32), K4.view(np.int32)),
              "the facade's K_last differs from phase 4's")
        check(sol.algorithms == ["dp_batch"] * batch.B, f"algorithms {set(sol.algorithms)}")
    prof = device_ms_by(lambda: eng.dispatch(batch).result(), ("minplus_row_kernel", "minplus_backtrack_kernel"))
    (rows_ms, rows), (bt_ms, bts) = prof["minplus_row_kernel"], prof["minplus_backtrack_kernel"]
    check((rows, bts) == (nb, 1), f"the profiler saw {rows} row and {bts} backtrack kernels in one replay; expected "
                                   f"{nb} and 1")
    log(f"[facade] (a) Solver.solve(batch, algorithm='dp_batch') x 3 on bucket {eng._bucket_label(key)}: "
        f"cache_stats {stats}; X identical to phase 4, K_last[:, :{Tmax + 1}] bit-identical; launches {launches}; "
        f"one warm replay by the profiler: {rows} row kernels ({rows_ms:.4f} ms) and {bts} backtrack ({bt_ms:.4f} ms)")

    # (b) a mixed batch through the regime split
    mrng = np.random.default_rng(1)
    regimes = [r for r in MIXED_TABLE2 for _ in range(4)]
    mixed = [random_problem(mrng, n=N_MAIN, T=T_MAIN, regime=r, max_upper=U_MAIN) for r in regimes]
    mp.launches = 0
    t0 = time.perf_counter()
    msol = solver.solve(mixed)
    mixed_cold_ms = 1e3 * (time.perf_counter() - t0)
    check(msol.algorithms == [MIXED_TABLE2[r] for r in regimes], f"algorithms {msol.algorithms}")
    check(mp.launches == nb, f"the mixed batch's DP part launched {mp.launches} row kernels, expected {nb}")
    t0 = time.perf_counter()
    csol = Solver(device="cpu").solve(mixed)
    cpu_s = time.perf_counter() - t0
    check(csol.algorithms == msol.algorithms, "algorithms differ from the CPU's")
    check(all(np.array_equal(a, b) for a, b in zip(msol.schedules, csol.schedules)), "schedules differ from the CPU's")
    serial = {"marin": marin, "marco": marco, "mardecun": mardecun, "mardec": mardec, "dp": solve_schedule_dp}
    gaps = {}
    for p, obj, alg in zip(mixed, msol.objectives, msol.algorithms):
        want = total_cost(p, serial[alg](p))
        gaps[alg] = max(gaps.get(alg, 0.0), abs(obj - want) / abs(want))
    check(max(gaps.values()) <= FACADE_RTOL, f"objectives against the serial float64 algorithms: {gaps}")
    log(f"[facade] (b) mixed batch of 16 (4 x {list(MIXED_TABLE2)}, n={N_MAIN}, T={T_MAIN}): algorithms "
        f"{sorted(set(msol.algorithms))} per paper Table 2, schedules identical to device='cpu' (its call took "
        f"{cpu_s:.1f} s), largest relative objective gap to the serial float64 algorithm by algorithm {gaps} "
        f"(limit {FACADE_RTOL})")

    # (c) a 100-point deadline sweep of phase 4's instance 0 in one dispatch
    p0 = batch.instance(0)
    tt = time_tables(p0, SEED + 7)
    grid = deadline_grid(p0, tt, SWEEP_POINTS)
    check(len(grid) == SWEEP_POINTS, f"the grid has {len(grid)} points")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = eng.cache_stats()
    t0 = time.perf_counter()
    swp = solver.sweep(p0, tt, grid)  # check=True: each schedule is validated against its tightened instance
    sweep_cold_ms = 1e3 * (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    skey = next(reversed(eng._cache))  # the sweep's bucket, the most recently used
    after = eng.cache_stats()
    check(after["hits"] + after["misses"] - before["hits"] - before["misses"] == 1, "the sweep took more than one dispatch")
    t_star = int(p0.T - p0.lower.sum())
    k_obj = swp.k_last[:, t_star]
    check(bool(np.all(np.diff(k_obj) <= 0)), "the DP objective rises as a deadline loosens")
    ends = [tighten_for_deadline(p0, tt, float(d)) for d in (grid[0], grid[-1])]
    Xe = solve_schedule_dp_batch(ends, device="cuda")
    check(np.array_equal(swp.schedules[0], Xe[0]) and np.array_equal(swp.schedules[-1], Xe[1]),
          "the sweep's end points differ from solve_schedule_dp_batch of their tightened instances")
    e = swp.objectives
    log(f"[facade] (c) Solver.sweep over {len(grid)} deadlines [{grid[0]:.6f}, {grid[-1]:.6f}] s in one dispatch "
        f"(bucket {eng._bucket_label(skey)}): every schedule feasible, the float32 DP "
        f"objective never rises, float64 energy {e[0]:.6f} -> {e[-1]:.6f} (largest rise "
        f"{max(0.0, float(np.max(np.diff(e)))):.3e}); end points identical to solve_schedule_dp_batch; peak device "
        f"memory {peak_gb:.3f} GB")

    # (d) the frontier over 64 deadlines; against the CPU at a cut size
    fgrid = deadline_grid(p0, tt, FRONTIER_POINTS)
    front = solver.frontier(p0, tt, fgrid)
    tight = [tighten_for_deadline(p0, tt, float(d)) for d in fgrid]
    want = assemble_frontier(p0, tt, fgrid, solve_schedule_dp_batch(tight, device="cuda"))
    check(same_frontier(front, want), "the frontier differs from the one of solve_schedule_dp_batch's schedules")
    crng = np.random.default_rng(SEED + 12)
    pc = random_problem(crng, n=FRONTIER_CPU_N, T=FRONTIER_CPU_T, regime="arbitrary", max_upper=FRONTIER_CPU_U)
    ttc = time_tables(pc, SEED + 13)
    cgrid = deadline_grid(pc, ttc, FRONTIER_POINTS)
    fc = solver.frontier(pc, ttc, cgrid)
    check(same_frontier(fc, Solver(device="cpu").frontier(pc, ttc, cgrid)), "the frontier differs from the CPU's")
    log(f"[facade] (d) Solver.frontier over {len(fgrid)} deadlines: {len(front)} points, the same as assembled from "
        f"solve_schedule_dp_batch; at n={FRONTIER_CPU_N}, T={FRONTIER_CPU_T}, U<={FRONTIER_CPU_U}: {len(fc)} points, "
        f"the same as device='cpu'")

    # (e) times
    log(f"[facade] (e) {card}")
    with torch.cuda.stream(eng._stream):
        eager_ms = median_wall_ms(lambda: plan.body(*plan.inputs), reps=1)
    graph = torch.cuda.CUDAGraph()  # the plan's capture once more, timed

    def capture():
        with torch.cuda.graph(graph, stream=eng._stream, capture_error_mode="thread_local"):
            plan.body(*plan.inputs)

    capture_ms = median_wall_ms(capture, reps=1)
    del graph
    new = lambda: eng.dispatch(batch).result()  # noqa: E731
    prev = lambda: solve_schedule_dp_batch(batch, device="cuda")  # noqa: E731
    walls = {"new": [], "previous": []}
    for name, fn in (("previous", prev), ("new", new), ("new", new), ("previous", prev)):
        walls[name].append(median_wall_ms(fn, reps=5))
    warm_ms, prev_ms = (statistics.mean(walls[k]) for k in ("new", "previous"))
    split = dispatch_split(plan, batch, key[1:])
    facade_ms = median_wall_ms(lambda: solver.solve(batch, algorithm="dp_batch"), reps=5)
    plist = [batch.instance(b) for b in range(batch.B)]
    host = facade_host_split(plist, np.stack(sols[0].schedules))
    log(f"[facade] (e) cold plan build: the first dp_batch solve {cold_ms:.3f} ms (host clock); of it, an eager run of "
        f"the plan's body (the warm-up) takes {eager_ms:.3f} ms and a capture of it {capture_ms:.3f} ms (each timed "
        f"alone, warm), the facade's host work the rest")
    log(f"[facade] (e) warm bucketed DP solve (engine.dispatch(batch).result()) {warm_ms:.3f} ms against "
        f"solve_schedule_dp_batch {prev_ms:.3f} ms (host clock, mean of two medians of 5, in turns: {walls}); "
        f"step by step (medians of 5, synchronized after each): " + split_text(split)
        + f"; the replay's {rows} row kernels {rows_ms:.4f} ms and its backtrack {bt_ms:.4f} ms by the profiler")
    log(f"[facade] (e) warm Solver.solve(batch, algorithm='dp_batch') {facade_ms:.3f} ms = the dispatch above + "
        f"k_last to the host + the facade's host work: " + ", ".join(f"{k} {v:.3f} ms" for k, v in host.items()))

    mb = ProblemBatch.from_problems(mixed)
    parts = {alg: [b for b, a in enumerate(msol.algorithms) if a == alg] for alg in ("dp", "marin", "marco", "mardec")}
    sel = parts["marin"] + parts["marco"]
    mixed_ms = median_wall_ms(lambda: solver.solve(mixed), reps=3)
    split_ms = {
        "batch and Table 2": median_wall_ms(lambda: select_algorithm_batch(mixed), reps=3),
        "DP plan": median_wall_ms(lambda: eng.dispatch(eng._take(mb, parts["dp"])).result(), reps=3),
        "selection plan": median_wall_ms(lambda: eng._dispatch_selection(eng._take(mb, sel)).result(), reps=3),
        "MarDec on the host": median_wall_ms(lambda: eng._host_part(eng._take(mb, parts["mardec"]), "mardec"), reps=1),
    }
    log(f"[facade] (e) warm mixed solve (Solver.solve) {mixed_ms:.3f} ms (first {mixed_cold_ms:.3f} ms); by part: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split_ms.items()))

    splan = eng._cache[skey]
    sweep_ms = median_wall_ms(lambda: solver.sweep(p0, tt, grid), reps=3)
    tighten_ms = median_wall_ms(lambda: [tighten_for_deadline(p0, tt, float(d)) for d in grid], reps=3)
    tight = [tighten_for_deadline(p0, tt, float(d)) for d in grid]
    tbatch = ProblemBatch.from_problems(tight)
    sweep_split = dispatch_split(splan, tbatch, skey[1:], reps=3)
    sweep_host = facade_host_split(tight, np.stack(swp.schedules), reps=3)
    log(f"[facade] (e) warm {len(grid)}-point sweep (Solver.sweep) {sweep_ms:.3f} ms (first {sweep_cold_ms:.3f} ms) = "
        f"tightening {tighten_ms:.3f} ms + " + ", ".join(f"{k} {v:.3f} ms" for k, v in sweep_host.items())
        + " + the dispatch on bucket " + eng._bucket_label(skey) + ": " + split_text(sweep_split)
        + " + k_last to the host and the rest")
    return launches


def main() -> int:
    # -- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}; run from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    from repro_torch.core import (
        Problem,
        ProblemBatch,
        random_problem,
        remove_lower_limits,
        solve_fused_batch_torch,
        solve_schedule_dp,
        solve_schedule_dp_batch,
        solve_schedule_dp_torch,
        total_cost,
        validate_schedule_batch,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import minplus as mp

    dev = torch.device("cuda")
    # float32 products in full float32 for the plain versions and the model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    mp._launch_fns()  # the first load builds every source, all together
    fa._launch_fn()
    fa._bwd_launch_fns()
    log(f"[build] minplus.cu, flash_fwd.cu, flash_bwd.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({build.build_dir()})")
    tc_names = {"minplus": (), "flash_fwd": ("flash_fwd_tc_kernel",),
                "flash_bwd": ("flash_dq_tc_kernel", "flash_dkv_tc_kernel")}
    for name, kernels in tc_names.items():
        usage = ptxas_usage((build.build_dir() / f"{name}.log").read_text())
        for line in (build.build_dir() / f"{name}.log").read_text().splitlines():
            if "C75" in line or "warning" in line:
                log(f"[build] {name} ptxas: {line.strip()}")
        plain = [u for fn, u in usage.items() if not tc_kernels({fn: 0})]
        log(f"[build] {name}: {len(plain)} CUDA-core kernels, registers {sorted(r for r, _, _ in plain)}, spill "
            f"stores and loads {sum(a + b for _, a, b in plain)} bytes in all")
        if name == "minplus":
            ops, pred = next(v for fn, v in sass_ops(build, name).items() if "minplus_row_kernel" in fn)
            log(f"[build] minplus_row_kernel SASS: FADD {ops.get('FADD', 0)} (predicated {pred.get('FADD', 0)}), "
                f"FSETP {ops.get('FSETP', 0)}, FSEL {ops.get('FSEL', 0)}, SEL {ops.get('SEL', 0)}, "
                f"LDS {ops.get('LDS', 0)} (the unrolled inner loop: 64 candidates, each an add, a compare and "
                f"two predicated adds)")
        if not kernels:
            continue
        usage = tc_kernels(usage)
        counts = tensor_core_counts(build, name)
        tc = tc_kernels(counts)
        other = sum(h + m for fn, (h, m) in counts.items() if not tc_kernels({fn: 0}))
        for kern in kernels:
            log(f"[build] {name} {kern} (head dim: ptxas registers, spill stores, spill loads in bytes; SASS HGMMA, "
                "HMMA) " + ", ".join(f"{d}: {usage.get((kern, d))}; {tc.get((kern, d))}" for d in fa.HEAD_DIMS))
            check(all((kern, d) in tc for d in fa.HEAD_DIMS), f"{name}: {kern} lacks a head dim of {fa.HEAD_DIMS}")
        log(f"[build] {name} SASS: the {len(counts) - len(tc)} float32 CUDA-core kernels {other} tensor-core "
            f"instructions in all")
        check(sorted(k for k, _ in tc) == sorted(kern for kern in kernels for _ in fa.HEAD_DIMS),
              f"{name}: tensor-core kernels {sorted(tc)}")
        check(all(h > 0 for h, _ in tc.values()), f"{name}: a bfloat16 tensor-core kernel has no HGMMA")
        if name == "flash_bwd":
            spills = usage[("flash_dkv_tc_kernel", 256)][1:]
            check(spills == (0, 0), f"flash_dkv_tc_kernel<256> spills (stores, loads): {spills}")

    # -- phases 3-5: the min-plus kernels, the solver's main path, times ------
    minplus_main, max_abs_err = minplus_phase(mp, dev)
    solver_batch, X, launches_main, bt_err = solver_phase(mp, fa, dev)
    st = solver_times(mp, minplus_main, solver_batch, X, dev, card)

    # -- phases 6-8: the flash kernel and the gemma2-2b prefill -------------
    flash_main, flash_err_max = flash_phase(fa, dev)
    cfg, params, batch, step, launches_prefill = prefill_phase(fa, mp, dev)
    ft = flash_times(fa, flash_main, cfg, params, batch, step, card)
    del flash_main, params, batch, step
    torch.cuda.empty_cache()

    # -- phases 9-11: the flash backward kernels and gemma2-2b training -----
    bwd_main, dq_err, dkv_err = flash_bwd_phase(fa, dev)
    cfg, tokens, launches_train, _ = train_phase(fa, mp, dev, card)
    train_f32_check(fa, dev, cfg, tokens)
    dq_t, dkv_t = flash_bwd_times(fa, bwd_main, card)
    del bwd_main
    torch.cuda.empty_cache()

    # -- phase 12: the scheduler layers through the Solver facade ------------
    launches_facade = facade_phase(mp, dev, card, solver_batch, X)

    kernels = [{
        "name": "minplus_cuda",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:76",
        "launches": launches_main["row"],
        "engine_launches": launches_facade["row"],
        "max_abs_err": max_abs_err,
        **st["row"],
    }, {
        "name": "minplus_backtrack",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "none: no TPU kernel (src/repro/core/jax_dp.py:148 _backtrack_batch is a plain jnp lax.scan)",
        "launches": launches_main["backtrack"],
        "engine_launches": launches_facade["backtrack"],
        "max_abs_err": bt_err,
        **st["backtrack"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "tc_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:53",
        "launches": launches_prefill,
        "max_abs_err": flash_err_max,
        **ft,
    }, {
        "name": "flash_dq",
        "route": "cuda",
        "tc_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": launches_train["flash_dq"],
        "max_abs_err": dq_err,
        **dq_t,
    }, {
        "name": "flash_dkv",
        "route": "cuda",
        "tc_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:127",
        "launches": launches_train["flash_dkv"],
        "max_abs_err": dkv_err,
        **dkv_t,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
