#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one CUDA card and holds its
kernel against the plain PyTorch version.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device  — a CUDA card is present; prints its name and power limit.
2. build   — builds ``src/repro_torch/kernels/csrc/minplus.cu`` with nvcc.
3. kernel  — ``minplus_cuda_batch`` against ``minplus_step_ref_batch`` on
             the card over a grid of shapes: bit-identical float32 values
             and identical int32 argmins.
4. main    — solves 16 random instances (n = 100 clients, T = 10,000 tasks,
             W <= 1,001) through ``solve_schedule_dp_batch``: exactly n
             kernel launches, bit-identical to the plain path on the card,
             feasible, within rtol 1e-5 of the float64 host DP; then the
             paper's worked example.
5. times   — kernel and plain-version time per class step, the bound, and
             the warm end-to-end solve time.

The line before the last is a JSON object of every kernel with its launch
count and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
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
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_CANDIDATE = 3  # add, saturating min, compare


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


def bound_ms(B, Tp, W):
    """Least time for one row update: the larger of its bytes (inputs read
    once, outputs written once) over HBM bandwidth and its float32
    operations over the float32 peak. Returns (ms, 'bytes'|'operations')."""
    nbytes = 4 * B * Tp + 4 * B * W + (4 + 4) * B * Tp
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = OPS_PER_CANDIDATE * candidates(B, Tp, W) / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


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
    from repro_torch.core.torch_dp import pack_problem
    from repro_torch.kernels import build
    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels.ref import BIG, minplus_step_ref_batch

    dev = torch.device("cuda")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    mp._launch_fn()
    log(f"[build] minplus.cu built and loaded in {time.perf_counter() - t0:.2f} s ({build.build_dir()})")
    for line in (build.build_dir() / "minplus.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

    # -- phase 3: kernel vs plain version on the card ----------------------
    rng = np.random.default_rng(SEED)
    cases = [(3, Tp, W, None, None, False)
             for Tp in (1, 7, 64, 255, 1024, 1500, 10001) for W in (1, 5, 130, 700, 1001)]
    # explicit tiles: 1, 2, 4 and 8 outputs per thread, odd edges
    cases += [(2, 1500, 700, BT, BW, False)
              for BT, BW in ((1, 1), (33, 7), (256, 64), (600, 100), (2048, 256))]
    cases += [(4, 3000, 400, None, None, True), (2, 1500, 700, 33, 7, True)]  # tie-heavy
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
    for BT, BW in ((None, None), (8, 3)):
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
    log(f"[kernel] {n_ok + 1} cases bit-identical to the plain version (values and argmins); "
        f"main shape B={B_MAIN} Tp={T_MAIN + 1} W={U_MAIN + 1} BT={bt_m} BW={bw_m}, max_abs_err {max_abs_err}")

    # -- phase 4: the main path at full size -------------------------------
    prng = np.random.default_rng(SEED)
    probs = [random_problem(prng, n=N_MAIN, T=T_MAIN, regime="arbitrary", max_upper=U_MAIN)
             for _ in range(B_MAIN)]
    batch = ProblemBatch.from_problems(probs)
    b0 = remove_lower_limits(batch)
    log(f"[main] batch B={batch.B} n={batch.n} T={T_MAIN} W'={b0.W} (after lower-limit removal)")
    mp.launches = 0
    t0 = time.perf_counter()
    X = solve_schedule_dp_batch(batch, device="cuda")
    cold_s = time.perf_counter() - t0
    launches_main = mp.launches
    check(launches_main == batch.n, f"{launches_main} kernel launches in the main solve, expected n={batch.n}")
    validate_schedule_batch(batch, X)
    log(f"[main] solve_schedule_dp_batch: {launches_main} launches (n={batch.n}), first call {cold_s:.3f} s, "
        f"every schedule sums to T and lies in [L, U]")

    costs = pack_problem(b0, dev)
    t_star = torch.from_numpy(b0.T).to(dev)
    Tmax = int(b0.T.max())
    Xc, Kc = solve_fused_batch_torch(costs, t_star, Tmax, backend="cuda")
    Xr, Kr = solve_fused_batch_torch(costs, t_star, Tmax, backend="ref")
    check(torch.equal(Xc, Xr), "schedules differ between the kernel and the plain path")
    check(torch.equal(Kc.view(torch.int32), Kr.view(torch.int32)), "K_last differs between kernel and plain path")
    check(np.array_equal(X, Xc.cpu().numpy().astype(np.int64) + batch.lower), "entry point != fused solver")
    log("[main] X and K_last bit-identical to backend='ref' on the card")

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

    # -- phase 5: times ----------------------------------------------------
    out_k = torch.empty_like(kprev_m)
    out_i = torch.empty(kprev_m.shape, dtype=torch.int32, device=dev)
    kernel_ms = median_event_ms(
        lambda: mp.minplus_cuda_batch(kprev_m, cost_m, out=out_k, iout=out_i), reps=15, per_rep=20)
    clocks = gpu_line("clocks.sm,power.draw")
    plain_ms = median_event_ms(lambda: minplus_step_ref_batch(kprev_m, cost_m), reps=5, per_rep=4)
    b_ms, b_by = bound_ms(B_MAIN, T_MAIN + 1, U_MAIN + 1)
    sweep = []
    for BT in (128, 256, 512, 1024):
        for BW in (128, 256, 512, 1024):
            ms = median_event_ms(
                lambda: mp.minplus_cuda_batch(kprev_m, cost_m, BT=BT, BW=BW, out=out_k, iout=out_i),
                reps=5, per_rep=20)
            sweep.append(f"{BT}x{BW}={ms:.4f}")
    e2e_ms = median_wall_ms(lambda: solve_schedule_dp_batch(batch, device="cuda"), reps=5)
    prep_ms = median_wall_ms(lambda: pack_problem(remove_lower_limits(batch), dev), reps=5)
    device_ms = median_event_ms(
        lambda: solve_fused_batch_torch(costs, t_star, Tmax, backend="cuda"), reps=5, warmup=1)
    log(f"[times] {card}")
    log(f"[times] minplus_cuda per class step (B={B_MAIN}, Tp={T_MAIN + 1}, W={U_MAIN + 1}, "
        f"BT={bt_m}, BW={bw_m}): {kernel_ms:.4f} ms (median of 15 runs of 20 launches; "
        f"clocks.sm, power.draw after: {clocks}); plain version {plain_ms:.4f} ms; "
        f"bound {1e3 * b_ms:.2f} us ({b_by}); library_ms: none")
    log(f"[times] tiles BTxBW=ms at the main shape: {' '.join(sweep)}")
    log(f"[times] warm solve_schedule_dp_batch {e2e_ms:.3f} ms (host clock, median of 5) = "
        f"host lower-limit removal + packing {prep_ms:.3f} ms + device solve {device_ms:.3f} ms "
        f"(CUDA events) + rest; {launches_main} kernel launches per solve; kernel time "
        f"{launches_main * kernel_ms:.3f} ms = {launches_main * kernel_ms / e2e_ms:.3f} of the solve")

    kernels = [{
        "name": "minplus_cuda",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:76",
        "launches": launches_main,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
