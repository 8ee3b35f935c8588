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
                lengths (ragged ones included; at D = 128 also phase 15's
                head counts, H = 48 with Hkv = 1 and H = 16 with Hkv =
                16; and every shape phases 15, 16 and 17 launch), and at the main path's
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
                softcaps, GQA ratios, head dims and lengths (and phases
                16's and 17's training shapes), and at the gemma2-2b training shapes
                (causal and sliding(4096)): float32 at rtol
                3e-4, atol 3e-5; bfloat16 I/O within 2^-8 relative of the
                plain version's float32 gradients plus 1e-5 of their largest
                entry, beside the error one wrongly visited tile would make.
10. train     — gemma2-2b at full width and depth (26 layers, bfloat16,
                remat "full", AdamW, random weights from ``torch.Generator``
                seed 0) takes one cold and three warm steps on one batch of
                B = 1, S = 8,192 tokens through ``build_train_step``: per step
                exactly 52 forward, 26 dQ and 26 dK/dV launches (all on the
                tensor-core route) and one AdamW kernel launch a leaf over
                every parameter (the counters from 0), finite losses
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
13. serve and fleet — (a) ``SchedulerService(max_batch=16,
                max_delay_s=0.002)`` over ``SweepEngine(device="cuda")``:
                ``warm`` of the production bucket over the pow2 ladder (5 plan
                builds), then 64 requests of the main shape (numpy seeds
                100-163) from 4 producer threads: schedules, ``k_last`` and
                objectives bit-identical to ``engine.dispatch`` of each alone,
                no plan build after ``warm``, no flush over 16 rows, no
                failed, retried or degraded flush, one flush of 16 rows = 128
                row kernels and 1 backtrack (profiler); the serial baseline
                and the saturated leg in turns, requests/s, a paced Poisson
                leg at half that rate (p50, p99 latency), one flush step by
                step, the warmed ladder's peak memory; (b)
                benchmarks/bench_serve.py's 200-request stream, plain and
                regime-split, each served schedule the one solved alone; (c)
                benchmarks/bench_fleet.py's throughput instance (n = 2,048,
                T = 8,192, U <= 64) through ``Solver(device="cuda").solve_fleet``:
                valid, the reference's cluster and quantum rules, k-means
                labels as on the CPU, the same through
                ``service.submit_fleet``; the flat exact DP of the instance in
                one host call (2,048 row launches), the fleet within its
                certified gap of it; the card identical to ``device="cpu"``
                at n = 512 (the CPU leg cut to bench_fleet.py::run's size);
                bench_fleet.py's gap cases (singleton clusters at q = 1
                exact); the warm fleet solve by stage and the warm flat DP.
14. FL runtime — (a) the FL launcher (``repro_torch.launch.train``) with its
                defaults on gemma2-2b FULL (26 layers, bfloat16, remat "full",
                random weights from ``torch.Generator`` seed 0): 6 clients,
                10 rounds of Σ max_batches / 2 SGD steps of batch 4 x 32
                tokens, clients one after another on the card: every round's
                schedule, estimated and true energy and makespan identical to
                the same campaign planned with ``SweepEngine(device="cpu")``,
                finite losses, the first client's round-1 parameters from
                ``local_train`` bit-identical to the same SGD steps written
                out here, round 1's aggregate within one bfloat16 ulp of
                Σ w_i p_i formed in float64 (the embedding and layer 0); the
                round's wall time by stage (plan, train by CUDA events,
                account, scenarios), client tokens/s, peak memory, min-plus
                launches per round; (b) bench_async.py's campaign (toy LM, 12
                clients, 6 rounds, 4 workloads and 4 dropouts of what-if
                scenarios a round) serial, pipelined, pipelined, serial:
                bit-identical schedules, losses, energies and scenario
                reports, equal to the CPU's (losses within rtol 1e-5), no
                plan build after round 1, the overlap fraction and the main
                thread's waits; and a fresh engine's first plan built and
                captured on another thread while the main thread enqueues a
                round of client training (schedules as the CPU's, the round
                bit-identical to one trained alone); (c) bench_faults.py's chaos campaign (10
                clients, 10 rounds): serial and pipelined bit-identical,
                every recovery the independent solve of its residual
                instance, and a campaign killed after round 4 and resumed
                from ``save_campaign_checkpoint`` bit-identical to the
                uninterrupted one.
15. LM serve  — (a) ``launch/serve.py``'s loop at its defaults (B = 4,
                prompt 32, gen 16) on gemma2-2b FULL (bfloat16, random
                weights from ``torch.Generator`` seed 0): no flash launch
                in decode; a teacher-forced decode of the prompt and the
                generated tokens against the kernel-route prefill of the
                same tokens, each position within DECODE_REL_L2 (relative
                L2 over the vocabulary), the greedy tokens equal to the
                prefill's argmax wherever its top-2 gap exceeds twice the
                largest deviation, the cache on the same storage every
                step; a 2-layer float32 cut within rtol = atol = 2e-3;
                (b) a cache of 8,320 slots filled by a kernel prefill of
                B = 4 x 8,192 tokens (26 launches), 128 greedy steps (the
                sliding layers on their windowed slice) against a kernel
                prefill of all 8,320 tokens: decode ms a token and tokens/s
                at steady state, the profiler's device time and launches of
                one step, the cache's size, peak memory, the bound;
                (c) olmoe-1b-7b FULL: a kernel prefill of B = 2 x 4,096
                (16 launches, every expert on every token), the launcher's
                loop with the einsum dispatch and (a)'s checks, the
                (position, layer) pairs whose experts differ between decode
                and prefill, the decode against a prefill routed to the
                decode's experts, a 2-layer float32 cut; (d)
                deepseek-v3-671b at full width cut to 2 layers (1 dense
                prefix): a prefill of 1,024 tokens (MLA on the kernels, v
                zero-padded to q's head dim 192, both run at 256),
                16 absorbed-decode steps at the last positions against it;
                (e) granite-20b and minitron-8b FULL: a kernel prefill of
                8,192 tokens (52 and 32 launches; G = 48 and 4) and 16
                teacher-forced decode steps against it; in every part, the
                first flash launch of each shape held against the plain
                version on its own inputs (a shape phase 6 did not hold
                fails); the phase's wall time.
16. ssm       — the SSM families at full width and depth (bf16, random
                weights from ``torch.Generator`` seed 0): (a) xlstm-1.3b, a
                prefill of 1,024 tokens through ``build_prefill_step``, one
                layer's sLSTM scan alone on the prefill's own inputs (its
                share of the prefill's kernel time by the profiler, its
                launches and host cost); (b) zamba2-2.7b, a prefill of 8,192
                tokens (9 flash launches, D = 80 on the D = 128 tensor-core
                kernels, the last position against the plain route). Each:
                the bf16 prefill against the same weights in float32; a
                collect-state prefill of S - 256 tokens, then 16
                teacher-forced decode steps against the prefill (within
                max(0.1, the prefill's own float32 distance)); the serve
                step's ms a token by CUDA events, busy share, launches and
                bound; a float32 cut (8 and 12 layers) within 2e-3, and
                zamba2's flash route within 1e-4 of the plain route; one
                cold and two warm train steps (remat full, AdamW; 512 and
                4,096 tokens; zamba2 18 forward, 9 dQ and 9 dK/dV launches
                each, all tensor-core), losses falling, peak memory, the last
                step's busy share by the profiler. Every flash launch's shape
                must be one phases 6 and 9 held, and its first launch is held
                on its own inputs. Then the forward, dQ and dK/dV at
                zamba2's shapes beside their D = 80 bounds and
                ``scaled_dot_product_attention``; the phase's wall time.
17. encoder and VLM — full width and depth (bf16, random weights from
                ``torch.Generator`` seed 0, batches from
                ``make_dummy_batch`` with numpy seed 0): (a) hubert-xlarge
                on the kernel route, an encode of 4 x 4,096 frames
                through ``build_prefill_step`` (48 forward launches, all
                tensor-core, bidirectional, D = 80 on the D = 128 kernels):
                ms and frames/s cold and warm, the flash kernels' share of
                the kernel time, busy share, peak memory; sequence 0
                against the plain route (relative L2 within 0.1); 2 layers
                in float32 against the plain route at 1e-4; three train
                steps (remat full, AdamW, masked prediction) at 2 x 4,096
                frames, each 96 forward, 48 dQ and 48 dK/dV launches, all
                tensor-core, the loss after them below the first; 2 float32
                layers of loss and gradients against the plain route
                (phase 11's limits); the kernels at hubert's shapes beside
                their D = 80 bounds and ``scaled_dot_product_attention``.
                (b) paligemma-3b, attention on the plain route under its
                prefix mask (no flash launch): a prefill of 2 x (256 patches
                + 7,936 text tokens), its ms, peak memory and the prefix
                attention's share of the kernel time; one layer's image rows
                against a bidirectional attention over the image block
                (float32, 2e-5); 16 teacher-forced decode steps after a
                collect-cache prefill, against the prefill (relative L2
                within 0.1; a 2-layer float32 cut within 2e-3; the cache on
                the same storage every step), the decode step's ms and
                bound; three train steps at 8,192 positions; the serve
                launcher's defaults, tokens/s. Every flash launch's shape
                must be one phases 6 and 9 held, and its first launch is
                held on its own inputs; the phase's wall time.
18. multi-device sweeps — the sweep engine over a sweep mesh that one
                process drives, at the main shape of phase 4: (a) the batch
                axis over ``make_sweep_mesh()`` (every card) and over the
                card repeated 4 times (one CUDA graph per position, each on
                its own stream): X and K_last identical to the unsharded
                engine, the same ``cache_stats()``, 128 row launches and one
                backtrack per position a solve; (b) the class ring over 4
                positions of the card (every turn in one graph), there and
                at bench_fleet.py's flat shape (n = 2,048, T = 8,192, U <=
                64): X and K_last bit-identical to the unsharded engine and
                to ``solve_fused_batch_torch``, n_b row launches and 4
                backtracks a solve; warm solve and graph replay in turns
                with the unsharded engine, slab bytes a position, peak and
                reserved memory; (c) the
                backtrack launched alone (``minplus_backtrack_cuda``) on the
                ring's slabs against ``backtrack_ref``, and its time; (d) the
                fleet on the ring engine at quantum 1 against the flat DP,
                and bench_fleet.py's instance against the unsharded engine.
19. distributed — the LM zoo over ``torch.distributed``: an NCCL process
                group of world size 1 on the card (a ``FileStore`` under
                ``build/``), ``make_smoke_mesh((1, 1))`` on "cuda", every
                tensor a DTensor placed by the logical-axis rules: (a)
                gemma2-2b FULL, phase 10's shape, 2 sharded train steps
                (``act_seq`` on "model", the flash kernels on local shards
                under ``local_map``) against the unsharded steps from the
                same parameters: losses within 2e-4, every parameter within
                rtol 3e-3, atol 3e-4 (the reference's limits), 52 forward,
                26 dQ and 26 dK/dV tensor-core launches a step; both steps
                in turns by CUDA events, peak memory and busy share; (b)
                olmoe-1b-7b FULL, one MoE layer in float32 at capacity 4.0
                on 4 x 2,048 tokens: ``moe_impl="a2a"`` (the exchange over
                NCCL) within 2e-4 of dense, einsum beside them, the three
                timed; a bf16 prefill with a2a, its first flash launch
                held against the plain version on its own inputs (a shape
                phase 6 holds), its relative L2 from the same weights in
                float32 within 1.05 x dense's, a2a against dense printed;
                (c) gemma2-2b FULL serve at phase 15 (b)'s
                shape: the cache placed by ``cache_pspecs``, 16 greedy
                tokens identical to the unsharded serve step's, the cache's
                local storage written in place, ms a token of both in turns;
                (d)-(h) the rest of the zoo, each sharded against unsharded
                from the same parameters, equal exactly at world size 1
                (every leaf placed by the spec functions), then in turns
                with busy share, launches and peak memory: (d) xlstm-1.3b
                cut to 8 layers, prefill and train, one ``local_map`` per
                sLSTM scan; (e) zamba2-2.7b cut to 12 layers, prefill,
                train and 16 serve tokens after a collect-state prefill;
                (f) hubert-xlarge encode and train, paligemma-3b prefill,
                train and 16 serve tokens, granite-20b cut to 4 layers
                (one KV head) prefill; (g) olmoe-1b-7b cut to 4 layers, a2a
                train steps against dense, and a float32 cut of 2 held to
                the reference's limits; (h) gemma2-2b FULL's train step
                under Adafactor (DTensor state), deepseek-v3 at 2 layers,
                a prefill with a2a over the flattened ("data", "model")
                group held by its float32 distance as (b)'s.
20. dry run   — the roofline's per-device counts (the constants' comment
                before ``DRYRUN_COMBOS``).
21. remat     — ``remat="dots"`` (the products without batch dims saved,
                the rest recomputed) against ``"full"``: (a) gemma2-2b
                FULL at phase 10's shape on the kernel route, the same
                weights and batch: REMAT_STEPS steps each, the first
                step's loss and the parameters after it (one AdamW step)
                within phase 11's limits, 52 forward, 26 dQ and 26 dK/dV
                launches a step under both (the launch counters from 0 for
                each), the warm steps' ms, the peak memory allocated and
                reserved and the allocator's retries of each; the float32 2-layer cut under
                "dots" against "none" (phase 11's limits); (b) the
                hill-climb (``python -m repro_torch.launch.hillclimb``) of
                deepseek-7b train_4k on the "cuda" fake pod mesh under
                ``baseline`` and ``remat_dots``, in subprocesses started at
                the phase's start, each within REMAT_CLIMB_TIMEOUT s: the
                three terms of each, ``remat_dots``'s FLOPs below
                ``baseline``'s; the phase's wall time.
22. examples  — the port's ``examples_torch/``: (a) ``python
                examples_torch/quickstart.py`` as a user starts it (a
                subprocess, no arguments): exit 0 and its result lines;
                (b) quickstart, heterogeneous_cluster and carbon_aware in
                process on the card, cold (the engines reset) and warm, then
                with ``--device cpu``: every printed line identical to the
                CPU's, the quickstart's k-means labels, allocations and
                schedule identical; min-plus row and backtrack launches
                equal to the engine dispatches' buckets (n_b rows and one
                backtrack each), the same warm as cold; plan builds and
                wall times; (c) fl_energy_training at its docstring's
                scaled size (EXAMPLE_FL_ARGV; 40 rounds, not 300, with
                ``--compare``), then with ``--frontier-mode knee`` for 10
                rounds: every round's schedule and energy identical to the
                same campaigns planned on the CPU (training stubbed), losses
                finite and the last below round 0's, the optimised
                campaign's energy below the uniform one's, min-plus launches
                on every knee round and on no "auto" or uniform round;
                client tokens/s, round wall time, peak memory.
23. adamw     — AdamW's leaf kernel (``kernels/csrc/adamw.cu``) against its
                plain version on the card, bit for bit (the update, mu, nu
                and the parameters after it), at deepseek-7b's head (102,400
                x 4,096; bf16 parameters and mu, float32 nu) and at a
                layer's w1 (4,096 x 11,008; bf16 or float32 parameters, mu
                bf16 or float32), steps 1, 2, 3 and 10,000, weight decay
                0.1; then its ms a launch at both beside its bound (the
                bytes it moves: 18 an element), the plain version and
                ``torch._fused_adamw_``.
24. deepseek-v3 — the benchmark cell ``deepseek-v3.train-4k``
                (``perfbench/``): (a) its attention launch, B = 1, H =
                128, S = 4,096, q/k head dim 192 and v 128, bf16, through
                ``models/layers.py::attention`` (the flash route pads all
                three to the 256 instance): one forward, one dQ and one
                dK/dV launch on the tensor cores; the launch's output and
                lse against the plain version on its own padded inputs
                (phase 6's limits), the padded output columns zero, the
                gradients against the plain backward on those inputs (phase
                9's limits), and the output and gradients against the plain
                route at the true head dims in float32 within 2e-2; (b)
                two train steps of the cell's configuration from its seed
                (``perfbench/modes/train_v3.py::build``: 5 layers at the
                published widths, 8 of 256 experts held, bf16, remat
                "full", AdamW), the launch counters set to 0 before each:
                10 forward, 5 dQ and 5 dK/dV launches a step, all on the
                tensor cores, no attention on the plain route, finite
                losses, the held route's pairs a MoE layer and pass with
                none dropped, the router biases bit for bit, the step's
                wall time and peak memory.

The line before the last is a JSON object of every kernel with its launch
count and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import gc
import io
import json
import math
import os
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
# The head counts phase 15 prefills through the kernel at D = 128: granite-20b
# (H = 48, MQA: G = 48) and olmoe-1b-7b (H = 16, G = 1): (B, H, Hkv, S, kind).
SERVE_HEAD_CASES = ((1, 48, 1, 1024, "causal"), (2, 48, 1, 200, "bidirectional"), (2, 16, 16, 1024, "causal"),
                    (1, 16, 16, 200, "causal"))
# Every forward launch phase 15 makes, (B, H, Hkv, S, D, kind, window,
# softcap) as the models pass them: gemma2-2b (H = 8, Hkv = 4, D = 256,
# softcap 50; its global layers pass the window too, which "causal" ignores)
# at (a)'s 4 x 48 tokens and (b)'s cache-filling 4 x 8,192 and check 4 x
# 8,320; olmoe-1b-7b (c) at 2 x 4,096 and 4 x 48; deepseek-v3's dense prefix
# layer (d), H = Hkv = 128 at 1 x 1,024, and its MLA layer, whose q/k head dim
# 192 and v head dim 128 run zero-padded at 256; granite-20b (G = 48) and
# minitron-8b (G = 4) (e) at 1 x 8,192. Phase 6 holds the kernel at each, in
# bfloat16 and float32; phase 15 fails on a launch at a shape not listed.
SERVE_FLASH_CASES = tuple(
    (B, 8, 4, S, 256, kind, 4096, 50.0) for B, S in ((4, 48), (4, 8192), (4, 8320)) for kind in ("sliding", "causal")
) + ((2, 16, 16, 4096, 128, "causal", 0, 0.0), (4, 16, 16, 48, 128, "causal", 0, 0.0),
     (1, 128, 128, 1024, 128, "causal", 4096, 0.0), (1, 128, 128, 1024, 256, "causal", 0, 0.0),
     (1, 48, 1, 8192, 128, "causal", 4096, 0.0),
     (1, 32, 8, 8192, 128, "causal", 4096, 0.0))
# Phase 16's flash launches: zamba2-2.7b's shared block, H = Hkv = 32 and D =
# 2560 / 32 = 80, which runs on the D = 128 instances on zero-padded inputs;
# the layers pass the config's window 4096, which "causal" ignores. Forward:
# the prefill of ZAMBA_S tokens, the collect-state prefill of its first
# ZAMBA_S - SSM_CHUNK, and the training step's ZAMBA_TRAIN_S; backward: the
# training step's. Phase 6 holds each forward shape and phase 9 each backward
# shape, in bfloat16 and float32; phase 16 fails on a launch at a shape not
# listed.
SSM_CHUNK, ZAMBA_S, ZAMBA_TRAIN_S = 256, 8192, 4096
SSM_FLASH_CASES = tuple((1, 32, 32, S, 80, "causal", 4096, 0.0) for S in (ZAMBA_S, ZAMBA_S - SSM_CHUNK, ZAMBA_TRAIN_S))
SSM_FLASH_BWD_CASES = ((1, 32, 32, ZAMBA_TRAIN_S, 80, "causal", 4096, 0.0),)
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
# The profiler's device times (phases 5, 12, 13): the wrapper counter
# (repro_torch.kernels.minplus) that counts each profiled kernel's launches,
# the sessions a measurement may take when the profiler misses records
# (device_ms_by), and the sessions run again per kernel, for the kernels line.
PROFILED_COUNTERS = {"minplus_row_kernel": "launches", "minplus_backtrack_kernel": "launches_backtrack"}
PROFILER_SESSIONS = 3
# The host time each profiler window of device_ms_by spends idle before its
# first call and after its last synchronize (its docstring says why).
PROFILER_MARGIN_S = 0.05
PROFILER_RERUNS = dict.fromkeys(PROFILED_COUNTERS, 0)
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
# Phase 13: (a) production traffic through the scheduling service: requests
# of the main shape (one instance each, numpy seeds SERVE_SEED0, +1, ...)
# from SERVE_PRODUCERS threads, flushed at SERVE_MAX_BATCH rows or
# SERVE_DELAY_S; (b) benchmarks/bench_serve.py's three request families, a
# stream of SERVE_STREAM requests (numpy seed 0); (c)
# benchmarks/bench_fleet.py's throughput instance (n = FLEET_N clients, T =
# 4n, U <= FLEET_UPPER, numpy seed FLEET_SEED, k-means seed 0), its CPU
# comparison cut to bench_fleet.py::run's n = FLEET_CPU_N (at n = 2,048 the
# CPU's DP would take most of a minute), and bench_fleet.py's gap cases
# (seed, n, T, clusters, quantum).
SERVE_REQUESTS, SERVE_PRODUCERS, SERVE_SEED0 = 64, 4, 100
SERVE_MAX_BATCH, SERVE_DELAY_S = 16, 0.002
SERVE_FAMILIES = (
    dict(n=8, T_lo=65, T_hi=128, u_lo=16, u_hi=31),
    dict(n=16, T_lo=33, T_hi=64, u_lo=4, u_hi=15),
    dict(n=4, T_lo=65, T_hi=128, u_lo=32, u_hi=63),
)
SERVE_STREAM = 200
FLEET_N, FLEET_CPU_N, FLEET_SEED, FLEET_UPPER = 2048, 512, 42, 64
FLEET_GAP_CASES = ((0, 16, 40, 16, 1), (1, 32, 80, None, None), (2, 48, 120, 6, 2), (3, 64, 160, None, None),
                   (4, 64, 192, 8, 3))
# Phase 14: (a) the FL launcher with its defaults on gemma2-2b FULL (6
# clients, seq 32, batch 4, max-batches 8, lr 0.1, sgd, algorithm "auto", seed
# 0, 10 rounds); (b) benchmarks/bench_async.py's full configuration and (c)
# benchmarks/bench_faults.py's, both on the toy LM of the JAX package's
# fl/toy.py (vocabulary, width, sequence length as there, weights from
# torch.Generator seed FL_TOY_PARAMS_SEED): (clients, max_batches, batch,
# rounds, seed). (c) kills its campaign after FL_KILL_AFTER rounds and
# resumes it from the checkpoint; its fault plan is bench_faults.py's.
FL_LAUNCH_ARGV = ("--arch", "gemma2-2b", "--full")
FL_TOY = (256, 64, 16)
FL_TOY_PARAMS_SEED = 1
FL_ASYNC = (12, 48, 8, 6, 0)
FL_FAULTS = (10, 48, 8, 10, 0)
FL_FAULT_RATES = dict(p_crash=0.25, p_straggle=0.2)
FL_KILL_AFTER = 4
# toy-LM losses, the card against the CPU (float32, no TF32, summed in
# another order over some 200 SGD steps a round)
FL_LOSS_RTOL = 1e-5
# Phase 15: (a) launch/serve.py's defaults (B, prompt, gen) on ARCH FULL; (b)
# long context: B sequences, a cache filled by a kernel prefill of S tokens,
# G greedy steps (S + G > 2 x window, so the sliding layers take their
# windowed slice); (c) MOE_ARCH FULL, a prefill of (B, S); (d) MLA_ARCH at
# full width cut to MLA_CUT (671 B parameters fit no single card), prefill
# of MLA_S tokens; (e) DENSE_ARCHS FULL, prefill of DENSE_S tokens; (d) and
# (e) decode the last TF_STEPS positions teacher-forced against the prefill.
SERVE_SHAPE = (4, 32, 16)
LONG_SHAPE = (4, 8192, 128)
MOE_ARCH, MOE_PREFILL = "olmoe-1b-7b", (2, 4096)
MLA_ARCH, MLA_CUT, MLA_S = "deepseek-v3-671b", dict(num_layers=2, dense_prefix_layers=1), 1024
DENSE_ARCHS, DENSE_S = ("granite-20b", "minitron-8b"), 8192
TF_STEPS = 16
# Decode logits against prefill logits of the same positions, bfloat16:
# relative L2 over the vocabulary at each position. The two compute the same
# function with different roundings: the decode step's products run at M = B
# rows, the prefill's at M = B x S (cuBLAS picks other tilings and summation
# orders), the decode attention rounds the probabilities to bfloat16 before
# the value product where the kernel rounds P per tile, and each bfloat16
# output rounds once; so each sublayer's output differs by about one
# bfloat16 ulp (2^-8 relative), and over 2L sublayers these add as a random
# walk: sqrt(52) x 2^-8 = 0.028 for gemma2-2b, sqrt(104) x 2^-8 = 0.040 for
# granite-20b. The limit leaves a factor 2.5 over the deepest; a wrong
# position, cache slot, window slice or mask moves the logits by O(1).
DECODE_REL_L2 = 0.1
# The float32 cut: the reference's test_decode_matches_prefill tolerance.
DECODE_F32_TOL = 2e-3
# Phase 16: the SSM families at full width and depth, bfloat16, random
# weights from torch.Generator seed SEED: (a) xlstm-1.3b, (b) zamba2-2.7b
# (attn_impl "flash"). Each: a prefill of B = 1 x SSM_S tokens; a
# collect-state prefill of its first S - SSM_CHUNK tokens (the chunked cells
# need a multiple of the chunk, so a decode cannot start TF_STEPS before the
# end), then TF_STEPS teacher-forced decode steps at positions S - SSM_CHUNK
# .. against the prefill's logits there; the same in float32 at
# SSM_F32_LAYERS layers (DECODE_F32_TOL); SSM_TRAIN_STEPS train steps (remat
# "full", AdamW; one cold) at B = 1 x SSM_TRAIN_S tokens. The bfloat16 decode
# is held within max(DECODE_REL_L2, r) of the bfloat16 prefill, where r is
# the bfloat16 prefill's own relative L2 from the same weights run in
# float32 at those positions: DECODE_REL_L2's random walk of one bfloat16
# ulp a sublayer assumes sublayers that pass a perturbation on at about its
# size, and xLSTM's exponential gates and normaliser amplify it, so there
# rounding alone can exceed 0.1 (the phase prints r); a decode that differs
# from its prefill by less than the prefill differs from float32 is within
# rounding, while a wrong state or position moves the logits by O(1).
SSM_ARCHS = ("xlstm-1.3b", "zamba2-2.7b")
SSM_S = {"xlstm-1.3b": 1024, "zamba2-2.7b": ZAMBA_S}
SSM_TRAIN_S = {"xlstm-1.3b": 512, "zamba2-2.7b": ZAMBA_TRAIN_S}
SSM_F32_LAYERS = {"xlstm-1.3b": 8, "zamba2-2.7b": 12}
SSM_TRAIN_STEPS = 3
# xlstm-1.3b's lengths are the shortest that still cross a chunk: its
# Python sLSTM scan issues about 25 launches a token, so its share of the
# script's time limit grows with the length.
# Phase 17: the encoder and VLM families at full width and depth, bfloat16,
# random weights from torch.Generator seed SEED, batches from
# make_dummy_batch (numpy seed SEED). (a) hubert-xlarge with attn_impl
# "flash" (every layer's bidirectional attention on the tensor-core kernels,
# D = 80 on the D = 128 instances, zero-padded): an encode of HUBERT_ENCODE
# = (B, frames) (4,096 frames are 82 s of 16 kHz audio at HuBERT's 20 ms
# frame rate), its first sequence against the plain route (PREFILL_REL_L2)
# and F32_LAYERS layers in float32 against the plain route at the first two
# sequences; ENC_TRAIN_STEPS train steps (remat "full", AdamW, masked
# prediction at the batch's mask; one cold) at HUBERT_TRAIN, cut from the
# reference's pod batch of 256 x 4,096 to one card, and F32_LAYERS layers of
# its loss and gradients in float32 (phase 11's limits). (b) paligemma-3b,
# whose attention takes the plain route under its prefix mask, as in the
# reference: a prefill of PALI_PREFILL = (B, positions), its num_patches
# image patches and the rest text (gemma2-2b's prefill length); a
# collect-cache prefill of all but the last TF_STEPS text tokens, then
# TF_STEPS teacher-forced decode steps against the prefill (DECODE_REL_L2),
# and the same in float32 at F32_LAYERS layers (DECODE_F32_TOL); one layer's
# image rows against a bidirectional attention over the image block;
# ENC_TRAIN_STEPS train steps at PALI_TRAIN; launch/serve.py's defaults.
# (a)'s flash launches: the encode at B = 4, the train step and the float32
# cuts at B = 2; the layers pass the config's window 4096, which
# "bidirectional" ignores. Phase 6 holds each forward shape and phase 9 the
# backward shape, in bfloat16 and float32; phase 17 fails on a launch at a
# shape not listed, and on any flash launch in (b).
HUBERT_ARCH, HUBERT_ENCODE, HUBERT_TRAIN = "hubert-xlarge", (4, 4096), (2, 4096)
PALI_ARCH, PALI_PREFILL, PALI_TRAIN = "paligemma-3b", (2, 8192), (1, 8192)
ENC_TRAIN_STEPS = 3
ENC_FLASH_CASES = tuple((B, 16, 16, 4096, 80, "bidirectional", 4096, 0.0) for B in (4, 2))
ENC_FLASH_BWD_CASES = ((2, 16, 16, 4096, 80, "bidirectional", 4096, 0.0),)
# Phase 18: the sweep engine over a sweep mesh, one process driving every
# position. (a) the batch axis over the machine's real mesh
# (make_sweep_mesh(): each card) and over the card repeated MESH_POSITIONS
# times, at the main shape; (b) the class ring over MESH_POSITIONS positions
# of the card at the main shape and at benchmarks/bench_fleet.py's flat shape
# (n = FLEET_N, T = 4n, U <= FLEET_UPPER, numpy seed FLEET_SEED); (c) the
# backtrack launched alone on the ring's slabs; (d) the fleet on the ring
# engine at quantum 1, the reference test's instance (numpy seed, n, T,
# clusters), and bench_fleet.py's instance at its defaults.
MESH_POSITIONS = 4
RING_FLEET = (3, 16, 40, 4)
# Phase 19: the LM zoo over torch.distributed, an NCCL process group of
# world size 1 on the card and a (1, 1) ("data", "model") DeviceMesh. (a)
# gemma2-2b FULL sharded train step at phase 10's shape, DIST_TRAIN_STEPS
# steps against the unsharded step from the same parameters, then
# DIST_TIMING_ROUNDS rounds of both in turns; (b) olmoe-1b-7b FULL: one MoE
# layer's moe_ffn in float32 at capacity 4.0 on DIST_MOE tokens (a2a, dense,
# einsum), then a bf16 prefill at that shape, a2a against dense; (c)
# gemma2-2b FULL sharded serve step at phase 15 (b)'s shape, DIST_SERVE_G
# greedy tokens against the unsharded serve step's.
DIST_TRAIN_STEPS = 2
DIST_TIMING_ROUNDS = 2
DIST_MOE = (4, 2048)
DIST_MOE_CAPACITY = 4.0
DIST_SERVE_G = 16
DIST_LOSS_ATOL = 2e-4  # the reference's limits (tests/test_distribution.py)
DIST_PARAM_TOL = dict(rtol=3e-3, atol=3e-4)
DIST_MOE_ATOL = 2e-4
DIST_PREFILL_REL_L2 = 2e-2
# (b)'s bf16 a2a prefill is held by its distance from the same weights in
# float32: at most DIST_PREFILL_F32_RATIO times the dense prefill's. Both are
# bf16 evaluations of one float32 function; a wrong dispatch moves a2a's.
DIST_PREFILL_F32_RATIO = 1.05
# (b)'s flash launches: olmoe-1b-7b (H = Hkv = 16, D = 128) at DIST_MOE's
# tokens. Phase 6 holds the kernel there in both dtypes; (b) fails on a
# launch at a shape not listed.
DIST_FLASH_CASES = ((DIST_MOE[0], 16, 16, DIST_MOE[1], 128, "causal", 0, 0.0),)
# Phase 19's backward launches: (g)'s olmoe-1b-7b train steps at DIST_MOE's
# tokens, in float32 and bfloat16, and (h)'s gemma2-2b train step at phase
# 10's shape (bfloat16). Phase 9 holds each shape against the plain
# backward (the first in both dtypes, the second among its training
# shapes); a part fails on a backward launch at a shape not listed.
DIST_FLASH_BWD_CASES = DIST_FLASH_CASES
DIST_TRAIN_FLASH_BWD_CASES = ((B_TRAIN, 8, 4, S_TRAIN, 256, "causal", 0, 50.0),
                              (B_TRAIN, 8, 4, S_TRAIN, 256, "sliding", 4096, 50.0))
# Phase 19 (d)-(h): the rest of the zoo on the same mesh, bfloat16 at full
# width, each run sharded (DTensors placed by param_pspecs, batch_pspecs,
# cache_pspecs and Adafactor's opt_state_pspecs) and unsharded from the
# same parameters: at world size 1 every redistribution is a no-op, so the
# two must agree exactly (the maximum difference is printed), then both are
# timed in turns (unsharded, sharded, sharded, unsharded) x DIST_ZOO_ROUNDS
# and each profiled once. Depth is cut where time or
# memory forces it: (d) xlstm-1.3b at DIST_XLSTM_LAYERS (one group of 7
# mLSTM blocks and the sLSTM block), prefill DIST_XLSTM_PREFILL, train
# DIST_XLSTM_TRAIN; (e) zamba2-2.7b at DIST_ZAMBA_LAYERS (two shared-block
# applications), prefill of ZAMBA_S, train at ZAMBA_TRAIN_S, DIST_SERVE_G
# serve tokens after a collect-state prefill of ZAMBA_S - SSM_CHUNK (the
# flash shapes of phase 16, SSM_FLASH_CASES); (f) hubert-xlarge encode
# HUBERT_ENCODE and train HUBERT_TRAIN; paligemma-3b prefill PALI_PREFILL,
# train PALI_TRAIN and DIST_SERVE_G serve tokens after a prefill of its
# first PALI_PREFILL positions at B = DIST_PALI_SERVE_B; granite-20b at
# DIST_GRANITE_LAYERS, prefill DENSE_S (one KV head: the singleton-shard
# repair); (g) olmoe-1b-7b at DIST_OLMOE_LAYERS, DIST_TRAIN_STEPS sharded
# a2a train steps (AdamW) at DIST_MOE against the unsharded (dense) ones,
# a timing run whose losses are printed, and a float32 cut of
# DIST_OLMOE_F32_LAYERS layers whose a2a step is held to the reference's
# limits against the dense step; every train step's flash launches,
# forward and backward, are held to phase 6's and phase 9's shapes and
# against the plain versions on their own inputs; (h) gemma2-2b FULL's
# train step (phase 10's shape) under Adafactor, every state leaf a DTensor
# placed by opt_state_pspecs, and deepseek-v3 at MLA_CUT, prefill of MLA_S
# tokens with moe_impl "a2a" at capacity DIST_MLA_CAPACITY under expert =
# ("data", "model") (a flattened group of one), held by (b)'s float32 ratio
# against the dense dispatch (the float32 reference: the same weights
# widened on the card from a host copy, the dense dispatch). At random
# init the router sends about half of the 1,024 tokens to one of the 256
# experts, so a2a's per-expert buffers need that capacity to drop nothing
# (checked against the largest load). A deepseek-v3 train step holding
# every expert fits no card (one MoE layer's 256 experts are 11.3 B
# parameters); phase 24 trains the benchmark cell's share (8 experts a MoE
# layer, moe_impl "held"), and the sharded step runs at 8 CPU ranks in
# tests/test_torch_distribution_zoo.py.
DIST_XLSTM_LAYERS, DIST_XLSTM_PREFILL, DIST_XLSTM_TRAIN = 8, (1, 1024), (1, 512)
DIST_ZAMBA_LAYERS = 12
DIST_GRANITE_LAYERS = 4
DIST_PALI_SERVE_B = 1
DIST_OLMOE_LAYERS, DIST_OLMOE_F32_LAYERS = 4, 2
DIST_MLA_CAPACITY = 8.0
DIST_ZOO_ROUNDS = 1  # (d)-(h)'s turns: one round keeps the script within 850 s
# Phase 19 (i): olmoe-1b-7b cut to DIST_OLMOE_LAYERS layers decoding with
# the einsum dispatch at the dry run's decode_32k batch (B =
# DIST_EINSUM_B: 28 slots an expert, which a 16-wide mesh axis does not
# divide), from a random KV cache at position DIST_EINSUM_POS: one decode's
# logits and DIST_SERVE_G greedy tokens sharded (the dispatch under
# local_map, the experts' weights DTensors) against unsharded, identical at
# world size 1, then a token in turns.
DIST_EINSUM_B, DIST_EINSUM_POS = 128, 1024
# Phase 20: the dry run. (a) Four combos of the reference's dry run on the
# production mesh, (data, model) = (16, 16) over a fake process group of 256
# ranks: gemma2-2b train_4k, olmoe-1b-7b prefill_32k (MoE a2a) and
# decode_32k (the einsum dispatch), xlstm-1.3b prefill_32k (the sLSTM scan
# and the mLSTM chunks counted by their trip counts), each ``python -m
# repro_torch.launch.dryrun`` in its own process (it opens the default
# process group), all at once and beside (b) and (c), each within
# DRYRUN_TIMEOUT s of the phase's start, also counting the same step
# unsharded. (b) The counter on the card: gemma2-2b FULL at phase 10's
# shape on the plain route, unsharded; its FLOPs and bytes from the fake
# trace must equal those of the same step run on the card, and DRYRUN_STEPS
# timed steps (CUDA events) are printed beside the roofline's terms. (c)
# The trip count held on the card: xlstm-1.3b at full width cut to
# DRYRUN_TRIP_LAYERS layers (one group of 7 mLSTM blocks and the sLSTM
# block), prefill and train step at DRYRUN_TRIP (1,024 steps of the sLSTM
# scan, 4 mLSTM chunks of 256), counted on the card (every step runs) and
# by the fake trace (the steps between the first and the last run once):
# FLOPs, bytes and collective bytes equal.
DRYRUN_COMBOS = (("gemma2-2b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"), ("olmoe-1b-7b", "decode_32k"),
                 ("xlstm-1.3b", "prefill_32k"))
DRYRUN_TIMEOUT = 170
DRYRUN_STEPS = 3
DRYRUN_TRIP_ARCH, DRYRUN_TRIP_LAYERS, DRYRUN_TRIP = "xlstm-1.3b", 8, (1, 1024)
# Phase 21: remat="dots" (the header). REMAT_STEPS steps under each remat,
# the first held, the rest timed; (b)'s hill-climb combos and their limit.
REMAT_STEPS = 4
REMAT_CLIMB = ("deepseek-7b", "train_4k", ("baseline", "remat_dots"))
REMAT_CLIMB_TIMEOUT = 120
# Phase 22: the port's examples (the header). (c)'s size: the FL example's
# docstring's scaled model (8 layers, d_model 320, vocab 8,192) over 8
# clients, 40 rounds with the uniform baseline, then 10 in frontier mode.
EXAMPLE_SCHEDULERS = ("quickstart", "heterogeneous_cluster", "carbon_aware")
EXAMPLE_FL_ARGV = ("--layers", "8", "--d-model", "320", "--vocab", "8192", "--clients", "8", "--batch", "4", "--seq",
                   "64")
EXAMPLE_FL_RUNS = {"compare": ("--rounds", "40", "--compare"), "knee": ("--rounds", "10", "--frontier-mode", "knee")}
EXAMPLE_TIMEOUT = 300
# Phase 23: AdamW's leaf kernel at the two largest leaf shapes of a
# deepseek-7b train step (its head, and a layer's gated-SiLU w1), held bit
# for bit against its plain version over ADAMW_STEPS (the bias corrections
# near 1 at the last) with the weight decay ADAMW_WD, in each dtype pair
# (parameters and gradients, first moment; the second is float32) of
# ADAMW_PAIRS at w1 and in the first at the head, where it is then timed.
# Its bound: the bytes it reads and writes (18 an element in the first
# pair) over PEAK_BYTES_PER_S.
ADAMW_LEAVES = {"head": (102_400, 4_096), "w1": (4_096, 11_008)}
ADAMW_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32), (torch.float32, torch.float32))
ADAMW_STEPS = (1, 2, 3, 10_000)
ADAMW_B1, ADAMW_B2, ADAMW_EPS, ADAMW_LR, ADAMW_WD = 0.9, 0.999, 1e-8, 3e-4, 0.1
# Phase 24: the benchmark cell deepseek-v3.train-4k (perfbench/). Its
# attention launch, (B, H, S, q/k head dim, v head dim), which the flash
# route runs at the 256 instance on q, k and v zero-padded; and its train
# step: V3_LAYERS layers, each one forward, one recompute (remat "full"), one
# dQ and one dK/dV launch, none on the plain route.
V3_CELL = "deepseek-v3.train-4k"
V3_ATTN = (1, 128, 4096, 192, 128)
V3_LAYERS = 5


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


def flash_err(fa, got, q, k, v, kind, window, softcap, scale=None):
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
    o32, lse32 = fa.flash_attention_ref(q.float(), k.float(), v.float(), kind, window, softcap, scale)
    o, o_plain = o.float(), o32.to(q.dtype).float()
    close_lse = bool(torch.allclose(lse, lse32, rtol=F32_TOL, atol=F32_TOL))
    if q.dtype == torch.float32:
        ok = close_lse and bool(torch.allclose(o, o32, rtol=F32_TOL, atol=F32_TOL))
    else:
        pv_abs = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(), kind, window, softcap, scale)[0]
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
        cases += [(B, H, Hkv, S, 128, kind, 0, 0.0, dtype) for B, H, Hkv, S, kind in SERVE_HEAD_CASES]
        cases += [(*case, dtype) for case in SERVE_FLASH_CASES + SSM_FLASH_CASES + ENC_FLASH_CASES + DIST_FLASH_CASES]
    worst = {torch.float32: [0.0] * 3, torch.bfloat16: [0.0] * 3}
    for B, H, Hkv, S, D, kind, window, softcap, dtype in cases:
        q, k, v = flash_inputs(gen, B, H, Hkv, S, D, dtype, dev)
        got = fa.flash_attention(q, k, v, kind, window, softcap)
        torch.cuda.synchronize()
        ok, *errs = flash_err(fa, got, q, k, v, kind, window, softcap)
        check(ok, f"flash kernel != plain at B={B} H={H} Hkv={Hkv} S={S} D={D} {kind} w={window} "
                  f"softcap={softcap} {dtype} (max |do|, |do32|, |dlse| {errs})")
        worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]
        del q, k, v, got
        if S >= 4096:
            torch.cuda.empty_cache()
    f32, b16 = worst[torch.float32], worst[torch.bfloat16]
    log(f"[flash] {len(cases)} cases ({padded_head_dims(fa)} among them; phase 15's {len(SERVE_FLASH_CASES)}, "
        f"phase 16's {len(SSM_FLASH_CASES)}, phase 17's {len(ENC_FLASH_CASES)} and phase 19's {len(DIST_FLASH_CASES)} "
        f"launch shapes in both dtypes) "
        f"within tolerance of the plain version: "
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
    """Device time by kernel over one call of ``step``, from torch.profiler's
    record of the card's activity: the kernel events (not CUPTI's "Command
    Buffer Full" marker for a full launch queue), summed by name from the
    raw kineto events (``key_averages`` spends about 100 us of host time on
    each event, a minute for a call of 3e5 launches). Returns (total ms, the
    top [(ms, count, name)], {kind: ms}, launches) with kinds: the port's
    flash kernels, cuBLAS's products (``nvjet``) and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.name().startswith("Command Buffer"):
            continue
        t, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (t + e.duration_ns() / 1e6, n + 1)
    rows = sorted(((t, n, name) for name, (t, n) in by_name.items() if t > 0), reverse=True)
    kinds = {"flash kernels": 0.0, "cuBLAS (nvjet)": 0.0, "the rest": 0.0}
    for t, _, name in rows:
        kinds["flash kernels" if "flash_" in name else "cuBLAS (nvjet)" if "nvjet" in name else "the rest"] += t
    return sum(r[0] for r in rows), rows[:top], kinds, sum(r[1] for r in rows)


LIBRARY_MASK = {"causal": "", "sliding": ", boolean band mask", "bidirectional": ", no mask"}


def library_attention(fa, F, q, k, v, kind, window):
    """``scaled_dot_product_attention`` on the same inputs, the yardstick of
    the flash kernels (no softcap: it has none): ``is_causal`` for a causal
    mask, no mask for a bidirectional one, a boolean ``(S, S)`` band for a
    sliding one."""
    if kind == "causal":
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    if kind == "bidirectional":
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
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
    total, rows, kinds, _ = device_time_table(step, params, batch)
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


def ref64(fa, q, k, v, o, lse, do, kind, window, softcap, scale):
    """``(dq, dk, dv)`` as ``flash_attention_bwd_ref`` forms them, in float64
    from the same inputs (the kernel's ``o`` and ``lse`` among them, so the
    only difference from the kernel is the kernel's own rounding); and the
    largest distances of that ``lse`` and ``o`` from a float64 forward."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = (q.double() * scale).reshape(B, Hkv, G, Sq, D)
    kf, vf = k.double()[:, :, None], v.double()[:, :, None]
    dof = do.double().reshape(B, Hkv, G, Sq, D)
    masked = ~fa.flash_mask(Sq, Sk, kind, window, q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    t = (s / softcap).tanh() if softcap else None
    s = (t * softcap if softcap else s).masked_fill(masked, float("-inf"))
    lse64 = torch.logsumexp(s, dim=-1, keepdim=True)
    d_lse = float((lse64.reshape(lse.shape) - lse.double()).abs().max())
    d_o = float((torch.matmul((s - lse64).exp(), vf).reshape(o.shape) - o.double()).abs().max())
    del lse64
    p = (s - lse.double().reshape(B, Hkv, G, Sq, 1)).exp()
    del s
    delta = (dof * o.double().reshape(B, Hkv, G, Sq, D)).sum(-1, keepdim=True)
    ds = (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * p
    if softcap:
        ds = ds * (1 - t * t)
    ds = ds.masked_fill(masked, 0.0)
    dq = torch.matmul(ds, kf).mul(scale).reshape(B, H, Sq, D)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    return (dq, dk, dv), d_lse, d_o


def f64_limits(w64: torch.Tensor) -> torch.Tensor:
    """Per-entry limits of a bfloat16 backward kernel's gradient against
    the float64 plain backward ``w64`` on the same inputs: one bfloat16 ulp
    at each float64 value's binade, plus BWD_BF16_ATOL_REL of its largest
    entry. One ulp, not half: the kernel rounds its float32 sum once, and
    that sum may lie across a rounding boundary from the float64 value (on
    gemma2-2b's random-init gradients: kernel 4.7684e-7 = 2^-21, float64
    4.7961e-7, a gap of 2.77e-9 against the ulp of 2^-28 = 3.73e-9 there;
    that float64 value came from its own forward's lse and o)."""
    return ulp(w64, torch.bfloat16) + BWD_BF16_ATOL_REL * float(w64.abs().max())


def bwd_err(fa, got, args, kind, window, softcap, scale=None):
    """Holds the kernels' ``(dq, dk, dv)`` against the plain backward on the
    widened inputs. Returns (ok, [max |g - want|], want)."""
    q, k, v, o, lse, do = args
    want = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse, do.float(), kind, window,
                                      softcap, scale)
    ok, errs = True, []
    for g, w in zip(got, want):
        rtol, atol = bwd_limits(w, q.dtype)
        d = (g.float() - w).abs()
        ok = ok and g.dtype == q.dtype and g.shape == w.shape and bool((d <= atol + rtol * w.abs()).all())
        errs.append(float(d.max()))
    return ok, errs, want


def tile_margins(fa, args, want, kind, window, softcap, lims=None):
    """What one tile visited wrongly would do at this shape, beside the limit.

    For every q tile, the contribution to dq of its diagonal K/V tile (the
    last one the dQ kernel visits); for every K/V tile, the contributions to
    dk and dv of its diagonal q tile (the first one the dK/dV kernel
    visits). Skipping, repeating or mis-masking such a tile moves the
    gradient by that contribution. Returns, for dq, dk and dv, the smallest
    over the tiles of (its contribution's largest entry, that entry over the
    largest deviation the check allows on the tile's rows). Given ``lims``
    (per-entry limits of dq, dk and dv, as :func:`f64_limits` gives them),
    the second is the largest ratio of the contribution to the limit over
    the tile's entries."""
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

    def margin(contrib, w, i, lim=None):
        c = float(contrib.abs().max())
        if lim is not None:
            return c, float((contrib.abs() / lim).max())
        rtol, atol = limits[i]
        return c, c / (atol + rtol * float(w.abs().max()))

    lq = None if lims is None else lims[0].reshape(B, Hkv, G, S, D)
    out = {"dq": [], "dk": [], "dv": []}
    BQ, BK = dq_tile
    for r0 in range(0, S, BQ):
        c0 = (min(r0 + BQ, S) - 1) // BK * BK
        r1, c1, _, ds = tile(r0, c0, BQ, BK)
        out["dq"].append(margin(ds @ kf[..., c0:c1, :] * scale, dq_w[..., r0:r1, :], 0,
                                None if lims is None else lq[..., r0:r1, :]))
    BQ, BK = dkv_tile
    for c0 in range(0, S, BK):
        r0 = c0 // BQ * BQ
        r1, c1, p, ds = tile(r0, c0, BQ, BK)
        out["dk"].append(margin((ds.transpose(-1, -2) @ qf[..., r0:r1, :]).sum(2), want[1][:, :, c0:c1], 1,
                                None if lims is None else lims[1][:, :, c0:c1]))
        out["dv"].append(margin((p.transpose(-1, -2) @ dof[..., r0:r1, :]).sum(2), want[2][:, :, c0:c1], 2,
                                None if lims is None else lims[2][:, :, c0:c1]))
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
        cases += [(*case, dtype) for case in SSM_FLASH_BWD_CASES + ENC_FLASH_BWD_CASES + DIST_FLASH_BWD_CASES]
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
    log(f"[flash bwd] {len(cases)} cases ({padded_head_dims(fa)} among them, and the launch shapes of phases 16, "
        f"17 and 19, {len(SSM_FLASH_BWD_CASES) + len(ENC_FLASH_BWD_CASES) + len(DIST_FLASH_BWD_CASES)}, in both "
        f"dtypes) within tolerance of the plain "
        f"backward: float32 rtol={GRAD_RTOL} "
        f"atol={GRAD_ATOL} (largest |d dq|, |d dk|, |d dv| {f32[0]:.3e}, {f32[1]:.3e}, {f32[2]:.3e}); bfloat16 I/O "
        f"within rtol={BWD_BF16_RTOL:.3e} of the float32 gradients + {BWD_BF16_ATOL_REL} of their largest entry "
        f"(largest {b16[0]:.3e}, {b16[1]:.3e}, {b16[2]:.3e})")

    main, worst = {}, [0.0] * 3
    for *shape, kind, window, _ in DIST_TRAIN_FLASH_BWD_CASES:
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
    from repro_torch.kernels import adamw as aw
    from repro_torch.launch import build_train_step
    from repro_torch.models import init_params, make_dummy_batch, param_count
    from repro_torch.optim import tree_leaves

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
    leaves, n_params = sum(1 for p in tree_leaves(params) if p.numel()), param_count(params)
    torch.cuda.reset_peak_memory_stats()
    mp.launches = fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_tc = fa.launches_dq_tc = fa.launches_dkv_tc = 0
    aw.launches = aw.elements = 0
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        n0 = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc)
        a0 = (aw.launches, aw.elements)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per = (fa.launches - n0[0], fa.launches_dq - n0[1], fa.launches_dkv - n0[2])
        check(per == (2 * L, L, L), f"step {i + 1}: (forward, dQ, dK/dV) launches {per}, expected {(2 * L, L, L)}")
        per_tc = (fa.launches_fwd_tc - n0[3], fa.launches_dq_tc - n0[4], fa.launches_dkv_tc - n0[5])
        check(per_tc == (2 * L, L, L),
              f"step {i + 1}: tensor-core (forward, dQ, dK/dV) launches {per_tc}, expected {(2 * L, L, L)}")
        per_aw = (aw.launches - a0[0], aw.elements - a0[1])
        check(per_aw == (leaves, n_params), f"step {i + 1}: AdamW kernel launches and elements {per_aw}, expected "
              f"{(leaves, n_params)} (one a leaf, every parameter)")
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"step {i + 1}: loss {losses[-1]}")
    launches = {"flash_attention": fa.launches, "flash_dq": fa.launches_dq, "flash_dkv": fa.launches_dkv,
                "adamw": aw.launches, "adamw_elements": aw.elements}
    check(mp.launches == 0, f"training launched the min-plus kernel {mp.launches} times")
    check(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps on one batch: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm_ms = 1e3 * statistics.median(secs[1:])
    log(f"[train] {TRAIN_STEPS} steps, per step exactly {2 * L} forward (with the remat recompute), {L} dQ and {L} "
        f"dK/dV launches, all on the tensor cores, {leaves} AdamW kernel launches over {n_params} elements, min-plus "
        f"0; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; peak device memory {peak_gb:.2f} GB; first step {secs[0]:.3f} s")

    total, rows, kinds, _ = device_time_table(lambda p, b: step(p, state, b), params, batch, top=12)
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


def train_f32_check(fa, dev, cfg, batch, tag="train"):
    """Phase 10, float32 part (and phase 17's): F32_LAYERS layers at full
    width on the same batch, loss and gradients of the kernel route against
    the plain route."""
    from repro_torch.launch import value_and_grad
    from repro_torch.models import init_params
    from repro_torch.optim import tree_leaves

    check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
          "float32 products must run in full float32, not TF32")
    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    b32 = batch
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
    shapes = ", ".join(f"{k} {tuple(t.shape)}" for k, t in batch.items())
    log(f"[{tag}] float32, {F32_LAYERS} layers at full width, batch {shapes}: loss "
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
    ``kernels`` (keys of PROFILED_COUNTERS) over ``calls`` calls of ``fn``
    after one warm-up call: {kernel: (total ms, launches)}. Unlike CUDA
    events around back-to-back calls, it does not count the gaps a
    host-bound caller leaves between launches.

    Each session reads the wrappers' launch counters over the same calls. A
    session whose profiler counts equal them is taken, so a launch that
    really is missing (or extra) shows in the first session and fails the
    caller's own count check. The profiler can miss a kernel's record
    (sessions on the card have seen 18 of 20 and 4 of 5 row-kernel launches
    that the counters saw): such a session is logged, counted in
    ``PROFILER_RERUNS`` for the kernels line, and run again, up to
    PROFILER_SESSIONS in all; if the last one still disagrees, this fails.

    The profiler keeps a kernel's record only if the record's start and end,
    moved from the card's clock onto the host's, fall inside the window
    between the profiler's start and stop on the host; a window that holds
    only a few short launches (5 of the row kernel, about 1 ms in all) ends
    within a fraction of a millisecond of its last record, so a small
    disagreement between the two clocks drops records at either end. Each
    window therefore opens PROFILER_MARGIN_S before the first call and
    closes PROFILER_MARGIN_S after the last synchronize: the records lie
    well inside it, and the device time it sums is the kernels' alone
    (``scripts/profiler_records.py`` counts the sessions that lose records
    with and without the margin)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import minplus as mp

    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        before = {k: getattr(mp, PROFILED_COUNTERS[k]) for k in kernels}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_MARGIN_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_MARGIN_S)
        launched = {k: getattr(mp, PROFILED_COUNTERS[k]) - before[k] for k in kernels}
        out = {k: (0.0, 0) for k in kernels}
        for e in prof.key_averages():
            for k in kernels:
                if k in e.key:
                    ms, count = out[k]
                    out[k] = (ms + (getattr(e, "device_time_total", None) or e.cuda_time_total) / 1e3, count + e.count)
        counts = {k: c for k, (_, c) in out.items()}
        if counts == launched:
            return out
        for k in kernels:
            PROFILER_RERUNS[k] += counts[k] != launched[k]
        log(f"[profiler] session {session} of {PROFILER_SESSIONS} saw launches {counts} over {calls} calls; the "
            f"launch counters saw {launched}")
    check(False, f"the profiler's launch counts {counts} differ from the launch counters' {launched} in all "
                 f"{PROFILER_SESSIONS} sessions")


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
    (key, (plan,)), = eng._cache.items()  # one position: one plan
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

    (splan,) = eng._cache[skey]
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


class DispatchLog:
    """An engine proxy for phase 13: it records every dispatch (its rows,
    whether regime-split, the host time of the call) and how long the
    caller then waits on each handle, and passes everything else through."""

    def __init__(self, engine):
        self._engine = engine
        self.calls = []  # [rows, split, dispatch ms, wait ms]

    def dispatch(self, problems, split_regimes=False):
        t0 = time.perf_counter()
        handle = self._engine.dispatch(problems, split_regimes=split_regimes)
        rows = problems.B if hasattr(problems, "B") else len(problems)
        self.calls.append([rows, split_regimes, 1e3 * (time.perf_counter() - t0), 0.0])
        return _TimedHandle(handle, self.calls[-1])

    def __getattr__(self, name):
        return getattr(self._engine, name)


class _TimedHandle:
    def __init__(self, handle, record):
        self._handle, self._record = handle, record

    def done(self):
        return self._handle.done()

    def _timed(self, name):
        t0 = time.perf_counter()
        out = getattr(self._handle, name)()
        self._record[3] += 1e3 * (time.perf_counter() - t0)
        return out

    def result(self):
        return self._timed("result")

    def k_last(self):
        return self._timed("k_last")

    def objectives(self):
        return self._timed("objectives")


def replay_launches(before, after):
    """The row and backtrack launches the DP replays between two
    ``cache_stats()`` snapshots hold: each warm hit on a ``dp`` bucket is one
    replay of n_b row kernels and one backtrack."""
    rows = bts = 0
    for label, hits in after["per_bucket_hits"].items():
        delta = hits - before["per_bucket_hits"].get(label, 0)
        if label.startswith("dp:") and delta:
            rows += delta * int(label.split(":")[2][1:])
            bts += delta
    return rows, bts


def family_problem(rng, fam, regime, Problem, costs):
    """One request of a benchmarks/bench_serve.py family, drawn as it draws
    them (its module imports the JAX package, so the draws are copied)."""
    n = fam["n"]
    upper = rng.integers(fam["u_lo"], fam["u_hi"] + 1, size=n)
    upper[0] = fam["u_hi"]
    T = int(min(rng.integers(fam["T_lo"], fam["T_hi"] + 1), upper.sum()))
    tables = []
    for u in (int(v) for v in upper):
        if regime == "arbitrary":
            tables.append(costs.measured_cost(u, rng))
        elif regime == "linear":
            tables.append(costs.linear_cost(u, float(rng.uniform(0.2, 5.0))))
        elif regime == "increasing":
            tables.append(costs.superlinear_cost(u, float(rng.uniform(0.2, 3.0)), float(rng.uniform(0.01, 0.6))))
        else:
            tables.append(costs.sublinear_cost(u, float(rng.uniform(5.0, 40.0)), float(rng.uniform(2.0, 20.0))))
    return Problem(T=T, lower=np.zeros(n, dtype=np.int64), upper=upper, cost_tables=tuple(tables))


def serve_saturated(svc, batches, producers):
    """Submits every batch from ``producers`` threads (request i from thread
    i mod producers) and waits for all: (futures in request order, ms, the
    ms the producers spent in ``submit``, summed)."""
    import threading

    futs = [None] * len(batches)
    errors, submit_ms = [], [0.0] * producers

    def produce(k):
        try:
            for i in range(k, len(batches), producers):
                t0 = time.perf_counter()
                futs[i] = svc.submit(batches[i])
                submit_ms[k] += 1e3 * (time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=produce, args=(k,)) for k in range(producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not errors and all(not t.is_alive() for t in threads), f"a producer failed: {errors}")
    for f in futs:
        f.result(timeout=300)
    return futs, 1e3 * (time.perf_counter() - t0), sum(submit_ms)


def service_phase(mp, card):
    """Phase 13 (a) and (b): the scheduling service on the card. Returns the
    row and backtrack launches of (a)'s first saturated leg, counted from 0."""
    import gc

    from repro_torch.core import Problem, ProblemBatch, SweepEngine, costs, random_problem
    from repro_torch.core.sweep import request_bucket, reset_default_engines
    from repro_torch.serve import SchedulerService, combine_batches, pow2_ladder

    reset_default_engines()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (a) production traffic
    eng = SweepEngine(device="cuda")
    logged = DispatchLog(eng)
    svc = SchedulerService(engine=logged, max_batch=SERVE_MAX_BATCH, max_delay_s=SERVE_DELAY_S,
                           max_pending=16 * SERVE_REQUESTS)
    try:
        t0 = time.perf_counter()
        built = svc.warm([(N_MAIN, T_MAIN, U_MAIN + 1)])
        warm_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        ladder = pow2_ladder(SERVE_MAX_BATCH)
        check(built == len(ladder), f"warm built {built} plans, expected {len(ladder)} (the ladder {ladder})")
        labels = sorted(eng._bucket_label(k) for k in eng._cache)
        compiles = eng.cache_stats()["compiles"]
        probs = [random_problem(np.random.default_rng(SERVE_SEED0 + i), n=N_MAIN, T=T_MAIN, regime="arbitrary",
                                max_upper=U_MAIN) for i in range(SERVE_REQUESTS)]
        batches = [ProblemBatch.from_problems([p]) for p in probs]
        check({request_bucket(b) for b in batches} == {(128, 16384, 1024)},
              f"the requests' buckets {sorted({request_bucket(b) for b in batches})}")

        def serial():
            t0 = time.perf_counter()
            hs = []
            for b in batches:
                hs.append(eng.dispatch(b))
                hs[-1].result()
            return hs, 1e3 * (time.perf_counter() - t0)

        logged.calls.clear()
        alone, serial_ms = serial()
        mp.launches = mp.launches_scan = mp.launches_backtrack = 0
        stats0 = eng.cache_stats()
        futs, sat_ms, submit_ms = serve_saturated(svc, batches, SERVE_PRODUCERS)
        st = svc.stats()
        sat_calls = [list(c) for c in logged.calls]  # before the checks below read k_last through the handles
        launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
        flushes = st["flushes"]
        check(launches == {"row": 128 * flushes, "scan": 0, "backtrack": flushes},
              f"the saturated leg's {flushes} flushes launched {launches}; expected {128 * flushes} rows and "
              f"{flushes} backtracks, all in graph replays")
        check(replay_launches(stats0, eng.cache_stats()) == (launches["row"], launches["backtrack"]),
              "the launches differ from the replays the cache counted")
        for i, (h, f) in enumerate(zip(alone, futs)):
            check(np.array_equal(f.result(timeout=60), h.result()), f"request {i}: served schedule != solved alone")
            check(np.array_equal(f.k_last(timeout=60).view(np.int32), h.k_last().view(np.int32)),
                  f"request {i}: served k_last != solved alone")
            check(np.array_equal(f.objectives(timeout=60), h.objectives()), f"request {i}: served objective != alone")
        sat_flushes = flushes
        walls = {"serial": [serial_ms], "saturated": [sat_ms]}
        for name in ("saturated", "serial"):
            if name == "serial":
                walls[name].append(serial()[1])
            else:
                f2, ms, _ = serve_saturated(svc, batches, SERVE_PRODUCERS)
                check(all(np.array_equal(a.result(timeout=60), b.result(timeout=60)) for a, b in zip(f2, futs)),
                      "a second saturated leg gave other schedules")
                walls[name].append(ms)
        serial_mean, sat_mean = (statistics.mean(walls[k]) for k in ("serial", "saturated"))
        rps = SERVE_REQUESTS / (sat_mean / 1e3)
        # paced: Poisson arrivals at half the saturated rate, from one thread
        gaps = np.random.default_rng(SEED + 13).exponential(2.0 / rps, size=SERVE_REQUESTS)
        paced = []
        t0 = time.perf_counter()
        for b, gap in zip(batches, gaps):
            time.sleep(gap)
            paced.append(svc.submit(b))
        for f, h in zip(paced, alone):
            check(np.array_equal(f.result(timeout=60), h.result()), "a paced request's schedule != solved alone")
        paced_ms = 1e3 * (time.perf_counter() - t0)
        lat = np.array([1e3 * (f.completed_at - f.submitted_at) for f in paced])
        # the profiler: one flush of 16 rows is one replay
        big = ProblemBatch.from_problems(probs[:SERVE_MAX_BATCH])
        prof = device_ms_by(lambda: svc.submit(big).result(timeout=60),
                            ("minplus_row_kernel", "minplus_backtrack_kernel"))
        (rows_ms, rows), (bt_ms, bts) = prof["minplus_row_kernel"], prof["minplus_backtrack_kernel"]
        check((rows, bts) == (128, 1), f"the profiler saw {rows} row and {bts} backtrack kernels in one flush")
        st = svc.stats()
        check(eng.cache_stats()["compiles"] == compiles, f"steady state built {eng.cache_stats()['compiles'] - compiles}"
              " plans after warm")
        check(max(c[0] for c in logged.calls) <= SERVE_MAX_BATCH, f"a flush of {max(c[0] for c in logged.calls)} rows")
        check(st["flush_failures"] == st["retries"] == st["degraded_flushes"] == 0, f"service stats {st}")
        key = ("dp", SERVE_MAX_BATCH, 128, 16384, 1024)
        combine_ms = median_wall_ms(lambda: combine_batches(batches[:SERVE_MAX_BATCH]), reps=5)
        combined, _ = combine_batches(batches[:SERVE_MAX_BATCH])
        with torch.cuda.stream(eng._stream):
            split = dispatch_split(eng._cache[key][0], combined, key[1:])
    finally:
        svc.close(timeout=120)
    log(f"[serve] (a) {card}")
    log(f"[serve] (a) SchedulerService(max_batch={SERVE_MAX_BATCH}, max_delay_s={SERVE_DELAY_S}) over "
        f"SweepEngine(device='cuda'): warm of (n={N_MAIN}, T={T_MAIN}, W={U_MAIN + 1}) over the ladder {ladder} built "
        f"{built} plans {labels} in {warm_ms:.3f} ms; peak device memory of the warmed ladder {peak_gb:.3f} GB "
        f"(above the {base / 1e9:.3f} GB held before)")
    log(f"[serve] (a) {SERVE_REQUESTS} requests (numpy seeds {SERVE_SEED0}..{SERVE_SEED0 + SERVE_REQUESTS - 1}) from "
        f"{SERVE_PRODUCERS} producers: schedules, k_last and objectives bit-identical to engine.dispatch of each "
        f"alone; the first saturated leg: {sat_flushes} flushes of {[c[0] for c in sat_calls]} rows, launches {launches}; "
        f"compiles {compiles} after warm and after every leg; flush_failures, retries, degraded_flushes 0; one flush "
        f"of {SERVE_MAX_BATCH} rows by the profiler: {rows} row kernels ({rows_ms:.4f} ms) and {bts} backtrack "
        f"({bt_ms:.4f} ms)")
    log(f"[serve] (a) serial baseline (one dispatch per request) {serial_mean:.3f} ms, saturated {sat_mean:.3f} ms "
        f"(host clock, mean of two in turns: {walls}): {rps:.1f} requests/s, {serial_mean / sat_mean:.3f}x the "
        f"serial baseline; paced at {rps / 2:.1f} requests/s (Poisson, {paced_ms:.3f} ms in all): latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms (host clock); "
        f"service stats {st}")
    log(f"[serve] (a) one flush of {SERVE_MAX_BATCH} rows step by step (medians of 5, synchronized after each): "
        f"combine {combine_ms:.3f} ms + " + split_text(split))
    log(f"[serve] (a) the first saturated leg, {sat_ms:.3f} ms: the producers spent {submit_ms:.3f} ms in submit "
        f"(summed over {SERVE_PRODUCERS} threads); the coalescer's engine.dispatch calls (host pad, copy in, replay "
        f"launch) {sum(c[2] for c in sat_calls):.3f} ms ({', '.join(f'{c[2]:.3f}' for c in sat_calls)}); the "
        f"completer's waits on the flush events and copies {sum(c[3] for c in sat_calls):.3f} ms "
        f"({', '.join(f'{c[3]:.3f}' for c in sat_calls)}) (host clock)")

    # (b) bench_serve.py's stream, plain and regime-split
    rng = np.random.default_rng(0)
    regimes = ("arbitrary", "linear", "increasing", "decreasing")
    stream = [family_problem(rng, SERVE_FAMILIES[int(rng.integers(len(SERVE_FAMILIES)))], regimes[i % 4],
                             Problem, costs) for i in range(SERVE_STREAM)]
    sbatches = [ProblemBatch.from_problems([p]) for p in stream]
    buckets = sorted({request_bucket(b) for b in sbatches})
    eng = SweepEngine(device="cuda")
    svc = SchedulerService(engine=eng, max_batch=SERVE_MAX_BATCH, max_delay_s=SERVE_DELAY_S,
                           max_pending=4 * SERVE_STREAM)
    try:
        for split in (False, True):
            built = svc.warm(buckets, split_regimes=split)
            compiles = eng.cache_stats()["compiles"]
            t0 = time.perf_counter()
            want = [eng.dispatch(b, split_regimes=split).result()[0] for b in sbatches]
            serial_ms = 1e3 * (time.perf_counter() - t0)
            f0 = svc.stats()["flushes"]
            t0 = time.perf_counter()
            futs = [svc.submit(b, split_regimes=split) for b in sbatches]
            got = [f.result(timeout=120) for f in futs]
            sat_ms = 1e3 * (time.perf_counter() - t0)
            for i, (g, w) in enumerate(zip(got, want)):
                check(np.array_equal(g[0], w), f"stream request {i} (split_regimes={split}): served != solved alone")
            st = svc.stats()
            steady = eng.cache_stats()["compiles"] - compiles
            if not split:
                check(steady == 0, f"the plain stream built {steady} plans after warm")
            check(st["flush_failures"] == st["degraded_flushes"] == 0, f"service stats {st}")
            log(f"[serve] (b) bench_serve.py's stream, {SERVE_STREAM} requests in buckets {buckets}, "
                f"split_regimes={split}: every served schedule equals the request solved alone; warm built {built} "
                f"plans, {steady} built after it; serial {serial_ms:.3f} ms, coalesced {sat_ms:.3f} ms = "
                f"{SERVE_STREAM / (sat_ms / 1e3):.1f} requests/s, {serial_ms / sat_ms:.3f}x, "
                f"{st['flushes'] - f0} flushes (host clock)")
    finally:
        svc.close(timeout=120)
    return launches


def fleet_phase(mp, card):
    """Phase 13 (c): the fleet solve on the card. Returns the row and
    backtrack launches of the warm fleet solve and of the flat DP, each
    counted from 0."""
    from repro_torch.core import Solver, random_problem, solve_fleet, solve_schedule_dp_batch, total_cost
    from repro_torch.core import fleet as tfleet
    from repro_torch.core import validate_schedule
    from repro_torch.core.sweep import reset_default_engines
    from repro_torch.serve import SchedulerService

    reset_default_engines()
    p = random_problem(np.random.default_rng(FLEET_SEED), n=FLEET_N, T=4 * FLEET_N, max_upper=FLEET_UPPER)
    Tp = int(p.T - p.lower.sum())
    check(np.array_equal(tfleet.cluster_clients(p, seed=0, device="cuda"),
                         tfleet.cluster_clients(p, seed=0, device="cpu")),
          "k-means on the card labels otherwise than on the CPU")
    solver = Solver(device="cuda")
    eng = solver.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve_fleet(p)
    cold_ms = 1e3 * (time.perf_counter() - t0)
    x = np.asarray(sol.schedule)
    validate_schedule(p, x)
    check(int(x.sum()) == p.T, "the fleet schedule does not sum to T")
    caps = [int((p.upper - p.lower)[sol.labels == c].sum()) for c in range(sol.num_clusters)]
    check(sol.num_clusters == len(np.unique(sol.labels)) <= tfleet._auto_clusters(FLEET_N)
          and sol.quantum == tfleet._auto_quantum(max(caps), Tp),
          f"num_clusters {sol.num_clusters}, quantum {sol.quantum}: not the reference's rules")
    mp.launches = mp.launches_scan = mp.launches_backtrack = 0
    before = eng.cache_stats()
    warm = solver.solve_fleet(p)
    launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
    check(np.array_equal(warm.schedule, sol.schedule), "a warm fleet solve gave another schedule")
    expect = replay_launches(before, eng.cache_stats())
    check(launches["scan"] == 0 and (launches["row"], launches["backtrack"]) == expect and expect[1] >= 2,
          f"the warm fleet solve launched {launches}; its replays hold {expect}")
    warm_ms = median_wall_ms(lambda: solver.solve_fleet(p), reps=3)
    logged = DispatchLog(eng)
    feats_ms = median_wall_ms(lambda: tfleet._client_features(p), reps=3)
    cluster_ms = median_wall_ms(lambda: tfleet.cluster_clients(p, seed=0, device="cuda"), reps=3)
    t0 = time.perf_counter()
    staged = Solver(engine=logged).solve_fleet(p)
    staged_ms = 1e3 * (time.perf_counter() - t0)
    check(np.array_equal(staged.schedule, sol.schedule), "the timed fleet solve gave another schedule")
    stages = ("curves", "top level", "schedules")
    dispatch_ms = sum(c[2] + c[3] for c in logged.calls)
    svc = SchedulerService(engine=eng, max_batch=16, max_delay_s=0.002)
    try:
        served = svc.submit_fleet(p).result(timeout=300)
    finally:
        svc.close(timeout=120)
    for f in ("schedule", "labels", "allocations"):
        check(np.array_equal(getattr(served, f), getattr(sol, f)), f"the served fleet solve's {f} differ")

    # the flat exact DP of the same instance, one host call
    mp.launches = mp.launches_scan = mp.launches_backtrack = 0
    Xf = solve_schedule_dp_batch([p], device="cuda")
    flat_launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
    check(flat_launches == {"row": FLEET_N, "scan": 1, "backtrack": 1}, f"the flat DP launched {flat_launches}")
    validate_schedule(p, Xf[0])
    opt = total_cost(p, Xf[0])
    rel = (sol.objective - opt) / opt
    check(sol.objective >= opt * (1 - 1e-9), f"the fleet objective {sol.objective} beats the flat DP's {opt}")
    check(rel <= sol.gap_bound + 1e-6, f"the fleet's gap {rel} exceeds its certificate {sol.gap_bound}")
    flat_ms = median_wall_ms(lambda: solve_schedule_dp_batch([p], device="cuda"), reps=3)

    # the CPU at bench_fleet.py::run's size
    pc = random_problem(np.random.default_rng(FLEET_SEED), n=FLEET_CPU_N, T=4 * FLEET_CPU_N, max_upper=FLEET_UPPER)
    on_card = solver.solve_fleet(pc)
    t0 = time.perf_counter()
    wc = Solver(device="cpu").solve_fleet(pc)
    cpu_s = time.perf_counter() - t0
    for f in ("labels", "allocations", "schedule"):
        check(np.array_equal(getattr(on_card, f), getattr(wc, f)), f"n={FLEET_CPU_N}: the card's {f} differ from the CPU's")
    check(np.array_equal(np.asarray(on_card.curves).view(np.int32), np.asarray(wc.curves).view(np.int32))
          and on_card.gap_bound == wc.gap_bound and on_card.objective == wc.objective,
          f"n={FLEET_CPU_N}: the card's curves, gap_bound or objective differ from the CPU's")

    # bench_fleet.py's gap cases
    rows = []
    for seed, n, T, k, q in FLEET_GAP_CASES:
        pg = random_problem(np.random.default_rng(seed), n=n, T=T)
        fs = solve_fleet(pg, engine=eng, clusters=k, quantum=q)
        flat = float(Solver(engine=eng).solve([pg], algorithm="dp_batch").objectives[0])
        scale = max(abs(flat), 1.0)
        check(fs.objective >= flat - 1e-6 * scale, f"gap case n={n}: the fleet beats the flat DP")
        check(fs.objective <= flat * (1.0 + fs.gap_bound) + 1e-6 * scale, f"gap case n={n}: outside its certificate")
        if k == n and q == 1:
            check(fs.objective == flat, f"gap case n={n}: singleton clusters at q = 1 are not exact")
        rows.append(f"n={n} k={fs.num_clusters} q={fs.quantum}: gap {100 * (fs.objective - flat) / scale:.4f}% "
                    f"(bound {100 * fs.gap_bound:.4f}%)")

    log(f"[fleet] (c) {card}")
    log(f"[fleet] (c) bench_fleet.py's throughput instance n={FLEET_N}, T={p.T} (T'={Tp}), U<={FLEET_UPPER}, "
        f"seed {FLEET_SEED}: Solver(device='cuda').solve_fleet: {sol.num_clusters} clusters, quantum {sol.quantum}, "
        f"gap_bound {sol.gap_bound:.6f}; valid; k-means labels identical on the card and the CPU; "
        f"service.submit_fleet gives the same schedule, labels and allocations; warm-solve launches {launches} "
        f"(the replays of {[c[0] for c in logged.calls]}-row dispatches, split {[c[1] for c in logged.calls]})")
    log(f"[fleet] (c) flat DP of the same instance (solve_schedule_dp_batch, one host call): launches "
        f"{flat_launches}, argmin slab {FLEET_N * (Tp + 1) * 4 / 1e6:.1f} MB; OPT {opt:.6f}, the fleet "
        f"{sol.objective:.6f}: relative gap {rel:.6e} within its gap_bound {sol.gap_bound:.6e}")
    log(f"[fleet] (c) n={FLEET_CPU_N}, T={pc.T}: the card's labels, allocations, schedule, curves, gap_bound and "
        f"objective identical to device='cpu' (its solve took {cpu_s:.3f} s); gap cases: " + "; ".join(rows))
    log(f"[fleet] (c) warm solve_fleet {warm_ms:.3f} ms = {FLEET_N / (warm_ms / 1e3):.1f} clients/s (first "
        f"{cold_ms:.3f} ms); warm flat DP {flat_ms:.3f} ms, {warm_ms / flat_ms:.3f}x faster than the fleet solve "
        f"(host clock, medians of 3)")
    log(f"[fleet] (c) one warm fleet solve {staged_ms:.3f} ms by stage: clustering (cluster_clients, medians of 3) "
        f"{cluster_ms:.3f} ms, of it the client features on the host {feats_ms:.3f} ms and k-means on the card the "
        f"rest; " + "; ".join(f"{name}: dispatch {c[2]:.3f} ms, wait and copy to the host {c[3]:.3f} ms"
                             for name, c in zip(stages, logged.calls))
        + f"; the host work around them (cluster problems, curve sampling, repair, validation, objective) "
          f"{staged_ms - cluster_ms - dispatch_ms:.3f} ms")
    return launches, flat_launches


def _stage_timer(obj, name, times):
    """Replaces ``obj.<name>`` with a wrapper that appends each call's
    host-clock ms to ``times[name]``."""
    fn = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times[name].append(1e3 * (time.perf_counter() - t0))
        return out

    setattr(obj, name, timed)


def same_rounds(a, b, what, losses=True):
    """Two campaign histories: schedules, energies, makespans, scenario
    reports and recoveries identical (and losses, unless told not to)."""
    check(len(a.rounds) == len(b.rounds), f"{what}: {len(a.rounds)} against {len(b.rounds)} rounds")
    for ra, rb in zip(a.rounds, b.rounds):
        r = ra.round_index
        check(np.array_equal(ra.assignments, rb.assignments), f"{what}: round {r}'s schedules differ")
        check((ra.energy_joules, ra.estimated_joules, ra.makespan_joules)
              == (rb.energy_joules, rb.estimated_joules, rb.makespan_joules), f"{what}: round {r}'s energies differ")
        check(not losses or ra.mean_loss == rb.mean_loss, f"{what}: round {r}'s losses differ")
        check((ra.scenarios is None) == (rb.scenarios is None), f"{what}: round {r}'s scenario reports differ")
        if ra.scenarios is not None:
            check(ra.scenarios.labels == rb.scenarios.labels
                  and np.array_equal(ra.scenarios.assignments, rb.scenarios.assignments)
                  and np.array_equal(ra.scenarios.energies, rb.scenarios.energies),
                  f"{what}: round {r}'s scenario reports differ")
        check((ra.recovery is None) == (rb.recovery is None), f"{what}: round {r}'s recoveries differ")
        if ra.recovery is not None:
            check(np.array_equal(ra.recovery.recovery_assignments, rb.recovery.recovery_assignments)
                  and ra.recovery.fallback == rb.recovery.fallback, f"{what}: round {r}'s recoveries differ")


def same_params(pa, pb, what):
    from repro_torch.optim import tree_leaves

    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb))), f"{what}: parameters differ")


def ulp(ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of ``dtype`` (bfloat16: 8 significant bits, float32: 24) at
    each entry's magnitude."""
    _, e = torch.frexp(ref.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.full_like(ref, torch.finfo(dtype).eps), e - 1)


def fl_launcher_phase(mp, card, dev):
    """Phase 14 (a): the FL launcher on gemma2-2b FULL. Returns its min-plus
    launches, counted from 0 over the campaign."""
    import gc

    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.core.sweep import SweepEngine, reset_default_engines
    from repro_torch.data import lm_round_batches
    from repro_torch.fl import FederatedServer, PlanPolicy, local_train, run_campaign
    from repro_torch.fl.client import train_steps
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import sgd, tree_leaves, tree_map

    reset_default_engines()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = launcher.parse_args([*FL_LAUNCH_ARGV, "--device", str(dev)])
    t0 = time.perf_counter()
    c = launcher.build_campaign(args, log=lambda m: log(f"[fl] (a) {m}"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, server = c.cfg, c.server
    check(cfg.attn_impl == "plain" and cfg.remat == "full" and cfg.vocab_size == 256000,
          f"gemma2-2b FULL: attn_impl {cfg.attn_impl}, remat {cfg.remat}")

    def watched(params):
        return {"emb": params["emb"], **{f"layers/0/{k}": v for k, v in flatten_with_paths(params["layers"][0])}}

    times = {k: [] for k in ("plan_round", "account_round", "solve_scenarios", "train_host")}
    for name in ("plan_round", "account_round", "solve_scenarios"):
        _stage_timer(server, name, times)
    events = []
    train_round = server.train_round

    def timed_train(plan, batches):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t = time.perf_counter()
        out = train_round(plan, batches)
        times["train_host"].append(1e3 * (time.perf_counter() - t))
        e1.record()
        events.append((e0, e1))
        return out

    server.train_round = timed_train
    round1 = {}

    def on_round(r):
        if r.round_index == 0:
            round1.update({k: v.clone() for k, v in watched(server.params).items()})

    mp.launches = mp.launches_scan = mp.launches_backtrack = 0
    t0 = time.perf_counter()
    _, hist = launcher.run(args, campaign=c, on_round=on_round, log=lambda m: log(f"[fl] (a) {m.strip()}"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    train_ms = [a.elapsed_time(b) for a, b in events]
    losses = hist.losses
    check(len(hist.rounds) == args.rounds and np.isfinite(losses).all(), f"losses {losses}")

    # the same campaign planned on the CPU: planning sees the estimator and
    # the rng, never the model, so training is left out
    est, examples, rng, T = launcher.make_world(args, cfg.vocab_size)
    replay = FederatedServer(None, None, None, est, policy=PlanPolicy(algorithm=args.algorithm,
                                                                      engine=SweepEngine(device="cpu")))
    replay.train_round = lambda plan, batches: torch.zeros(())
    h_cpu = run_campaign(replay, examples, args.rounds, round_T=T, batch_size=args.batch, rng=rng)
    same_rounds(hist, h_cpu, "the card's campaign against the CPU-planned replay", losses=False)
    check(T == c.round_T and all(int(r.assignments.sum()) == T for r in hist.rounds), f"round_T {T}")

    # round 1 again, client by client, from the same starting point
    server._buffers = None
    gc.collect()
    torch.cuda.empty_cache()
    params0 = init_params(cfg, args.seed, device=dev)
    max_steps = max(d.max_batches for d in est.fleet)
    tb = torch.from_numpy(lm_round_batches(examples, max_steps, args.batch, 0)).to(dev).long()
    x = np.asarray(hist.rounds[0].assignments, dtype=np.int64)
    w = x.astype(np.float32) / np.float32(max(int(x.sum()), 1))

    def loss(p, b):
        return loss_fn(p, cfg, {"tokens": b})

    acc = {k: torch.zeros(v.shape, dtype=torch.float64, device=dev) for k, v in watched(params0).items()}
    mag = {k: torch.zeros_like(v) for k, v in acc.items()}  # Σ |w_i p_i|
    first = int(np.flatnonzero(x)[0])
    for i in np.flatnonzero(x):
        k = int(x[i])
        p_i, _ = local_train(loss, sgd(args.lr), params0, tb[i, :k], k)
        if i == first:
            # the same SGD steps written out: p <- p + bf16(-lr) * g, in place
            q = tree_map(lambda p: p.clone(), params0)
            for s in range(k):
                leaves = tree_leaves(q)
                with torch.enable_grad():
                    xs = [p.detach().requires_grad_() for p in leaves]
                    it = iter(xs)
                    grads = torch.autograd.grad(loss(tree_map(lambda _: next(it), q), tb[i, s]), xs)
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        p.add_(g * torch.tensor(-args.lr, dtype=g.dtype, device=dev))
                del grads, xs
            same_params(p_i, q, f"client {i}'s {k} steps of local_train against the written-out SGD steps")
            del q
        for name, v in watched(p_i).items():
            acc[name] += float(w[i]) * v.double()
            mag[name] += float(w[i]) * v.double().abs()
        del p_i
    # the server sums in float32 (one rounding a product and a sum, so at most
    # (clients + 1) float32 ulps of Σ |w_i p_i|) and rounds once to the leaf's
    # dtype (within one ulp of it)
    terms, worst, over_one, entries = int(np.count_nonzero(x)) + 1, 0.0, 0, 0
    for name, ref in acc.items():
        got, dtype = round1[name].double(), round1[name].dtype
        err = (got - ref).abs()
        limit = ulp(ref, dtype) + terms * 2.0 ** -24 * mag[name]
        worst = max(worst, (err / limit).max().item())
        over_one += int((err > ulp(ref, dtype)).sum())
        entries += ref.numel()
        check(bool((err <= limit).all()), f"round 1's {name}: {(err / limit).max().item():.3f} times the limit "
              "from the float64 sum of w_i p_i")
    # one warm client step (forward, remat forward, backward, SGD) by the
    # profiler: the device's busy time against the step's wall time
    del acc, mag, round1
    buf = tree_map(lambda p: p.clone(), params0)

    def step():
        train_steps(loss, sgd(args.lr), buf, tb[first, :1], 1)

    step()
    step_ms = median_wall_ms(step, 3)
    step_dev_ms, step_top, step_kinds, step_launches = device_time_table(lambda p, b: step(), None, None, top=6)
    del params0, buf, tb
    server.params = None
    gc.collect()
    torch.cuda.empty_cache()

    tokens = [int(r.assignments.sum()) * args.batch * args.seq for r in hist.rounds]
    walls = [1e3 * s for s in hist.pipeline_stats.round_wall_s]
    log(f"[fl] (a) {card}")
    log(f"[fl] (a) launcher defaults {vars(args)}: {len(hist.rounds)} rounds of T = {T} steps over "
        f"{args.clients} clients, x {[r.assignments.tolist() for r in hist.rounds]}; schedules, estimated and true "
        f"energies and makespans identical to the campaign planned with SweepEngine(device='cpu'); losses "
        f"{[round(float(v), 4) for v in losses]} (round 1 {losses[0]:.4f} against ln 256000 = "
        f"{math.log(256000):.4f}); client {first}'s round-1 parameters after {int(x[first])} steps of local_train "
        f"bit-identical to the SGD steps written out; round 1's embedding and layer 0 ({entries} entries) within "
        f"{worst:.3f} times the limit (one ulp of the leaf's dtype + {terms} float32 ulps of Σ|w_i p_i|) of the "
        f"float64 sum of w_i p_i, {over_one} entries more than one ulp from it")
    log(f"[fl] (a) model and server built in {build_s:.2f} s; campaign {wall_s:.2f} s; peak device memory "
        f"{peak_gb:.3f} GB above the {base / 1e9:.3f} GB held before; min-plus launches {launches} in "
        f"{len(hist.rounds)} rounds ({launches['row'] / len(hist.rounds):.1f} row, "
        f"{launches['backtrack'] / len(hist.rounds):.1f} backtrack a round: 'auto' plans this arbitrary-regime "
        f"round on the host's float64 DP, as the reference does)")
    for r in range(len(hist.rounds)):
        log(f"[fl] (a) round {r + 1}: wall {walls[r]:.3f} ms = plan {times['plan_round'][r]:.3f} + train "
            f"{train_ms[r]:.3f} (CUDA events; its host enqueue {times['train_host'][r]:.3f}) + account "
            f"{times['account_round'][r]:.3f} + scenarios {times['solve_scenarios'][r]:.3f} ms + the rest; "
            f"{tokens[r]} client tokens = {tokens[r] / (train_ms[r] / 1e3):.1f} tokens/s")
    log(f"[fl] (a) one warm client step (batch {args.batch} x {args.seq}, SGD) {step_ms:.3f} ms (host clock, "
        f"median of 3); by the profiler the card is busy {step_dev_ms:.3f} ms of it ({step_launches} kernel launches, "
        f"idle share {1 - step_dev_ms / step_ms:.3f}); by kind {', '.join(f'{k} {v:.3f} ms' for k, v in step_kinds.items())}; "
        f"top: " + "; ".join(f"{n[:60]} x{c} {t:.3f} ms" for t, c, n in step_top))
    warm = slice(1, None)
    log(f"[fl] (a) rounds 2-{len(hist.rounds)}: wall {statistics.mean(walls[warm]):.3f} ms, train "
        f"{statistics.mean(train_ms[warm]):.3f} ms, plan {statistics.mean(times['plan_round'][warm]):.3f} ms, account "
        f"{statistics.mean(times['account_round'][warm]):.3f} ms (means); client training "
        f"{sum(tokens[warm]) / (sum(train_ms[warm]) / 1e3):.1f} tokens/s")
    return launches


def toy_campaign(device, clients, max_batches, seed, scenarios, engine=None):
    """bench_async.py's / bench_faults.py's ``build_campaign`` in the port:
    ``(server, examples, rng, T)``; the toy LM's starting weights are drawn
    on the CPU and copied, so every device trains from the same ones."""
    from repro_torch.core.sweep import SweepEngine
    from repro_torch.data import client_corpora, make_lm_examples
    from repro_torch.fl import EnergyEstimator, FederatedServer, PlanPolicy, make_fleet
    from repro_torch.fl.toy import make_tiny_lm
    from repro_torch.optim import sgd

    vocab, dim, seq = FL_TOY
    init, loss = make_tiny_lm(vocab, dim)
    rng = np.random.default_rng(seed)
    fleet = make_fleet(rng, clients, max_batches=max_batches)
    est = EnergyEstimator(fleet)
    est.calibrate(rng)
    examples = [make_lm_examples(cc, seq) for cc in client_corpora(rng, clients, 4000, vocab)]
    T = sum(d.max_batches for d in fleet) // 2
    kw = dict(scenario_T_candidates=[int(0.6 * T), int(0.8 * T), T, int(1.2 * T)],
              scenario_dropouts=[[0], [1], [2], [3]]) if scenarios else {}
    params = {k: v.to(device) for k, v in init(FL_TOY_PARAMS_SEED, device="cpu").items()}
    policy = PlanPolicy(algorithm="auto", engine=engine if engine is not None else SweepEngine(device=device), **kw)
    return FederatedServer(loss, params, sgd(0.3), est, policy=policy), examples, rng, T


def fl_async_phase(mp, card, dev):
    """Phase 14 (b): bench_async.py's campaign, serial and pipelined, on the
    card. Returns the min-plus launches of the first pipelined campaign."""
    import threading

    from repro_torch.core import sweep
    from repro_torch.fl import run_campaign

    clients, max_batches, batch, rounds, seed = FL_ASYNC
    runs, launches, after_round1, builds = {}, None, {}, {}
    plan_call = sweep._Plan.__call__
    for k, mode in enumerate(("serial", "pipelined", "pipelined", "serial")):
        server, examples, rng, T = toy_campaign(dev, clients, max_batches, seed, scenarios=True)
        seen, trained, built = [], [], []
        train_round = server.train_round

        def timed_train(plan, batches, train_round=train_round, trained=trained):
            out = train_round(plan, batches)
            trained.append(torch.cuda.Event())
            trained[-1].record()
            return out

        def first_call(plan, *arrays, trained=trained, built=built):
            # a plan's first call runs it eagerly and captures its graph: note
            # the thread, and whether the clients' last training work was
            # still running on the card when it began
            if plan.graph is None:
                built.append((threading.current_thread().name, bool(trained) and not trained[-1].query()))
            return plan_call(plan, *arrays)

        def on_round(r, server=server, seen=seen):
            if r.round_index == 0:
                seen.append(server.engine.cache_stats()["compiles"])

        server.train_round = timed_train
        if k == 1:
            mp.launches = mp.launches_scan = mp.launches_backtrack = 0
        torch.cuda.synchronize()
        sweep._Plan.__call__ = first_call
        try:
            t0 = time.perf_counter()
            h = run_campaign(server, examples, rounds, round_T=T, batch_size=batch, rng=rng,
                             pipelined=mode == "pipelined", on_round=on_round)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            sweep._Plan.__call__ = plan_call
        builds[k] = built
        if k == 1:
            launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
        after_round1[k] = h.dp_cache_stats["compiles"] - seen[0]
        check(after_round1[k] == 0, f"{mode} campaign {k}: {after_round1[k]} plan builds after round 1")
        runs[k] = (mode, h, server.params, wall_ms)
    _, h0, p0, _ = runs[0]
    for k in (1, 2, 3):
        same_rounds(h0, runs[k][1], f"bench_async campaign {k} ({runs[k][0]}) against campaign 0 (serial)")
        same_params(p0, runs[k][2], f"bench_async campaign {k} ({runs[k][0]}) against campaign 0 (serial)")
    check(launches["row"] > 0 and launches["backtrack"] > 0, f"the pipelined campaign launched {launches}")

    server, examples, rng, T = toy_campaign("cpu", clients, max_batches, seed, scenarios=True)
    h_cpu = run_campaign(server, examples, rounds, round_T=T, batch_size=batch, rng=rng)
    same_rounds(h0, h_cpu, "bench_async's campaign on the card against the CPU", losses=False)
    rel = np.abs(h0.losses - h_cpu.losses) / np.abs(h_cpu.losses)
    check(rel.max() <= FL_LOSS_RTOL, f"losses on the card against the CPU: relative {rel.max():.3e}")

    log(f"[fl] (b) {card}")
    pipe = [runs[k] for k in (1, 2)]
    ser = [runs[k] for k in (0, 3)]
    waits = [sum(1 for t in r[1].pipeline_stats.tasks if t["blocked_s"] > 0) for r in pipe]
    log(f"[fl] (b) bench_async.py's campaign ({clients} clients, max_batches {max_batches}, batch {batch}, {rounds} "
        f"rounds, T = {T}, {len(h0.rounds[0].scenarios.labels)} scenarios a round {h0.rounds[0].scenarios.labels}): "
        f"serial, pipelined, pipelined, serial bit-identical in schedules, losses, energies, scenario reports and "
        f"parameters; equal to the CPU's in schedules, energies and scenario reports, losses within "
        f"{rel.max():.3e} relative; plan builds after round 1: {list(after_round1.values())}; min-plus launches of "
        f"the first pipelined campaign {launches}; engine {h0.dp_cache_stats}")
    for mode, h, _, wall_ms in (runs[k] for k in range(4)):
        ps = h.pipeline_stats
        log(f"[fl] (b) {mode}: campaign {wall_ms:.3f} ms, rounds {[round(1e3 * v, 3) for v in ps.round_wall_s]} ms "
            f"(mean {1e3 * statistics.mean(ps.round_wall_s):.3f}); planner busy {1e3 * ps.planner_busy_s:.3f} ms, "
            f"blocked {1e3 * ps.planner_blocked_s:.3f} ms, overlap fraction {ps.overlap_fraction:.4f}; waiting on "
            f"the losses {1e3 * ps.train_block_s:.3f} ms")
    for k in (1, 2):
        check(builds[k] and all(name.startswith("fl-planner") for name, _ in builds[k]),
              f"pipelined campaign {k}'s plans were built on {builds[k]}")
    log(f"[fl] (b) the main thread waited on the planner {waits} times in the two pipelined campaigns (of "
        f"{len(pipe[0][1].pipeline_stats.tasks)} tasks each); their plan builds (eager call and graph capture) "
        f"ran on the planner thread: {[[n for n, _ in builds[k]] for k in (1, 2)]}, with the clients' training "
        f"still running on the card at the start of {[sum(f for _, f in builds[k]) for k in (1, 2)]} of them; "
        f"the serial campaigns' on {[[n for n, _ in builds[k]] for k in (0, 3)]}")
    capture_while_training(dev, clients, max_batches, batch, seed)
    return launches


def capture_while_training(dev, clients, max_batches, batch, seed):
    """A bucket's first plan (eager call and CUDA-graph capture on the
    engine's stream) built on another thread while the main thread launches
    a round of client training: the schedules equal the CPU engine's, the
    trained parameters equal the same round trained alone, and the two
    threads' spans overlap."""
    import threading

    from repro_torch.core.sweep import SweepEngine
    from repro_torch.data import lm_round_batches

    runs = []
    for concurrent in (True, False):
        server, examples, rng, T = toy_campaign(dev, clients, max_batches, seed, scenarios=True)
        problems, _ = server.build_scenarios(T)
        plan = server.plan_round(0, T)
        batches = lm_round_batches(examples, max(d.max_batches for d in server.estimator.fleet), batch, 0)
        out, spans, errors = {}, {}, []

        def build():
            t0 = time.perf_counter()
            try:
                out["X"] = server.engine.dispatch(problems, split_regimes=True).result()
            except BaseException as e:  # noqa: BLE001 - reported by the check below
                errors.append(e)
            spans["plan"] = (t0, time.perf_counter())

        torch.cuda.synchronize()
        thread = threading.Thread(target=build, name="fl-planner-capture")
        t0 = time.perf_counter()
        if concurrent:
            thread.start()
        loss = server.train_round(plan, batches)
        spans["train"] = (t0, time.perf_counter())
        if not concurrent:
            thread.start()
        thread.join(timeout=120)
        check(not thread.is_alive() and not errors, f"the plan build on another thread failed: {errors}")
        runs.append((float(loss), server.params, out["X"], spans, server.engine.cache_stats()["compiles"]))
    (loss_c, params_c, x_c, spans, compiles), (loss_a, params_a, x_a, _, _) = runs
    want = SweepEngine(device="cpu").dispatch(problems, split_regimes=True).result()
    check(np.array_equal(x_c, want) and np.array_equal(x_a, want), "the plan built beside training differs from the CPU's")
    check(loss_c == loss_a, f"training beside a plan build: loss {loss_c} against {loss_a} alone")
    same_params(params_c, params_a, "training beside a plan build against training alone")
    (p0, p1), (t0, t1) = spans["plan"], spans["train"]
    check(compiles == 1 and p0 < t1 and t0 < p1, f"spans: plan {spans['plan']}, train {spans['train']}")
    log(f"[fl] (b) a fresh engine's first plan ({len(problems)} scenarios, regime split; eager call and CUDA-graph "
        f"capture on the engine's stream) built on another thread from {1e3 * (p0 - t0):.3f} to {1e3 * (p1 - t0):.3f} "
        f"ms while the main thread enqueued a round of client training from 0 to {1e3 * (t1 - t0):.3f} ms (host "
        f"clock): schedules equal the CPU engine's, the loss and the trained parameters bit-identical to the round "
        f"trained alone")


def fl_faults_phase(mp, card, dev):
    """Phase 14 (c): bench_faults.py's chaos campaign on the card, serial,
    pipelined, and killed and resumed. Returns the min-plus launches of the
    serial campaign."""
    import tempfile

    from repro_torch.core import Solver, validate_schedule
    from repro_torch.core.sweep import SweepEngine
    from repro_torch.fl import FaultPlan, run_campaign

    clients, max_batches, batch, rounds, seed = FL_FAULTS
    plan = FaultPlan.generate(seed=seed + 100, num_rounds=rounds, n_clients=clients, **FL_FAULT_RATES)
    server_s, ex, rng, T = toy_campaign(dev, clients, max_batches, seed, scenarios=False)
    mp.launches = mp.launches_scan = mp.launches_backtrack = 0
    t0 = time.perf_counter()
    h_s = run_campaign(server_s, ex, rounds, round_T=T, batch_size=batch, rng=rng, faults=plan)
    torch.cuda.synchronize()
    serial_ms = 1e3 * (time.perf_counter() - t0)
    launches = {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}
    server_p, ex, rng, _ = toy_campaign(dev, clients, max_batches, seed, scenarios=False)
    t0 = time.perf_counter()
    h_p = run_campaign(server_p, ex, rounds, round_T=T, batch_size=batch, rng=rng, faults=plan, pipelined=True)
    torch.cuda.synchronize()
    pipe_ms = 1e3 * (time.perf_counter() - t0)
    same_rounds(h_s, h_p, "the pipelined chaos campaign against the serial one")
    same_params(server_s.params, server_p.params, "the pipelined chaos campaign against the serial one")

    recovered = [r for r in h_s.rounds if r.recovery is not None]
    check(recovered, "the chaos plan recovered no round")
    auditor = Solver(engine=SweepEngine(device="cpu"))
    for r in recovered:
        ri = r.recovery
        y = np.asarray(auditor.solve([ri.residual_problem]).schedules[0], np.int64)
        validate_schedule(ri.residual_problem, ri.recovery_assignments)
        check(not ri.fallback and np.array_equal(ri.recovery_assignments, y)
              and np.array_equal(r.assignments, ri.completed + y),
              f"round {r.round_index}'s recovery is not the independent solve of its residual instance")

    class Kill(Exception):
        pass

    def killer(res):
        if res.round_index == FL_KILL_AFTER - 1:
            raise Kill()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fl_") as ckpt:
        server_b, ex, rng, _ = toy_campaign(dev, clients, max_batches, seed, scenarios=False)
        try:
            run_campaign(server_b, ex, rounds, round_T=T, batch_size=batch, rng=rng, faults=plan,
                         checkpoint_dir=ckpt, on_round=killer)
            check(False, "the campaign was not killed")
        except Kill:
            pass
        server_c, ex, rng, _ = toy_campaign(dev, clients, max_batches, seed, scenarios=False)
        h_c = run_campaign(server_c, ex, rounds, round_T=T, batch_size=batch, rng=rng, faults=plan,
                           checkpoint_dir=ckpt)
    same_rounds(h_s, h_c, f"the campaign resumed after round {FL_KILL_AFTER} against the uninterrupted one")
    same_params(server_s.params, server_c.params, "the resumed campaign against the uninterrupted one")
    check(launches["row"] > 0 and launches["backtrack"] > 0, f"the chaos campaign launched {launches}")
    summ = h_s.summary()
    log(f"[fl] (c) {card}")
    log(f"[fl] (c) bench_faults.py's chaos campaign ({clients} clients, max_batches {max_batches}, batch {batch}, "
        f"{rounds} rounds, T = {T}, {len(plan.client_faults)} client faults planned): serial {serial_ms:.3f} ms, "
        f"pipelined {pipe_ms:.3f} ms, bit-identical; {len(recovered)} recovered rounds "
        f"{[r.round_index for r in recovered]}, each the independent solve of its residual instance, no fallback; "
        f"recovery overhead {summ['recovery_overhead_J']:.6f} J estimated; killed after round {FL_KILL_AFTER} and "
        f"resumed from the checkpoint: bit-identical to the uninterrupted campaign; min-plus launches of the serial "
        f"campaign {launches}")
    return launches


def fl_phase(mp, card, dev):
    """Phase 14: the FL runtime on the card. Returns each part's min-plus
    launches."""
    parts = {"launcher": fl_launcher_phase(mp, card, dev), "async": fl_async_phase(mp, card, dev),
             "faults": fl_faults_phase(mp, card, dev)}
    total = {k: sum(p[k] for p in parts.values()) for k in ("row", "backtrack")}
    check(total["row"] > 0 and total["backtrack"] > 0, f"phase 14 launched {parts}")
    return parts, total


# -- phase 15: serving the LM zoo ---------------------------------------------


def cache_tensors(cache) -> list:
    """The tensors of a decode cache: a dense ``(k, v)``, an MoE ``{"moe",
    "dense"}``, or the nested dicts and tuples of an SSM state."""
    if isinstance(cache, dict):
        return [t for x in cache.values() for t in cache_tensors(x)]
    if isinstance(cache, (tuple, list)):
        return [t for x in cache for t in cache_tensors(x)]
    return [cache]


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cache_gb(cache) -> float:
    return tensor_bytes(cache_tensors(cache)) / 1e9


@contextlib.contextmanager
def patched(module, name, make):
    """While open, ``module.<name>`` is ``make(original)``; the original is
    put back on exit."""
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def spying(module, name, record):
    """:func:`patched` with a function that calls the original and then
    ``record(result, *args)``."""

    def make(inner):
        def spy(*args, **kw):
            out = inner(*args, **kw)
            record(out, *args, **kw)
            return out

        return spy

    return patched(module, name, make)


def run_with_launches_held(fa, what, part, *args, cases=SERVE_FLASH_CASES, tag="lm"):
    """Runs ``part(*args)`` while recording, for each distinct signature
    (B, H, Hkv, S, D, kind, window, softcap, dtype) of the flash forward
    launches the models make, the first launch's inputs and its ``(o,
    lse)``. Then holds each recorded output against the plain version on
    the same inputs (:func:`flash_err`, no further launch) and checks that
    the shape is one of ``cases``, which phase 6 held. Returns ``part``'s
    result."""
    from repro_torch.models import layers

    seen = {}

    def record(out, q, k, v, kind="causal", window=0, softcap=0.0, scale=None):
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], kind, window, softcap, q.dtype)
        if key not in seen:
            seen[key] = [t.detach().clone() for t in (q, k, v, *out)] + [scale]

    with spying(layers, "flash_attention", record):
        result = part(*args)
    torch.cuda.empty_cache()
    worst = {}
    with torch.inference_mode():
        for key in list(seen):
            q, k, v, o, lse, scale = seen.pop(key)
            *shape, dtype = key
            check(tuple(shape) in cases, f"{what}: a flash launch at {tuple(shape)}, which phase 6 "
                                                     f"did not hold against the plain version")
            ok, *errs = flash_err(fa, (o, lse), q, k, v, *shape[5:], scale)
            check(ok, f"{what}: the flash launch at {key} != plain on its inputs (max |do|, |do32|, |dlse| {errs})")
            worst[str(dtype).replace("torch.", "")] = max(worst.get(str(dtype).replace("torch.", ""), 0.0), errs[0])
            log(f"[{tag}] {what}: launch (B, H, Hkv, S, D, kind, window, softcap) {tuple(shape)} {dtype}, the first "
                f"of its shape: within phase 6's tolerance of the plain version on its own inputs (max |do| "
                f"{errs[0]:.3e}, |do32| {errs[1]:.3e}, |dlse| {errs[2]:.3e})")
            del q, k, v, o, lse
            torch.cuda.empty_cache()
    return result


def routing_flips(dec_idx, pre_idx, B, n) -> torch.Tensor:
    """``(B, n)``: at each position, the layers where the experts the
    teacher-forced decode chose (``dec_idx``: one ``(B, k)`` per step and
    layer, step-major) differ as a set from the prefill's (``pre_idx``: one
    ``(B x n, k)`` per layer)."""
    L = len(pre_idx)
    dec = torch.stack(dec_idx).reshape(n, L, B, -1).permute(1, 2, 0, 3).sort(dim=-1).values
    pre = torch.stack(pre_idx).reshape(L, B, n, -1).sort(dim=-1).values
    return (dec != pre).any(dim=-1).sum(dim=0)


def teacher_forced(decode_fn, params, cfg, cache, tokens, start):
    """Decodes ``tokens[:, i]`` at position ``start + i`` for every i and
    returns the float32 logits ``(B, n, V)``; checks after every step that
    the cache is the same tensors on the same storage."""
    ptrs = [t.data_ptr() for t in cache_tensors(cache)]
    outs = []
    for i in range(tokens.shape[1]):
        lg, new = decode_fn(params, cfg, cache, tokens[:, i:i + 1], start + i)
        check([t.data_ptr() for t in cache_tensors(new)] == ptrs, f"the cache moved at decode step {start + i}")
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def decode_vs_prefill(what, got, want, tokens=None, flips=None, limit=DECODE_REL_L2):
    """Holds decode logits against prefill logits of the same positions
    ``(B, n, V)``: every position within ``limit`` (relative L2 over the
    vocabulary; DECODE_REL_L2 unless the caller argues another). With ``tokens (B, n)`` (the greedy tokens those positions
    produced), each must be the prefill's argmax wherever the prefill's
    top-2 gap exceeds twice the largest |decode - prefill| at that position
    (there no deviation that small can swap the two). With ``flips (B, n)``
    (:func:`routing_flips`), the log splits the distances by positions
    whose experts differ in some layer and positions where they agree."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite decode logits")
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    dev = (got - want).abs().amax(dim=-1)
    worst = float(rel.max())
    msg = (f"{what}: relative L2 per position max {worst:.3e}, mean {float(rel.mean()):.3e} (limit {limit:.4g}); "
           f"max |dlogit| {float(dev.max()):.3e}")
    check(worst <= limit, msg)
    if flips is not None:
        same = flips == 0
        split = lambda m: f"max {float(rel[m].max()):.3e}" if bool(m.any()) else "none"  # noqa: E731
        msg += (f"; the experts differ in {int(flips.sum())} (position, layer) pairs, at {int((~same).sum())} of "
                f"{same.numel()} positions: relative L2 there {split(~same)}, at the {int(same.sum())} positions "
                f"routed alike {split(same)}")
    if tokens is not None:
        top2 = want.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2 * dev
        agree = tokens == want.argmax(dim=-1)
        check(bool((agree | ~decided).all()), f"{what}: a greedy token differs from the prefill's argmax at a "
                                               f"position whose top-2 gap exceeds 2 max|dlogit|")
        msg += (f"; greedy tokens equal to the prefill's argmax at {int(agree.sum())} of {agree.numel()} positions, "
                f"at all {int(decided.sum())} whose top-2 gap exceeds 2 max|dlogit|")
    log(f"[lm] {msg}")


def decode_bound_ms(params, cfg, B, slots_per_layer) -> float:
    """Least time of one decode step: the parameters read once and the
    attended cache slots (k and v of ``slots_per_layer[i]`` positions of
    layer i) read once, over HBM bandwidth; the logits' write is negligible."""
    from repro_torch.optim import tree_leaves

    w = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    kv = sum(2 * B * n * cfg.num_kv_heads * cfg.hd * torch.finfo(cfg.cdtype()).bits // 8 for n in slots_per_layer)
    return 1e3 * (w + kv) / PEAK_BYTES_PER_S


def serve_launcher_part(fa, dev, card):
    """Phase 15 (a): the serve launcher's loop at its defaults on gemma2-2b
    FULL, against the prefill of the same tokens; the float32 2-layer cut.
    Returns (params, cfg, flash launches)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_fn, init_cache, init_params, param_count, prefill_fn

    cfg = serve.serve_config(get_config(ARCH))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    B, P, G = SERVE_SHAPE
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, P))).long().to(dev)
    fa.launches = fa.launches_fwd_tc = 0
    out, _, (t_pre, t_gen) = serve.generate(params, cfg, prompts, G)
    check(fa.launches == 0, f"the decode loop launched the flash kernel {fa.launches} times")
    log(f"[lm] (a) {ARCH} FULL ({param_count(params)} parameters, {cfg.param_dtype}) through launch/serve.py's "
        f"loop, B={B} prompt {P} gen {G}: teacher-forced prompt {1e3 * t_pre:.3f} ms ({1e3 * t_pre / P:.3f} ms a step), "
        f"decode {1e3 * t_gen:.3f} ms = {B * G / t_gen:.1f} tokens/s on {card}")

    full = torch.cat([prompts, out], dim=1)
    tf = teacher_forced(decode_fn, params, cfg, init_cache(cfg, B, P + G), full, 0)
    fa.launches = fa.launches_fwd_tc = 0
    want = prefill_fn(params, cfg.replace(attn_impl="flash"), {"tokens": full})
    launches = fa.launches
    check(launches == cfg.num_layers and fa.launches_fwd_tc == cfg.num_layers,
          f"the check prefill launched {launches} flash kernels ({fa.launches_fwd_tc} tensor-core)")
    decode_vs_prefill(f"(a) teacher-forced decode of all {P + G} positions vs the kernel-route prefill",
                      tf, want)
    decode_vs_prefill("(a) the loop's greedy tokens", tf[:, P - 1:P + G - 1], want[:, P - 1:P + G - 1], out)
    del tf, want

    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32", attn_impl="flash")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    tf32 = teacher_forced(decode_fn, p32, cfg32, init_cache(cfg32, B, P + G), full, 0)
    n0 = fa.launches
    want32 = prefill_fn(p32, cfg32, {"tokens": full})
    launches += fa.launches - n0
    err = float((tf32 - want32).abs().max())
    check(bool(torch.allclose(tf32, want32, rtol=DECODE_F32_TOL, atol=DECODE_F32_TOL)),
          f"(a) float32 decode vs prefill: max |dlogit| {err}")
    log(f"[lm] (a) float32, {F32_LAYERS} layers at full width: {P + G} teacher-forced steps within rtol=atol="
        f"{DECODE_F32_TOL} of the kernel-route prefill (max |dlogit| {err:.3e})")
    del p32, tf32, want32
    return params, cfg, launches


def serve_long_part(fa, dev, card, params, cfg):
    """Phase 15 (b): a cache filled by a kernel prefill of LONG_S tokens,
    then LONG_G greedy steps, the sliding layers on their windowed slice.
    Returns its flash launches."""
    from repro_torch.models import decode_fn, init_cache
    from repro_torch.models.dense import _embed, _logits, attn_pattern, stack_forward

    B, S, G = LONG_SHAPE
    cfg = cfg.replace(attn_impl="flash")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (B, S))).long().to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_fwd_tc = 0
    with torch.inference_mode():
        h, (k, v) = stack_forward(cfg, params["layers"], _embed(cfg, params, tokens), collect_cache=True)
        first = _logits(cfg, params, h[:, -1:]).argmax(dim=-1)
        del h
    check(fa.launches == cfg.num_layers, f"the cache-filling prefill launched {fa.launches} flash kernels")
    cache = init_cache(cfg, B, S + G)
    check(S + G > 2 * cfg.window, "the long shape does not reach the sliding layers' windowed slice")
    cache[0][:, :, :S].copy_(k)
    cache[1][:, :, :S].copy_(v)
    del k, v
    ptrs = [t.data_ptr() for t in cache]

    logits = torch.empty((B, G, cfg.vocab_size), device=dev)
    toks = torch.empty((B, G), dtype=torch.long, device=dev)
    tok = first
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    warm = G // 8
    for i in range(G):
        if i == warm:
            start.record()
            t0 = time.perf_counter()
        toks[:, i:i + 1] = tok
        lg, cache = decode_fn(params, cfg, cache, tok, S + i)
        logits[:, i] = lg[:, 0]
        tok = lg[:, -1].argmax(dim=-1, keepdim=True)
    end.record()
    end.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / (G - warm)
    step_ms = start.elapsed_time(end) / (G - warm)
    check([t.data_ptr() for t in cache] == ptrs, "the long cache moved")
    peak = torch.cuda.max_memory_allocated() / 1e9

    pos = S + G - 1
    total, rows, kinds, n_kernels = device_time_table(lambda p, b: decode_fn(p, cfg, cache, tok, pos), params, None)
    wall = median_wall_ms(lambda: decode_fn(params, cfg, cache, tok, pos), reps=5)
    pattern = attn_pattern(cfg)
    slots = [min(pos + 1, cfg.window) if pattern[i % len(pattern)] == "sliding" else pos + 1
             for i in range(cfg.num_layers)]
    b_ms = decode_bound_ms(params, cfg, B, slots)

    n0 = fa.launches
    full = torch.cat([tokens, toks], dim=1)
    with torch.inference_mode():
        h, _ = stack_forward(cfg, params["layers"], _embed(cfg, params, full))
        want = _logits(cfg, params, h[:, S:])
        del h
    check(fa.launches - n0 == cfg.num_layers, "the check prefill did not launch the kernel once per layer")
    launches = fa.launches
    log(f"[lm] (b) {ARCH} FULL, B={B}: cache filled by a kernel prefill of {S} tokens ({cfg.num_layers} flash "
        f"launches), copied into a cache of {S + G} slots ({cache_gb(cache):.3f} GB; > 2 x window {cfg.window}, so "
        f"the sliding layers attend to their windowed slice), {G} greedy steps; peak device memory {peak:.2f} GB")
    decode_vs_prefill(f"(b) {G} greedy decode steps at positions {S}-{S + G - 1} vs a kernel-route prefill of all "
                      f"{S + G} tokens", logits, want)
    kinds_text = ", ".join(f"{k} {t:.3f} ms" for k, t in kinds.items())
    log(f"[lm] {card}")
    log(f"[lm] (b) decode at steady state (steps {warm}-{G - 1}): {step_ms:.4f} ms a token by CUDA events "
        f"({host_ms:.4f} ms host clock) = {B * 1e3 / step_ms:.1f} tokens/s at B={B}; one step at position {pos}: "
        f"{wall:.4f} ms alone (host clock to a sync, median of 5); by the profiler the card is busy {total:.4f} ms "
        f"a step ({n_kernels} kernel launches), a share {total / step_ms:.3f} of the steady-state step (idle share "
        f"{1 - total / step_ms:.3f}); by kind {kinds_text}; bound {b_ms:.4f} ms (bytes: "
        f"the parameters and the attended k, v slots once at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s), step at "
        f"{step_ms / b_ms:.2f}x the bound")
    for t, n, name in rows:
        log(f"[lm]   {t:10.4f} ms  x{n:<5d} {name[:90]}")
    del logits, want, cache
    torch.cuda.empty_cache()
    return launches


def tf_step_ms(decode_fn, params, cfg, cache, tok, pos, reps=5):
    """One decode step's time by CUDA events (median of ``reps`` runs of 3
    steps at position ``pos``, which rewrite the same cache slot)."""
    return median_event_ms(lambda: decode_fn(params, cfg, cache, tok, pos), reps=reps, per_rep=3, warmup=1)


def routed_decode_and_prefill(params, scfg, cfg, tokens):
    """Teacher-forced decode of ``tokens`` under ``scfg``, a prefill of them
    under ``cfg``, and a prefill whose router takes, in every layer, the
    experts the decode chose for each token (its gate weights from its own
    probabilities at those experts, normalised as ``route`` does): their
    float32 logits ``(B, n, V)`` and :func:`routing_flips` between the
    decode's experts and the first prefill's."""
    from repro_torch.models import decode_fn, init_cache, moe_dispatch, prefill_fn

    B, n = tokens.shape
    dec_idx, pre_idx = [], []
    with spying(moe_dispatch, "route", lambda out, *args: dec_idx.append(out[1])):
        tf = teacher_forced(decode_fn, params, scfg, init_cache(scfg, B, n), tokens, 0)
    with spying(moe_dispatch, "route", lambda out, *args: pre_idx.append(out[1])):
        want = prefill_fn(params, cfg, {"tokens": tokens})
    L = len(pre_idx)
    by_layer = iter(torch.stack(dec_idx).reshape(n, L, B, -1).permute(1, 2, 0, 3).reshape(L, B * n, -1))

    def make(inner):
        def routed_as_decoded(cfg_, x2d, router_w, *rest):
            _, _, aux = inner(cfg_, x2d, router_w, *rest)
            idx = next(by_layer)
            w = torch.softmax(x2d.float() @ router_w.float(), dim=-1).gather(1, idx)
            return w / w.sum(-1, keepdim=True).clamp_min(1e-9), idx, aux

        return routed_as_decoded

    with patched(moe_dispatch, "route", make):
        alike = prefill_fn(params, cfg, {"tokens": tokens})
    check(next(by_layer, None) is None, "the prefill routed as decoded did not route every layer")
    return tf, want, alike, routing_flips(dec_idx, pre_idx, B, n)


def serve_moe_part(fa, dev):
    """Phase 15 (c): olmoe-1b-7b FULL: a kernel-route prefill with the dense
    expert dispatch, the serve launcher's loop with the einsum dispatch, and
    teacher-forced decode against the prefill. Returns flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_fn, init_cache, init_params, param_count, prefill_fn
    from repro_torch.models.moe_dispatch import einsum_capacity

    cfg = get_config(MOE_ARCH).replace(attn_impl="flash")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = MOE_PREFILL
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, S))).long().to(dev)
    fa.launches = fa.launches_fwd_tc = 0
    logits = prefill_fn(params, cfg, {"tokens": tokens})
    check(fa.launches == cfg.num_layers == fa.launches_fwd_tc, f"olmoe prefill: {fa.launches} flash launches")
    check(bool(torch.isfinite(logits).all()), "olmoe prefill: non-finite logits")
    del logits
    prefill_ms = median_wall_ms(lambda: prefill_fn(params, cfg, {"tokens": tokens}), reps=1)
    launches = fa.launches
    log(f"[lm] (c) {MOE_ARCH} FULL: {param_count(params)} parameters ({cfg.param_dtype}, {cfg.num_experts} "
        f"experts top-{cfg.top_k}) initialised in {init_s:.2f} s; kernel-route prefill B={B} S={S}, moe_impl dense (every "
        f"expert on every token): {cfg.num_layers} flash launches, finite logits, warm {prefill_ms:.3f} ms = "
        f"{B * S / prefill_ms * 1e3:.1f} tokens/s")

    scfg = serve.serve_config(cfg)
    Bs, P, G = SERVE_SHAPE
    check(einsum_capacity(scfg, Bs) >= Bs, "the einsum dispatch would drop tokens at decode")
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (Bs, P))).long().to(dev)
    out, _, (t_pre, t_gen) = serve.generate(params, scfg, prompts, G)
    full = torch.cat([prompts, out], dim=1)
    n0 = fa.launches
    tf, want, alike, flips = routed_decode_and_prefill(params, scfg, cfg, full)
    launches += fa.launches - n0
    log(f"[lm] (c) launch/serve.py's loop, moe_impl einsum (capacity {einsum_capacity(scfg, Bs)} slots an expert "
        f"at T = {Bs}: nothing drops), B={Bs} prompt {P} gen {G}: prompt {1e3 * t_pre / P:.3f} ms a step, decode "
        f"{Bs * G / t_gen:.1f} tokens/s")
    decode_vs_prefill(f"(c) teacher-forced einsum decode of {P + G} positions vs the dense-dispatch kernel "
                      f"prefill", tf, want, flips=flips)
    decode_vs_prefill("(c) the loop's greedy tokens", tf[:, P - 1:P + G - 1], want[:, P - 1:P + G - 1], out,
                      flips=flips[:, P - 1:P + G - 1])
    decode_vs_prefill(f"(c) the same decode vs a dense-dispatch kernel prefill routed, in every layer, to the "
                      f"experts the decode chose", tf, alike)
    del tf, want, alike

    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    n0 = fa.launches
    tf32, want32, alike32, flips32 = routed_decode_and_prefill(p32, serve.serve_config(cfg32), cfg32, full)
    launches += fa.launches - n0
    errs = [float((tf32 - w).abs().max()) for w in (want32, alike32)]
    check(all(bool(torch.allclose(tf32, w, rtol=DECODE_F32_TOL, atol=DECODE_F32_TOL)) for w in (want32, alike32)),
          f"(c) float32 einsum decode vs dense-dispatch prefill, routed freely and as decoded: max |dlogit| {errs} "
          f"(experts differ in {int(flips32.sum())} (position, layer) pairs)")
    log(f"[lm] (c) float32, {F32_LAYERS} layers at full width: {P + G} teacher-forced einsum-dispatch steps within "
        f"rtol=atol={DECODE_F32_TOL} of the dense-dispatch kernel-route prefill, routed freely (max |dlogit| "
        f"{errs[0]:.3e}; experts differ in {int(flips32.sum())} (position, layer) pairs) and as decoded "
        f"({errs[1]:.3e})")
    del p32, tf32, want32, alike32
    cache = init_cache(scfg, Bs, P + G)
    ms = tf_step_ms(decode_fn, params, scfg, cache, out[:, -1:], P + G - 1)
    log(f"[lm] (c) decode step at B={Bs}: {ms:.4f} ms by CUDA events = {Bs * 1e3 / ms:.1f} tokens/s; bound "
        f"{decode_bound_ms(params, scfg, Bs, [P + G] * cfg.num_layers):.4f} ms (every expert's weights read)")
    del params, cache
    torch.cuda.empty_cache()
    return launches


def serve_mla_part(fa, dev):
    """Phase 15 (d): deepseek-v3-671b at full width, depth cut: a prefill
    (every layer on the kernel: the dense prefix layer's MHA, and MLA on v
    zero-padded to q's head dim), then absorbed decode against the
    non-absorbed prefill. Returns flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_fn, init_cache, init_params, param_count
    from repro_torch.models.layers import apply_rope, make_rope
    from repro_torch.models.moe import moe_forward

    cfg = get_config(MLA_ARCH).replace(attn_impl="flash", **MLA_CUT)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    S, n = MLA_S, TF_STEPS
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, S))).long().to(dev)
    fa.launches = fa.launches_fwd_tc = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        want, _, caches, _ = moe_forward(params, cfg, tokens, collect_cache=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fa.launches
    check(launches == cfg.num_layers, f"deepseek-v3 prefill: {launches} flash launches (one a layer: the MLA "
                                      f"layers and the dense prefix layer)")
    check(bool(torch.isfinite(want).all()), "deepseek-v3 prefill: non-finite logits")
    log(f"[lm] (d) {MLA_ARCH} at full width, cut to {MLA_CUT} ({param_count(params)} parameters, "
        f"{cfg.param_dtype}, MTP head included) initialised in {init_s:.2f} s; prefill B=1 S={S} (MLA: q/k head dim {cfg.hd + cfg.rope_head_dim} "
        f"and v's {cfg.v_head_dim} zero-padded to the kernels' 256; {launches} flash launches; moe_impl dense): first "
        f"call {prefill_s:.3f} s")

    scfg = serve.serve_config(cfg)
    cache = init_cache(scfg, 1, S)
    start = S - n
    with torch.inference_mode():  # the absorbed cache holds k_rope after the rope; the prefill collects it before
        k, v = caches["dense"]
        cache["dense"][0][:, :, :start].copy_(k[:, :, :start])
        cache["dense"][1][:, :, :start].copy_(v[:, :, :start])
        ckv, kr = caches["moe"]
        sin, cos = make_rope(torch.arange(S, device=dev), cfg.rope_head_dim, cfg.rope_base)
        kr = apply_rope(kr[..., None, :], sin, cos)[..., 0, :]
        cache["moe"][0][:, :, :start].copy_(ckv[:, :, :start])
        cache["moe"][1][:, :, :start].copy_(kr[:, :, :start])
    del caches, k, v, ckv, kr
    tf = teacher_forced(decode_fn, params, scfg, cache, tokens[:, start:], start)
    decode_vs_prefill(f"(d) {n} teacher-forced absorbed-decode steps at positions {start}-{S - 1} (kv_lora_rank "
                      f"{cfg.kv_lora_rank}) vs the non-absorbed prefill", tf, want[:, start:])
    ms = tf_step_ms(decode_fn, params, scfg, cache, tokens[:, -1:], S - 1)
    log(f"[lm] (d) absorbed decode step at B=1, cache {S} slots ({cache_gb(cache):.4f} GB): {ms:.4f} ms by CUDA "
        f"events")
    del params, want, tf, cache
    torch.cuda.empty_cache()
    return launches


def serve_dense_part(fa, dev, arch):
    """Phase 15 (e): one dense FULL config: a kernel-route prefill of
    DENSE_S tokens that also fills the cache, then TF_STEPS teacher-forced
    decode steps at the last positions against it. Returns flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_fn, init_cache, init_params, param_count
    from repro_torch.models.dense import dense_forward

    cfg = get_config(arch).replace(attn_impl="flash")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    S, n = DENSE_S, TF_STEPS
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, S))).long().to(dev)
    fa.launches = fa.launches_fwd_tc = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        want, (k, v) = dense_forward(params, cfg, tokens, collect_cache=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fa.launches
    check(launches == cfg.num_layers == fa.launches_fwd_tc, f"{arch} prefill: {launches} flash launches")
    check(bool(torch.isfinite(want).all()), f"{arch} prefill: non-finite logits")
    start = S - n
    want = want[:, start:].clone()
    cache = init_cache(cfg, 1, S)
    cache[0][:, :, :start].copy_(k[:, :, :start])
    cache[1][:, :, :start].copy_(v[:, :, :start])
    del k, v
    G = cfg.num_heads // cfg.num_kv_heads
    log(f"[lm] (e) {arch} FULL ({param_count(params)} parameters, {cfg.param_dtype}, H={cfg.num_heads} "
        f"Hkv={cfg.num_kv_heads}: G={G}, D={cfg.hd}, {cfg.mlp_kind} MLP) initialised in {init_s:.2f} s; kernel-route prefill B=1 S={S}: "
        f"{launches} flash launches (all tensor-core), first call {prefill_s:.3f} s, finite logits")
    tf = teacher_forced(decode_fn, params, cfg, cache, tokens[:, start:], start)
    decode_vs_prefill(f"(e) {arch}: {n} teacher-forced decode steps at positions {start}-{S - 1} vs the prefill",
                      tf, want)
    ms = tf_step_ms(decode_fn, params, cfg, cache, tokens[:, -1:], S - 1)
    b_ms = decode_bound_ms(params, cfg, 1, [S] * cfg.num_layers)
    log(f"[lm] (e) {arch} decode step at B=1, cache {S} slots ({cache_gb(cache):.3f} GB): {ms:.4f} ms by CUDA "
        f"events; bound {b_ms:.4f} ms (bytes), {ms / b_ms:.2f}x")
    del params, want, tf, cache
    torch.cuda.empty_cache()
    return launches


def serve_phase(fa, dev, card):
    """Phase 15: serving the LM zoo. Returns the flash launches by part."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    params, cfg, la = run_with_launches_held(fa, "(a)", serve_launcher_part, fa, dev, card)
    lb = run_with_launches_held(fa, "(b)", serve_long_part, fa, dev, card, params, cfg)
    del params
    torch.cuda.empty_cache()
    parts = {"a": la, "b": lb, "c": run_with_launches_held(fa, "(c)", serve_moe_part, fa, dev),
             "d": run_with_launches_held(fa, "(d)", serve_mla_part, fa, dev)}
    for arch in DENSE_ARCHS:
        parts[f"e:{arch}"] = run_with_launches_held(fa, f"(e) {arch}", serve_dense_part, fa, dev, arch)
    log(f"[lm] phase 15 wall time {time.perf_counter() - t0:.1f} s; flash launches by part {parts}")
    return parts


# -- phase 16: the SSM families ---------------------------------------------


def run_with_bwd_launches_held(fa, what, part, *args, cases=SSM_FLASH_BWD_CASES, tag="ssm", values=True):
    """Runs ``part(*args)`` while recording, for each distinct signature
    (B, H, Hkv, S, D, kind, window, softcap, dtype) of the flash backward
    calls the models make, the first call's inputs and its ``(dq, dk, dv)``
    (D is the kernel's: a model's D = 80 arrives zero-padded to 128). Then
    holds each against the plain backward on the same inputs
    (:func:`bwd_err`) and checks that the shape is one of ``cases``, which
    phase 9 held (the window compared only for a sliding launch: the other
    kinds ignore it). With ``values="float64"`` (bfloat16 launches) the
    values are held instead against a float64 plain backward on the same
    inputs (:func:`ref64`) within :func:`f64_limits`, and the check is shown
    to still catch a tile visited wrongly (:func:`tile_margins` under those
    limits: every diagonal tile's contribution exceeds them somewhere).
    Returns ``part``'s result."""
    seen = {}

    def record(out, q, k, v, o, lse, do, kind="causal", window=0, softcap=0.0, scale=None):
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], kind, window, softcap, q.dtype)
        if key not in seen:
            seen[key] = ([t.detach().clone() for t in (q, k, v, o, lse, do)], [t.detach().clone() for t in out], scale)

    with spying(fa, "flash_attention_bwd", record):
        result = part(*args)

    def sig(B, H, Hkv, S, D, kind, window, softcap):
        return B, H, Hkv, S, fa.kernel_head_dim(D), kind, window if kind == "sliding" else 0, softcap

    allowed = {sig(*case) for case in cases}
    for key in list(seen):
        inputs, got, scale = seen.pop(key)
        *shape, dtype = key
        check(sig(*shape) in allowed, f"{what}: a flash backward launch at {tuple(shape)}, which phase 9 did not hold "
                                      f"against the plain version")
        ok, errs, want = bwd_err(fa, got, inputs, *shape[5:], scale)
        if values == "float64":
            check(dtype == torch.bfloat16, f"{what}: a float64-held backward launch in {dtype}")
            held_f64(fa, what, tag, key, inputs, got, want, scale)
        else:
            check(ok, f"{what}: the flash backward at {key} != plain on its inputs (max |d dq|, |d dk|, |d dv| "
                      f"{errs})")
        verdict = "within" if ok else "NOT within (printed; held against float64)"
        log(f"[{tag}] {what}: backward launch (B, H, Hkv, S, D, kind, window, softcap) {tuple(shape)} {dtype}, the "
            f"first of its shape: {verdict} phase 9's tolerance of the plain backward on its own inputs (max |d dq| "
            f"{errs[0]:.3e}, |d dk| {errs[1]:.3e}, |d dv| {errs[2]:.3e})")
        del inputs, got, want
        torch.cuda.empty_cache()
    return result


def held_f64(fa, what, tag, key, inputs, got, want, scale):
    """Holds a bfloat16 backward launch's ``got = (dq, dk, dv)`` against the
    float64 plain backward on its ``inputs`` within :func:`f64_limits`, and
    checks that a tile visited wrongly would still fail that limit
    (:func:`tile_margins`, every ratio above 1)."""
    q, k, v, o, lse, do = inputs
    kind, window, softcap = key[5:8]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    w64, d_lse, d_o = ref64(fa, q, k, v, o, lse, do, kind, window, softcap, scale)
    lims = [f64_limits(w) for w in w64]
    parts = []
    for name, g, w6, lim, w32 in zip(("dq", "dk", "dv"), got, w64, lims, want):
        ratio = (g.double() - w6).abs() / lim
        worst = float(ratio.max())
        check(worst <= 1.0, f"{what}: the flash backward's {name} at {key} lies {worst:.3f}x the float64 limit from "
                            f"the float64 plain backward")
        parts.append(f"{name} worst {worst:.3f}x the limit (kernel max |d| {float((g.double() - w6).abs().max()):.3e}"
                     f", float32 plain {float((w32.double() - w6).abs().max()):.3e})")
    margins = tile_margins(fa, inputs, want, kind, window, softcap, lims=[lim.float() for lim in lims])
    for name, (c, m) in margins.items():
        check(m > 1.0, f"{what}: a {name} tile visited wrongly moves it by at most {m:.3f}x the float64 limit")
    log(f"[{tag}] {what}: backward launch {key[:8]} held against the float64 plain backward (1 bf16 ulp at its "
        f"binade + {BWD_BF16_ATOL_REL} of its largest entry; forward |lse - lse64| {d_lse:.3e}, |o - o64| "
        f"{d_o:.3e}): " + "; ".join(parts) + "; one tile visited wrongly (smallest contribution, its ratio to the "
        "limit): " + ", ".join(f"{n} {c:.3e} {m:.1f}x" for n, (c, m) in margins.items()))
    del w64, lims
    torch.cuda.empty_cache()


def ssm_prefix_decode(params, cfg, tokens):
    """A collect-state prefill of ``tokens[:, :start]`` with ``start = S -
    cfg.chunk_size``, then TF_STEPS teacher-forced decode steps from its
    state at positions ``start ..``. zamba2's collected keys and values go
    into a cache of S slots first (its collect-state prefill fills a cache
    exactly as long as the prompt). Returns the steps' float32 logits ``(B,
    TF_STEPS, V)``, the state after them and ``start``; checks that the KV
    cache stays the same tensors."""
    from repro_torch.models import decode_fn, hybrid, init_cache, xlstm

    B, S = tokens.shape
    start = S - cfg.chunk_size
    with torch.inference_mode():
        if cfg.family == "ssm":
            _, state = xlstm.xlstm_forward(params, cfg, tokens[:, :start], collect_state=True)
        else:
            _, state = hybrid.zamba_forward(params, cfg, tokens[:, :start], collect_state=True)
            attn = init_cache(cfg, B, S)["attn"]
            for dst, src in zip(attn, state["attn"]):
                dst[:, :, :start].copy_(src)
            state = {"mamba": state["mamba"], "attn": attn}
    kv = state.get("attn", ())
    outs = []
    for i in range(TF_STEPS):
        lg, state = decode_fn(params, cfg, state, tokens[:, start + i:start + i + 1], start + i)
        outs.append(lg[:, 0])
    check(all(a is b for a, b in zip(state.get("attn", ()), kv)), "the KV cache was not written in place")
    return torch.stack(outs, dim=1), state, start


def ssm_decode_bound_ms(params, cfg, state, pos):
    """Least time of one decode step at position ``pos``: the parameters read
    once (zamba2's shared block once for each of its applications), the
    recurrent states read and written once, and the attended KV slots
    (positions 0..pos of every application's cache) read once, over HBM
    bandwidth. Returns (ms, (weight, KV, state bytes))."""
    from repro_torch.optim import tree_leaves

    w = tensor_bytes(tree_leaves(params))
    kv = 0
    rec = 2 * tensor_bytes(cache_tensors(state["mamba"] if cfg.family == "hybrid" else state))
    if cfg.family == "hybrid":
        shared = tensor_bytes(tree_leaves({k: params[k] for k in ("shared", "shared_in_proj")}))
        w += (cfg.num_layers // cfg.shared_attn_every - 1) * shared
        k, _ = state["attn"]
        kv = 2 * k[:, :, :pos + 1].numel() * k.element_size()
    return 1e3 * (w + kv + rec) / PEAK_BYTES_PER_S, (w, kv, rec)


def slstm_bound_ms(args):
    """Least time of one sLSTM scan: its recurrent products (2 x 4D flops per
    entry of h, in float32 outside the tensor cores) over the float32 peak,
    or its bytes (the four gate inputs, the weights and the float32 output)
    over HBM bandwidth. The time steps depend on each other, which no
    roofline counts."""
    z, r = args[0], args[4]
    B, L, H, D = z.shape
    flops = 2 * B * L * H * D * 4 * D
    nbytes = 4 * z.numel() * z.element_size() + tensor_bytes(r.values()) + 4 * z.numel()
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kinds_text(kinds) -> str:
    return ", ".join(f"{k} {t:.3f} ms" for k, t in kinds.items())


def ssm_part(fa, dev, card, arch):
    """Phase 16 (a) xlstm-1.3b or (b) zamba2-2.7b at full width and depth:
    the prefill, decode against it (bfloat16 and the float32 cut), training.
    Returns (flash launches by use, figures)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_prefill_step, build_serve_step, build_train_step
    from repro_torch.models import init_params, make_dummy_batch, param_count, prefill_fn, xlstm
    from repro_torch.models import ssm as cells
    from repro_torch.optim import tree_map

    what = "(a)" if arch == SSM_ARCHS[0] else "(b)"
    cfg = get_config(arch).replace(attn_impl="flash")
    hybrid = cfg.family == "hybrid"
    check(cfg.chunk_size == SSM_CHUNK and cfg.remat == "full" and cfg.optimizer == "adamw",
          f"{arch} FULL: chunk {cfg.chunk_size}, remat {cfg.remat}, {cfg.optimizer}")
    n_attn = cfg.num_layers // cfg.shared_attn_every if hybrid else 0
    if hybrid:
        check(cfg.hd == 80 and fa.kernel_head_dim(cfg.hd) == 128, f"{arch}: head dim {cfg.hd} runs on the "
                                                                    f"D = {fa.kernel_head_dim(cfg.hd)} kernels")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    S = SSM_S[arch]
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, S))).long().to(dev)
    batch = {"tokens": tokens}
    step = build_prefill_step(cfg)
    launches, figs = {}, {}
    t_part = time.perf_counter()

    def slog(msg):
        log(f"[ssm] {what} +{time.perf_counter() - t_part:.1f} s: {msg}")

    layout = (f"{cfg.num_layers} Mamba2 layers, the shared attention block applied {n_attn} times (H = Hkv = "
              f"{cfg.num_heads}, D = {cfg.hd} on the D = {fa.kernel_head_dim(cfg.hd)} kernels, zero-padded)" if hybrid
              else f"{cfg.num_layers} blocks, one sLSTM in {cfg.slstm_every}, H = {cfg.num_heads}, inner "
                   f"{cfg.ssm_expand * cfg.d_model}")
    slog(f"{arch} FULL: {param_count(params)} parameters ({cfg.param_dtype}, "
        f"{tensor_bytes(cache_tensors(params)) / 1e9:.3f} GB), {layout}, d = {cfg.d_model}, V = {cfg.vocab_size}, "
        f"chunk {cfg.chunk_size}; initialised on the card in {init_s:.2f} s")

    # -- prefill
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_fwd_tc = 0
    scans = []
    t0 = time.perf_counter()
    with spying(xlstm, "slstm_scan", lambda out, *args, **kw: scans.append(args) if not scans else None):
        logits = step(params, batch)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (1, S, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"{what} prefill: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    check(fa.launches == n_attn and fa.launches_fwd_tc == n_attn,
          f"{what} prefill: {fa.launches} flash launches ({fa.launches_fwd_tc} tensor-core), expected {n_attn}")
    check(len(scans) == (0 if hybrid else 1), f"{what} prefill: sLSTM scans recorded {len(scans)}")
    launches["prefill"] = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    start = S - SSM_CHUNK
    want = logits[:, start:start + TF_STEPS].clone()
    last = logits[:, -1].clone()
    del logits
    prefill_ms = median_wall_ms(lambda: step(params, batch), reps=1)
    busy, rows, kinds, n_kernels = device_time_table(lambda p, b: step(p, b), params, batch, top=6)
    figs.update(prefill_ms=prefill_ms, prefill_tokens_s=S / prefill_ms * 1e3, prefill_busy_ms=busy,
                prefill_launches=n_kernels, prefill_peak_gb=peak_gb)
    slog(f"prefill B=1 S={S}: {launches['prefill']} flash launches{' (all tensor-core)' if n_attn else ''}, finite logits, "
        f"first call {cold_s:.3f} s, warm {prefill_ms:.3f} ms (host clock) = {S / prefill_ms * 1e3:.1f} tokens/s, "
        f"peak device memory {peak_gb:.2f} GB; by the profiler {busy:.3f} ms of kernel time over {n_kernels} "
        f"launches, busy share {busy / prefill_ms:.3f} (idle {1 - busy / prefill_ms:.3f}); by kind {kinds_text(kinds)}")
    for t, n, name in rows:
        log(f"[ssm]   {t:10.3f} ms  x{n:<7d} {name[:90]}")
    if hybrid:
        plain = prefill_fn(params, cfg.replace(attn_impl="plain"), batch)[:, -1].clone()
        torch.cuda.empty_cache()
        rel = float((last - plain).norm() / plain.norm())
        slog(f"last position, kernel route vs plain route (block_q={cfg.attn_block_q}): relative L2 "
            f"{rel:.3e} (limit {PREFILL_REL_L2}), max |dlogit| {float((last - plain).abs().max()):.3e}")
        check(rel <= PREFILL_REL_L2, f"{what}: the kernel route's last logits differ from the plain route's: {rel}")
        del plain
    else:
        # one layer's sLSTM scan on the prefill's own inputs, alone
        with torch.inference_mode():
            args = scans.pop()
            scan_busy, _, scan_kinds, scan_kernels = device_time_table(lambda p, b: cells.slstm_scan(*args), None,
                                                                       None)
            scan_ms = median_event_ms(lambda: cells.slstm_scan(*args), reps=1, warmup=0)
            scan_wall = median_wall_ms(lambda: cells.slstm_scan(*args), reps=1)
        n_s = cfg.num_layers // cfg.slstm_every
        b_ms, b_by = slstm_bound_ms(args)
        figs.update(slstm_layer_ms=scan_ms, slstm_layer_busy_ms=scan_busy, slstm_layer_launches=scan_kernels,
                    slstm_share_busy=n_s * scan_busy / busy, slstm_share_wall=n_s * scan_ms / prefill_ms,
                    slstm_bound_ms=b_ms)
        slog(f"one layer's sLSTM scan (L = {S} steps, B=1, H = {cfg.num_heads}, D = "
            f"{cfg.d_model // cfg.num_heads}) on the prefill's inputs: {scan_ms:.3f} ms by CUDA events "
            f"({scan_wall:.3f} ms host clock), {scan_busy:.3f} ms of kernel time over {scan_kernels} launches "
            f"({scan_kernels / S:.1f} a step, {1e3 * scan_ms / S:.2f} us a step), busy share {scan_busy / scan_ms:.3f}; "
            f"bound {b_ms:.4f} ms ({b_by}); x {n_s} layers = {n_s * scan_busy:.3f} ms, a share "
            f"{n_s * scan_busy / busy:.3f} of the prefill's kernel time and {n_s * scan_ms / prefill_ms:.3f} of its "
            f"warm time; by kind {kinds_text(scan_kinds)}")
        del args
    torch.cuda.empty_cache()

    # -- decode against the prefill, beside the prefill's own rounding
    n0 = fa.launches
    wide_cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    exact = prefill_fn(tree_map(lambda t: t.float(), params), wide_cfg, batch)[:, start:start + TF_STEPS].clone()
    launches["float32 reference"] = fa.launches - n0
    check(launches["float32 reference"] == n_attn, f"{what}: the float32 reference prefill launched "
                                                   f"{launches['float32 reference']}")
    torch.cuda.empty_cache()
    rounding = float(((want - exact).norm(dim=-1) / exact.norm(dim=-1)).max())
    figs.update(bf16_vs_float32=rounding)
    slog(f"the bfloat16 prefill against the same weights run in float32, positions {start}-"
        f"{start + TF_STEPS - 1}: relative L2 max {rounding:.3e}")
    n0 = fa.launches
    got, state, start = ssm_prefix_decode(params, cfg, tokens)
    launches["decode check"] = fa.launches - n0
    check(launches["decode check"] == n_attn, f"{what}: the collect-state prefill launched {launches['decode check']}")
    dec = ((got - want).norm(dim=-1) / want.norm(dim=-1))
    figs.update(decode_rel_l2_max=float(dec.max()), decode_rel_l2_mean=float(dec.mean()))
    decode_vs_prefill(f"{what} {arch}: {TF_STEPS} teacher-forced decode steps at positions {start}-"
                      f"{start + TF_STEPS - 1}, after a collect-state prefill of {start} tokens, vs the prefill",
                      got, want, limit=max(DECODE_REL_L2, rounding))
    del exact
    serve_step = build_serve_step(cfg)
    pos = start + TF_STEPS
    tok = tokens[:, -1:]
    step_ms = median_event_ms(lambda: serve_step(params, state, tok, pos), reps=5, per_rep=3, warmup=1)
    wall = median_wall_ms(lambda: serve_step(params, state, tok, pos), reps=5)
    dbusy, drows, dkinds, dn = device_time_table(lambda p, b: serve_step(p, state, tok, pos), params, None)
    b_ms, (w, kv, rec) = ssm_decode_bound_ms(params, cfg, state, pos)
    figs.update(decode_ms=step_ms, decode_wall_ms=wall, decode_busy_ms=dbusy, decode_launches=dn, decode_bound_ms=b_ms)
    slog(f"serve step at B=1, position {pos}: {step_ms:.4f} ms a token by CUDA events (3 back to back, "
        f"median of 5), {wall:.4f} ms alone (host clock to a sync); by the profiler {dbusy:.4f} ms of kernel time over "
        f"{dn} launches, busy share {dbusy / step_ms:.3f}; by kind {kinds_text(dkinds)}; bound {b_ms:.4f} ms (bytes: "
        f"weights {w / 1e9:.3f} GB, KV slots {kv / 1e9:.3f} GB, states read and written {rec / 1e9:.3f} GB at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s), step at {step_ms / b_ms:.2f}x the bound; state "
        f"{cache_gb(state):.3f} GB")
    for t, n, name in drows[:4]:
        log(f"[ssm]   {t:10.4f} ms  x{n:<5d} {name[:90]}")
    del got, state, want
    torch.cuda.empty_cache()

    # -- the float32 cut
    cfg32 = cfg.replace(num_layers=SSM_F32_LAYERS[arch], param_dtype="float32", compute_dtype="float32")
    n32 = cfg32.num_layers // cfg32.shared_attn_every if hybrid else 0
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    n0, n0_tc = fa.launches, fa.launches_fwd_tc
    full32 = prefill_fn(p32, cfg32, batch)
    launches["float32 cut"] = fa.launches - n0
    check(fa.launches - n0 == n32 and fa.launches_fwd_tc == n0_tc, f"{what} float32 prefill: "
                                                                   f"{fa.launches - n0} flash launches")
    want32 = full32[:, start:start + TF_STEPS].clone()
    route = ""
    if hybrid:
        plain32 = prefill_fn(p32, cfg32.replace(attn_impl="plain"), batch)
        err = float((full32 - plain32).abs().max())
        check(bool(torch.allclose(full32, plain32, rtol=1e-4, atol=1e-4)), f"{what} float32 prefill, kernel vs "
                                                                          f"plain route: max |dlogit| {err}")
        route = f"; the kernel-route prefill within rtol=atol=1e-4 of the plain route at all {S} positions " \
                f"(max |dlogit| {err:.3e})"
        del plain32
    del full32
    n0 = fa.launches
    got32, _, _ = ssm_prefix_decode(p32, cfg32, tokens)
    check(fa.launches - n0 == n32, f"{what}: the float32 collect-state prefill launched {fa.launches - n0}")
    launches["float32 cut"] += fa.launches - n0
    err = float((got32 - want32).abs().max())
    check(bool(torch.allclose(got32, want32, rtol=DECODE_F32_TOL, atol=DECODE_F32_TOL)),
          f"{what} float32 decode vs prefill: max |dlogit| {err}")
    slog(f"float32, {cfg32.num_layers} layers at full width: {TF_STEPS} teacher-forced steps after a "
        f"collect-state prefill of {start} tokens within rtol=atol={DECODE_F32_TOL} of the prefill (max |dlogit| "
        f"{err:.3e}){route}")
    del p32, got32, want32
    torch.cuda.empty_cache()

    # -- training
    tb = make_dummy_batch(cfg, 1, SSM_TRAIN_S[arch], "train", np.random.default_rng(SEED), device=dev)
    tstep, opt = build_train_step(cfg)
    ostate = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = ("launches", "launches_dq", "launches_dkv", "launches_fwd_tc", "launches_dq_tc", "launches_dkv_tc")
    before = {c: getattr(fa, c) for c in counters}
    losses, secs, out = [], [], {}
    for i in range(SSM_TRAIN_STEPS):
        n0 = [getattr(fa, c) for c in counters]
        t0 = time.perf_counter()
        if i == SSM_TRAIN_STEPS - 1:  # the last step under the profiler: the card's busy time
            def run(p, b):
                out["step"] = tstep(p, ostate, b)

            tbusy, trows, tkinds, tn = device_time_table(run, params, tb, top=6)
            params, ostate, loss = out.pop("step")
        else:
            params, ostate, loss = tstep(params, ostate, tb)
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per = tuple(getattr(fa, c) - n for c, n in zip(counters, n0))
        check(per == (2 * n_attn, n_attn, n_attn) * 2, f"{what} train step {i + 1}: (forward, dQ, dK/dV) launches and "
                                                       f"their tensor-core ones {per}, expected "
                                                       f"{(2 * n_attn, n_attn, n_attn) * 2}")
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"{what} train step {i + 1}: loss {losses[-1]}")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall over {SSM_TRAIN_STEPS} steps on one batch: {losses}")
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    for c, key in (("launches", "train forward"), ("launches_dq", "train dq"), ("launches_dkv", "train dkv")):
        launches[key] = getattr(fa, c) - before[c]
    T = SSM_TRAIN_S[arch]
    warm_ms = 1e3 * secs[1]
    figs.update(train_warm_ms=warm_ms, train_tokens_s=T / warm_ms * 1e3, train_busy_ms=tbusy, train_launches=tn,
                train_peak_gb=train_peak, losses=losses)
    slog(f"{SSM_TRAIN_STEPS} train steps (remat {cfg.remat}, {cfg.optimizer} lr {cfg.learning_rate}) "
        f"B=1 S={T}: per step {2 * n_attn} forward (with the remat recompute), {n_attn} dQ and {n_attn} dK/dV flash "
        f"launches{', all tensor-core' if n_attn else ''}; losses {', '.join(f'{x:.5f}' for x in losses)}; steps "
        f"{', '.join(f'{x:.3f}' for x in secs)} s (the first cold, the last under the profiler); warm "
        f"{warm_ms:.3f} ms = {T / warm_ms * 1e3:.1f} tokens/s; peak device memory {train_peak:.2f} GB; by the "
        f"profiler {tbusy:.3f} ms of kernel time over {tn} launches, busy share {tbusy / warm_ms:.3f} of the warm "
        f"step; by kind {kinds_text(tkinds)}")
    for t, n, name in trows:
        log(f"[ssm]   {t:10.3f} ms  x{n:<7d} {name[:90]}")
    del params, ostate, tb, tstep, opt
    torch.cuda.empty_cache()
    return launches, figs


def padded_flash_times(fa, dev, card, tag, who, H, kind, window, fwd_shapes, bwd_shape):
    """The flash kernels at a model's D = 80 shapes (H = Hkv = ``H``), where
    D = 80 runs on the D = 128 kernels on zero-padded inputs: each kernel
    alone on padded inputs, by CUDA events around 3 back-to-back launches (a
    launch of 1-5 ms dwarfs its enqueue; the profiler dropped 3 of 5 of
    these records in one session), the whole padded call beside it (the
    padding's and slicing's copies, and the backward's delta), their bound
    at D = 80 and at 128, and ``scaled_dot_product_attention`` (forward, and
    its backward) at D = 80. ``fwd_shapes`` are the (B, S) of the forward
    launches timed, ``bwd_shape`` the backward's. Returns the JSON fields."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = {}
    D, Dk = 80, fa.kernel_head_dim(80)
    scale = D ** -0.5
    mask = f"{kind}{f'({window})' if kind == 'sliding' else ''}"
    for B, S in fwd_shapes:
        q, k, v = flash_inputs(gen, B, H, H, S, D, torch.bfloat16, dev)
        qp, kp, vp = (F.pad(x, (0, Dk - D)) for x in (q, k, v))
        n0 = fa.launches_fwd_tc
        ms = median_event_ms(lambda: fa.flash_attention(qp, kp, vp, kind, window, 0.0, scale), reps=5, per_rep=3)
        call_ms = median_event_ms(lambda: fa.flash_attention(q, k, v, kind, window, 0.0), reps=5, per_rep=3)
        check(fa.launches_fwd_tc - n0 == 2 * (3 + 5 * 3), "the D = 80 forward timing did not launch the tensor-core "
                                                          "kernel once a call")
        b80, by80 = flash_bound_ms(B, H, H, S, D, kind, window, 2)
        b128, _ = flash_bound_ms(B, H, H, S, Dk, kind, window, 2)
        lib = median_event_ms(lambda: library_attention(fa, F, q, k, v, kind, window), reps=5, per_rep=3)
        res[f"fwd_S{S}"] = dict(ms=ms, pad_ms=call_ms - ms, bound_ms=b80, bound_by=by80, bound_ms_at_128=b128,
                                library_ms=lib)
        log(f"[{tag}] flash forward B={B} H=Hkv={H} S={S} D={D} {mask} bfloat16 ({who}): the D = {Dk} "
            f"kernel {ms:.4f} ms a launch on padded inputs, the padded call {call_ms:.4f} ms (padding and slicing "
            f"{call_ms - ms:.4f} ms); bound at D = {D} {b80:.4f} ms ({by80}), kernel at {ms / b80:.2f}x; bound at "
            f"D = {Dk} {b128:.4f} ms, kernel at {ms / b128:.2f}x; scaled_dot_product_attention at D = {D} "
            f"{lib:.4f} ms")
        del q, k, v, qp, kp, vp
        torch.cuda.empty_cache()
    B, S = bwd_shape
    args = bwd_inputs(fa, gen, B, H, H, S, D, torch.bfloat16, dev, kind, window, 0.0)
    q, k, v, o, lse, do = args
    qp, kp, vp, op, dop = (F.pad(x, (0, Dk - D)) for x in (q, k, v, o, do))
    do_c, delta = fa._bwd_rows(op, dop)
    ms = {which: median_event_ms(lambda: fa._launch_bwd(which, qp, kp, vp, do_c, lse, delta, kind, window, 0.0,
                                                        scale), reps=5, per_rep=3) for which in ("dq", "dkv")}
    call_ms = median_event_ms(lambda: fa.flash_attention_bwd(*args, kind, window, 0.0), reps=5, per_rep=3)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = library_attention(fa, F, qg, kg, vg, kind, window)
    lib = median_event_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True), reps=5, per_rep=3)
    for which in ("dq", "dkv"):
        b80, by80 = flash_bwd_bound_ms(B, H, H, S, D, kind, window, 2, which)
        b128, _ = flash_bwd_bound_ms(B, H, H, S, Dk, kind, window, 2, which)
        res[f"{which}_S{S}"] = dict(ms=ms[which], bound_ms=b80, bound_by=by80, bound_ms_at_128=b128, library_ms=lib)
        log(f"[{tag}] flash_{which} B={B} H=Hkv={H} S={S} D={D} {mask} bfloat16: the D = {Dk} kernel "
            f"{ms[which]:.4f} ms a launch on padded inputs; bound at D = {D} {b80:.4f} ms ({by80}), kernel at "
            f"{ms[which] / b80:.2f}x; bound at D = {Dk} {b128:.4f} ms, kernel at {ms[which] / b128:.2f}x; library "
            f"(backward of scaled_dot_product_attention at D = {D}, dq, dk and dv) {lib:.4f} ms")
    pad = call_ms - ms["dq"] - ms["dkv"]
    log(f"[{tag}] the padded backward call {call_ms:.4f} ms: padding, slicing and delta {pad:.4f} ms; {card}")
    res["bwd_pad_ms"] = pad
    del args, qg, kg, vg, lib_out, qp, kp, vp, op, dop, do_c, delta
    torch.cuda.empty_cache()
    return res


def ssm_phase(fa, dev, card):
    """Phase 16: the SSM families. Returns (flash launches by arch and use,
    figures, the D = 80 flash times)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches, figs = {}, {}
    for arch in SSM_ARCHS:
        what = "(a)" if arch == SSM_ARCHS[0] else "(b)"

        def held(arch=arch, what=what):
            return run_with_launches_held(fa, what, ssm_part, fa, dev, card, arch, cases=SSM_FLASH_CASES, tag="ssm")

        launches[arch], figs[arch] = run_with_bwd_launches_held(fa, what, held)
    d80 = padded_flash_times(fa, dev, card, "ssm", "zamba2's shared block", 32, "causal", 4096,
                             ((1, ZAMBA_S), (1, ZAMBA_TRAIN_S)), (1, ZAMBA_TRAIN_S))
    log(f"[ssm] phase 16 wall time {time.perf_counter() - t0:.1f} s; flash launches {launches}")
    return launches, figs, d80


# -- phase 17: the encoder and VLM families ----------------------------------

FLASH_COUNTERS = ("launches", "launches_dq", "launches_dkv", "launches_fwd_tc", "launches_dq_tc", "launches_dkv_tc")


def flash_counts(fa) -> tuple:
    """The flash wrappers' six counters: (forward, dQ, dK/dV) and their
    tensor-core launches."""
    return tuple(getattr(fa, c) for c in FLASH_COUNTERS)


def train_steps(fa, what, tstep, params, ostate, batch, per_step, tag, loss_of):
    """ENC_TRAIN_STEPS steps of ``tstep`` on one batch, the last under the
    profiler; each must add ``per_step`` to :func:`flash_counts`. The loss
    of the batch after the steps (``loss_of(params)``, without grad) must
    lie below the first step's: at random init AdamW's first steps can
    raise the loss of a deep model before it falls (hubert-xlarge's rises
    over its first two steps), so the steps' own losses need not fall. Returns (params, losses + [the loss
    after], step seconds, peak GB, (busy ms, rows, kinds, launches))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, out = [], [], {}
    for i in range(ENC_TRAIN_STEPS):
        n0 = flash_counts(fa)
        t0 = time.perf_counter()
        if i == ENC_TRAIN_STEPS - 1:  # the last step under the profiler: the card's busy time
            def run(p, b):
                out["step"] = tstep(p, ostate, b)

            prof = device_time_table(run, params, batch, top=6)
            params, ostate, loss = out.pop("step")
        else:
            params, ostate, loss = tstep(params, ostate, batch)
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per = tuple(a - b for a, b in zip(flash_counts(fa), n0))
        check(per == per_step, f"[{tag}] {what} train step {i + 1}: flash (forward, dQ, dK/dV, and their tensor-core) "
                               f"launches {per}, expected {per_step}")
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"[{tag}] {what} train step {i + 1}: loss {losses[-1]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        losses.append(float(loss_of(params)))
    check(losses[-1] < losses[0], f"[{tag}] {what}: {ENC_TRAIN_STEPS} steps did not lower the loss of their batch: "
                                  f"{losses}")
    return params, losses, secs, peak, prof


def hubert_part(fa, dev, card):
    """Phase 17 (a): hubert-xlarge FULL on the kernel route: the encode,
    against the plain route and in float32; the train step and its float32
    cut. Returns (flash launches by use, figures)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_prefill_step, build_train_step
    from repro_torch.models import init_params, loss_fn, make_dummy_batch, param_count, prefill_fn

    cfg = get_config(HUBERT_ARCH).replace(attn_impl="flash")
    check(cfg.family == "encoder" and cfg.attn_kind == "bidirectional" and cfg.remat == "full"
          and cfg.optimizer == "adamw", f"{HUBERT_ARCH} FULL: {cfg.family}, {cfg.attn_kind}, remat {cfg.remat}, "
                                        f"{cfg.optimizer}")
    check(cfg.hd == 80 and fa.kernel_head_dim(cfg.hd) == 128, f"{HUBERT_ARCH}: head dim {cfg.hd} runs on the "
                                                               f"D = {fa.kernel_head_dim(cfg.hd)} kernels")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = HUBERT_ENCODE
    batch = make_dummy_batch(cfg, B, S, "prefill", np.random.default_rng(SEED), device=dev)
    step = build_prefill_step(cfg)
    launches, figs = {}, {}
    t_part = time.perf_counter()

    def elog(msg):
        log(f"[enc] (a) +{time.perf_counter() - t_part:.1f} s: {msg}")

    elog(f"{HUBERT_ARCH} FULL: {param_count(params)} parameters ({cfg.param_dtype}, "
         f"{tensor_bytes(cache_tensors(params)) / 1e9:.3f} GB), {L} layers, d = {cfg.d_model}, H = Hkv = "
         f"{cfg.num_heads}, D = {cfg.hd} on the D = {fa.kernel_head_dim(cfg.hd)} kernels (zero-padded), "
         f"{cfg.attn_kind}, {cfg.mlp_kind} MLP d_ff = {cfg.d_ff}, {cfg.vocab_size} cluster ids, frames of "
         f"{cfg.frame_dim}; initialised on the card in {init_s:.2f} s")

    # -- encode
    torch.cuda.reset_peak_memory_stats()
    for c in FLASH_COUNTERS:
        setattr(fa, c, 0)
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = flash_counts(fa)
    check(counts == (L, 0, 0, L, 0, 0), f"(a) encode: flash (forward, dQ, dK/dV, and their tensor-core) launches "
                                        f"{counts}, expected {(L, 0, 0, L, 0, 0)}")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"(a) encode: logits {tuple(logits.shape)} {logits.dtype}, finite "
                                                   f"{bool(torch.isfinite(logits).all())}")
    launches["encode"] = L
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = logits[0].clone()
    del logits
    n0 = fa.launches
    enc_ms = median_wall_ms(lambda: step(params, batch), reps=3)
    check(fa.launches - n0 == 3 * L, f"(a) {fa.launches - n0} flash launches in 3 warm encodes")
    busy, rows, kinds, n_kernels = device_time_table(step, params, batch, top=6)
    flash_ms = kinds["flash kernels"]
    figs.update(encode_ms=enc_ms, encode_frames_s=B * S / enc_ms * 1e3, encode_cold_s=cold_s, encode_busy_ms=busy,
                encode_launches=n_kernels, encode_flash_ms=flash_ms, encode_flash_share=flash_ms / busy,
                encode_peak_gb=peak_gb)
    elog(f"encode B={B} x {S} frames ({S * 0.02:.1f} s of audio each at 20 ms a frame): {L} flash launches, all "
         f"tensor-core, finite logits; first call {cold_s:.3f} s, warm {enc_ms:.3f} ms (host clock, median of 3) = "
         f"{B * S / enc_ms * 1e3:.1f} frames/s; peak device memory {peak_gb:.2f} GB; by the profiler {busy:.3f} ms of "
         f"kernel time over {n_kernels} launches, busy share {busy / enc_ms:.3f}; the flash kernels {flash_ms:.3f} ms "
         f"= {flash_ms / busy:.3f} of the kernel time; by kind {kinds_text(kinds)}; {card}")
    for t, n, name in rows:
        log(f"[enc]   {t:10.3f} ms  x{n:<7d} {name[:90]}")
    plain = prefill_fn(params, cfg.replace(attn_impl="plain"), {"frames": batch["frames"][:1]})[0]
    torch.cuda.empty_cache()
    rel = float((first - plain).norm() / plain.norm())
    figs.update(encode_rel_l2_vs_plain=rel)
    elog(f"sequence 0, kernel route vs plain route (block_q={cfg.attn_block_q}): relative L2 {rel:.3e} over its "
         f"{S} x {cfg.vocab_size} logits (limit {PREFILL_REL_L2}), max |dlogit| "
         f"{float((first - plain).abs().max()):.3e}")
    check(rel <= PREFILL_REL_L2, f"(a) the kernel route's logits differ from the plain route's: {rel}")
    del first, plain

    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    b32 = {"frames": batch["frames"][:2]}
    n0 = flash_counts(fa)
    l32 = prefill_fn(p32, cfg32, b32)
    per = tuple(a - b for a, b in zip(flash_counts(fa), n0))
    check(per == (F32_LAYERS, 0, 0, 0, 0, 0), f"(a) float32 encode: flash launches {per}")
    launches["float32 encode cut"] = F32_LAYERS
    l32p = prefill_fn(p32, cfg32.replace(attn_impl="plain"), b32)
    err32 = float((l32 - l32p).abs().max())
    check(bool(torch.allclose(l32, l32p, rtol=1e-4, atol=1e-4)), f"(a) float32 encode: max |dlogit| {err32}")
    elog(f"float32, {F32_LAYERS} layers at full width, B=2 x {S} frames: the kernel route within rtol=atol=1e-4 of "
         f"the plain route at all positions (max |dlogit| {err32:.3e})")
    del p32, l32, l32p, batch
    torch.cuda.empty_cache()

    # -- training
    tb = make_dummy_batch(cfg, *HUBERT_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    tstep, opt = build_train_step(cfg)
    ostate = opt.init(params)
    params, losses, secs, train_peak, (tbusy, trows, tkinds, tn) = train_steps(
        fa, "(a)", tstep, params, ostate, tb, (2 * L, L, L) * 2, "enc", lambda p: loss_fn(p, cfg, tb))
    for use, c in (("train forward", 0), ("train dq", 1), ("train dkv", 2)):
        launches[use] = ENC_TRAIN_STEPS * (2 * L, L, L)[c]
    frames = HUBERT_TRAIN[0] * HUBERT_TRAIN[1]
    warm_ms = 1e3 * secs[1]
    masked = int(tb["mask"].sum())
    figs.update(train_warm_ms=warm_ms, train_frames_s=frames / warm_ms * 1e3, train_busy_ms=tbusy, train_launches=tn,
                train_flash_ms=tkinds["flash kernels"], train_flash_share=tkinds["flash kernels"] / tbusy,
                train_peak_gb=train_peak, losses=losses)
    elog(f"{ENC_TRAIN_STEPS} train steps (remat {cfg.remat}, {cfg.optimizer} lr {cfg.learning_rate}, masked "
         f"prediction at {masked} of {frames} frames) B={HUBERT_TRAIN[0]} x {HUBERT_TRAIN[1]} frames: per step "
         f"{2 * L} forward (with the remat recompute), {L} dQ and {L} dK/dV flash launches, all tensor-core; losses "
         f"{', '.join(f'{x:.5f}' for x in losses[:-1])}, after them {losses[-1]:.5f}; steps "
         f"{', '.join(f'{x:.3f}' for x in secs)} s (the first cold, the last under the profiler); warm "
         f"{warm_ms:.3f} ms = {frames / warm_ms * 1e3:.1f} frames/s; peak device "
         f"memory {train_peak:.2f} GB; by the profiler {tbusy:.3f} ms of kernel time over {tn} launches, busy share "
         f"{tbusy / warm_ms:.3f} of the warm step; the flash kernels {tkinds['flash kernels']:.3f} ms = "
         f"{tkinds['flash kernels'] / tbusy:.3f} of the kernel time; by kind {kinds_text(tkinds)}")
    for t, n, name in trows:
        log(f"[enc]   {t:10.3f} ms  x{n:<7d} {name[:90]}")
    del params, ostate, tstep, opt
    torch.cuda.empty_cache()
    n0 = flash_counts(fa)
    train_f32_check(fa, dev, cfg, tb, tag="enc")
    launches["float32 train cut"] = fa.launches - n0[0]
    del tb
    torch.cuda.empty_cache()
    return launches, figs


def paligemma_part(fa, dev, card):
    """Phase 17 (b): paligemma-3b FULL, attention on the plain route under
    its prefix mask: the prefill and its prefix attention's share, the
    image rows against a bidirectional attention, decode against the
    prefill (bfloat16 and the float32 cut), training, the serve launcher.
    Returns figures."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_prefill_step, build_train_step, serve
    from repro_torch.models import decode_fn, dense, init_cache, init_params, loss_fn, make_dummy_batch
    from repro_torch.models import param_count, prefill_fn, vlm

    cfg = get_config(PALI_ARCH)
    check(cfg.family == "vlm" and cfg.attn_kind == "prefix" and cfg.attn_impl == "plain" and cfg.remat == "full"
          and cfg.optimizer == "adamw", f"{PALI_ARCH} FULL: {cfg.family}, {cfg.attn_kind}, {cfg.attn_impl}, remat "
                                        f"{cfg.remat}, {cfg.optimizer}")
    L, P = cfg.num_layers, cfg.num_patches
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = PALI_PREFILL
    batch = make_dummy_batch(cfg, B, S, "prefill", np.random.default_rng(SEED), device=dev)
    St = batch["tokens"].shape[1]
    step = build_prefill_step(cfg)
    figs = {}
    t_part = time.perf_counter()

    def elog(msg):
        log(f"[enc] (b) +{time.perf_counter() - t_part:.1f} s: {msg}")

    elog(f"{PALI_ARCH} FULL: {param_count(params)} parameters ({cfg.param_dtype}, "
         f"{tensor_bytes(cache_tensors(params)) / 1e9:.3f} GB), {L} layers, d = {cfg.d_model}, H = {cfg.num_heads}, "
         f"Hkv = {cfg.num_kv_heads}, D = {cfg.hd}, V = {cfg.vocab_size}; {P} patches of {cfg.patch_dim} before the "
         f"text; initialised on the card in {init_s:.2f} s")

    # -- prefill
    torch.cuda.reset_peak_memory_stats()
    for c in FLASH_COUNTERS:
        setattr(fa, c, 0)
    calls = []
    t0 = time.perf_counter()
    with spying(dense, "attention", lambda out, *a, **kw: calls.append((a, kw)) if not calls else None):
        logits = step(params, batch)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    check(flash_counts(fa) == (0,) * 6, f"(b) prefill: flash launches {flash_counts(fa)}, expected none")
    check(tuple(logits.shape) == (B, St, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"(b) prefill: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = logits[:, St - TF_STEPS:].clone()
    del logits
    pre_ms = median_wall_ms(lambda: step(params, batch), reps=2)
    busy, rows, kinds, n_kernels = device_time_table(step, params, batch, top=6)
    (q, k, v), kw = calls.pop()
    check(kw.get("kind") == "prefix" and kw.get("prefix_len") == P and kw.get("impl") == "plain",
          f"(b) the layers' attention call: kind {kw.get('kind')}, prefix_len {kw.get('prefix_len')}, {kw.get('impl')}")
    with torch.inference_mode():
        attn_busy, _, attn_kinds, attn_n = device_time_table(lambda p, b: dense.attention(q, k, v, **kw), None, None)
        attn_ms = median_event_ms(lambda: dense.attention(q, k, v, **kw), reps=3, warmup=1)
    share = L * attn_busy / busy
    figs.update(prefill_ms=pre_ms, prefill_tokens_s=B * S / pre_ms * 1e3, prefill_cold_s=cold_s, prefill_busy_ms=busy,
                prefill_launches=n_kernels, prefill_peak_gb=peak_gb, prefix_attention_layer_ms=attn_ms,
                prefix_attention_layer_busy_ms=attn_busy, prefix_attention_share=share)
    elog(f"prefill B={B} x ({P} patches + {St} text tokens) = {B * S} positions, no flash launch: finite text "
         f"logits; first call {cold_s:.3f} s, warm {pre_ms:.3f} ms (host clock, median of 2) = "
         f"{B * S / pre_ms * 1e3:.1f} positions/s; peak device memory {peak_gb:.2f} GB; by the profiler {busy:.3f} ms "
         f"of kernel time over {n_kernels} launches, busy share {busy / pre_ms:.3f}; by kind {kinds_text(kinds)}; "
         f"{card}")
    for t, n, name in rows:
        log(f"[enc]   {t:10.3f} ms  x{n:<7d} {name[:90]}")
    elog(f"one layer's plain prefix attention (query blocks of {kw.get('block_q')}, float32 scores) on its own "
         f"inputs: {attn_ms:.3f} ms by CUDA events, {attn_busy:.3f} ms of kernel time over {attn_n} launches (by "
         f"kind {kinds_text(attn_kinds)}); x {L} layers = {L * attn_busy:.3f} ms, a share {share:.3f} of the "
         f"prefill's kernel time")

    # -- the prefix mask on the card: the image rows see exactly the image
    with torch.inference_mode():
        pos = torch.arange(q.shape[1], device=dev)
        qf, kf, vf = q[:, :P].float(), k.float(), v.float()
        img = dense.attention(qf, kf, vf, q_pos=pos[:P], kv_pos=pos, kind="prefix", prefix_len=P,
                              block_q=cfg.attn_block_q)
        bidir = dense.attention(qf, kf[:, :P], vf[:, :P], q_pos=pos[:P], kv_pos=pos[:P], kind="bidirectional")
        causal = dense.attention(qf, kf[:, :P], vf[:, :P], q_pos=pos[:P], kv_pos=pos[:P], kind="causal")
    err, gap = float((img - bidir).abs().max()), float((img - causal).abs().max())
    check(bool(torch.allclose(img, bidir, rtol=F32_TOL, atol=F32_TOL)) and gap > 1e3 * F32_TOL,
          f"(b) the image rows under the prefix mask: max |d| {err} from bidirectional, {gap} from causal")
    elog(f"one layer's {P} image rows under the prefix mask (its own inputs widened to float32, all {q.shape[1]} "
         f"keys): within rtol=atol={F32_TOL} of a bidirectional attention over the image block (max |d| {err:.3e}); "
         f"a causal one lies {gap:.3e} away")
    del q, k, v, qf, kf, vf, img, bidir, causal, calls
    torch.cuda.empty_cache()

    # -- decode against the prefill
    start_txt = St - TF_STEPS
    with torch.inference_mode():
        _, (kc, vc) = vlm.paligemma_forward(params, cfg, batch["patches"], batch["tokens"][:, :start_txt],
                                            collect_cache=True)
    cache = init_cache(cfg, B, P + St)
    cache[0][:, :, :P + start_txt].copy_(kc)
    cache[1][:, :, :P + start_txt].copy_(vc)
    del kc, vc
    torch.cuda.empty_cache()
    got = teacher_forced(decode_fn, params, cfg, cache, batch["tokens"][:, start_txt:], P + start_txt)
    check(flash_counts(fa) == (0,) * 6, f"(b) decode: flash launches {flash_counts(fa)}")
    dec = (got - want).norm(dim=-1) / want.norm(dim=-1)
    figs.update(decode_rel_l2_max=float(dec.max()), decode_rel_l2_mean=float(dec.mean()))
    decode_vs_prefill(f"(b) {PALI_ARCH}: {TF_STEPS} teacher-forced decode steps at positions {P + start_txt}-"
                      f"{P + St - 1} after a collect-cache prefill of {P} patches and {start_txt} text tokens, vs "
                      f"the prefill", got, want)
    pos = P + St - 1
    dec_ms = tf_step_ms(decode_fn, params, cfg, cache, batch["tokens"][:, -1:], pos)
    b_ms = decode_bound_ms(params, cfg, B, [P + St] * L)
    figs.update(decode_ms=dec_ms, decode_bound_ms=b_ms)
    elog(f"decode step at B={B}, position {pos}, cache {P + St} slots ({cache_gb(cache):.3f} GB): {dec_ms:.4f} ms a "
         f"token by CUDA events ({B / dec_ms * 1e3:.1f} tokens/s); bound {b_ms:.4f} ms (bytes), {dec_ms / b_ms:.2f}x")
    del got, want, cache
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
    b32 = {"patches": batch["patches"][:1], "tokens": batch["tokens"][:1]}
    want32 = prefill_fn(p32, cfg32, b32)[:, start_txt:].clone()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        _, (kc, vc) = vlm.paligemma_forward(p32, cfg32, b32["patches"], b32["tokens"][:, :start_txt],
                                            collect_cache=True)
    cache32 = init_cache(cfg32, 1, P + St)
    cache32[0][:, :, :P + start_txt].copy_(kc)
    cache32[1][:, :, :P + start_txt].copy_(vc)
    got32 = teacher_forced(decode_fn, p32, cfg32, cache32, b32["tokens"][:, start_txt:], P + start_txt)
    err = float((got32 - want32).abs().max())
    check(bool(torch.allclose(got32, want32, rtol=DECODE_F32_TOL, atol=DECODE_F32_TOL)),
          f"(b) float32 decode vs prefill: max |dlogit| {err}")
    figs.update(decode_f32_max_abs=err)
    elog(f"float32, {F32_LAYERS} layers at full width, B=1: {TF_STEPS} teacher-forced steps after a collect-cache "
         f"prefill of the image and {start_txt} text tokens within rtol=atol={DECODE_F32_TOL} of the prefill "
         f"(max |dlogit| {err:.3e})")
    del p32, b32, want32, kc, vc, cache32, got32, batch
    torch.cuda.empty_cache()

    # -- training
    tb = make_dummy_batch(cfg, *PALI_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    tstep, opt = build_train_step(cfg)
    ostate = opt.init(params)
    params, losses, secs, train_peak, (tbusy, trows, tkinds, tn) = train_steps(
        fa, "(b)", tstep, params, ostate, tb, (0,) * 6, "enc", lambda p: loss_fn(p, cfg, tb))
    positions = PALI_TRAIN[0] * PALI_TRAIN[1]
    warm_ms = 1e3 * secs[1]
    figs.update(train_warm_ms=warm_ms, train_tokens_s=positions / warm_ms * 1e3, train_busy_ms=tbusy,
                 train_launches=tn, train_peak_gb=train_peak, losses=losses)
    elog(f"{ENC_TRAIN_STEPS} train steps (remat {cfg.remat}, {cfg.optimizer} lr {cfg.learning_rate}) "
         f"B={PALI_TRAIN[0]} x ({P} patches + {tb['tokens'].shape[1] - 1} text tokens), no flash launch; losses "
         f"{', '.join(f'{x:.5f}' for x in losses[:-1])}, after them {losses[-1]:.5f}; steps "
         f"{', '.join(f'{x:.3f}' for x in secs)} s (the first cold, the last under the profiler); warm "
         f"{warm_ms:.3f} ms = {positions / warm_ms * 1e3:.1f} positions/s; peak "
         f"device memory {train_peak:.2f} GB; by the profiler {tbusy:.3f} ms of kernel time over {tn} launches, busy "
         f"share {tbusy / warm_ms:.3f}; by kind {kinds_text(tkinds)}")
    for t, n, name in trows:
        log(f"[enc]   {t:10.3f} ms  x{n:<7d} {name[:90]}")
    del params, ostate, tstep, opt, tb
    torch.cuda.empty_cache()

    # -- the serve launcher at its defaults
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", PALI_ARCH, "--full"])
    text = out.getvalue()
    m = re.search(r"\(([0-9.]+) tok/s on (.+)\)", text)
    check(m is not None and m.group(2) == torch.cuda.get_device_name(0) and flash_counts(fa) == (0,) * 6,
          f"(b) launch/serve.py --arch {PALI_ARCH} --full printed {text!r}; flash launches {flash_counts(fa)}")
    figs.update(serve_launcher_tokens_s=float(m.group(1)))
    for line in text.splitlines():
        elog(f"launch/serve.py --arch {PALI_ARCH} --full: {line}")
    torch.cuda.empty_cache()
    return figs


def encoder_phase(fa, dev, card):
    """Phase 17: the encoder and VLM families. Returns (hubert's flash
    launches by use, figures, hubert's D = 80 flash times)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()

    def held():
        return run_with_launches_held(fa, "(a)", hubert_part, fa, dev, card, cases=ENC_FLASH_CASES, tag="enc")

    launches, figs = run_with_bwd_launches_held(fa, "(a)", held, cases=ENC_FLASH_BWD_CASES, tag="enc")
    d80 = padded_flash_times(fa, dev, card, "enc", "hubert-xlarge's attention", 16, "bidirectional", 4096,
                             (HUBERT_ENCODE,), HUBERT_TRAIN)
    enc_ms = sum(v["ms"] for k, v in d80.items() if k.startswith("fwd"))
    log(f"[enc] hubert's encode: {launches['encode']} forward launches x {enc_ms:.4f} ms = "
        f"{launches['encode'] * enc_ms:.3f} ms of the kernel alone (the profiler's flash time in the encode "
        f"{figs['encode_flash_ms']:.3f} ms, a share {figs['encode_flash_share']:.3f})")
    pali = run_with_launches_held(fa, "(b)", paligemma_part, fa, dev, card, cases=(), tag="enc")
    log(f"[enc] phase 17 wall time {time.perf_counter() - t0:.1f} s; hubert's flash launches {launches}")
    return launches, {"hubert": figs, "paligemma": pali}, d80


# -- phase 18: multi-device sweeps ----------------------------------------------


def graph_replay_ms(eng, key, reps=10):
    """Host-clock ms of replaying every position's graph of ``key`` (each
    on its own stream) and synchronizing: the replay step of a warm
    dispatch, as ``dispatch_split`` times it."""
    plans = eng._cache[key]

    def replay():
        for plan in plans:
            with torch.cuda.stream(plan.streams[0]):
                plan.graph.replay()

    return median_wall_ms(replay, reps=reps)


def peak_gb(fn):
    """Device memory ``fn`` takes above what was held before it (GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def multi_device_phase(mp, dev, card):
    """Phase 18: batch sharding and the class ring through ``SweepEngine``
    (every check bit for bit), their launches, times in turns with the
    unsharded engine, slab bytes and peak memory. Returns the launches of
    the ring's and the batch mesh's solves at the main shape (each counted
    from 0), the backtrack's largest deviation from its plain version on the
    ring's slabs, and the backtrack's times on a ring slab."""
    from repro_torch.core import ProblemBatch, Solver, random_problem, remove_lower_limits, solve_schedule_dp_batch
    from repro_torch.core import torch_dp
    from repro_torch.core.sweep import SweepEngine, SweepMesh, make_sweep_mesh
    from repro_torch.core.torch_dp import pack_problem, solve_fused_batch_ring, solve_fused_batch_torch
    from repro_torch.kernels.ref import backtrack_ref

    t_phase = time.perf_counter()
    D = MESH_POSITIONS

    def zero():
        mp.launches = mp.launches_scan = mp.launches_backtrack = 0

    def counts():
        return {"row": mp.launches, "scan": mp.launches_scan, "backtrack": mp.launches_backtrack}

    prng = np.random.default_rng(SEED)
    batch = ProblemBatch.from_problems([random_problem(prng, n=N_MAIN, T=T_MAIN, regime="arbitrary",
                                                       max_upper=U_MAIN) for _ in range(B_MAIN)])
    X = solve_schedule_dp_batch(batch, device=dev)
    fleet_p = random_problem(np.random.default_rng(FLEET_SEED), n=FLEET_N, T=4 * FLEET_N, max_upper=FLEET_UPPER)
    flat = ProblemBatch.from_problems([fleet_p])
    real = make_sweep_mesh(device=dev)
    check(real.devices.size == real.shape["sweep"] == torch.cuda.device_count(),
          f"make_sweep_mesh() has {real.devices.size} positions, the machine {torch.cuda.device_count()} cards")
    rep = SweepMesh([dev] * D)
    one = SweepEngine(device=dev)
    want = one.dispatch(batch)
    check(np.array_equal(want.result(), X), "the unsharded engine differs from solve_schedule_dp_batch")
    (key,) = one._cache  # the main shape's bucket; B_MAIN is a multiple of MESH_POSITIONS
    nb = key[2]

    # (a) the batch axis over a mesh
    meshes = {f"mesh of the {real.devices.size} card(s)": SweepEngine(mesh=real, device=dev),
              f"mesh of {D} positions of the card": SweepEngine(mesh=rep, device=dev)}
    mesh_launches = {}
    for name, eng in meshes.items():
        zero()
        hs = [eng.dispatch(batch) for _ in range(3)]  # eager warm-up and capture per position, two replays
        mesh_launches[name] = counts()
        for h in hs:
            check(np.array_equal(h.result(), X), f"{name}: the schedules differ from the unsharded solve")
            check(np.array_equal(h.k_last().view(np.int32), want.k_last().view(np.int32)),
                  f"{name}: K_last differs from the unsharded engine's")
        P = eng._ndev
        check(mesh_launches[name] == {"row": 3 * P * nb, "scan": P, "backtrack": 3 * P},
              f"{name}: three solves launched {mesh_launches[name]}; expected {P} positions x 3 x {nb} rows, "
              f"{P} scan calls (the warm-ups) and 3 x {P} backtracks")
        stats = eng.cache_stats()
        check((stats["compiles"], stats["hits"], stats["misses"]) == (1, 2, 1) and list(eng._cache) == [key],
              f"{name}: cache_stats {stats}, buckets {list(eng._cache)}")
        check(len(eng._cache[key]) == P and all(p.graph is not None for p in eng._cache[key]),
              f"{name}: not one captured graph per position")
    one.solve(batch)
    one.solve(batch)
    check(all(e.cache_stats() == one.cache_stats() for e in meshes.values()),
          "a mesh engine's cache_stats differ from the unsharded engine's after the same calls")

    # (b) the class ring over D positions of the card
    ring = SweepEngine(ring_mesh=rep, device=dev)
    zero()
    hs = [ring.dispatch(batch) for _ in range(3)]
    ring_launches = counts()
    check(ring_launches == {"row": 3 * nb, "scan": D, "backtrack": 3 * D},
          f"the ring's three solves launched {ring_launches}; expected 3 x {nb} rows, {D} scan calls (the warm-up's "
          f"turns) and 3 x {D} backtracks")
    b0 = remove_lower_limits(batch)
    costs, t_star, Tmax = pack_problem(b0, dev), torch.from_numpy(b0.T).to(dev), int(b0.T.max())
    Xf, Kf = solve_fused_batch_torch(costs, t_star, Tmax, backend="cuda")
    for h in hs:
        check(np.array_equal(h.result(), X), "the ring's schedules differ from the unsharded solve")
        k = h.k_last()
        check(np.array_equal(k.view(np.int32), want.k_last().view(np.int32)), "the ring's K_last differs")
        check(np.array_equal(k[:, : Tmax + 1].view(np.int32), Kf.cpu().numpy().view(np.int32)),
              "the ring's K_last differs from solve_fused_batch_torch's")
    check(np.array_equal(Xf.cpu().numpy() + batch.lower, X), "solve_fused_batch_torch differs from the entry point")
    check(ring.cache_stats() == one.cache_stats() and list(ring._cache) == [key]
          and ring._cache[key][0].graph is not None,
          f"the ring engine's cache_stats {ring.cache_stats()} or buckets {list(ring._cache)}")
    # the fused ring solve itself, eager, with the backtrack's inputs kept for (c)
    seen = []
    zero()
    with spying(torch_dp, "minplus_backtrack_cuda", lambda out, I, t: seen.append((I, t, out))):
        Xr, Kr = solve_fused_batch_ring(costs, t_star, Tmax, "cuda", rep, "sweep")
    direct = counts()
    check(direct == {"row": N_MAIN, "scan": D, "backtrack": D}, f"solve_fused_batch_ring launched {direct}")
    check(torch.equal(Xr, Xf) and torch.equal(Kr.view(torch.int32), Kf.view(torch.int32)),
          "solve_fused_batch_ring differs from solve_fused_batch_torch")

    # (c) the backtrack launched alone, on the ring's slabs
    check(len(seen) == D, f"the ring's reverse walk called the backtrack {len(seen)} times")
    bt_err = 0
    for I, t, out in seen:
        bt_err = max(bt_err, int((out - backtrack_ref(I, t)).abs().max()))
    check(bt_err == 0, f"minplus_backtrack_cuda differs from backtrack_ref on a ring slab by {bt_err}")
    I0, t0 = seen[0][:2]
    # 20 launches in one graph, timed by CUDA events: no host time between
    # them (the profiler drops records late in a long run)
    bt_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(bt_graph):
        for _ in range(20):
            mp.minplus_backtrack_cuda(I0, t0)
    bt_ms = median_event_ms(bt_graph.replay, reps=5) / 20
    bt_plain_ms = median_event_ms(lambda: backtrack_ref(I0, t0), reps=5, per_rep=4)
    bt_bound, bt_by = backtrack_bound_ms(I0.shape[0], I0.shape[1])

    # the ring at bench_fleet.py's flat shape
    fwant = one.dispatch(flat)
    fkey = next(reversed(one._cache))
    zero()
    fh = [ring.dispatch(flat) for _ in range(3)]
    fleet_launches = counts()
    check(fleet_launches == {"row": 3 * fkey[2], "scan": D, "backtrack": 3 * D},
          f"the ring's three flat solves launched {fleet_launches}")
    f0 = remove_lower_limits(flat)
    Xff, Kff = solve_fused_batch_torch(pack_problem(f0, dev), torch.from_numpy(f0.T).to(dev), int(f0.T.max()),
                                       backend="cuda")
    for h in fh:
        check(np.array_equal(h.result(), fwant.result()) and np.array_equal(h.result(), Xff.cpu().numpy() + flat.lower),
              "the ring's flat schedule differs from the unsharded solve")
        check(np.array_equal(h.k_last().view(np.int32), fwant.k_last().view(np.int32))
              and np.array_equal(h.k_last()[:, : int(f0.T.max()) + 1].view(np.int32), Kff.cpu().numpy().view(np.int32)),
              "the ring's flat K_last differs")

    # times, in turns with the unsharded engine, one process
    def solve_ms(eng, b):
        return median_wall_ms(lambda: eng.solve(b), reps=5)

    legs = {"unsharded": (one, batch, key), **{k: (e, batch, key) for k, e in meshes.items()},
            f"ring of {D}": (ring, batch, key), "unsharded, flat": (one, flat, fkey),
            f"ring of {D}, flat": (ring, flat, fkey)}
    warm, replay = {k: [] for k in legs}, {k: [] for k in legs}
    for name in list(legs) + list(reversed(legs)):
        eng, b, k = legs[name]
        warm[name].append(solve_ms(eng, b))
        replay[name].append(graph_replay_ms(eng, k))
    warm = {k: statistics.mean(v) for k, v in warm.items()}
    replay = {k: statistics.mean(v) for k, v in replay.items()}

    # slab bytes and peak memory: a cold solve (plan build and capture) and a warm one
    slab = {name: k[2] // (D if name.startswith("ring") else 1) * k[1] * (k[3] + 1) * 4
            for name, (_, _, k) in legs.items() if "mesh" not in name}
    peaks = {}
    for name, make in (("unsharded", lambda: SweepEngine(device=dev)),
                       (f"ring of {D}", lambda: SweepEngine(ring_mesh=rep, device=dev)),
                       (f"mesh of {D} positions of the card", lambda: SweepEngine(mesh=rep, device=dev))):
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        eng = make()
        cold = peak_gb(lambda: eng.solve(batch))
        warm_gb = peak_gb(lambda: eng.solve(batch))
        torch.cuda.empty_cache()  # what stays reserved is the plans' graph pools and buffers
        peaks[name] = (cold, warm_gb, (torch.cuda.memory_reserved() - reserved) / 1e9)
        del eng

    # (d) the fleet on the ring engine
    seed, n, T, k = RING_FLEET
    pq = random_problem(np.random.default_rng(seed), n=n, T=T)
    fs = Solver(engine=ring).solve_fleet(pq, clusters=k, quantum=1)
    flat_obj = float(Solver(engine=one).solve([pq], algorithm="dp_batch").objectives[0])
    check(abs(fs.objective - flat_obj) <= 1e-6, f"the fleet on the ring at quantum 1: {fs.objective} != {flat_obj}")
    fs1 = Solver(engine=one).solve_fleet(pq, clusters=k, quantum=1)
    check(np.array_equal(fs.schedule, fs1.schedule), "the fleet on the ring differs from the unsharded engine's")
    big = Solver(engine=ring).solve_fleet(fleet_p)
    big1 = Solver(engine=one).solve_fleet(fleet_p)
    for f in ("labels", "allocations", "schedule"):
        check(np.array_equal(getattr(big, f), getattr(big1, f)), f"bench_fleet's instance on the ring: {f} differ")
    check(big.objective == big1.objective and np.array_equal(np.asarray(big.curves).view(np.int32),
                                                             np.asarray(big1.curves).view(np.int32)),
          "bench_fleet's instance on the ring: curves or objective differ")

    log(f"[mesh] {card}")
    log(f"[mesh] main shape B={B_MAIN}, n={N_MAIN}, T={T_MAIN}, W<={U_MAIN + 1} (bucket {one._bucket_label(key)}); "
        f"make_sweep_mesh(): {real!r}")
    for name in meshes:
        log(f"[mesh] (a) SweepEngine(mesh={name}): X and K_last identical to the unsharded engine over 3 solves, "
            f"cache_stats the same, one graph per position on its own stream; launches {mesh_launches[name]}")
    log(f"[mesh] (b) SweepEngine(ring_mesh={D} positions of the card): X and K_last bit-identical to the unsharded "
        f"engine and to solve_fused_batch_torch over 3 solves, all turns in one graph; launches {ring_launches}; the "
        f"fused ring solve {direct}, bit-identical; at the flat shape n={FLEET_N}, T={fleet_p.T} (bucket "
        f"{one._bucket_label(fkey)}): launches {fleet_launches}, bit-identical")
    log(f"[mesh] (c) minplus_backtrack_cuda on the ring's {D} slabs ({tuple(I0.shape)} int32 each): identical to "
        f"backtrack_ref (largest deviation {bt_err}); {bt_ms:.4f} ms a launch (CUDA events over a graph of 20 "
        f"launches on the last position's slab, which stays in L2), plain "
        f"{bt_plain_ms:.4f} ms, bound {1e3 * bt_bound:.5f} us ({bt_by})")
    log(f"[mesh] (d) the fleet on the ring engine: n={n}, T={T}, {k} clusters, quantum 1: objective {fs.objective:.6f} "
        f"= the flat DP's {flat_obj:.6f}, schedule as on the unsharded engine; bench_fleet's n={FLEET_N} at its "
        f"defaults: labels, allocations, schedule, curves and objective as on the unsharded engine")
    log(f"[mesh] times {card}: warm solve / graph replay (host clock, means of the medians of 5 and 10 in turns "
        f"{' , '.join(legs)} and back): " + "; ".join(f"{k} {warm[k]:.3f} / {replay[k]:.3f} ms" for k in legs))
    log("[mesh] argmin slab bytes per position at the bucket: " + "; ".join(
        f"{k} {v / 1e6:.3f} MB" for k, v in slab.items()))
    log("[mesh] peak device memory allocated above the held (cold solve: plan build and capture; warm solve) and "
        "memory the engine's plans keep reserved (graph pools, static buffers): " + "; ".join(
            f"{k} {c:.3f} / {w:.3f} GB, {r:.3f} GB" for k, (c, w, r) in peaks.items())
        + " (one physical card holds every position's slab, so the ring's peak does not fall; the mesh's positions "
          "build one after another)")
    log(f"[mesh] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"ring": ring_launches, "mesh": mesh_launches[f"mesh of {D} positions of the card"],
            "ring_flat": fleet_launches, "bt_err": bt_err,
            "bt_ring": {"ms": bt_ms, "plain_ms": bt_plain_ms, "bound_ms": bt_bound, "shape": list(I0.shape)}}


# -- phase 19: the LM zoo over torch.distributed -----------------------------------


def whole(x):
    """A DTensor's whole value; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def host_copy(tree):
    """A copy of a tree of tensors or DTensors on the host."""
    from repro_torch.optim import tree_map

    return tree_map(lambda x: whole(x).detach().to("cpu", copy=True), tree)


def placement_leaves(tree) -> list:
    """The placement lists of a tree that ``train_shardings`` gives, in
    tree order."""
    from torch.distributed.tensor import Placement

    if isinstance(tree, list) and tree and all(isinstance(p, Placement) for p in tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [pl for x in items for pl in placement_leaves(x)]


def event_ms(fn):
    """The device time of one call of ``fn`` between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def dist_train_part(fa, dev, card, mesh):
    """Phase 19 (a): gemma2-2b FULL sharded train steps against the
    unsharded ones from the same parameters. Returns the flash launches of
    the sharded steps (forward, dQ, dK/dV)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch import build_train_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import batch_pspecs, train_shardings
    from repro_torch.models import init_params, make_dummy_batch
    from repro_torch.optim import AdamState, tree_leaves, tree_map

    cfg = get_config(ARCH).replace(attn_impl="flash")
    L, n = cfg.num_layers, DIST_TRAIN_STEPS
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, B_TRAIN, S_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    start = host_copy(params)
    step, opt = build_train_step(cfg)

    # unsharded: the reference run, its parameters kept on the host
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses_u = []
    for _ in range(n):
        params, state, loss = step(params, state, batch)
        losses_u.append(float(loss))
    peak_u = torch.cuda.max_memory_allocated() / 1e9
    want = host_copy(params)
    del params, state
    torch.cuda.empty_cache()

    # sharded, from the same parameters
    with shd.mesh_context(mesh, {"act_seq": "model"}):
        pd = shd.distribute_params(tree_map(lambda x: x.to(dev), start))
        od = opt.init(pd)
        bd = {k: distribute_tensor(v, mesh, shd.spec_to_placements(spec, mesh, v.shape))
              for (k, v), spec in zip(batch.items(), batch_pspecs(cfg, batch, B_TRAIN).values())}
        p_pl, o_pl, b_pl = train_shardings(cfg, pd, od, batch, B_TRAIN)
        check(all(list(x.placements) == pl for x, pl in zip(tree_leaves(pd), placement_leaves(p_pl)))
              and all(list(x.placements) == pl for x, pl in zip(tree_leaves(od.mu), placement_leaves(o_pl.mu)))
              and all(list(x.placements) == pl for x, pl in zip(bd.values(), placement_leaves(b_pl))),
              "(a) the DTensors' placements differ from train_shardings'")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        fa.launches_fwd_tc = fa.launches_dq_tc = fa.launches_dkv_tc = 0
        losses_s = []
        for i in range(n):
            n0 = flash_counts(fa)
            pd, od, loss = step(pd, od, bd)
            losses_s.append(float(whole(loss)))
            per = tuple(b - a for a, b in zip(n0, flash_counts(fa)))
            check(per == (2 * L, L, L) * 2, f"(a) sharded step {i + 1}: flash (forward, dQ, dK/dV) and tensor-core "
                                            f"launches {per}, expected {(2 * L, L, L) * 2}")
        launches = (fa.launches, fa.launches_dq, fa.launches_dkv)
        peak_s = torch.cuda.max_memory_allocated() / 1e9
    d_loss = max(abs(a - b) for a, b in zip(losses_s, losses_u))
    check(all(math.isfinite(x) for x in losses_s) and d_loss < DIST_LOSS_ATOL,
          f"(a) losses sharded {losses_s} against unsharded {losses_u}")
    worst, worst_rel = 0.0, 0.0
    for a, b in zip(tree_leaves(pd), tree_leaves(want)):
        a, b = whole(a).float(), b.to(dev).float()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / b.abs().clamp_min(1e-30)).max()))
        check(torch.allclose(a, b, **DIST_PARAM_TOL), f"(a) a parameter after {n} sharded steps differs: max "
                                                      f"|diff| {float(diff.max()):.3e}")
    del a, b, diff, want, start
    log(f"[dist] (a) {ARCH} FULL, B={B_TRAIN}, S={S_TRAIN}, remat {cfg.remat}, {cfg.optimizer}: {n} sharded train "
        f"steps (DTensors on the (1, 1) mesh, act_seq on 'model') against the unsharded steps from the same "
        f"parameters: losses {', '.join(f'{x:.6f}' for x in losses_s)} against "
        f"{', '.join(f'{x:.6f}' for x in losses_u)} (max |diff| {d_loss:.3e}, limit {DIST_LOSS_ATOL}); parameters "
        f"max |diff| {worst:.3e}, max relative {worst_rel:.3e} (limit rtol {DIST_PARAM_TOL['rtol']}, atol "
        f"{DIST_PARAM_TOL['atol']}); per sharded step {2 * L} forward, {L} dQ, {L} dK/dV flash launches, all "
        f"tensor-core, inside local_map; peak device memory sharded {peak_s:.2f} GB, unsharded {peak_u:.2f} GB")

    # both in turns on one state: at world size 1 the local shards are the
    # whole tensors, so the unsharded step runs on the DTensors' storage
    pu = tree_map(lambda x: x.to_local(), pd)
    ou = AdamState(step=od.step, mu=tree_map(lambda x: x.to_local(), od.mu), nu=tree_map(lambda x: x.to_local(), od.nu))
    times = {"sharded": [], "unsharded": []}
    with shd.mesh_context(mesh, {"act_seq": "model"}):
        for _ in range(DIST_TIMING_ROUNDS):
            for which in ("unsharded", "sharded", "sharded", "unsharded"):
                if which == "sharded":
                    ms, (pd, od, _) = event_ms(lambda: step(pd, od, bd))
                else:
                    with shd.mesh_context(None):
                        ms, (pu, ou, _) = event_ms(lambda: step(pu, ou, batch))
                times[which].append(ms)
        total_s, _, kinds_s, n_s = device_time_table(lambda p, b: step(p, od, b), pd, bd)
    with shd.mesh_context(None):
        total_u, _, kinds_u, n_u = device_time_table(lambda p, b: step(p, ou, b), pu, batch)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[dist] {card}")
    log(f"[dist] (a) train step in turns (unsharded, sharded, sharded, unsharded) x {DIST_TIMING_ROUNDS}, CUDA "
        f"events: sharded {med['sharded']:.3f} ms (steps {', '.join(f'{x:.3f}' for x in times['sharded'])}), "
        f"unsharded {med['unsharded']:.3f} ms ({', '.join(f'{x:.3f}' for x in times['unsharded'])}), "
        f"sharded/unsharded {med['sharded'] / med['unsharded']:.4f}; by the profiler one step is busy "
        f"{total_s:.3f} ms sharded ({n_s} kernel launches, busy share {total_s / med['sharded']:.3f}) and "
        f"{total_u:.3f} ms unsharded ({n_u} launches, busy share {total_u / med['unsharded']:.3f}); by kind sharded "
        f"{kinds_text(kinds_s)}, unsharded {kinds_text(kinds_u)}")
    del pd, od, pu, ou, bd, batch, step, opt
    torch.cuda.empty_cache()
    return launches, dict(ms=med, peak_gb=(peak_s, peak_u), busy=(total_s / med["sharded"], total_u / med["unsharded"]),
                          loss_diff=d_loss, param_diff=worst)


def dist_moe_part(fa, dev, card, mesh):
    """Phase 19 (b): olmoe-1b-7b FULL, one MoE layer in float32 through the
    three dispatches, then a bf16 prefill with a2a against dense. Returns
    the prefill's flash launches."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch import build_prefill_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import batch_pspecs
    from repro_torch.models import init_params, make_dummy_batch
    from repro_torch.models.moe import _init_moe_ffn
    from repro_torch.models.moe_dispatch import moe_ffn
    from repro_torch.optim import tree_map

    B, S = DIST_MOE
    cfg = get_config(MOE_ARCH).replace(capacity_factor=DIST_MOE_CAPACITY)
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = _init_moe_ffn(c32, gen)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) * 0.3
    ys, ms = {}, {}
    with torch.no_grad():
        for impl in ("dense", "einsum"):
            ys[impl] = moe_ffn(c32.replace(moe_impl=impl), p, x)[0]
            ms[impl] = median_event_ms(lambda impl=impl: moe_ffn(c32.replace(moe_impl=impl), p, x), reps=3, warmup=1)
            torch.cuda.empty_cache()
        with shd.mesh_context(mesh):
            pd = shd.distribute_params({"moe": p})["moe"]
            xd = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
            ys["a2a"] = whole(moe_ffn(c32.replace(moe_impl="a2a"), pd, xd)[0])
            ms["a2a"] = median_event_ms(lambda: moe_ffn(c32.replace(moe_impl="a2a"), pd, xd), reps=3, warmup=1)
    err = {k: float((ys[k] - ys["dense"]).abs().max()) for k in ("a2a", "einsum")}
    check(err["a2a"] <= DIST_MOE_ATOL, f"(b) a2a against dense: max |diff| {err['a2a']:.3e}")
    T = B * S
    log(f"[dist] (b) {MOE_ARCH} FULL, one MoE layer in float32 ({cfg.num_experts} experts, top {cfg.top_k}, "
        f"capacity {cfg.capacity_factor}) on {B} x {S} tokens: a2a (one peer over NCCL) against dense max |diff| "
        f"{err['a2a']:.3e} (limit {DIST_MOE_ATOL}), einsum against dense {err['einsum']:.3e}; {card}: dense "
        f"{ms['dense']:.3f} ms, einsum {ms['einsum']:.3f} ms, a2a {ms['a2a']:.3f} ms (CUDA events, median of 3; "
        f"{T / ms['a2a'] * 1e3:.0f} tokens/s through a2a)")
    del p, x, ys, pd, xd
    torch.cuda.empty_cache()

    cfg = cfg.replace(attn_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, B, S, "prefill", np.random.default_rng(SEED), device=dev)
    want = build_prefill_step(cfg.replace(moe_impl="dense"))(params, batch)
    ein = build_prefill_step(cfg.replace(moe_impl="einsum"))(params, batch)
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32", moe_impl="dense")
    p32 = tree_map(lambda x: x.float(), params)
    want32 = build_prefill_step(c32)(p32, batch)
    del p32
    torch.cuda.empty_cache()
    def sharded_prefill():
        with shd.mesh_context(mesh):
            pd = shd.distribute_params(params)
            bd = {k: distribute_tensor(v, mesh, shd.spec_to_placements(spec, mesh, v.shape))
                  for (k, v), spec in zip(batch.items(), batch_pspecs(cfg, batch, B).values())}
            n0 = fa.launches
            got = whole(build_prefill_step(cfg.replace(moe_impl="a2a"))(pd, bd))
            return got, fa.launches - n0

    got, launches = run_with_launches_held(fa, "(b) a2a prefill", sharded_prefill, cases=DIST_FLASH_CASES, tag="dist")
    check(launches == cfg.num_layers, f"(b) the sharded prefill launched {launches} flash kernels")
    check(bool(torch.isfinite(got).all()), "(b) non-finite a2a prefill logits")
    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    rel = {"a2a-dense": rel_l2(got, want), "einsum-dense": rel_l2(ein, want), "a2a-einsum": rel_l2(got, ein),
           "dense-f32": rel_l2(want, want32), "a2a-f32": rel_l2(got, want32)}
    # a2a and dense are two bf16 evaluations of one float32 function: a2a
    # no farther from it than dense, within DIST_PREFILL_F32_RATIO (which
    # bounds a2a-dense by (1 + ratio) x dense's distance, by the triangle
    # inequality); the float32 layer check above holds the dispatch itself
    limit = DIST_PREFILL_F32_RATIO * rel["dense-f32"]
    check(rel["a2a-f32"] <= limit, f"(b) bf16 prefill, a2a farther from float32 than dense: relative L2 {rel}")
    log(f"[dist] (b) {MOE_ARCH} FULL bf16 prefill of {B} x {S} tokens at capacity {cfg.capacity_factor}, moe_impl "
        f"a2a on the mesh, from the same weights in float32 (dense): a2a {rel['a2a-f32']:.3e}, dense "
        f"{rel['dense-f32']:.3e} (limit for a2a {DIST_PREFILL_F32_RATIO} x dense's = {limit:.3e}); relative L2 of "
        f"the logits a2a against dense {rel['a2a-dense']:.3e} (printed; the issue's {DIST_PREFILL_REL_L2} "
        f"{'met' if rel['a2a-dense'] <= DIST_PREFILL_REL_L2 else 'missed'}), einsum against dense "
        f"{rel['einsum-dense']:.3e}, a2a against einsum {rel['a2a-einsum']:.3e}; {launches} flash launches on "
        f"local shards")
    del ein, want32
    del params, got, want
    torch.cuda.empty_cache()
    return launches, dict(ms=ms, err=err, prefill_rel_l2=rel)


def dist_serve_part(fa, dev, card, mesh):
    """Phase 19 (c): gemma2-2b FULL sharded serve steps against the
    unsharded ones, from a cache filled by one prefill of the prompt."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch import build_serve_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import batch_pspecs, cache_pspecs
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.dense import _embed, _logits, stack_forward

    B, S, slots = LONG_SHAPE[0], LONG_SHAPE[1], LONG_SHAPE[1] + LONG_SHAPE[2]
    G = DIST_SERVE_G
    cfg = get_config(ARCH).replace(attn_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (B, S))).long().to(dev)
    with torch.inference_mode():
        h, (k, v) = stack_forward(cfg, params["layers"], _embed(cfg, params, tokens), collect_cache=True)
        first = _logits(cfg, params, h[:, -1:]).argmax(dim=-1)
        del h
    cache = init_cache(cfg, B, slots)
    cache[0][:, :, :S].copy_(k)
    cache[1][:, :, :S].copy_(v)
    del k, v
    cache_s = tuple(c.clone() for c in cache)
    step = build_serve_step(cfg)

    def greedy(params, cache, tok):
        toks, ptrs, moved = [], None, False
        for i in range(G):
            tok, cache = step(params, cache, tok, S + i)
            toks.append(whole(tok))
            local = [c.to_local() if hasattr(c, "to_local") else c for c in cache]
            ptrs = ptrs or [t.data_ptr() for t in local]
            moved |= [t.data_ptr() for t in local] != ptrs
        return torch.cat(toks, dim=1), cache, moved

    want, cache, moved_u = greedy(params, cache, first)
    with shd.mesh_context(mesh):
        pd = shd.distribute_params(params)
        cd = tuple(distribute_tensor(c, mesh, shd.spec_to_placements(spec, mesh, c.shape))
                   for c, spec in zip(cache_s, cache_pspecs(cfg, cache_s, B, slots)))
        del cache_s
        ptrs = [c.to_local().data_ptr() for c in cd]
        td = distribute_tensor(first, mesh, shd.spec_to_placements(batch_pspecs(cfg, first, B), mesh, first.shape))
        got, cd, moved_s = greedy(pd, cd, td)
        check([c.to_local().data_ptr() for c in cd] == ptrs and not moved_s,
              "(c) the sharded cache's local storage moved")
    check(not moved_u, "(c) the unsharded cache moved")
    check(torch.equal(got, want), f"(c) sharded greedy tokens differ from the unsharded ones at "
                                  f"{int((got != want).sum())} of {got.numel()}")
    pos = S + G - 1
    tok_u, times = want[:, -1:], {"sharded": [], "unsharded": []}
    with shd.mesh_context(mesh):
        tok_s = distribute_tensor(tok_u, mesh, td.placements)
        for _ in range(DIST_TIMING_ROUNDS):
            for which in ("unsharded", "sharded", "sharded", "unsharded"):
                if which == "sharded":
                    ms = median_event_ms(lambda: step(pd, cd, tok_s, pos), reps=3, per_rep=3, warmup=1)
                else:
                    with shd.mesh_context(None):
                        ms = median_event_ms(lambda: step(params, cache, tok_u, pos), reps=3, per_rep=3, warmup=1)
                times[which].append(ms)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[dist] (c) {ARCH} FULL serve, B={B}, a cache of {slots} slots filled by a prefill of {S} tokens, placed "
        f"by cache_pspecs ({cache_gb(cd):.3f} GB): {G} sharded greedy tokens identical to the unsharded serve "
        f"step's, the cache's local storage the same every step; {card}: ms a token in turns (CUDA events, 3 "
        f"steps a pair, median of 3, x {DIST_TIMING_ROUNDS} rounds) sharded {med['sharded']:.4f} "
        f"({', '.join(f'{x:.4f}' for x in times['sharded'])}), unsharded {med['unsharded']:.4f} "
        f"({', '.join(f'{x:.4f}' for x in times['unsharded'])}), sharded/unsharded "
        f"{med['sharded'] / med['unsharded']:.4f}")
    del params, pd, cache, cd
    torch.cuda.empty_cache()
    return dict(ms=med)


def local_view(tree):
    """A tree of DTensors as their local tensors (at world size 1 the whole
    values, on the same storage); other leaves as they are."""
    from repro_torch.launch.steps import _map_tensors

    return _map_tensors(lambda x: x.to_local() if hasattr(x, "to_local") else x, tree)


def all_placed(tree, pl_tree) -> bool:
    """Every DTensor leaf of ``tree`` (a tree of ``train_shardings``' shape)
    in its placements; a plain leaf only as an optimizer's 0-d step."""
    leaves = tree_leaves_of(tree)
    return len(leaves) == len(placement_leaves(pl_tree)) and all(
        list(x.placements) == pl if hasattr(x, "placements") else x.dim() == 0
        for x, pl in zip(leaves, placement_leaves(pl_tree)))


def max_diff(a, b) -> float:
    """The largest absolute difference between two trees of tensors (DTensors
    taken whole, host copies moved to ``a``'s device)."""
    xs, ys = tree_leaves_of(a), tree_leaves_of(b)
    return max(float((whole(x).float() - y.to(whole(x).device).float()).abs().max()) if x.numel() else 0.0
               for x, y in zip(xs, ys))


def profiled(fn):
    """``(fn(), device ms, kernel launches)`` of one call under the
    profiler (:func:`device_time_table`)."""
    box = {}
    total, _, _, n = device_time_table(lambda p, b: box.setdefault("out", fn()), None, None)
    return box["out"], total, n


def dist_turns(what, run_u, run_s, card, dev=None):
    """``run_u`` and ``run_s`` (unsharded and sharded, each one call) in
    turns (unsharded, sharded, sharded, unsharded) x DIST_ZOO_ROUNDS by CUDA
    events. ``dev`` is ``{"sharded": (device ms, launches), "unsharded":
    ...}`` of one call of each under the profiler (the parts' first calls:
    a call's device time does not depend on its host time); without it one
    more call of each runs under the profiler. Logs and returns the medians,
    busy shares and kernel launches."""
    times = {"sharded": [], "unsharded": []}
    for _ in range(DIST_ZOO_ROUNDS):
        for which in ("unsharded", "sharded", "sharded", "unsharded"):
            times[which].append(event_ms(run_s if which == "sharded" else run_u)[0])
    med = {k: statistics.median(v) for k, v in times.items()}
    if dev is None:
        dev = {"unsharded": profiled(run_u)[1:], "sharded": profiled(run_s)[1:]}
    (total_s, n_s), (total_u, n_u) = dev["sharded"], dev["unsharded"]
    rec = dict(ms=med, busy=(total_s / med["sharded"], total_u / med["unsharded"]), launches=(n_s, n_u))
    log(f"[dist] {what}, {card}: in turns x {DIST_ZOO_ROUNDS} (CUDA events) sharded {med['sharded']:.3f} ms "
        f"({', '.join(f'{x:.3f}' for x in times['sharded'])}), unsharded {med['unsharded']:.3f} ms "
        f"({', '.join(f'{x:.3f}' for x in times['unsharded'])}), sharded/unsharded "
        f"{med['sharded'] / med['unsharded']:.4f}; busy share (profiler) sharded {rec['busy'][0]:.3f}, unsharded "
        f"{rec['busy'][1]:.3f}; kernel launches a call sharded {n_s}, unsharded {n_u}")
    return rec


def dist_prefill_pair(fa, what, cfg, params, batch, mesh, rules, card, cases):
    """The prefill step sharded against unsharded from the same parameters:
    identical at world size 1 (the difference is printed), then in turns.
    The sharded run's flash launches are held to ``cases``. Returns the
    record of :func:`dist_turns` with the first sharded call's flash
    launches and peak memory."""
    from repro_torch.launch import build_prefill_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import batch_pspecs, distribute_tree

    step = build_prefill_step(cfg)
    B = next(iter(batch.values())).shape[0]
    with torch.inference_mode():
        want, *dev_u = profiled(lambda: step(params, batch))
    with shd.mesh_context(mesh, rules):
        pd = shd.distribute_params(params)
        bd = distribute_tree(batch, batch_pspecs(cfg, batch, B), mesh)

    def sharded():
        with shd.mesh_context(mesh, rules):
            return step(pd, bd)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = fa.launches
    got, *dev_s = run_with_launches_held(fa, what, profiled, sharded, cases=cases, tag="dist")
    got = whole(got)
    launches, peak = fa.launches - n0, torch.cuda.max_memory_allocated() / 1e9
    diff = max_diff(got, want)
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape, f"{what}: sharded logits {tuple(got.shape)}")
    check(diff == 0.0, f"{what}: sharded logits differ from unsharded at world size 1 (max |d| {diff:.3e})")
    del got, want
    torch.cuda.empty_cache()
    log(f"[dist] {what}: sharded logits identical to the unsharded ones (max |d| {diff}); {launches} flash launches; "
        f"peak device memory {peak:.2f} GB")

    def unsharded():
        with torch.inference_mode():
            return step(params, batch)

    rec = dist_turns(what, unsharded, sharded, card, {"sharded": dev_s, "unsharded": dev_u})
    del pd, bd
    torch.cuda.empty_cache()
    return dict(rec, flash=launches, peak_gb=peak, diff=diff)


def dist_train_pair(fa, what, cfg, batch, mesh, rules, dev, card, hold="exact", steps=1):
    """``steps`` train steps sharded against unsharded from the same
    parameters (``init_params`` from SEED; ``moe_impl="a2a"`` sharded
    against the dense dispatch unsharded): every parameter, optimizer-state
    and batch leaf placed as ``train_shardings`` says; the last loss and the
    parameters after the steps identical at world size 1
    (``hold="exact"``), within the reference's limits (``"limits"``:
    DIST_LOSS_ATOL, DIST_PARAM_TOL) or only printed (``None``: a timing
    run, bfloat16 a2a against dense, two roundings of one sum). Then one
    step of each in turns on the same storage. Returns the record of
    :func:`dist_turns` with the first sharded step's flash launches, peak
    memory and differences."""
    from repro_torch.launch import build_train_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import batch_pspecs, distribute_tree, train_shardings
    from repro_torch.models import init_params
    from repro_torch.optim import tree_map

    step, opt = build_train_step(cfg)
    ucfg = cfg.replace(moe_impl="dense") if cfg.moe_impl == "a2a" else cfg
    ustep, _ = build_train_step(ucfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    start = host_copy(params)
    B = next(iter(batch.values())).shape[0]
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (params, state, loss_u), *dev_u = profiled(lambda: ustep(params, state, batch))
    for _ in range(steps - 1):
        params, state, loss_u = ustep(params, state, batch)
    loss_u, peak_u = float(loss_u), torch.cuda.max_memory_allocated() / 1e9
    want = host_copy(params)
    del params, state
    torch.cuda.empty_cache()
    with shd.mesh_context(mesh, rules):
        pd = shd.distribute_params(tree_map(lambda x: x.to(dev), start))
        del start
        od = opt.init(pd)
        bd = distribute_tree(batch, batch_pspecs(cfg, batch, B), mesh)
        p_pl, o_pl, b_pl = train_shardings(cfg, pd, od, batch, B)
        placed = all_placed(pd, p_pl) and all_placed(od, o_pl) and all_placed(bd, b_pl)
        check(placed, f"{what}: a parameter, optimizer-state or batch leaf is not placed as train_shardings says")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = flash_counts(fa)
        (pd, od, loss_s), *dev_s = profiled(lambda: step(pd, od, bd))
        flash = tuple(b - a for a, b in zip(n0, flash_counts(fa)))[:3]
        for _ in range(steps - 1):
            pd, od, loss_s = step(pd, od, bd)
        peak_s = torch.cuda.max_memory_allocated() / 1e9
    loss_s = float(whole(loss_s))
    d_loss, d_param = abs(loss_s - loss_u), max_diff(pd, want)
    if hold == "exact":
        check(d_loss == 0.0 and d_param == 0.0, f"{what}: the sharded step differs from the unsharded one at world "
                                                 f"size 1 (loss |d| {d_loss:.3e}, parameters max |d| {d_param:.3e})")
    elif hold == "limits":
        check(d_loss < DIST_LOSS_ATOL and all(torch.allclose(whole(a).float(), b.to(dev).float(), **DIST_PARAM_TOL)
                                              for a, b in zip(tree_leaves_of(pd), tree_leaves_of(want))),
              f"{what}: the sharded step against the unsharded one: loss |d| {d_loss:.3e}, parameters max |d| "
              f"{d_param:.3e}")
    check(math.isfinite(loss_s), f"{what}: sharded loss {loss_s}")
    del want
    torch.cuda.empty_cache()
    log(f"[dist] {what}: {steps} train step(s) ({cfg.optimizer}) sharded against unsharded from the same parameters"
        f"{'' if hold else ' (a timing run: the losses are printed, not held)'}: last loss "
        f"{loss_s:.6f} against {loss_u:.6f} (|d| {d_loss}), parameters max |d| {d_param}; every parameter, "
        f"optimizer-state and batch leaf placed as train_shardings says (optimizer state: "
        f"{type(od).__name__}, DTensor leaves); the first sharded step's flash launches (forward, dQ, dK/dV) "
        f"{flash}; peak device memory sharded {peak_s:.2f} GB, unsharded {peak_u:.2f} GB")
    pu, box = local_view(pd), {"s": od, "u": local_view(od)}

    def sharded():
        with shd.mesh_context(mesh, rules):
            _, box["s"], loss = step(pd, box["s"], bd)
        return loss

    def unsharded():
        _, box["u"], loss = ustep(pu, box["u"], batch)
        return loss

    rec = dist_turns(what, unsharded, sharded, card, {"sharded": dev_s, "unsharded": dev_u})
    del pd, od, pu, bd, box
    torch.cuda.empty_cache()
    return dict(rec, flash=flash, peak_gb=(peak_s, peak_u), loss_diff=d_loss, param_diff=d_param)


def held_train_pair(fa, what, fwd, bwd, *args, **kw):
    """:func:`dist_train_pair` ``(fa, what, *args, **kw)`` with every flash
    forward launch held to ``fwd`` (phase 6's shapes) and every backward
    launch to ``bwd`` (phase 9's), each against its plain version on its
    own inputs (``()``: a part that must launch no flash kernel)."""
    def run():
        return run_with_launches_held(fa, what, lambda: dist_train_pair(fa, what, *args, **kw), cases=fwd, tag="dist")

    return run_with_bwd_launches_held(fa, what, run, cases=bwd, tag="dist")


def tree_leaves_of(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in its order."""
    from repro_torch.launch.steps import _map_tensors

    out = []
    _map_tensors(out.append, tree)
    return out


def dist_serve_pair(what, cfg, params, cache, slots, first, pos0, mesh, card):
    """DIST_SERVE_G greedy serve steps from ``cache`` (a clone for each
    side) and the token ``first`` at position ``pos0``, sharded (the cache
    placed by ``cache_pspecs``) against unsharded: tokens and caches
    identical at world size 1, the KV caches written in place; then one
    step at the last position in turns."""
    from repro_torch.launch import build_serve_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import _map_tensors, batch_pspecs, cache_pspecs, distribute_tree, spec_leaves

    step = build_serve_step(cfg)
    B, G, S = first.shape[0], DIST_SERVE_G, slots
    kv = lambda c: next((c[k] for k in ("attn", "moe") if k in c), ()) if isinstance(c, dict) else (  # noqa: E731
        c if isinstance(c, tuple) else ())

    def greedy(params, cache, tok):
        ptrs = [whole_local(t).data_ptr() for t in kv(cache)]
        toks = []
        for i in range(G):
            tok, cache = step(params, cache, tok, pos0 + i)
            toks.append(whole(tok))
        check([whole_local(t).data_ptr() for t in kv(cache)] == ptrs, f"{what}: the KV cache moved")
        return torch.cat(toks, dim=1), cache

    cache_s = _map_tensors(lambda t: t.clone(), cache)
    want, cache_u = greedy(params, cache, first)
    with shd.mesh_context(mesh):
        pd = shd.distribute_params(params)
        specs = cache_pspecs(cfg, cache_s, B, S)
        cd = distribute_tree(cache_s, specs, mesh)
        placed = all(list(x.placements) == shd.spec_to_placements(sp, mesh, x.shape)
                     for x, sp in zip(tree_leaves_of(cd), spec_leaves(specs)))
        check(placed, f"{what}: a cache leaf is not placed as cache_pspecs says")
        td = distribute_tree(first, batch_pspecs(cfg, first, B), mesh)
        got, cd = greedy(pd, cd, td)
    d_cache = max_diff(cd, cache_u)
    check(torch.equal(got, want), f"{what}: sharded greedy tokens differ from the unsharded ones at "
                                  f"{int((got != want).sum())} of {got.numel()}")
    check(d_cache == 0.0, f"{what}: the sharded cache differs from the unsharded one (max |d| {d_cache:.3e})")
    log(f"[dist] {what}: {G} sharded greedy tokens identical to the unsharded serve step's, caches and recurrent "
        f"states identical (max |d| {d_cache}), every cache leaf placed by cache_pspecs ({cache_gb(cd):.3f} GB), "
        f"the KV caches written in place")
    pos, tok_u = pos0 + G - 1, want[:, -1:]
    with shd.mesh_context(mesh):
        tok_s = distribute_tree(tok_u, batch_pspecs(cfg, tok_u, B), mesh)

    def sharded():
        with shd.mesh_context(mesh):
            return step(pd, cd, tok_s, pos)

    rec = dist_turns(f"{what}, one serve step", lambda: step(params, cache_u, tok_u, pos), sharded, card)
    del pd, cd, cache_u, cache_s
    torch.cuda.empty_cache()
    return rec


def whole_local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def dist_xlstm_part(fa, dev, card, mesh):
    """Phase 19 (d): xlstm-1.3b cut to DIST_XLSTM_LAYERS layers, prefill and
    train step sharded against unsharded; a sharded sLSTM scan crosses the
    DTensor boundary once (one ``local_shards``, one ``local_map``), whatever
    its length."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models import init_params, make_dummy_batch, ssm, xlstm

    rules = {"act_seq": "model"}
    cfg = get_config("xlstm-1.3b").replace(num_layers=DIST_XLSTM_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, *DIST_XLSTM_PREFILL, "prefill", np.random.default_rng(SEED), device=dev)
    scans, boundaries = [], []
    with spying(xlstm, "slstm_scan", lambda out, z, *a, **k: scans.append(hasattr(z, "to_local"))):
        pre = dist_prefill_pair(fa, f"(d) xlstm-1.3b x {DIST_XLSTM_LAYERS} layers, prefill {DIST_XLSTM_PREFILL}", cfg,
                                params, batch, mesh, rules, card, ())
    with shd.mesh_context(mesh, rules), torch.no_grad():
        pd = shd.distribute_params(params)
        D = cfg.d_model // cfg.num_heads
        z = distribute_tensor(torch.zeros((1, DIST_XLSTM_PREFILL[1], cfg.num_heads, D), device=dev,
                                          dtype=cfg.cdtype()), mesh, [Replicate()] * mesh.ndim)
        with spying(ssm, "local_shards", lambda out, *a, **k: boundaries.append(1)):
            ssm.slstm_scan(z, z, z, z, {k: pd["slstm"][0][k] for k in ("rz", "ri", "rf", "ro")})
    check(len(boundaries) == 1, f"(d) one sharded sLSTM scan made {len(boundaries)} local_shards calls")
    log(f"[dist] (d) the sLSTM scan on DTensors: {len(boundaries)} DTensor boundary (one local_shards, one "
        f"local_map) per scan of {DIST_XLSTM_PREFILL[1]} steps, its loop on local tensors; the part's sharded "
        f"prefill calls ran {sum(scans)} sLSTM scans on DTensors ({cfg.num_layers // cfg.slstm_every} sLSTM block "
        f"a call)")
    del pd, z, params
    torch.cuda.empty_cache()
    train_batch = make_dummy_batch(cfg, *DIST_XLSTM_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    tr = held_train_pair(fa, f"(d) xlstm-1.3b x {DIST_XLSTM_LAYERS} layers, train {DIST_XLSTM_TRAIN}", (), (), cfg,
                         train_batch, mesh, rules, dev, card)
    return dict(prefill=pre, train=tr, slstm_boundaries=len(boundaries))


def dist_zamba_part(fa, dev, card, mesh):
    """Phase 19 (e): zamba2-2.7b cut to DIST_ZAMBA_LAYERS layers: prefill,
    train step and DIST_SERVE_G serve tokens after a collect-state prefill,
    sharded against unsharded."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid, init_cache, init_params, make_dummy_batch

    rules = {"act_seq": "model"}
    cfg = get_config("zamba2-2.7b").replace(num_layers=DIST_ZAMBA_LAYERS, attn_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, 1, ZAMBA_S, "prefill", np.random.default_rng(SEED), device=dev)
    pre = dist_prefill_pair(fa, f"(e) zamba2-2.7b x {DIST_ZAMBA_LAYERS} layers, prefill (1, {ZAMBA_S})", cfg, params,
                            batch, mesh, rules, card, SSM_FLASH_CASES)
    start = ZAMBA_S - SSM_CHUNK
    tokens = batch["tokens"]
    with torch.inference_mode():
        logits, state = run_with_launches_held(
            fa, "(e) collect-state prefill", lambda: hybrid.zamba_forward(params, cfg, tokens[:, :start],
                                                                          collect_state=True),
            cases=SSM_FLASH_CASES, tag="dist")
        first = logits[:, -1:].argmax(dim=-1)
    cache = init_cache(cfg, 1, start + DIST_SERVE_G)
    with torch.inference_mode():
        for dst, src in zip(cache["attn"], state["attn"]):
            dst[:, :, :start].copy_(src)
    cache = {"mamba": tuple(x.clone() for x in state["mamba"]), "attn": cache["attn"]}
    del logits, state
    torch.cuda.empty_cache()
    sv = dist_serve_pair(f"(e) zamba2-2.7b x {DIST_ZAMBA_LAYERS} layers, serve after a collect-state prefill of "
                         f"{start}", cfg, params, cache, start + DIST_SERVE_G, first, start, mesh, card)
    del params, cache, batch
    torch.cuda.empty_cache()
    train_batch = make_dummy_batch(cfg, 1, ZAMBA_TRAIN_S, "train", np.random.default_rng(SEED), device=dev)
    tr = held_train_pair(fa, f"(e) zamba2-2.7b x {DIST_ZAMBA_LAYERS} layers, train (1, {ZAMBA_TRAIN_S})",
                         SSM_FLASH_CASES, SSM_FLASH_BWD_CASES, cfg, train_batch, mesh, rules, dev, card)
    return dict(prefill=pre, serve=sv, train=tr)


def dist_encoder_part(fa, dev, card, mesh):
    """Phase 19 (f): hubert-xlarge encode and train, paligemma-3b prefill,
    train and serve, granite-20b (cut) prefill, each sharded against
    unsharded."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, make_dummy_batch, vlm
    from repro_torch.models.dense import _logits, stack_forward

    rules, out = {"act_seq": "model"}, {}
    cfg = get_config(HUBERT_ARCH).replace(attn_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, *HUBERT_ENCODE, "prefill", np.random.default_rng(SEED), device=dev)
    out["hubert_encode"] = dist_prefill_pair(fa, f"(f) {HUBERT_ARCH} encode {HUBERT_ENCODE}", cfg, params, batch,
                                             mesh, rules, card, ENC_FLASH_CASES)
    del params, batch
    torch.cuda.empty_cache()
    batch = make_dummy_batch(cfg, *HUBERT_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    out["hubert_train"] = held_train_pair(fa, f"(f) {HUBERT_ARCH} train {HUBERT_TRAIN}", ENC_FLASH_CASES,
                                          ENC_FLASH_BWD_CASES, cfg, batch, mesh, rules, dev, card)
    del batch
    torch.cuda.empty_cache()

    cfg = get_config(PALI_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, *PALI_PREFILL, "prefill", np.random.default_rng(SEED), device=dev)
    out["pali_prefill"] = dist_prefill_pair(fa, f"(f) {PALI_ARCH} prefill {PALI_PREFILL}", cfg, params, batch, mesh,
                                            rules, card, ())
    B, P = DIST_PALI_SERVE_B, cfg.num_patches
    patches, tokens = batch["patches"][:B], batch["tokens"][:B]
    del batch
    torch.cuda.empty_cache()
    with torch.inference_mode():
        h, (k, v) = stack_forward(cfg, params["layers"], vlm._fuse(params, cfg, patches, tokens), prefix_len=P,
                                  collect_cache=True)
        first = _logits(cfg, params, h[:, -1:]).argmax(dim=-1)
    S = h.shape[1]
    del h
    cache = init_cache(cfg, B, S + DIST_SERVE_G)
    with torch.inference_mode():
        cache[0][:, :, :S].copy_(k)
        cache[1][:, :, :S].copy_(v)
    del k, v
    out["pali_serve"] = dist_serve_pair(f"(f) {PALI_ARCH} serve at B={B} after a prefill of {S} positions", cfg,
                                        params, cache, S + DIST_SERVE_G, first, S, mesh, card)
    del params, cache
    torch.cuda.empty_cache()
    batch = make_dummy_batch(cfg, *PALI_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    out["pali_train"] = held_train_pair(fa, f"(f) {PALI_ARCH} train {PALI_TRAIN}", (), (), cfg, batch, mesh, rules,
                                        dev, card)
    del batch
    torch.cuda.empty_cache()

    cfg = get_config("granite-20b").replace(num_layers=DIST_GRANITE_LAYERS, attn_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, 1, DENSE_S, "prefill", np.random.default_rng(SEED), device=dev)
    out["granite_prefill"] = dist_prefill_pair(
        fa, f"(f) granite-20b x {DIST_GRANITE_LAYERS} layers (one KV head, replicated on the model axis of size 1), "
        f"prefill (1, {DENSE_S})", cfg, params, batch, mesh, rules, card, SERVE_FLASH_CASES)
    del params, batch
    torch.cuda.empty_cache()
    return out


def dist_olmoe_part(fa, dev, card, mesh):
    """Phase 19 (g): a float32 cut of olmoe-1b-7b to DIST_OLMOE_F32_LAYERS
    layers, one sharded a2a train step held to the reference's limits
    against the unsharded (dense) step; then the bfloat16 cut to
    DIST_OLMOE_LAYERS layers, DIST_TRAIN_STEPS sharded a2a steps against
    the dense ones, a timing run (two roundings of one sum: its losses are
    printed, not held). Every flash launch of both, forward and backward,
    is held against its plain version on its own inputs."""
    from repro_torch.configs import get_config

    from repro_torch.models import make_dummy_batch

    rules = {"act_seq": "model"}
    base = get_config(MOE_ARCH).replace(attn_impl="flash", moe_impl="a2a", capacity_factor=DIST_MOE_CAPACITY)
    c32 = base.replace(num_layers=DIST_OLMOE_F32_LAYERS, param_dtype="float32", compute_dtype="float32")
    batch = make_dummy_batch(c32, *DIST_MOE, "train", np.random.default_rng(SEED), device=dev)
    f32 = held_train_pair(fa, f"(g) {MOE_ARCH} x {DIST_OLMOE_F32_LAYERS} layers in float32, train {DIST_MOE}, a2a "
                          f"(sharded) against dense (unsharded)", DIST_FLASH_CASES, DIST_FLASH_BWD_CASES, c32, batch,
                          mesh, rules, dev, card, hold="limits")
    cfg = base.replace(num_layers=DIST_OLMOE_LAYERS)
    tr = held_train_pair(fa, f"(g) {MOE_ARCH} x {DIST_OLMOE_LAYERS} layers, train {DIST_MOE}, a2a (sharded) against "
                         f"dense (unsharded)", DIST_FLASH_CASES, DIST_FLASH_BWD_CASES, cfg, batch, mesh, rules, dev,
                         card, hold=None, steps=DIST_TRAIN_STEPS)
    del batch
    torch.cuda.empty_cache()
    return dict(f32=f32, train=tr)


def dist_einsum_part(fa, dev, card, mesh):
    """Phase 19 (i): olmoe-1b-7b's decode with the einsum dispatch, sharded
    against unsharded (the constants' comment). The sharded decode must run
    the dispatch's ``local_map`` body once a layer, the unsharded never."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import _map_tensors, batch_pspecs, cache_pspecs, distribute_tree
    from repro_torch.models import decode_fn, init_cache, init_params, moe_dispatch

    B, pos0 = DIST_EINSUM_B, DIST_EINSUM_POS
    slots = pos0 + DIST_SERVE_G
    cfg = get_config(MOE_ARCH).replace(num_layers=DIST_OLMOE_LAYERS, moe_impl="einsum")
    cap = moe_dispatch.einsum_capacity(cfg, B)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cache = init_cache(cfg, B, slots)
    with torch.inference_mode():
        for c in tree_leaves_of(cache):
            for layer in c:
                layer[:, :pos0].normal_(generator=gen).mul_(0.5)
    first = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    bodies = []
    cache_u = _map_tensors(lambda t: t.clone(), cache)
    with spying(moe_dispatch, "_moe_einsum_sharded", lambda *a, **k: bodies.append("u")):
        logits_u, cache_u = decode_fn(params, cfg, cache_u, first, pos0)
    n_u = len(bodies)
    with shd.mesh_context(mesh):
        pd = shd.distribute_params(params)
        cs = _map_tensors(lambda t: t.clone(), cache)
        cd = distribute_tree(cs, cache_pspecs(cfg, cs, B, slots), mesh)
        td = distribute_tree(first, batch_pspecs(cfg, first, B), mesh)
        with spying(moe_dispatch, "_moe_einsum_sharded", lambda *a, **k: bodies.append("s")):
            logits_s, cd = decode_fn(pd, cfg, cd, td, pos0)
    d_logits = float((whole(logits_s).float() - logits_u.float()).abs().max())
    d_cache = max_diff(cd, cache_u)
    check(n_u == 0 and len(bodies) == cfg.num_layers,
          f"(i) the einsum dispatch's local_map body ran {n_u} times unsharded and {len(bodies) - n_u} times sharded "
          f"({cfg.num_layers} MoE layers)")
    check(d_logits == 0.0 and d_cache == 0.0, f"(i) the sharded einsum decode differs from the unsharded one: "
                                              f"logits max |d| {d_logits:.3e}, cache {d_cache:.3e}")
    log(f"[dist] (i) {MOE_ARCH} x {cfg.num_layers} layers, einsum decode at B={B} ({cap} slots an expert) from a "
        f"random cache at position {pos0}: the sharded decode ran the dispatch under local_map in each of its "
        f"{cfg.num_layers} layers; logits and cache identical to the unsharded decode's (max |d| {d_logits}, "
        f"{d_cache})")
    del pd, cs, cd, logits_s, logits_u, cache_u
    torch.cuda.empty_cache()
    sv = dist_serve_pair(f"(i) {MOE_ARCH} x {cfg.num_layers} layers, einsum serve at B={B} from position {pos0}", cfg,
                         params, cache, slots, first, pos0, mesh, card)
    del params, cache
    torch.cuda.empty_cache()
    return dict(serve=sv, capacity=cap)


def widened(tree, dev):
    """A float32 copy on ``dev`` of a tree of dicts and lists of host
    tensors, each leaf widened on the card a slab of its leading dim at a
    time (no narrow copy of a whole leaf is ever on the card)."""
    if isinstance(tree, dict):
        return {k: widened(x, dev) for k, x in tree.items()}
    if isinstance(tree, list):
        return [widened(x, dev) for x in tree]
    out = torch.empty(tree.shape, dtype=torch.float32, device=dev)
    step = max(1, (1 << 28) // max(1, tree[0].numel() if tree.dim() else 1))
    for i in range(0, tree.shape[0] if tree.dim() else 1, step):
        if tree.dim():
            out[i:i + step].copy_(tree[i:i + step].to(dev))
        else:
            out.copy_(tree.to(dev))
    return out


def dist_adafactor_part(fa, dev, card, mesh):
    """Phase 19 (h): gemma2-2b FULL's train step under Adafactor sharded
    against unsharded; deepseek-v3 at MLA_CUT, a prefill with a2a over
    ("data", "model") against the dense dispatch, held by their float32
    distances."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_prefill_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import batch_pspecs, distribute_tree
    from repro_torch.models import init_params, make_dummy_batch, moe_dispatch

    cfg = get_config(ARCH).replace(attn_impl="flash", optimizer="adafactor")
    batch = make_dummy_batch(cfg, B_TRAIN, S_TRAIN, "train", np.random.default_rng(SEED), device=dev)
    # the backward launches' shapes are held, their values against a
    # float64 plain backward: on this step's random-init gradients (|dk|
    # under 1e-6, sums of 8,192 terms with cancellation) the kernels' bf16
    # outputs lie a bf16 ulp from the float32 plain backward, whose own
    # distance from a float64 one is as large, and phase 9's bf16 limit
    # (half an ulp at the bottom of a binade) fails on a few of 8.4 M
    # entries
    what = f"(h) {ARCH} FULL, train ({B_TRAIN}, {S_TRAIN}) under Adafactor"
    ada = run_with_bwd_launches_held(fa, what, dist_train_pair, fa, what, cfg, batch, mesh, {"act_seq": "model"}, dev,
                                     card, cases=DIST_TRAIN_FLASH_BWD_CASES, tag="dist", values="float64")
    del batch
    torch.cuda.empty_cache()

    rules = {"expert": ("data", "model")}
    cfg = get_config(MLA_ARCH).replace(attn_impl="flash", capacity_factor=DIST_MLA_CAPACITY, **MLA_CUT)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = make_dummy_batch(cfg, 1, MLA_S, "prefill", np.random.default_rng(SEED), device=dev)
    with torch.inference_mode():
        want = build_prefill_step(cfg.replace(moe_impl="dense"))(params, batch)
    # the float32 reference below is widened from a host copy (57.7 GB does
    # not fit beside a bfloat16 copy); the sharded run holds only the
    # DTensors (a shard on an axis of size 1 is scattered into a copy)
    host = host_copy(params)
    with shd.mesh_context(mesh, rules):
        pd = shd.distribute_params(params)
        bd = distribute_tree(batch, batch_pspecs(cfg, batch, 1), mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def sharded():
        with shd.mesh_context(mesh, rules):
            n0 = fa.launches
            got = whole(build_prefill_step(cfg.replace(moe_impl="a2a"))(pd, bd))
            return got, fa.launches - n0

    loads = []
    with spying(moe_dispatch, "route", lambda out, *a: loads.append(
            int(torch.bincount(whole(out[1]).reshape(-1), minlength=cfg.num_experts).max()))):
        got, launches = run_with_launches_held(fa, "(h) deepseek-v3 a2a prefill", sharded, cases=SERVE_FLASH_CASES,
                                               tag="dist")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(got).all()), "(h) non-finite deepseek-v3 a2a prefill logits")
    del pd, bd
    torch.cuda.empty_cache()
    params = widened(host, dev)
    del host
    with torch.inference_mode():
        want32 = build_prefill_step(cfg.replace(param_dtype="float32", compute_dtype="float32",
                                                moe_impl="dense"))(params, batch)
    # a2a's per-expert buffers with one peer (moe_dispatch._moe_a2a): every
    # routed row fits when the largest load does
    cap_send = max(8, int(-(-MLA_S * cfg.top_k * cfg.capacity_factor // 1) // 8 * 8 + 8))
    cap = max(8, int(-(-cap_send * cfg.capacity_factor // cfg.num_experts) // 8 * 8 + 8))
    check(max(loads) <= cap, f"(h) a2a at capacity {cfg.capacity_factor} drops tokens: an expert's load "
                             f"{max(loads)} > {cap}")
    del params
    torch.cuda.empty_cache()
    rel_l2 = lambda a, b: float((a.float() - b).norm() / b.norm())  # noqa: E731
    rel = {"a2a-f32": rel_l2(got, want32), "dense-f32": rel_l2(want, want32), "a2a-dense": rel_l2(got, want.float())}
    limit = DIST_PREFILL_F32_RATIO * rel["dense-f32"]
    check(rel["a2a-f32"] <= limit, f"(h) deepseek-v3 bf16 prefill, a2a farther from float32 than dense: {rel}")
    log(f"[dist] (h) {MLA_ARCH} at full width cut to {MLA_CUT}, prefill (1, {MLA_S}), moe_impl a2a at capacity "
        f"{cfg.capacity_factor} over the flattened expert group ('data', 'model') of one rank ({cfg.num_experts} "
        f"experts on it; largest expert load {max(loads)} of a2a's {cap} slots an expert: nothing dropped): "
        f"relative L2 from the same weights in float32 (dense dispatch) a2a {rel['a2a-f32']:.3e}, dense "
        f"{rel['dense-f32']:.3e} "
        f"(limit {DIST_PREFILL_F32_RATIO} x dense's = {limit:.3e}); a2a against dense {rel['a2a-dense']:.3e}; "
        f"{launches} flash launches; peak device memory of the sharded prefill {peak:.2f} GB")
    del got, want, want32, batch
    torch.cuda.empty_cache()
    return dict(adafactor=ada, mla=dict(rel_l2=rel, flash=launches, peak_gb=peak))


def distributed_phase(fa, dev, card):
    """Phase 19: the LM zoo over torch.distributed (the constants' comment).
    Returns the flash launches of the sharded runs by part."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    store = Path(__file__).resolve().parent / "build" / "phase19.store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        check(dist.get_backend() == "nccl", f"the process group's backend is {dist.get_backend()}, not nccl")
        mesh = make_smoke_mesh((1, 1))
        check(mesh.device_type == "cuda" and tuple(mesh.mesh_dim_names) == ("data", "model"), f"mesh {mesh}")
        log(f"[dist] NCCL process group of world size {dist.get_world_size()} (FileStore {store.name}), mesh {mesh}")
        train_launches, train = dist_train_part(fa, dev, card, mesh)
        moe_launches, moe = dist_moe_part(fa, dev, card, mesh)
        serve = dist_serve_part(fa, dev, card, mesh)
        parts, times = {}, {}
        for name, part in (("d", dist_xlstm_part), ("e", dist_zamba_part), ("f", dist_encoder_part),
                           ("g", dist_olmoe_part), ("h", dist_adafactor_part), ("i", dist_einsum_part)):
            t1 = time.perf_counter()
            parts[name] = part(fa, dev, card, mesh)
            times[name] = round(time.perf_counter() - t1, 1)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    # the first sharded run's flash launches (forward, dQ, dK/dV) of each
    # part that launches the kernels
    runs = {"zamba2-2.7b prefill": parts["e"]["prefill"]["flash"], "zamba2-2.7b train": parts["e"]["train"]["flash"],
            f"{HUBERT_ARCH} encode": parts["f"]["hubert_encode"]["flash"],
            f"{HUBERT_ARCH} train": parts["f"]["hubert_train"]["flash"],
            "granite-20b prefill": parts["f"]["granite_prefill"]["flash"],
            f"{MOE_ARCH} float32 train": parts["g"]["f32"]["flash"], f"{MOE_ARCH} train": parts["g"]["train"]["flash"],
            f"{ARCH} Adafactor train": parts["h"]["adafactor"]["flash"], f"{MLA_ARCH} prefill": parts["h"]["mla"]["flash"]}
    runs = {k: (v, 0, 0) if isinstance(v, int) else v for k, v in runs.items()}
    launches = {"train": train_launches, "moe_prefill": moe_launches, "zoo": runs}
    log(f"[dist] phase 19 wall time {time.perf_counter() - t0:.1f} s (parts (d)-(i) {times} s); flash launches of "
        f"the sharded runs {launches}")
    return launches, dict(train=train, moe=moe, serve=serve, **parts)


def trip_count_part(card, dev):
    """Phase 20 (c): the fake trace's trip-counted count of xlstm-1.3b's
    prefill and train step against the count of the same step run on the
    card (the constants' comment). The fake trace must take the trip-counted
    loops, the run on the card never."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import build_prefill_step, build_train_step
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.models import init_params, make_dummy_batch, ssm

    B, S = DRYRUN_TRIP
    cfg = get_config(DRYRUN_TRIP_ARCH).replace(num_layers=DRYRUN_TRIP_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    out = {}
    for mode in ("prefill", "train"):
        trips = []
        with spying(ssm, "_slstm_by_trips", lambda *a, **k: trips.append("s")), \
                spying(ssm, "_mlstm_by_trips", lambda *a, **k: trips.append("m")):
            fake, fake_s, _ = count_step(cfg, InputShape("trip", S, B, mode), device=dev)
            n_fake = (trips.count("s"), trips.count("m"))
            batch = make_dummy_batch(cfg, B, S, mode, np.random.default_rng(SEED), device=dev)
            if mode == "train":
                step, opt = build_train_step(cfg)
                args = (params, opt.init(params), batch)
            else:
                step, args = build_prefill_step(cfg), (params, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CostCounter() as real:
                res = step(*args)
            torch.cuda.synchronize()
            real_s = time.perf_counter() - t0
        check(n_fake[0] > 0 and n_fake[1] > 0 and len(trips) == sum(n_fake),
              f"(c) {mode}: trip-counted sLSTM / mLSTM loops in the fake trace {n_fake}, on the card "
              f"{len(trips) - sum(n_fake)}")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves_of(res[-1] if mode == "train" else res)),
              f"(c) {mode}: a result is not finite")
        check(real.cost.flops == fake.cost.flops and real.cost.mem_bytes == fake.cost.mem_bytes
              and real.cost.coll_total == fake.cost.coll_total,
              f"(c) {mode}: the count on the card (FLOPs {real.cost.flops:.6e}, bytes {real.cost.mem_bytes:.6e}, "
              f"collective {real.cost.coll_total:.6e}) != the trip-counted fake trace's (FLOPs {fake.cost.flops:.6e}, "
              f"bytes {fake.cost.mem_bytes:.6e}, collective {fake.cost.coll_total:.6e})")
        log(f"[dryrun] (c) {DRYRUN_TRIP_ARCH} x {cfg.num_layers} layers, {mode} (B={B}, S={S}), unsharded: the fake "
            f"trace counted {n_fake[0]} sLSTM scans and {n_fake[1]} mLSTM chunk loops by their trip counts in "
            f"{fake_s:.2f} s; the card ran every step under the counter in {real_s:.2f} s: FLOPs {real.cost.flops:.6e}, "
            f"bytes {real.cost.mem_bytes:.6e}, collective bytes {real.cost.coll_total:.6e}, equal to the fake "
            f"trace's")
        out[mode] = dict(flops=fake.cost.flops, bytes=fake.cost.mem_bytes, fake_s=fake_s, real_s=real_s)
        del res, args, batch
    del params
    torch.cuda.empty_cache()
    return out


def dryrun_phase(card, dev, kernel_step_ms):
    """Phase 20: the dry run (the constants' comment). ``kernel_step_ms`` is
    phase 10's warm kernel-route step. Stops both subprocesses whatever
    happens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import build_train_step
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.launch.roofline import HW, roofline_terms_from_cost
    from repro_torch.models import init_params, make_dummy_batch

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    procs = {}
    for arch, shape in DRYRUN_COMBOS:
        out = out_dir / f"{arch}.{shape}.pod.json"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", "pod",
               "--device", dev.type, "--unsharded", "--out", str(out)]
        procs[(arch, shape)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                                      env=env, cwd=str(root)))
    try:
        # (b) the counter on the card, while (a) runs on the host's other cores
        cfg = get_config(ARCH).replace(attn_impl="plain")
        shape = InputShape("phase10", S_TRAIN, B_TRAIN, "train")
        fake, fake_s, memory = count_step(cfg, shape, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        step, opt = build_train_step(cfg)
        state = opt.init(params)
        batch = make_dummy_batch(cfg, B_TRAIN, S_TRAIN, "train", np.random.default_rng(SEED), device=dev)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - m0
        leaves = tree_leaves_of((params, state, batch))
        n_tensors = len(leaves)
        # the caching allocator rounds a block up to 512 B, and leaves a
        # large block's (over 1 MiB) tail unsplit when it is at most 1 MiB
        slack = sum((1 << 20) + 512 if t.numel() * t.element_size() > 1 << 20 else 512 for t in leaves)
        check(0 <= placed - memory["argument_bytes"] <= slack,
              f"(b) the placed parameters, optimizer state and batch take {placed} B on the card, the fake trace's "
              f"argument_bytes {memory['argument_bytes']} (allocator rounding over {n_tensors} tensors: at most "
              f"{slack} B)")
        with CostCounter() as real:
            params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        check(math.isfinite(float(loss)), f"(b) loss {float(loss)}")
        check(real.cost.flops == fake.cost.flops and real.cost.mem_bytes == fake.cost.mem_bytes,
              f"(b) the counter on the card (FLOPs {real.cost.flops:.6e}, bytes {real.cost.mem_bytes:.6e}) != the "
              f"fake trace (FLOPs {fake.cost.flops:.6e}, bytes {fake.cost.mem_bytes:.6e})")
        ms = []
        for _ in range(DRYRUN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, loss = step(params, state, batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        plain_ms = statistics.median(ms)
        terms = roofline_terms_from_cost(fake.cost)
        log(f"[dryrun] {card}")
        log(f"[dryrun] (b) {ARCH} FULL train step, plain route, B={B_TRAIN} S={S_TRAIN}, unsharded: counted on the "
            f"card {real.cost.flops:.6e} FLOPs, {real.cost.mem_bytes:.6e} B (2 x result bytes), equal to the fake "
            f"trace's ({fake_s:.2f} s); roofline with HW {HW}: t_compute {1e3 * terms['t_compute_s']:.3f} ms, "
            f"t_memory {1e3 * terms['t_memory_s']:.3f} ms ({terms['dominant']}); measured plain-route step "
            f"{plain_ms:.3f} ms (CUDA events, median of {DRYRUN_STEPS}: {', '.join(f'{x:.3f}' for x in ms)}), "
            f"phase 10's kernel-route step {kernel_step_ms:.3f} ms; argument_bytes {memory['argument_bytes']} B "
            f"against {placed} B allocated for the placed parameters, optimizer state and batch ({n_tensors} "
            f"tensors, {placed - memory['argument_bytes']} B of allocator rounding, at most {slack})")
        del params, state, batch, step, opt
        torch.cuda.empty_cache()
        trip_count_part(card, dev)

        # (a) the production mesh
        results = {}
        for (arch, shape), (out, proc) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t_phase)))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"check failed: (a) the dry run of {arch} {shape} took over {DRYRUN_TIMEOUT} s")
            check(proc.returncode == 0, f"(a) the dry run of {arch} {shape} exited {proc.returncode}: {stderr[-2000:]}")
            r = json.loads(out.read_text())
            results[(arch, shape)] = r
            check(r["status"] == "ok" and r["n_chips"] == 256 and r["collectives"]["total"] > 0,
                  f"(a) {arch} {shape}: status {r['status']}, n_chips {r.get('n_chips')}, collective bytes "
                  f"{r.get('collectives', {}).get('total')}")
            t = r["roofline"]
            un = r["unsharded"]["flops"]
            log(f"[dryrun] (a) {arch} {shape} on (16, 16): per device {t['hlo_flops_per_device']:.6e} FLOPs, "
                f"{t['hlo_bytes_per_device']:.6e} B, {t['collective_bytes_per_device']:.6e} collective B "
                f"({r['collectives']['_counts']}); t_compute {t['t_compute_s']:.6e} s, t_memory "
                f"{t['t_memory_s']:.6e} s, t_collective {t['t_collective_s']:.6e} s -> {t['dominant']}; trace "
                f"{r['lower_s']} s (unsharded {r['unsharded']['lower_s']} s); per-device FLOPs x 256 "
                f"{256 * t['hlo_flops_per_device']:.6e} against the unsharded step's {un:.6e} (ratio "
                f"{256 * t['hlo_flops_per_device'] / un:.4f}); memory (rank 0) {r['memory']}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    log(f"[dryrun] phase 20 wall time {time.perf_counter() - t_phase:.1f} s")
    return results


def remat_train(fa, cfg, start, batch, dev, what):
    """REMAT_STEPS train steps of ``cfg`` from the host copy ``start``: the
    first step's loss and parameters (a host copy), the flash launches of
    each step (the counters set to 0 before the steps), the warm steps' ms
    (CUDA events), the peak device memory over the steps, allocated and
    reserved, and the caching allocator's retries in them (a retry frees
    the cache and calls cudaMalloc again, which waits on the card)."""
    from repro_torch.launch import build_train_step
    from repro_torch.optim import tree_map

    step, opt = build_train_step(cfg)
    params = tree_map(lambda x: x.to(dev, copy=True), start)  # the step updates its parameters in place
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in FLASH_COUNTERS:
        setattr(fa, c, 0)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    L, ms, first = cfg.num_layers, [], None
    for i in range(REMAT_STEPS):
        n0 = flash_counts(fa)
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        params, state, loss = step(params, state, batch)
        end_ev.record()
        torch.cuda.synchronize()
        per = tuple(b - a for a, b in zip(n0, flash_counts(fa)))
        check(per == (2 * L, L, L) * 2, f"{what} step {i + 1}: flash (forward, dQ, dK/dV) launches and their "
                                        f"tensor-core ones {per}, expected {(2 * L, L, L) * 2}")
        check(math.isfinite(float(loss)), f"{what} step {i + 1}: loss {float(loss)}")
        if i == 0:
            first = (float(loss), host_copy(params))
        else:
            ms.append(start_ev.elapsed_time(end_ev))
    launches = flash_counts(fa)[:3]
    peak = (torch.cuda.max_memory_allocated() / 1e9, torch.cuda.max_memory_reserved() / 1e9,
            torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries)
    del params, state, step, opt
    torch.cuda.empty_cache()
    return first, launches, statistics.median(ms), ms, peak


def remat_phase(fa, dev, card):
    """Phase 21: ``remat="dots"`` against ``"full"`` (the header). Returns
    the flash launches of the "dots" steps. Stops (b)'s subprocesses
    whatever happens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import value_and_grad
    from repro_torch.models import init_params, make_dummy_batch
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "perf"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    arch, shape, variants = REMAT_CLIMB
    procs = {}
    for v in variants:
        out = out_dir / f"{arch}.{shape}.{v}.json"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.hillclimb", "--arch", arch, "--shape", shape, "--variant", v,
               "--mesh", "pod", "--device", dev.type, "--out", str(out)]
        procs[v] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                                          cwd=str(root)))
    try:
        # (a) the train step under each remat, from the same weights and batch
        cfg = get_config(ARCH).replace(attn_impl="flash")
        check(cfg.remat == "full", f"{ARCH} FULL trains with remat {cfg.remat}")
        start = host_copy(init_params(cfg, torch.Generator(device=dev).manual_seed(SEED)))
        batch = make_dummy_batch(cfg, B_TRAIN, S_TRAIN, "train", np.random.default_rng(SEED), device=dev)
        torch.cuda.empty_cache()
        runs = {r: remat_train(fa, cfg.replace(remat=r), start, batch, dev, f"(a) remat={r}") for r in ("full", "dots")}
        (loss_f, p_f), (loss_d, p_d) = runs["full"][0], runs["dots"][0]
        d_loss = abs(loss_d - loss_f)
        worst, ok = 0.0, True
        for a, b in zip(tree_leaves_of(p_d), tree_leaves_of(p_f)):
            d = (a.float() - b.float()).abs()
            ok = ok and bool((d <= MODEL_GRAD_ATOL + MODEL_GRAD_RTOL * b.float().abs()).all())
            worst = max(worst, float(d.max()))
        del start, p_f, p_d
        log(f"[remat] {card}")
        log(f"[remat] (a) {ARCH} FULL B={B_TRAIN} S={S_TRAIN}, flash route, AdamW, the same weights and batch: first "
            f"step's loss dots {loss_d:.6f}, full {loss_f:.6f} (|d| {d_loss:.3e}, limit {LOSS_ATOL}); parameters "
            f"after it within rtol={MODEL_GRAD_RTOL}, atol={MODEL_GRAD_ATOL} of full's: {ok} (largest |d| "
            f"{worst:.3e})")
        for r, (_, launches, warm, ms, peak) in runs.items():
            log(f"[remat] (a) remat={r}: flash launches over {REMAT_STEPS} steps (forward, dQ, dK/dV) {launches}, "
                f"{tuple(n // REMAT_STEPS for n in launches)} a step, all tensor-core; warm step {warm:.3f} ms (CUDA "
                f"events, median of {len(ms)}: {', '.join(f'{x:.3f}' for x in ms)}); peak device memory {peak[0]:.2f} GB "
                f"allocated, {peak[1]:.2f} GB reserved; allocator retries over the steps {peak[2]}")
        check(d_loss < LOSS_ATOL and ok, f"(a) remat=dots against full: loss |d| {d_loss}, parameters within limits "
                                         f"{ok}")
        cfg32 = cfg.replace(num_layers=F32_LAYERS, param_dtype="float32", compute_dtype="float32")
        p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED))
        n0 = flash_counts(fa)
        loss_n, g_n = value_and_grad(p32, cfg32.replace(remat="none"), batch)
        loss_d32, g_d = value_and_grad(p32, cfg32.replace(remat="dots"), batch)
        per = tuple(b - a for a, b in zip(n0, flash_counts(fa)))[:3]
        check(per == (3 * F32_LAYERS, 2 * F32_LAYERS, 2 * F32_LAYERS), f"(a) float32 none + dots launches {per}")
        d32 = abs(float(loss_d32) - float(loss_n))
        worst32, ok32 = 0.0, True
        for a, b in zip(tree_leaves(g_d), tree_leaves(g_n)):
            d = (a - b).abs()
            ok32 = ok32 and bool((d <= MODEL_GRAD_ATOL + MODEL_GRAD_RTOL * b.abs()).all())
            worst32 = max(worst32, float(d.max()))
        del p32, g_n, g_d, batch
        torch.cuda.empty_cache()
        log(f"[remat] (a) float32, {F32_LAYERS} layers at full width: loss under dots {float(loss_d32):.6f} against "
            f"none {float(loss_n):.6f} (|d| {d32:.3e}, limit {LOSS_ATOL}); gradients within rtol={MODEL_GRAD_RTOL}, "
            f"atol={MODEL_GRAD_ATOL} (largest |d| {worst32:.3e}); flash launches (forward, dQ, dK/dV) {per}")
        check(d32 < LOSS_ATOL and ok32, f"(a) float32 dots against none: loss |d| {d32}, gradients within limits "
                                        f"{ok32}")

        # (b) the hill-climb on the fake pod mesh
        terms = {}
        for v, (out, proc) in procs.items():
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(1.0, REMAT_CLIMB_TIMEOUT - (time.perf_counter() - t_phase)))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"check failed: (b) the hill-climb of {arch} {shape} [{v}] took over "
                                   f"{REMAT_CLIMB_TIMEOUT} s")
            check(proc.returncode == 0, f"(b) the hill-climb [{v}] exited {proc.returncode}: {stderr[-2000:]}")
            r = json.loads(out.read_text())
            check(r["status"] == "ok" and r["variant"] == v and r["n_chips"] == 256,
                  f"(b) [{v}]: status {r['status']}, variant {r.get('variant')}, n_chips {r.get('n_chips')}")
            t = terms[v] = r["roofline"]
            log(f"[remat] (b) {arch} {shape} [{v}] on the fake (16, 16) mesh of \"{dev.type}\" stand-ins: per device "
                f"{t['hlo_flops_per_device']:.6e} FLOPs, {t['hlo_bytes_per_device']:.6e} B, "
                f"{t['collective_bytes_per_device']:.6e} collective B; t_compute {t['t_compute_s']:.6e} s, t_memory "
                f"{t['t_memory_s']:.6e} s, t_collective {t['t_collective_s']:.6e} s -> {t['dominant']}; trace "
                f"{r['lower_s']} s; summary: {stdout.strip().splitlines()[-1]}")
        ratio = terms["remat_dots"]["hlo_flops_per_device"] / terms["baseline"]["hlo_flops_per_device"]
        log(f"[remat] (b) remat_dots / baseline per-device FLOPs {ratio:.4f}")
        check(ratio < 1.0, f"(b) remat_dots counts {ratio:.4f} x baseline's FLOPs per device")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    log(f"[remat] phase 21 wall time {time.perf_counter() - t_phase:.1f} s")
    return runs["dots"][1]


# -- phase 22: the port's examples ----------------------------------------------


def load_example(name):
    """``examples_torch/<name>.py`` as a module (the directory is not a package)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def captured(fn, *args):
    """``fn(*args)``'s standard output and result."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


def example_launch_part(card):
    """Phase 22 (a): the quickstart as a user starts it."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "examples_torch/quickstart.py"], capture_output=True, text=True, cwd=root,
                          env=env, timeout=EXAMPLE_TIMEOUT)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"examples_torch/quickstart.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    check("energy saved vs uniform split:" in proc.stdout and "fleet scale: n=256 clients ->" in proc.stdout,
          f"examples_torch/quickstart.py printed {proc.stdout!r}")
    for line in proc.stdout.splitlines():
        log(f"[examples] (a) | {line}")
    log(f"[examples] (a) {card}; `python examples_torch/quickstart.py` (no arguments: the card) exit 0 in "
        f"{wall_s:.2f} s, the process's start and imports included")


def example_scheduler_part(mp, card):
    """Phase 22 (b): the three scheduler examples on the card against
    ``--device cpu``. Returns ``{name: {"row": .., "backtrack": ..}}``
    of each cold run, counted from 0."""
    from repro_torch.core.sweep import SweepEngine, reset_default_engines

    keys = []  # the bucket of every engine dispatch

    def recording(inner):
        def entry(self, key):
            keys.append(key)
            return inner(self, key)

        return entry

    launches = {}
    for name in EXAMPLE_SCHEDULERS:
        module = load_example(name)
        runs = []
        reset_default_engines()
        for _ in ("cold", "warm"):
            keys.clear()
            mp.launches = mp.launches_scan = mp.launches_backtrack = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with patched(SweepEngine, "_entry", recording):
                out, res = captured(module.main, ["--device", "cuda"])
            torch.cuda.synchronize()
            dp = [k for k in keys if k[0] == "dp"]
            runs.append(dict(out=out, res=res, s=time.perf_counter() - t0, keys=list(keys),
                             launches={"row": mp.launches, "backtrack": mp.launches_backtrack},
                             expect={"row": sum(k[2] for k in dp), "backtrack": len(dp)},
                             stats=res["solver"].engine.cache_stats()))
        cold, warm = runs
        check(cold["res"]["solver"].engine.device.type == "cuda", f"{name}: the engine is not on the card")
        t0 = time.perf_counter()
        cpu_out, cpu_res = captured(module.main, ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        check(cold["out"].splitlines() == cpu_out.splitlines() == warm["out"].splitlines(),
              f"{name}: the card printed {cold['out']!r}, the CPU {cpu_out!r}")
        if name == "quickstart":
            for f in ("labels", "allocations", "schedule"):
                check(np.array_equal(getattr(cold["res"]["fleet"], f), getattr(cpu_res["fleet"], f)),
                      f"quickstart: the card's fleet {f} differ from the CPU's")
        for run in runs:
            check(run["launches"] == run["expect"], f"{name}: launches {run['launches']}; the engine's dp dispatches "
                  f"{run['keys']} hold {run['expect']}")
        check(warm["launches"] == cold["launches"] and warm["stats"]["compiles"] == cold["stats"]["compiles"]
              == len(set(cold["keys"])), f"{name}: warm {warm['launches']} against cold {cold['launches']}, "
              f"plan builds {cold['stats']['compiles']} of {len(set(cold['keys']))} buckets")
        launches[name] = cold["launches"]
        for line in cold["out"].splitlines():
            log(f"[examples] (b) {name} | {line}")
        labels = sorted({SweepEngine._bucket_label(k) for k in cold["keys"]})
        log(f"[examples] (b) {name}: every line identical to --device cpu (and warm to cold)"
            + ("; k-means labels, allocations and schedule identical to the CPU's" if name == "quickstart" else "")
            + f"; min-plus launches {cold['launches']} (the engine's {len(cold['keys'])} dispatches over buckets "
            f"{labels}: n_b rows and one backtrack each dp dispatch), the same warm; plan builds "
            f"{cold['stats']['compiles']}; wall {cold['s']:.3f} s cold (engines reset), {warm['s']:.3f} s warm, "
            f"{cpu_s:.3f} s with --device cpu")
    log(f"[examples] (b) {card}")
    return launches


def example_fl_part(mp, card):
    """Phase 22 (c): the FL example at its scaled size on the card, planning
    held against the same campaigns planned on the CPU. Returns ``{run:
    {"row": .., "backtrack": ..}}``, each counted from 0 over the run."""
    import gc

    from repro_torch.core.sweep import reset_default_engines

    module = load_example("fl_energy_training")
    servers = []

    class Counted(module.FederatedServer):
        """The example's server, counting the min-plus launches of each
        round's plan (round r + 1 is planned while round r trains)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.plan_launches = []
            servers.append(self)

        def plan_round(self, *args, **kw):
            before = np.array([mp.launches, mp.launches_backtrack])
            out = super().plan_round(*args, **kw)
            self.plan_launches.append(np.array([mp.launches, mp.launches_backtrack]) - before)
            return out

    class PlanOnly(module.FederatedServer):
        def train_round(self, plan, batches):
            return torch.zeros(())

    opt = dict(zip(EXAMPLE_FL_ARGV[::2], EXAMPLE_FL_ARGV[1::2]))
    batch, seq = int(opt["--batch"]), int(opt["--seq"])
    launches = {}
    for key, run_argv in EXAMPLE_FL_RUNS.items():
        argv = [*EXAMPLE_FL_ARGV, *run_argv]
        reset_default_engines()
        servers.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mp.launches = mp.launches_scan = mp.launches_backtrack = 0
        t0 = time.perf_counter()
        with patched(module, "FederatedServer", lambda _: Counted):
            out, hists = captured(module.main, [*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches[key] = {"row": mp.launches, "backtrack": mp.launches_backtrack}
        for line in out.splitlines():
            log(f"[examples] (c) {key} | {line}")
        # the same campaigns planned on the CPU: planning sees the estimator,
        # the time tables and the rng, never the model, so training is stubbed
        with patched(module, "FederatedServer", lambda _: PlanOnly), \
                patched(module, "init_params", lambda _: lambda cfg, seed, device: {}):
            cpu_out, cpu_hists = captured(module.main, [*argv, "--device", "cpu"])
        check(list(hists) == list(cpu_hists) == (["auto", "uniform"] if key == "compare" else ["auto"])
              and len(servers) == len(hists), f"{key}: campaigns {list(hists)} on the card, {list(cpu_hists)} on the CPU")
        if key == "knee":
            front = [line for line in out.splitlines() if "round-0 frontier" in line]
            check(len(front) == 1 and front == [line for line in cpu_out.splitlines() if "round-0 frontier" in line],
                  f"knee: the round-0 frontier line {front} differs from the CPU's")
        for (name, hist), server in zip(hists.items(), servers):
            what = f"{key}: the {name} campaign on the card against the CPU-planned one"
            same_rounds(hist, cpu_hists[name], what, losses=False)
            losses = hist.losses
            check(np.isfinite(losses).all() and losses[-1] < losses[0], f"{what}: losses {losses}")
            per_plan = np.array(server.plan_launches).reshape(-1, 2)
            check(len(per_plan) == len(hist.rounds), f"{what}: {len(per_plan)} plans for {len(hist.rounds)} rounds")
            rows = per_plan[:, 0]
            if key == "knee":
                check(bool((rows > 0).all()), f"knee: a round's plan launched no min-plus row kernel: {rows.tolist()}")
            else:
                check(not per_plan.any(), f"{name}: min-plus launches by round's plan {per_plan.tolist()}")
            tokens = np.array([int(r.assignments.sum()) * batch * seq for r in hist.rounds])
            walls = np.asarray(hist.pipeline_stats.round_wall_s)
            log(f"[examples] (c) {key} {name}: {len(hist.rounds)} rounds, schedules, estimated and true energies and "
                f"makespans identical to the CPU-planned campaign; total {hist.total_energy:.6f} J; loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}; min-plus row launches by round's plan "
                f"{rows.tolist() if rows.any() else 'none'}, backtracks "
                f"{per_plan[:, 1].tolist() if per_plan[:, 1].any() else 'none'}; round wall {1e3 * walls[0]:.3f} ms "
                f"first, {1e3 * walls[1:].mean():.3f} ms mean of the rest (host clock, each round's loss read on the "
                f"host); client tokens/s {tokens[1:].sum() / walls[1:].sum():.1f} over rounds 2-{len(walls)} "
                f"({tokens[0] / walls[0]:.1f} in round 1)")
        if key == "compare":
            check(hists["auto"].total_energy < hists["uniform"].total_energy,
                  f"optimised {hists['auto'].total_energy} J, uniform {hists['uniform'].total_energy} J")
        log(f"[examples] (c) {key}: argv {argv}; {wall_s:.2f} s in all; peak device memory {peak_gb:.3f} GB above the "
            f"{base / 1e9:.3f} GB held before; min-plus launches {launches[key]}; {card}")
    return launches


def examples_phase(mp, card):
    """Phase 22: the port's examples (the header). Returns the min-plus
    launches of (b)'s and (c)'s runs by example."""
    t_phase = time.perf_counter()
    example_launch_part(card)
    launches = example_scheduler_part(mp, card)
    fl = example_fl_part(mp, card)
    launches.update({f"fl_energy_training {k}": v for k, v in fl.items()})
    log(f"[examples] phase 22 wall time {time.perf_counter() - t_phase:.1f} s; min-plus launches {launches}")
    return launches


def adamw_phase(aw, dev, card):
    """Phase 23: AdamW's leaf kernel (``aw``, :mod:`repro_torch.kernels.adamw`)
    on the card against its plain version on the same card (the constants'
    comment), then its device time per launch at the head and w1 leaves
    beside its bound, the plain version and ``torch._fused_adamw_``, the
    nearest library call (it takes one dtype for every state, so its second
    moment is bfloat16 here, and rounds elsewhere: the port never calls it).
    Returns the kernels line's figures."""
    from repro_torch.optim.optimizers import _as

    f32 = torch.float32
    t_phase = time.perf_counter()

    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)

    def corrections(t):
        t = torch.full((), float(t), device=dev)
        return (1 - torch.full((), ADAMW_B1, device=dev) ** t, 1 - torch.full((), ADAMW_B2, device=dev) ** t)

    def leaf(shape, dt, mdt):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        g = torch.randn(shape, generator=gen, device=dev).mul_(1e-2).to(dt)
        p = torch.randn(shape, generator=gen, device=dev).mul_(0.05).to(dt)
        m = torch.randn(shape, generator=gen, device=dev).mul_(1e-3).to(mdt)
        v = torch.randn(shape, generator=gen, device=dev).mul_(1e-2).square_()
        kw = dict(b1=_as(ADAMW_B1, mdt), c1=_as(1 - ADAMW_B1, dt), b2=_as(ADAMW_B2, f32), c2=_as(1 - ADAMW_B2, f32),
                  eps=ADAMW_EPS, wd=_as(ADAMW_WD, dt), lr=ADAMW_LR)
        return g, p, m, v, kw

    cases = [("head", *ADAMW_PAIRS[0])] + [("w1", dt, mdt) for dt, mdt in ADAMW_PAIRS]
    for name, dt, mdt in cases:
        g, p, m, v, kw = leaf(ADAMW_LEAVES[name], dt, mdt)
        p2, m2, v2 = p.clone(), m.clone(), v.clone()
        for t in ADAMW_STEPS:
            bc1, bc2 = corrections(t)
            n0 = aw.launches
            u = aw.adamw_leaf(g, m, v, p, bc1, bc2, **kw)
            check(aw.launches == n0 + 1, f"adamw_leaf on the card launched {aw.launches - n0} kernels, not 1")
            u2 = aw.adamw_leaf_ref(g, m2, v2, p2, bc1, bc2, **kw)
            p.add_(u)
            p2.add_(u2)
            differ = [k for k, a, b in (("update", u, u2), ("mu", m, m2), ("nu", v, v2), ("p", p, p2))
                      if not torch.equal(bits(a), bits(b))]
            check(not differ, f"adamw {name} {tuple(p.shape)} p {dt} mu {mdt}, step {t}: {differ} differ bitwise "
                  "from the plain version")
        del g, p, m, v, p2, m2, v2, u, u2
        torch.cuda.empty_cache()
    log(f"[adamw] adamw_leaf against adamw_leaf_ref on the card, steps {', '.join(map(str, ADAMW_STEPS))}, weight "
        f"decay {ADAMW_WD}: update, mu, nu and p after it bit-identical at the head {ADAMW_LEAVES['head']} (p bf16, "
        f"mu bf16) and at w1 {ADAMW_LEAVES['w1']} (p and mu "
        + "; ".join(f"{str(dt)[6:]} and {str(mdt)[6:]}" for dt, mdt in ADAMW_PAIRS) + ")")

    log(f"[times] {card}")
    out = {}
    for name, shape in ADAMW_LEAVES.items():
        g, p, m, v, kw = leaf(shape, *ADAMW_PAIRS[0])
        bc1, bc2 = corrections(7)
        n = p.numel()
        moved = sum(x.nbytes for x in (g, p, m, v, m, v, p))  # reads g, p, m, v; writes m, v and u (p's dtype)
        n0 = aw.launches
        ms = median_event_ms(lambda: aw.adamw_leaf(g, m, v, p, bc1, bc2, **kw), reps=10, per_rep=5)
        check(aw.launches - n0 == 3 + 10 * 5, f"adamw {name}: {aw.launches - n0} launches counted, expected 53")
        plain_ms = median_event_ms(lambda: aw.adamw_leaf_ref(g, m, v, p, bc1, bc2, **kw), reps=5, warmup=1)
        v16, steps = v.to(p.dtype), [torch.full((), 7.0, device=dev)]
        lib_ms = median_event_ms(lambda: torch._fused_adamw_(
            [p], [g], [m], [v16], [], steps, lr=ADAMW_LR, beta1=ADAMW_B1, beta2=ADAMW_B2, weight_decay=ADAMW_WD,
            eps=ADAMW_EPS, amsgrad=False, maximize=False), reps=10, per_rep=5)
        b_ms = moved / PEAK_BYTES_PER_S * 1e3
        out[name] = dict(leaf_shape=list(shape), leaf_elements=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=f"bytes: {moved / n:.0f} an element over {PEAK_BYTES_PER_S:.3g} B/s",
                         library_ms=lib_ms)
        log(f"[times] adamw_kernel at the {name} leaf {shape} ({n} elements, p and g bf16, mu bf16, nu float32): "
            f"{ms:.4f} ms a launch (CUDA events, median of 10 x 5), bound {b_ms:.4f} ms ({moved / n:.0f} bytes an "
            f"element over {PEAK_BYTES_PER_S:.3g} B/s), kernel at {ms / b_ms:.3f}x the bound; plain version "
            f"{plain_ms:.4f} ms; torch._fused_adamw_ (nu bf16) {lib_ms:.4f} ms")
        del g, p, m, v, v16
        torch.cuda.empty_cache()
    log(f"[adamw] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {**out["head"], "w1": out["w1"], "max_abs_err": 0.0}


def deepseek_v3_phase(fa, dev, card):
    """Phase 24: the benchmark cell ``V3_CELL``'s attention launch and
    train step (the header). Returns its figures."""
    from perfbench import registry, weights
    from perfbench.modes import train_v3
    from repro_torch.models import layers, moe_dispatch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tc = ("launches_fwd_tc", "launches_dq_tc", "launches_dkv_tc")

    def counts():
        return tuple(getattr(fa, name) for name in tc)

    # (a) the attention launch through layers.attention
    B, H, S, D, Dv = V3_ATTN
    scale = D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k = ((torch.randn((B, S, H, D), generator=gen, device=dev) * 0.5).bfloat16() for _ in range(2))
    v = (torch.randn((B, S, H, Dv), generator=gen, device=dev) * 0.5).bfloat16()
    do = torch.randn((B, S, H, Dv), generator=gen, device=dev).bfloat16()
    pos = torch.arange(S, device=dev)
    seen = []
    n0 = counts()
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    with spying(layers, "flash_attention", lambda out, *a, **kw: seen.append(
            [t.detach().clone() for t in (*a[:3], *out)])):
        o = layers.attention(*xs, q_pos=pos, kv_pos=pos, kind="causal", scale=scale, impl="flash")
        o.backward(do)
    got_n = tuple(b - a for a, b in zip(n0, counts()))
    check(got_n == (1, 1, 1), f"deepseek-v3 attention {V3_ATTN}: tensor-core launches (fwd, dQ, dK/dV) {got_n}, "
                              f"not one each")
    check(len(seen) == 1, f"deepseek-v3 attention: {len(seen)} flash_attention calls, not 1")
    qp, kp, vp, op, lse = seen.pop()
    Dk = fa.kernel_head_dim(D)
    check(qp.shape == (B, H, S, Dk) and vp.shape == (B, H, S, Dk),
          f"deepseek-v3 attention: the launch took q {tuple(qp.shape)}, v {tuple(vp.shape)}, not {Dk} wide")
    check(bool((op[..., Dv:] == 0).all()), "deepseek-v3 attention: v's zero columns gave non-zero output columns")
    got = [o.detach()] + [t.grad for t in xs]
    del xs, o
    with torch.inference_mode():
        ok, *errs = flash_err(fa, (op, lse), qp, kp, vp, "causal", 0, 0.0, scale)
        check(ok, f"deepseek-v3 attention: the launch at {tuple(qp.shape)} != plain on its padded inputs "
                  f"(max |do|, |do32|, |dlse| {errs})")
        torch.cuda.empty_cache()
        dop = torch.nn.functional.pad(do.transpose(1, 2), (0, Dk - Dv))
        want = fa.flash_attention_bwd_ref(qp.float(), kp.float(), vp.float(), op.float(), lse, dop.float(),
                                          "causal", 0, 0.0, scale)
        bwd = {}
        for name, g, w, dim in (("dq", got[1], want[0], D), ("dk", got[2], want[1], D), ("dv", got[3], want[2], Dv)):
            w = w[..., :dim].transpose(1, 2)
            rtol, atol = bwd_limits(w, torch.bfloat16)
            d = (g.float() - w).abs()
            check(g.dtype == torch.bfloat16 and bool((d <= atol + rtol * w.abs()).all()),
                  f"deepseek-v3 attention: {name} != the plain backward on the padded inputs (max {float(d.max()):.3e},"
                  f" limit {atol:.3e} + {rtol:.3e} |want|)")
            bwd[name] = float(d.max())
        del want, dop, qp, kp, vp, op, lse
        torch.cuda.empty_cache()
    rs = [t.float().requires_grad_() for t in (q, k, v)]
    o = layers.attention(*rs, q_pos=pos, kv_pos=pos, kind="causal", scale=scale, impl="plain", block_q=1024)
    o.backward(do.float())
    plain = {}
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, [o.detach()] + [t.grad for t in rs]):
        plain[name] = float((a.float() - b).abs().max()) / float(b.abs().max())
        check(plain[name] <= BF16_GRID_TOL, f"deepseek-v3 attention: {name} against the plain route at head dims "
                                            f"{D}/{Dv} in float32: relative {plain[name]:.3e} > {BF16_GRID_TOL}")
    del rs, o, got, q, k, v, do
    torch.cuda.empty_cache()
    log(f"[v3] (a) attention {V3_ATTN} (B, H, S, q/k and v head dims), bf16, through layers.attention: one forward, "
        f"dQ and dK/dV launch at the {Dk} instance on zero-padded q, k, v; the launch within phase 6's limits of the "
        f"plain version on its inputs (max |do| {errs[0]:.3e}, |do32| {errs[1]:.3e}, |dlse| {errs[2]:.3e}), the "
        f"padded output columns zero; gradients within phase 9's limits of the plain backward (max "
        + ", ".join(f"{n} {e:.3e}" for n, e in bwd.items()) + "); against the plain route in float32, relative "
        + ", ".join(f"{n} {e:.3e}" for n, e in plain.items()))

    # (b) the cell's train step
    root = Path(__file__).resolve().parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    plan = registry.plan(V3_CELL, root)
    config, cell = plan["config"], plan["cell"]
    model = config["model"]
    check(model["num_layers"] == V3_LAYERS, f"{V3_CELL}: {model['num_layers']} layers, not {V3_LAYERS}")
    torch.cuda.reset_peak_memory_stats()
    obj = train_v3.build(config, model, SEED, dev)
    params, state, step = obj["params"], obj["state"], obj["step"]
    biases = [b.clone() for b in obj["biases"]]
    pool = weights.batch_pool(SEED, 2, cell["batch"], cell["seq_len"], model["vocab_size"], dev)
    n_moe = model["num_layers"] - model["dense_prefix_layers"]
    plain_calls, out = [], []
    for i in range(2):
        for name in tc:
            setattr(fa, name, 0)
        held0 = (moe_dispatch.pairs_held, moe_dispatch.dropped)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with spying(layers, "_build_mask", lambda *a, **kw: plain_calls.append(1)):
            params, state, loss = step(params, state, {"tokens": pool[i]})
            loss = float(loss)
        wall_ms = (time.perf_counter() - t0) * 1e3
        got_n = counts()
        want_n = (2 * V3_LAYERS, V3_LAYERS, V3_LAYERS)
        check(got_n == want_n, f"{V3_CELL} step {i}: tensor-core launches (fwd, dQ, dK/dV) {got_n}, not {want_n}")
        check(not plain_calls, f"{V3_CELL} step {i}: {len(plain_calls)} attention calls on the plain route")
        check(math.isfinite(loss), f"{V3_CELL} step {i}: loss {loss}")
        pairs = (moe_dispatch.pairs_held - held0[0]) / (2 * n_moe)
        check(moe_dispatch.dropped == held0[1] and pairs > 0, f"{V3_CELL} step {i}: held pairs {pairs} a MoE layer "
                                                              f"and pass, dropped {moe_dispatch.dropped - held0[1]}")
        out.append({"loss": loss, "wall_ms": wall_ms, "pairs_held_per_layer_pass": pairs})
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(obj["biases"], biases))
    check(same, f"{V3_CELL}: a router bias changed in a train step")
    peak = torch.cuda.max_memory_allocated()
    log(f"[v3] (b) {V3_CELL}: {weights.numel(obj['lay'])} parameters and biases, built from seed {SEED}; two steps of "
        f"{cell['batch']} x {cell['seq_len']} tokens, each {2 * V3_LAYERS} forward, {V3_LAYERS} dQ and {V3_LAYERS} "
        f"dK/dV launches, all tensor-core, none on the plain route; losses "
        + ", ".join(f"{x['loss']:.4f}" for x in out) + "; held pairs a MoE layer and pass "
        + ", ".join(f"{x['pairs_held_per_layer_pass']:.1f}" for x in out) + ", none dropped; the router biases bit "
        f"for bit; wall " + ", ".join(f"{x['wall_ms']:.1f}" for x in out) + f" ms (the first cold); peak "
        f"{peak / 2 ** 30:.3f} GiB; {card}")
    del obj, params, state, step, biases, pool
    torch.cuda.empty_cache()
    log(f"[v3] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"attention": {"fwd_err": errs, "bwd_err": bwd, "plain_rel": plain}, "steps": out, "peak_bytes": peak}


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
    from repro_torch.kernels import adamw as aw
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
    aw._launch_fn()
    log(f"[build] minplus.cu, flash_fwd.cu, flash_bwd.cu, adamw.cu built and loaded in {time.perf_counter() - t0:.2f} "
        f"s ({build.build_dir()})")
    tc_names = {"minplus": (), "adamw": (), "flash_fwd": ("flash_fwd_tc_kernel",),
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
    cfg, tokens, launches_train, train_figs = train_phase(fa, mp, dev, card)
    train_f32_check(fa, dev, cfg, {"tokens": tokens})
    dq_t, dkv_t = flash_bwd_times(fa, bwd_main, card)
    del bwd_main
    torch.cuda.empty_cache()

    # -- phase 12: the scheduler layers through the Solver facade ------------
    launches_facade = facade_phase(mp, dev, card, solver_batch, X)

    # -- phase 13: the scheduling service and the fleet solve ---------------
    launches_serve = service_phase(mp, card)
    launches_fleet, launches_flat = fleet_phase(mp, card)

    # -- phase 14: the FL runtime --------------------------------------------
    launches_fl_parts, launches_fl = fl_phase(mp, card, dev)

    # -- phase 15: serving the LM zoo -----------------------------------------
    launches_serve_parts = serve_phase(fa, dev, card)

    # -- phase 16: the SSM families --------------------------------------------
    launches_ssm, _, d80 = ssm_phase(fa, dev, card)
    ssm_by_use = {f"{arch}: {use}": n for arch, uses in launches_ssm.items() for use, n in uses.items()}

    # -- phase 17: the encoder and VLM families ------------------------------------
    launches_enc, _, hubert_d80 = encoder_phase(fa, dev, card)
    enc_by_use = {f"{HUBERT_ARCH}: {use}": n for use, n in launches_enc.items()}

    # -- phase 18: multi-device sweeps -------------------------------------------
    md = multi_device_phase(mp, dev, card)

    # -- phase 19: the LM zoo over torch.distributed -------------------------------
    dist_launches, _ = distributed_phase(fa, dev, card)
    dist_train = dist_launches["train"]

    # -- phase 20: the dry run ------------------------------------------------------
    dryrun_phase(card, dev, train_figs["warm_ms"])

    # -- phase 21: remat="dots" and the hill-climb ------------------------------------
    dots_launches = remat_phase(fa, dev, card)

    # -- phase 22: the port's examples --------------------------------------------------
    ex_launches = examples_phase(mp, card)
    adamw_run_launches = aw.launches  # every AdamW step since phase 10 reset the counter

    # -- phase 23: AdamW's leaf kernel ------------------------------------------------------
    aw_t = adamw_phase(aw, dev, card)

    # -- phase 24: the deepseek-v3 cell's attention launch and train step ----------------
    v3 = deepseek_v3_phase(fa, dev, card)

    kernels = [{
        "name": "minplus_cuda",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:76",
        "launches": launches_main["row"],
        "engine_launches": launches_facade["row"],
        "service_launches": launches_serve["row"],
        "fleet_launches": launches_fleet["row"],
        "flat_launches": launches_flat["row"],
        "fl_launches": launches_fl["row"],
        "fl_launches_by_part": {k: v["row"] for k, v in launches_fl_parts.items()},
        "ring_launches": md["ring"]["row"],
        "ring_flat_launches": md["ring_flat"]["row"],
        "mesh_launches": md["mesh"]["row"],
        "examples_launches_by_part": {k: v["row"] for k, v in ex_launches.items()},
        "profiler_sessions_rerun": PROFILER_RERUNS["minplus_row_kernel"],
        "max_abs_err": max_abs_err,
        **st["row"],
    }, {
        "name": "minplus_backtrack",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "none: no TPU kernel (src/repro/core/jax_dp.py:148 _backtrack_batch is a plain jnp lax.scan)",
        "launches": launches_main["backtrack"],
        "engine_launches": launches_facade["backtrack"],
        "service_launches": launches_serve["backtrack"],
        "fleet_launches": launches_fleet["backtrack"],
        "flat_launches": launches_flat["backtrack"],
        "fl_launches": launches_fl["backtrack"],
        "fl_launches_by_part": {k: v["backtrack"] for k, v in launches_fl_parts.items()},
        "ring_launches": md["ring"]["backtrack"],
        "ring_flat_launches": md["ring_flat"]["backtrack"],
        "mesh_launches": md["mesh"]["backtrack"],
        "examples_launches_by_part": {k: v["backtrack"] for k, v in ex_launches.items()},
        "ring_max_abs_err": md["bt_err"],
        "ring_slab": md["bt_ring"],
        "profiler_sessions_rerun": PROFILER_RERUNS["minplus_backtrack_kernel"],
        "max_abs_err": max(bt_err, md["bt_err"]),
        **st["backtrack"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "tc_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:53",
        "launches": launches_prefill,
        "serve_launches_by_part": launches_serve_parts,
        "ssm_launches_by_part": {k: v for k, v in ssm_by_use.items() if "dq" not in k and "dkv" not in k},
        "zamba2_d80": {k: v for k, v in d80.items() if k.startswith("fwd")},
        "encoder_launches_by_part": {**{k: v for k, v in enc_by_use.items() if "dq" not in k and "dkv" not in k},
                                     f"{PALI_ARCH}: all": 0},
        "hubert_d80": {k: v for k, v in hubert_d80.items() if k.startswith("fwd")},
        "distributed_launches": dist_train[0] + dist_launches["moe_prefill"] + sum(
            v[0] for v in dist_launches["zoo"].values()),
        "distributed_launches_by_part": {"gemma2-2b train": dist_train[0], f"{MOE_ARCH} prefill":
                                         dist_launches["moe_prefill"],
                                         **{k: v[0] for k, v in dist_launches["zoo"].items()}},
        "remat_dots_launches": dots_launches[0],
        "v3_cell_launches_per_step": 2 * V3_LAYERS,  # checked in phase 24
        "v3_attention": v3["attention"],
        "max_abs_err": flash_err_max,
        **ft,
    }, {
        "name": "flash_dq",
        "route": "cuda",
        "tc_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": launches_train["flash_dq"],
        "ssm_launches_by_part": {k: v for k, v in ssm_by_use.items() if k.endswith("train dq")},
        "zamba2_d80": d80[f"dq_S{ZAMBA_TRAIN_S}"],
        "encoder_launches_by_part": {k: v for k, v in enc_by_use.items() if k.endswith("train dq")},
        "hubert_d80": hubert_d80[f"dq_S{HUBERT_TRAIN[1]}"],
        "distributed_launches": dist_train[1] + sum(v[1] for v in dist_launches["zoo"].values()),
        "remat_dots_launches": dots_launches[1],
        "v3_cell_launches_per_step": V3_LAYERS,  # checked in phase 24
        "max_abs_err": dq_err,
        **dq_t,
    }, {
        "name": "flash_dkv",
        "route": "cuda",
        "tc_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:127",
        "launches": launches_train["flash_dkv"],
        "ssm_launches_by_part": {k: v for k, v in ssm_by_use.items() if k.endswith("train dkv")},
        "zamba2_d80": d80[f"dkv_S{ZAMBA_TRAIN_S}"],
        "encoder_launches_by_part": {k: v for k, v in enc_by_use.items() if k.endswith("train dkv")},
        "hubert_d80": hubert_d80[f"dkv_S{HUBERT_TRAIN[1]}"],
        "distributed_launches": dist_train[2] + sum(v[2] for v in dist_launches["zoo"].values()),
        "remat_dots_launches": dots_launches[2],
        "v3_cell_launches_per_step": V3_LAYERS,  # checked in phase 24
        "max_abs_err": dkv_err,
        **dkv_t,
    }, {
        "name": "adamw",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none: the reference's AdamW (src/repro/optim/optimizers.py:64) is jnp under jit, fused by XLA",
        "launches": launches_train["adamw"],
        "elements": launches_train["adamw_elements"],  # phase 10's steps; the timed leaves' are leaf_elements
        "launches_phases_10_to_22": adamw_run_launches,
        **aw_t,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
