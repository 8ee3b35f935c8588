"""End-to-end driver on the PyTorch/CUDA port: federated training of a
transformer LM with energy-minimal workload scheduling, vs a uniform-split
baseline. The counterpart of ``examples/fl_energy_training.py``; it prints the
same lines in the same format.

Runs a real FedAvg campaign on a synthetic non-IID corpus with a simulated
heterogeneous fleet; clients train on ``--device`` one after another and
rounds are planned on the same device's engine. Model size / rounds are
CLI-scalable.

    PYTHONPATH=src python examples_torch/fl_energy_training.py \
        --rounds 40 --clients 8 --layers 2 --d-model 128

Scaling up (e.g. --layers 8 --d-model 320 --vocab 8192 ~ 10M params,
--rounds 300) reproduces the same curves at larger scale. ``--device cpu``
runs it on the CPU; without a CUDA card the default ``--device cuda``
raises, nothing falls back to the CPU.

The starting weights come from ``torch.Generator`` seed 0 (``init_params``),
not from ``jax.random``, so the losses differ from the JAX example's run;
the schedules and energies do not depend on the weights.

``--frontier-mode knee`` (or ``min_energy`` / ``min_time`` / a seconds
budget) plans every round from the live (energy, completion-time) Pareto
frontier instead of the plain min-energy solve: the server sweeps a
deadline grid in one batched dispatch per round and picks the configured
operating point.

``main`` returns the campaigns' histories (``"auto"``-style keys: the
algorithm's name, and ``"uniform"`` with ``--compare``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import PlanPolicy, Solver
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sweep import default_engine
from repro_torch.data import client_corpora, make_lm_examples
from repro_torch.fl import EnergyEstimator, FederatedServer, make_fleet, run_campaign
from repro_torch.models import init_params, loss_fn, param_count
from repro_torch.optim import sgd


def main(argv=None):
    ap = argparse.ArgumentParser(description="FL training with energy-minimal round schedules")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-batches", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--algorithm", default="auto", help="auto|dp|marin|olar|uniform|proportional")
    ap.add_argument("--compare", action="store_true", help="also run the uniform baseline")
    ap.add_argument(
        "--frontier-mode", default=None,
        help="knee|min_energy|min_time|<seconds> — pick each round's "
        "operating point from the live energy x time Pareto frontier",
    )
    ap.add_argument("--device", default="cuda", help="where clients train and rounds are planned (cuda or cpu)")
    args = ap.parse_args(argv)
    frontier_mode = args.frontier_mode
    if frontier_mode is not None:
        try:
            frontier_mode = float(frontier_mode)  # a round-time budget
        except ValueError:
            pass
    engine = default_engine(device=args.device)
    device = engine.device

    cfg = ModelConfig(
        arch="fl-lm", family="dense",
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 64, 2), num_kv_heads=max(args.d_model // 64, 2),
        d_ff=args.d_model * 4, vocab_size=args.vocab,
    )
    params0 = init_params(cfg, 0, device=device)
    print(f"model: {cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"-> {param_count(params0)/1e6:.2f}M params")
    del params0

    def lm_loss(params, batch):
        return loss_fn(params, cfg, {"tokens": batch})

    def campaign(algorithm, seed=0):
        rng = np.random.default_rng(seed)
        fleet = make_fleet(rng, args.clients, max_batches=args.max_batches)
        est = EnergyEstimator(fleet)
        est.calibrate(rng)
        corpora = client_corpora(rng, args.clients, args.seq * 200, args.vocab)
        examples = [make_lm_examples(c, args.seq) for c in corpora]
        # per-client time tables (seconds for j batches), for frontier mode:
        # seconds-per-batch drawn once per fleet, deterministic in the seed
        seconds_per_batch = np.random.default_rng(seed + 1).uniform(
            0.5, 2.5, size=args.clients
        )
        time_tables = [
            np.arange(d.max_batches + 1, dtype=np.float64) * spb
            for d, spb in zip(fleet, seconds_per_batch)
        ]
        server = FederatedServer(
            loss_fn=lm_loss,
            init_params=init_params(cfg, seed, device=device),
            client_optimizer=sgd(args.lr),
            estimator=est,
            policy=PlanPolicy(
                algorithm=algorithm,
                frontier_mode=frontier_mode if algorithm != "uniform" else None,
                time_tables=time_tables,
                engine=engine,
            ),
        )
        T = sum(d.max_batches for d in fleet) // 2

        if frontier_mode is not None and algorithm != "uniform":
            # one facade call shows the trade-off space the planner works in
            front = Solver(engine=server.engine).frontier(
                est.problem(T), time_tables
            )
            lo, hi = front.min_time(), front.min_energy()
            print(
                f"  round-0 frontier: {len(front)} points, "
                f"{lo.time:.1f}s/{lo.energy:.0f}J (fastest) .. "
                f"{hi.time:.1f}s/{hi.energy:.0f}J (cheapest); mode={frontier_mode!r}"
            )
        t0 = time.time()

        def on_round(r):
            if r.round_index % max(args.rounds // 10, 1) == 0:
                print(
                    f"  [{algorithm}] round {r.round_index:3d} loss {r.mean_loss:.4f} "
                    f"energy {r.energy_joules:8.1f} J  x={[int(v) for v in r.assignments]}"
                )

        hist = run_campaign(
            server, examples, args.rounds, round_T=T, batch_size=args.batch,
            rng=rng, on_round=on_round,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the last round's aggregate is in the wall time too
        print(f"  [{algorithm}] wall {time.time() - t0:.1f}s  {hist.summary()}")
        return hist

    print(f"\n=== campaign: {args.algorithm} scheduler ===")
    h_opt = campaign(args.algorithm)
    histories = {args.algorithm: h_opt}
    if args.compare:
        print("\n=== campaign: uniform baseline ===")
        h_uni = histories["uniform"] = campaign("uniform")
        save = 100 * (1 - h_opt.total_energy / h_uni.total_energy)
        print(
            f"\nenergy: {h_opt.total_energy:.0f} J vs uniform {h_uni.total_energy:.0f} J "
            f"({save:.1f}% saved); final loss {h_opt.rounds[-1].mean_loss:.4f} "
            f"vs {h_uni.rounds[-1].mean_loss:.4f}"
        )
    return histories


if __name__ == "__main__":
    main()
