"""Quickstart on the PyTorch/CUDA port: schedule one FL round's workload for
minimal energy. The counterpart of ``examples/quickstart.py``; it prints the
same lines in the same format.

    PYTHONPATH=src python examples_torch/quickstart.py               # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Without a CUDA card the default ``--device cuda`` raises; nothing falls back
to the CPU. ``main`` returns the solver and what it solved.
"""

import argparse

import numpy as np

from repro_torch import Solver
from repro_torch.core import device_fleet_problem, random_problem


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the engine solves (cuda or cpu)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    # A heterogeneous fleet: 2 low-end phones, a tablet, a laptop, two edge
    # accelerators. Each gets an energy cost table C_i(j) (Joules for j
    # mini-batches) from its device class.
    classes = ["phone_lo", "phone_lo", "tablet", "laptop", "edge_tpu", "jetson"]
    T = 48  # mini-batches to distribute this round
    problem = device_fleet_problem(
        T=T,
        classes=classes,
        upper=[12, 12, 16, 24, 32, 32],
        lower=[1, 1, 0, 0, 0, 0],  # keep both phones participating
    )
    problem.validate()

    # the Solver facade: one front door for every solve
    solver = Solver(device=args.device)
    opt = solver.solve(problem)
    print(f"fleet: {classes}")
    print(f"round workload T={T}, regime detected: {opt.regime!r}")
    print(f"auto-selected algorithm: {opt.algorithm}\n")

    print(f"{'algorithm':>16} | {'schedule x_i':>28} | energy (J)")
    print("-" * 72)
    solutions = {}
    for alg in ("auto", "dp", "marin", "olar", "uniform", "proportional"):
        try:
            sol = solver.solve(problem, algorithm=alg)
        except ValueError as e:  # the facade's refusal of an instance the algorithm does not admit
            print(f"{alg:>16} | inapplicable: {e}")
            continue
        solutions[alg] = sol
        print(f"{alg:>16} | {str([int(v) for v in sol.schedule]):>28} | {sol.objective:8.1f}")

    x_uni = solver.solve(problem, algorithm="uniform")
    save = 100 * (1 - opt.objective / x_uni.objective)
    print(f"\nenergy saved vs uniform split: {save:.1f}%")

    # fleet scale: at hundreds+ of clients, solve_fleet clusters similar cost
    # profiles, solves each cluster once, and splits the round's workload
    # across clusters with a small exact knapsack — returning a per-client
    # schedule plus a certified optimality-gap bound
    big = random_problem(rng, n=256, T=512, max_upper=16)
    fsol = solver.solve_fleet(big)
    print(
        f"\nfleet scale: n=256 clients -> {fsol.num_clusters} clusters "
        f"(quantum {fsol.quantum}), energy {fsol.objective:.1f} J, "
        f"certified gap <= {fsol.gap_bound * 100:.2f}%"
    )
    return {"solver": solver, "solutions": solutions, "fleet": fsol}


if __name__ == "__main__":
    main()
