"""Energy-aware 1-D data partition across heterogeneous accelerator pods, on
the PyTorch/CUDA port. The counterpart of ``examples/heterogeneous_cluster.py``;
it prints the same lines in the same format.

Scenario: a global batch of sequences must be split across pods with
different chip generations and power envelopes. Cost tables = measured
Joules per microbatch count (superlinear once a pod exceeds its efficient
operating point). The scheduler finds the minimum-energy split subject to
per-pod memory caps (upper limits) and keep-warm floors (lower limits).

    PYTHONPATH=src python examples_torch/heterogeneous_cluster.py               # on the card
    PYTHONPATH=src python examples_torch/heterogeneous_cluster.py --device cpu

Without a CUDA card the default ``--device cuda`` raises; nothing falls back
to the CPU. ``main`` returns the solver and what it solved.
"""

import argparse

import numpy as np

from repro_torch.core import Problem, Solver


def pod_cost_table(u, joules_per_mb, dvfs_knee, p=1.8):
    """Energy for j microbatches: linear until the DVFS knee, superlinear after."""
    j = np.arange(u + 1, dtype=np.float64)
    base = joules_per_mb * j
    over = np.maximum(j - dvfs_knee, 0.0)
    return base + joules_per_mb * 0.25 * over ** p


def main(argv=None):
    ap = argparse.ArgumentParser(description="energy-aware split of a global batch across accelerator pods")
    ap.add_argument("--device", default="cuda", help="where the engine solves (cuda or cpu)")
    args = ap.parse_args(argv)
    solver = Solver(device=args.device)  # the facade; raises here, before any output, without the card

    # Four pods: v5e-256 (efficient), v5e-128, old v4-128 (power hungry),
    # and a preemptible v5e-64 kept warm with a floor of 2 microbatches.
    pods = ["v5e-256", "v5e-128", "v4-128", "v5e-64-preempt"]
    upper = [64, 32, 32, 16]  # memory caps (max microbatches)
    lower = [0, 0, 0, 2]
    tables = (
        pod_cost_table(64, 12.0, 40),
        pod_cost_table(32, 13.0, 20),
        pod_cost_table(32, 21.0, 12),  # old gen: pricier per microbatch
        pod_cost_table(16, 13.5, 10),
    )
    T = 96  # global batch in microbatches

    problem = Problem(T=T, lower=lower, upper=upper, cost_tables=tables)
    problem.validate()
    print(f"global batch: {T} microbatches over {pods}")
    print(f"cost regime: {problem.regime()}\n")

    solutions = {}
    for alg in ("auto", "uniform", "proportional", "olar"):
        sol = solutions[alg] = solver.solve(problem, algorithm=alg)
        per_pod = ", ".join(f"{p}={int(v)}" for p, v in zip(pods, sol.schedule))
        print(f"{alg:>14}: {per_pod}  ->  {sol.objective:8.1f} J/step")

    x_opt = solver.solve(problem)
    x_uni = solver.solve(problem, algorithm="uniform")
    save = 100 * (1 - x_opt.objective / x_uni.objective)
    print(f"\nper-step energy saved vs uniform: {save:.1f}% "
          f"(~{save:.1f}% of the training-campaign compute bill)")
    return {"solver": solver, "solutions": solutions}


if __name__ == "__main__":
    main()
