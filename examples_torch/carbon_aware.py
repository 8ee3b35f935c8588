"""Carbon-aware FL scheduling on the PyTorch/CUDA port (paper §6: the
algorithms minimize ANY cost — weight each device's energy by the carbon
intensity of its grid region). The counterpart of ``examples/carbon_aware.py``;
it prints the same lines in the same format.

Cost tables become gCO2e(j) = carbon_intensity[g/kWh] * E_i(j)[J] / 3.6e6
(:func:`repro_torch.core.costs.carbon_cost_table`). The same optimal
algorithms then minimize emissions instead of Joules; the example shows the
schedule shifting work toward low-carbon regions even when their devices are
less energy-efficient.

Grid carbon intensity is time-varying, so the second half of the example
sweeps a day of intensity windows
(:class:`repro_torch.core.costs.CostWindows`) and prints the exact
(completion-time, emissions) Pareto frontier per window — every window and
every frontier point solved by ONE batched engine dispatch through
``Solver.frontier``.

    PYTHONPATH=src python examples_torch/carbon_aware.py               # on the card
    PYTHONPATH=src python examples_torch/carbon_aware.py --device cpu

Without a CUDA card the default ``--device cuda`` raises; nothing falls back
to the CPU. ``main`` returns the solver and what it solved.
"""

import argparse

import numpy as np

from repro_torch.core import CostWindows, Problem, Solver, total_cost
from repro_torch.core.costs import carbon_cost_table, linear_cost

# (region, carbon g/kWh, device J/batch, max batches)
FLEET = [
    ("IS-hydro", 28, 3.0, 24),   # efficient grid, mediocre device
    ("FR-nuclear", 79, 2.2, 24),
    ("US-CA", 216, 1.8, 24),
    ("DE", 381, 1.6, 24),        # efficient device, dirty-ish grid
    ("PL-coal", 657, 1.5, 24),   # most efficient device, dirtiest grid
]

# seconds per batch (the slow devices sit on the clean grids)
SECONDS_PER_BATCH = [2.4, 1.8, 1.3, 1.1, 1.0]

# diurnal intensity multipliers per region: solar-heavy grids (US-CA) dip at
# midday, coal-heavy grids peak in the evening, baseload barely moves
WINDOW_MULT = {
    "night": [1.00, 0.95, 1.10, 1.05, 1.00],
    "midday": [1.00, 1.00, 0.55, 0.80, 1.05],
    "evening": [1.00, 1.10, 1.20, 1.25, 1.15],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="carbon-aware schedules and per-window Pareto frontiers")
    ap.add_argument("--device", default="cuda", help="where the engine solves (cuda or cpu)")
    args = ap.parse_args(argv)

    T = 60
    n = len(FLEET)
    upper = [u for *_, u in FLEET]
    energy_tables = tuple(linear_cost(u, jpb) for _, _, jpb, u in FLEET)
    carbon_tables = tuple(
        carbon_cost_table(linear_cost(u, jpb), ci)  # -> mgCO2e
        for _, ci, jpb, u in FLEET
    )
    e_prob = Problem(T=T, lower=[0] * n, upper=upper, cost_tables=energy_tables)
    c_prob = Problem(T=T, lower=[0] * n, upper=upper, cost_tables=carbon_tables)

    # both objectives solved in ONE batched DP call through the facade
    solver = Solver(device=args.device)
    sols = solver.solve([e_prob, c_prob], algorithm="dp_batch")
    x_energy, x_carbon = sols.schedules

    print(f"{'region':>12} | {'J/batch':>7} | {'g/kWh':>6} | {'x (min J)':>9} | {'x (min CO2)':>11}")
    print("-" * 60)
    for (region, ci, jpb, u), xe, xc in zip(FLEET, x_energy, x_carbon):
        print(f"{region:>12} | {jpb:7.1f} | {ci:6d} | {int(xe):9d} | {int(xc):11d}")

    print(
        f"\nmin-energy schedule: {total_cost(e_prob, x_energy):.1f} J, "
        f"{total_cost(c_prob, x_energy):.2f} mgCO2e"
    )
    print(
        f"min-carbon schedule: {total_cost(e_prob, x_carbon):.1f} J, "
        f"{total_cost(c_prob, x_carbon):.2f} mgCO2e"
    )
    drop = 100 * (1 - total_cost(c_prob, x_carbon) / total_cost(c_prob, x_energy))
    print(f"emissions reduced {drop:.1f}% by optimizing the right objective")

    # ---- time-varying intensity: per-window (time, emissions) frontiers ----
    time_tables = [
        np.arange(u + 1, dtype=np.float64) * spb
        for (*_, u), spb in zip(FLEET, SECONDS_PER_BATCH)
    ]
    labels = tuple(WINDOW_MULT)
    intensities = np.array(
        [[ci * m for (_, ci, *_), m in zip(FLEET, WINDOW_MULT[w])] for w in labels]
    )
    windows = CostWindows.from_carbon_intensities(labels, intensities)

    # all windows x all candidate deadlines: ONE engine dispatch
    fronts = solver.frontier(e_prob, time_tables, windows=windows)

    print("\n(time, emissions) Pareto frontier per intensity window")
    print(f"{'window':>8} | pts | {'fastest (s -> mg)':>20} | {'knee (s -> mg)':>18} | {'cleanest (s -> mg)':>20}")
    print("-" * 84)
    for w in labels:
        f = fronts[w]
        lo, kn, hi = f.min_time(), f.knee(), f.min_energy()
        print(
            f"{w:>8} | {len(f):3d} | {lo.time:7.1f} -> {lo.energy:8.2f} | "
            f"{kn.time:6.1f} -> {kn.energy:6.2f} | {hi.time:7.1f} -> {hi.energy:8.2f}"
        )

    best = min(labels, key=lambda w: fronts[w].min_energy().energy)
    kn = fronts[best].knee()
    print(
        f"\ncleanest window: {best!r} — knee point runs the round in "
        f"{kn.time:.1f}s at {kn.energy:.2f} mgCO2e "
        f"(deadline {kn.deadline:.1f}s, schedule {[int(v) for v in kn.schedule]})"
    )
    return {"solver": solver, "schedules": sols.schedules, "frontiers": fronts}


if __name__ == "__main__":
    main()
