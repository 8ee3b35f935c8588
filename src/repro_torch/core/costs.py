"""Energy cost-function families for heterogeneous devices.

The paper treats ``C_i`` as arbitrary tabulated functions; related work often
assumes linear costs. We provide the three marginal-cost regimes of paper
Definition 3 plus arbitrary/measured costs, parameterized to mimic published
device energy behaviour (paper refs [13], [27], [28], [32], [34]):

  - ``superlinear`` (increasing marginals): DVFS-style — sustaining throughput
    for larger workloads pushes clocks/voltage up; E(j) = a*j + b*j^p, p>1.
  - ``linear`` (constant marginals): fixed energy per mini-batch.
  - ``sublinear`` (decreasing marginals): fixed idle/wakeup power amortized
    over more work; E(j) = c*(1 - exp(-j/s)) + a*j with a small.
  - ``measured``: arbitrary tables (e.g. from a profiler like I-Prof/Flower),
    here synthesized with reproducible noise.

All generators return dense tables ``C_i(0..U_i)`` with ``C_i`` monotone
non-decreasing (energy cannot shrink with more work) except the ``measured``
family, which may be arbitrary (the general problem allows it).

A numpy copy of ``repro.core.costs``: from the same ``np.random.Generator``
state the generators draw the same instances, so the port's own scripts
build real-size instances without the JAX package; :class:`CostWindows` and
:func:`carbon_cost_table` reweight tables for time-varying objectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .problem import Problem

__all__ = [
    "CostWindows",
    "JOULES_PER_KWH",
    "carbon_cost_table",
    "linear_cost",
    "superlinear_cost",
    "sublinear_cost",
    "measured_cost",
    "random_problem",
    "device_fleet_problem",
    "DEVICE_CLASSES",
]

JOULES_PER_KWH = 3.6e6


def linear_cost(u: int, per_task: float, base: float = 0.0) -> np.ndarray:
    j = np.arange(u + 1, dtype=np.float64)
    c = base + per_task * j
    c[0] = 0.0 if base == 0.0 else c[0]
    return c


def superlinear_cost(u: int, a: float, b: float, p: float = 1.5) -> np.ndarray:
    j = np.arange(u + 1, dtype=np.float64)
    return a * j + b * np.power(j, p)


def sublinear_cost(u: int, amortized: float, scale: float, a: float = 0.0) -> np.ndarray:
    j = np.arange(u + 1, dtype=np.float64)
    c = amortized * (1.0 - np.exp(-j / scale)) + a * j
    c[0] = 0.0
    return c


def measured_cost(
    u: int, rng: np.random.Generator, lo: float = 0.5, hi: float = 4.0
) -> np.ndarray:
    """Arbitrary (non-monotone-marginal) cost table: cumulative sum of random
    per-task increments, as a stand-in for profiler measurements."""
    inc = rng.uniform(lo, hi, size=u)
    c = np.concatenate([[0.0], np.cumsum(inc)])
    return c


# ---------------------------------------------------------------------------
# Device fleet modeling: classes loosely mirroring the heterogeneity spread
# reported by Lane et al. [32] (1-3 orders of magnitude) and Kim & Wu [13].
# energy_per_batch ~ Joules to train one mini-batch of the reference model.
# ---------------------------------------------------------------------------

DEVICE_CLASSES = {
    # name: (per-batch J, regime, kwargs)
    "phone_lo": dict(per_task=8.0, regime="superlinear", b=0.35, p=1.6),
    "phone_hi": dict(per_task=3.0, regime="superlinear", b=0.10, p=1.5),
    "tablet": dict(per_task=2.2, regime="linear"),
    "laptop": dict(per_task=1.2, regime="linear"),
    "edge_tpu": dict(per_task=0.6, regime="sublinear", amortized=25.0, scale=24.0),
    "jetson": dict(per_task=0.9, regime="sublinear", amortized=18.0, scale=16.0),
    "workstation": dict(per_task=0.35, regime="linear"),
}


def _table_for_class(name: str, u: int, flops_scale: float = 1.0) -> np.ndarray:
    spec = DEVICE_CLASSES[name]
    a = spec["per_task"] * flops_scale
    if spec["regime"] == "linear":
        return linear_cost(u, a)
    if spec["regime"] == "superlinear":
        return superlinear_cost(u, a, spec["b"] * flops_scale, spec["p"])
    if spec["regime"] == "sublinear":
        return sublinear_cost(u, spec["amortized"] * flops_scale, spec["scale"], a * 0.5)
    raise ValueError(spec["regime"])


def device_fleet_problem(
    T: int,
    classes: Sequence[str],
    upper: Optional[Sequence[int]] = None,
    lower: Optional[Sequence[int]] = None,
    flops_scale: float = 1.0,
) -> Problem:
    """Builds a Problem from named device classes.

    ``flops_scale`` scales per-batch energy by the model's per-batch FLOPs
    relative to the reference model (how `fl/energy.py` adapts cost tables per
    architecture).
    """
    n = len(classes)
    if upper is None:
        upper = [T] * n
    if lower is None:
        lower = [0] * n
    tables = tuple(_table_for_class(c, int(u), flops_scale) for c, u in zip(classes, upper))
    return Problem(T=T, lower=np.asarray(lower), upper=np.asarray(upper), cost_tables=tables)


# ---------------------------------------------------------------------------
# Time-varying objectives: the paper's algorithms minimize ANY tabulated cost
# (§6), so carbon-aware or tariff-aware scheduling is just a reweighting of
# the energy tables — and a DAY of grid conditions is a stack of reweighted
# instances the sweep engine solves in one dispatch
# (repro_torch.core.pareto.frontier_by_window).
# ---------------------------------------------------------------------------


def carbon_cost_table(
    energy_table: np.ndarray, carbon_intensity: float, unit: float = 1000.0
) -> np.ndarray:
    """Reweights an energy table (Joules) into emissions:
    ``gCO2e(j) = intensity[g/kWh] * E(j)[J] / 3.6e6``; the default
    ``unit=1000`` returns mgCO2e (readable magnitudes for per-round
    fleets)."""
    e = np.asarray(energy_table, dtype=np.float64)
    return e * (float(carbon_intensity) / JOULES_PER_KWH) * float(unit)


@dataclasses.dataclass(frozen=True)
class CostWindows:
    """Window-indexed per-device cost multipliers: carbon-intensity periods,
    tariff windows, demand-response slots.

    ``multipliers[w, i]`` scales device ``i``'s whole cost table inside
    window ``w`` (labelled ``labels[w]``). Multipliers must be positive:
    positive scaling preserves each instance's marginal-cost regime, so
    windowed instances keep riding the same fast paths as the base problem.
    :meth:`apply` yields one reweighted :class:`Problem` per window —
    identical shape envelope, so a whole day of windows batches into ONE
    engine dispatch.
    """

    labels: tuple
    multipliers: np.ndarray  # (num_windows, n) positive float64

    def __post_init__(self):
        m = np.asarray(self.multipliers, dtype=np.float64)
        object.__setattr__(self, "multipliers", m)
        object.__setattr__(self, "labels", tuple(self.labels))
        if m.ndim != 2 or m.shape[0] != len(self.labels):
            raise ValueError("multipliers must be (num_windows, n) with one row per label")
        if not np.all(m > 0):
            raise ValueError("multipliers must be positive (regime-preserving)")

    @property
    def num_windows(self) -> int:
        return len(self.labels)

    @classmethod
    def from_carbon_intensities(
        cls, labels, intensities, unit: float = 1000.0
    ) -> "CostWindows":
        """Windows from per-window, per-device grid carbon intensities
        (g/kWh), ``(num_windows, n)`` — broadcast a ``(num_windows, 1)``
        column for a single-region fleet. Applying these to energy-Joule
        tables yields emission tables in ``unit``-gCO2e (default mg), the
        same conversion as :func:`carbon_cost_table`."""
        m = np.asarray(intensities, dtype=np.float64) * float(unit) / JOULES_PER_KWH
        return cls(labels=tuple(labels), multipliers=m)

    def apply(self, problem: Problem):
        """One reweighted :class:`Problem` per window (limits and ``T``
        untouched — only the objective changes)."""
        if self.multipliers.shape[1] != problem.n:
            raise ValueError(
                f"multipliers cover {self.multipliers.shape[1]} devices, "
                f"problem has {problem.n}"
            )
        return [
            Problem(
                T=problem.T,
                lower=problem.lower,
                upper=problem.upper,
                cost_tables=tuple(
                    np.asarray(tbl, np.float64) * self.multipliers[w, i]
                    for i, tbl in enumerate(problem.cost_tables)
                ),
            )
            for w in range(self.num_windows)
        ]


def random_problem(
    rng: np.random.Generator,
    n: int,
    T: int,
    regime: str = "arbitrary",
    max_upper: Optional[int] = None,
    with_lower: bool = True,
) -> Problem:
    """Random valid instance of a given marginal-cost regime (for tests)."""
    max_upper = max_upper or T
    # Draw uppers until feasible.
    while True:
        upper = rng.integers(1, max_upper + 1, size=n)
        if upper.sum() >= T:
            break
    if with_lower:
        # lowers small enough to stay feasible
        lower = np.minimum(rng.integers(0, 3, size=n), upper)
        while lower.sum() > T:
            k = int(rng.integers(0, n))
            lower[k] = max(0, lower[k] - 1)
    else:
        lower = np.zeros(n, dtype=np.int64)
    tables = []
    for i in range(n):
        u = int(upper[i])
        if regime == "arbitrary":
            tables.append(measured_cost(u, rng))
        elif regime == "linear":
            tables.append(linear_cost(u, float(rng.uniform(0.2, 5.0))))
        elif regime == "increasing":
            tables.append(
                superlinear_cost(u, float(rng.uniform(0.2, 3.0)), float(rng.uniform(0.01, 0.6)), float(rng.uniform(1.1, 2.2)))
            )
        elif regime == "decreasing":
            tables.append(
                sublinear_cost(u, float(rng.uniform(5.0, 40.0)), float(rng.uniform(2.0, 20.0)), float(rng.uniform(0.0, 0.2)))
            )
        else:
            raise ValueError(regime)
    p = Problem(T=T, lower=lower, upper=upper, cost_tables=tuple(tables))
    p.validate()
    return p
