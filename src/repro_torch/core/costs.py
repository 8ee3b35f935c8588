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

A numpy copy of the generators of ``repro.core.costs``: from the same
``np.random.Generator`` state they draw the same instances, so the port's
own scripts build real-size instances without the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .problem import Problem

__all__ = [
    "linear_cost",
    "superlinear_cost",
    "sublinear_cost",
    "measured_cost",
    "random_problem",
    "device_fleet_problem",
    "DEVICE_CLASSES",
]

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
