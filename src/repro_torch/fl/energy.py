"""Device energy modeling, measurement simulation, and online estimation.

The scheduler needs per-device cost tables ``C_i(j)`` = Joules to train with
``j`` mini-batches. On a real deployment these come from profilers (paper
refs: I-Prof [35], Flower [36], PMC models [34]). Here:

  * :class:`DeviceProfile` — ground-truth energy behaviour of a simulated
    device (hidden from the scheduler), with measurement noise and an
    externally-driven ``drift_scale`` (thermal throttling, battery state —
    set per round by the FL runtime's drift injector).
  * :class:`EnergyEstimator` — what the server knows: per-device tabulated
    estimates refreshed each round from noisy measurements via a
    huber-weighted, clipped EMA (DESIGN.md §18). Beyond the raw tables the
    estimator is a full online calibrator: it tracks per-(client, workload)
    innovation statistics with uncertainty bands, a per-client multiplicative
    trend used to PREDICT future tables (speculative lookahead), and a
    reliability score fed by observed crash/straggle history that can
    down-weight a chronically flaky client's effective capacity in the
    planning :class:`~repro_torch.core.problem.Problem` — never in the true
    simulator tables.
  * :func:`flops_scaled_tables` — adapts a reference cost table to a model's
    per-batch FLOPs (bigger model => proportionally more Joules per batch).

A numpy copy of ``repro.fl.energy``: the port imports nothing of that
package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np

from ..core.costs import DEVICE_CLASSES, _table_for_class
from ..core.problem import Problem

__all__ = ["DeviceProfile", "EnergyEstimator", "make_fleet", "flops_scaled_tables"]

_TABLE_KEY = re.compile(r"^\d{4,}$")


@dataclasses.dataclass
class DeviceProfile:
    """Ground truth for one simulated device."""

    name: str
    device_class: str
    max_batches: int  # upper limit U_i (local data / contract)
    min_batches: int = 0  # lower limit L_i (participation floor)
    noise: float = 0.03  # relative measurement noise
    flops_scale: float = 1.0
    # multiplicative drift on the TRUE energy (thermal throttling, battery
    # sag, contention). Overwritten per round by a DriftInjector; 1.0 = the
    # stationary world every pre-drift campaign ran in.
    drift_scale: float = 1.0

    def true_table(self) -> np.ndarray:
        tbl = _table_for_class(self.device_class, self.max_batches, self.flops_scale)
        if self.drift_scale != 1.0:
            tbl = tbl * self.drift_scale
        return tbl

    def measure(self, j: int, rng: np.random.Generator) -> float:
        """Simulates an energy measurement for training with j batches."""
        true = float(self.true_table()[j])
        return true * float(1.0 + self.noise * rng.standard_normal())


def make_fleet(
    rng: np.random.Generator,
    n_devices: int,
    classes: Optional[Sequence[str]] = None,
    max_batches: int = 64,
    min_batches: int = 0,
) -> list:
    classes = list(classes or DEVICE_CLASSES)
    out = []
    for i in range(n_devices):
        cls = classes[int(rng.integers(0, len(classes)))]
        ub = int(rng.integers(max(min_batches + 1, max_batches // 2), max_batches + 1))
        out.append(
            DeviceProfile(
                name=f"dev{i:03d}_{cls}",
                device_class=cls,
                max_batches=ub,
                min_batches=min_batches,
            )
        )
    return out


def flops_scaled_tables(table: np.ndarray, model_flops_per_batch: float, ref_flops_per_batch: float) -> np.ndarray:
    return table * (model_flops_per_batch / ref_flops_per_batch)


class EnergyEstimator:
    """Server-side estimate of every device's cost table, plus the online
    calibration state the adaptive layer (DESIGN.md §18) plans from.

    Starts from a coarse monotone prior (:meth:`calibrate`), then blends
    full-table measurements as rounds progress. The estimate is what the
    scheduler consumes; the *true* table is what the simulator charges — the
    gap is reported by ``fl/rounds.py``.

    Robustness (vs the earlier plain EMA): each observation's relative
    innovation ``z = (measured - C_i(j)) / C_i(j)`` is huber-weighted
    (full EMA step inside ``|z| <= huber_delta``, attenuated outside), the
    whole-table rescale factor is clipped to ``[1/clip, clip]``, and
    non-finite or non-positive measurements are dropped outright — one
    adversarial spike can no longer corrupt every entry of a table.

    Calibration state (all pure functions of the observation sequence, so
    serial and pipelined campaigns agree bit-for-bit):

      * per-client EWMA innovation mean/variance (uncertainty bands), plus
        per-(client, workload) point statistics;
      * a per-client multiplicative ``trend`` — the EWMA of observed rescale
        factors — used by :meth:`predict_problem` to extrapolate tables
        ``s`` rounds ahead for speculative lookahead;
      * a reliability score in [0, 1] fed by :meth:`record_round_outcome`
        (crash/straggle history), consumed by :meth:`reliability_weights`
        to down-weight a flaky client's effective ``upper`` in the planning
        problem only.
    """

    def __init__(
        self,
        fleet: Sequence[DeviceProfile],
        ema: float = 0.5,
        huber_delta: float = 0.25,
        clip: float = 2.0,
        stats_decay: float = 0.3,
    ):
        self.fleet = list(fleet)
        self.ema = ema
        self.huber_delta = float(huber_delta)
        self.clip = float(clip)
        self.stats_decay = float(stats_decay)
        self._tables = [None] * len(self.fleet)
        self._reset_calibration_state()

    def _reset_calibration_state(self) -> None:
        n = len(self.fleet)
        self._innov_mean = np.zeros(n, dtype=np.float64)
        self._innov_var = np.zeros(n, dtype=np.float64)
        self._trend = np.ones(n, dtype=np.float64)
        self._reliability = np.ones(n, dtype=np.float64)
        self._obs_count = np.zeros(n, dtype=np.int64)
        self._fault_count = np.zeros(n, dtype=np.int64)
        self._dropped = 0
        self._point_stats: dict = {}  # (client, j) -> [ewma_z, ewma_z2, count]
        self._round_innovations: list = []  # (client, j, z) since last drain

    def calibrate(self, rng: np.random.Generator, probe_points: int = 4) -> None:
        """Initial profiling pass: probe a few j values per device and fit a
        monotone (isotonic-ish, via cumulative positive increments) table."""
        for i, dev in enumerate(self.fleet):
            u = dev.max_batches
            js = np.unique(np.linspace(1, u, min(probe_points, u)).astype(int))
            meas = np.array([dev.measure(int(j), rng) for j in js])
            full = np.interp(np.arange(u + 1), np.concatenate([[0], js]), np.concatenate([[0.0], meas]))
            inc = np.maximum(np.diff(full), 0.0)  # enforce monotone energy
            self._tables[i] = np.concatenate([[0.0], np.cumsum(inc)])

    def observe(self, i: int, j: int, measured_joules: float) -> None:
        """Robust EMA update of device i's table around the observed point:
        rescales the whole table so that ``C_i(j)`` matches the blended
        observation. In-band observations (``|z| <= huber_delta``) take the
        exact plain-EMA step; outliers are huber-attenuated, the rescale
        factor is clipped, and non-finite measurements are dropped."""
        tbl = self._tables[i]
        if tbl is None or j <= 0 or j >= len(tbl) or tbl[j] <= 0:
            return
        m = float(measured_joules)
        if not np.isfinite(m) or m <= 0.0:
            self._dropped += 1
            return
        z = (m - float(tbl[j])) / float(tbl[j])
        az = abs(z)
        if az <= self.huber_delta:
            # bit-identical to the legacy plain-EMA blend for in-band points
            blended = (1 - self.ema) * tbl[j] + self.ema * m
        else:
            blended = tbl[j] + self.ema * (self.huber_delta / az) * (m - tbl[j])
        factor = float(blended / tbl[j])
        factor = min(max(factor, 1.0 / self.clip), self.clip)
        self._tables[i] = tbl * factor
        d = self.stats_decay
        self._innov_mean[i] = (1 - d) * self._innov_mean[i] + d * z
        self._innov_var[i] = (1 - d) * self._innov_var[i] + d * z * z
        # trend: EWMA of rescale factors. Under steady multiplicative drift
        # the estimate must grow at the drift rate to keep tracking, so the
        # factor EWMA converges to that rate — the s-step predictor.
        self._trend[i] = min(max((1 - d) * self._trend[i] + d * factor, 0.5), 2.0)
        self._obs_count[i] += 1
        key = (int(i), int(j))
        pm, pv, pc = self._point_stats.get(key, (0.0, 0.0, 0))
        self._point_stats[key] = [(1 - d) * pm + d * z, (1 - d) * pv + d * z * z, pc + 1]
        self._round_innovations.append((int(i), int(j), float(z)))

    # ---- calibration telemetry ----------------------------------------

    def drain_innovations(self) -> list:
        """Returns (and clears) the ``(client, j, z)`` innovations recorded
        since the last drain — the drift detector's per-round signal. Called
        on the main thread in round order, so the detector's state is a pure
        function of the observation sequence."""
        out, self._round_innovations = self._round_innovations, []
        return out

    def uncertainty(self, i: int) -> tuple:
        """Per-client innovation band: (EWMA mean, EWMA std) of the relative
        innovation ``z``. A well-calibrated client sits near (0, noise)."""
        var = max(float(self._innov_var[i]) - float(self._innov_mean[i]) ** 2, 0.0)
        return float(self._innov_mean[i]), float(np.sqrt(var))

    def point_uncertainty(self, i: int, j: int) -> tuple:
        """(EWMA mean, EWMA std, count) of the innovation at one (client,
        workload) point — the finest-grained calibration band tracked."""
        pm, pv, pc = self._point_stats.get((int(i), int(j)), (0.0, 0.0, 0))
        return float(pm), float(np.sqrt(max(pv - pm * pm, 0.0))), int(pc)

    def record_round_outcome(self, participated, faulty=(), decay: float = 0.25) -> None:
        """Feeds one round of crash/straggle telemetry into the per-client
        reliability scores: participants that completed pull toward 1,
        faulty ones toward 0 (EWMA with ``decay``)."""
        faulty = set(int(c) for c in faulty)
        for i in set(int(c) for c in participated) | faulty:
            ok = 0.0 if i in faulty else 1.0
            self._reliability[i] = (1 - decay) * self._reliability[i] + decay * ok
            if i in faulty:
                self._fault_count[i] += 1

    def reliability_scores(self) -> np.ndarray:
        return self._reliability.copy()

    def reliability_weights(self, threshold: float = 0.9, floor: float = 0.25) -> np.ndarray:
        """Effective-capacity multipliers: clients at or above ``threshold``
        reliability keep full capacity; flakier ones are down-weighted
        proportionally, never below ``floor`` (a flaky client still gets a
        chance to redeem itself — and to be observed)."""
        r = self._reliability
        return np.where(r >= threshold, 1.0, np.maximum(r / threshold, floor))

    # ---- planning snapshots -------------------------------------------

    def _bounds(self, reliability=None):
        lowers = np.array([d.min_batches for d in self.fleet])
        uppers = np.array([d.max_batches for d in self.fleet])
        if reliability is not None:
            w = np.clip(np.asarray(reliability, dtype=np.float64), 0.0, 1.0)
            uppers = np.maximum(lowers, np.floor(uppers * w).astype(np.int64))
        return lowers, uppers

    def problem(self, T: int, reliability=None) -> Problem:
        """The planning instance under the CURRENT estimates. With
        ``reliability`` (per-client multipliers in (0, 1], e.g. from
        :meth:`reliability_weights`), flaky clients' effective ``upper`` is
        down-weighted — in this planning snapshot ONLY; the true simulator
        tables are untouched — and ``T`` is clipped to the reduced capacity."""
        lowers, uppers = self._bounds(reliability)
        if reliability is not None:
            T = int(np.clip(int(T), int(lowers.sum()), int(uppers.sum())))
            tables = tuple(
                np.asarray(t, dtype=np.float64)[: int(u) + 1]
                for t, u in zip(self._tables, uppers)
            )
        else:
            tables = tuple(np.asarray(t, dtype=np.float64) for t in self._tables)
        return Problem(T=T, lower=lowers, upper=uppers, cost_tables=tables)

    def predict_problem(self, T: int, steps: int, reliability=None) -> Problem:
        """The PREDICTED instance ``steps`` rounds ahead: each client's table
        scaled by ``trend_i ** steps`` (steps=0 is exactly :meth:`problem`).
        Pure function of the calibration snapshot — the speculative lookahead
        batch is built from these."""
        if steps <= 0:
            return self.problem(T, reliability=reliability)
        base = self.problem(T, reliability=reliability)
        growth = self._trend ** int(steps)
        tables = tuple(tbl * g for tbl, g in zip(base.cost_tables, growth))
        return Problem(T=base.T, lower=base.lower, upper=base.upper, cost_tables=tables)

    def true_problem(self, T: int) -> Problem:
        lowers = np.array([d.min_batches for d in self.fleet])
        uppers = np.array([d.max_batches for d in self.fleet])
        tables = tuple(d.true_table() for d in self.fleet)
        return Problem(T=T, lower=lowers, upper=uppers, cost_tables=tables)

    # ---- persistence (public API; DESIGN.md §18) ----------------------

    def state_dict(self) -> dict:
        """The estimator's complete persistent state as flat ``{key: array}``
        — table keys are ``f"{i:04d}"`` (bit-compatible with the plain-EMA
        checkpoint npz layout), calibration state rides ``calib_*`` keys."""
        out = {
            f"{i:04d}": np.asarray(t)
            for i, t in enumerate(self._tables)
            if t is not None
        }
        out["calib_innov_mean"] = self._innov_mean.copy()
        out["calib_innov_var"] = self._innov_var.copy()
        out["calib_trend"] = self._trend.copy()
        out["calib_reliability"] = self._reliability.copy()
        out["calib_obs_count"] = self._obs_count.copy()
        out["calib_fault_count"] = self._fault_count.copy()
        out["calib_dropped"] = np.int64(self._dropped)
        if self._point_stats:
            keys = sorted(self._point_stats)
            out["calib_point_keys"] = np.array(keys, dtype=np.int64)
            out["calib_point_vals"] = np.array(
                [self._point_stats[k] for k in keys], dtype=np.float64
            )
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restores :meth:`state_dict` output IN PLACE. Tolerates plain-EMA
        checkpoints that carry only the numeric table keys: calibration
        state then resets to its fresh defaults."""
        self._reset_calibration_state()
        for key, arr in state.items():
            if _TABLE_KEY.match(key):
                i = int(key)
                if i < len(self._tables):
                    self._tables[i] = np.asarray(arr, dtype=np.float64)
        for name, attr in (
            ("calib_innov_mean", "_innov_mean"),
            ("calib_innov_var", "_innov_var"),
            ("calib_trend", "_trend"),
            ("calib_reliability", "_reliability"),
        ):
            if name in state:
                setattr(self, attr, np.asarray(state[name], dtype=np.float64).copy())
        for name, attr in (
            ("calib_obs_count", "_obs_count"),
            ("calib_fault_count", "_fault_count"),
        ):
            if name in state:
                setattr(self, attr, np.asarray(state[name], dtype=np.int64).copy())
        if "calib_dropped" in state:
            self._dropped = int(state["calib_dropped"])
        if "calib_point_keys" in state:
            keys = np.asarray(state["calib_point_keys"], dtype=np.int64)
            vals = np.asarray(state["calib_point_vals"], dtype=np.float64)
            self._point_stats = {
                (int(k[0]), int(k[1])): [float(v[0]), float(v[1]), int(v[2])]
                for k, v in zip(keys, vals)
            }
