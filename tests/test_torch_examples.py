"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``) on the CPU.

Each reference example's ``main`` runs once per module, in process, its
standard output captured; the port's ``main([..., "--device", "cpu"])``
must print the same lines:

* the three scheduler examples, every line exactly. The quickstart's fleet
  line depends on k-means' initial centres, which the port draws with numpy
  and the reference with ``jax.random.choice``: the port runs under JAX's
  centres (``_initial_centres`` patched, as ``test_torch_fleet.py`` does).
* the FL example, at ``test_examples_and_launchers.py``'s size with
  ``--compare`` and a two-round ``--frontier-mode knee`` campaign, with the
  port's ``init_params`` patched to the reference's weights (``PRNGKey(seed)``,
  through ``params_from_jax``). Every line is equal once the losses and the
  wall time are masked; the schedules, energies and plan-cache counts of
  each round are identical, and each round's loss is within ``LOSS_RTOL``
  of the reference's (float32 SGD on the same weights and batches in two
  libraries; the largest relative distance measured on these campaigns is
  2.3e-7).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import init_params as j_init_params
from repro_torch.core import fleet as tfleet
from repro_torch.models import config_from_jax, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SCHEDULER_EXAMPLES = ("quickstart", "heterogeneous_cluster", "carbon_aware")
# tests/test_examples_and_launchers.py's FL arguments, and a frontier-mode campaign
FL_COMPARE = ["--rounds", "3", "--clients", "3", "--layers", "1", "--d-model", "64", "--compare"]
FL_KNEE = ["--rounds", "2", "--clients", "3", "--layers", "1", "--d-model", "64", "--frontier-mode", "knee"]
FL_RUNS = {"compare": FL_COMPARE, "knee": FL_KNEE}
LOSS_RTOL = 1e-5
# what the weights or the clock decide in the FL example's output
WEIGHT_BOUND = (r"loss \d+\.\d+", r"'final_loss': [-\d.e]+", r"final loss \d+\.\d+ vs \d+\.\d+", r"wall [\d.]+s",
                r"'planner_overlap_fraction': [-\d.e]+")


def _load(directory: str, name: str):
    spec = importlib.util.spec_from_file_location(f"_{directory}_{name}", ROOT / directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _captured(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


def _jax_centres(n: int, k: int, seed: int) -> np.ndarray:
    return np.asarray(jax.random.choice(jax.random.PRNGKey(int(seed)), n, shape=(k,), replace=False))


def _masked(text: str) -> list:
    for pattern in WEIGHT_BOUND:
        text = re.sub(pattern, "<masked>", text)
    return text.splitlines()


@pytest.fixture(scope="module")
def reference_scheduler_outputs():
    return {name: _captured(_load("examples", name).main)[0] for name in SCHEDULER_EXAMPLES}


@pytest.mark.parametrize("name", SCHEDULER_EXAMPLES)
def test_scheduler_example_prints_the_reference_lines(name, reference_scheduler_outputs, monkeypatch):
    monkeypatch.setattr(tfleet, "_initial_centres", _jax_centres)
    got, result = _captured(_load("examples_torch", name).main, CPU)
    assert got.splitlines() == reference_scheduler_outputs[name].splitlines()
    assert result["solver"].engine.device.type == "cpu"


def _reference_fl(argv):
    """The reference FL example's output and the histories its campaigns
    returned (its ``main`` reads ``sys.argv`` and returns nothing)."""
    module = _load("examples", "fl_energy_training")
    histories = []
    run_campaign = module.run_campaign

    def recorded(*args, **kw):
        histories.append(run_campaign(*args, **kw))
        return histories[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["fl_energy_training.py", *argv])
        mp.setattr(module, "run_campaign", recorded)
        out, _ = _captured(module.main)
    return out, histories


def _reference_weights(cfg, seed, device="cuda"):
    """The reference's ``init_params(cfg, PRNGKey(seed))`` as the port's
    parameters on ``device``."""
    jcfg = JModelConfig(arch=cfg.arch, family=cfg.family, num_layers=cfg.num_layers, d_model=cfg.d_model,
                        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, d_ff=cfg.d_ff,
                        vocab_size=cfg.vocab_size)
    assert config_from_jax(jcfg) == cfg
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(int(seed))))
    return params_from_jax(cfg, tree, device=device)


@pytest.fixture(scope="module")
def fl_runs():
    """``{run: ((reference output, histories), (port output, histories))}``."""
    runs = {}
    for key, argv in FL_RUNS.items():
        ref = _reference_fl(argv)
        module = _load("examples_torch", "fl_energy_training")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "init_params", _reference_weights)
            out, histories = _captured(module.main, argv + CPU)
        runs[key] = (ref, (out, list(histories.values())))
    return runs


@pytest.mark.parametrize("run", FL_RUNS)
def test_fl_example_prints_the_reference_lines_but_losses_and_wall(run, fl_runs):
    (ref_out, _), (out, _) = fl_runs[run]
    assert _masked(out) == _masked(ref_out)
    if run == "knee":
        assert "round-0 frontier: 9 points" in out


@pytest.mark.parametrize("run", FL_RUNS)
def test_fl_example_schedules_and_energies_are_the_reference_ones(run, fl_runs):
    (_, ref_hists), (_, hists) = fl_runs[run]
    assert len(hists) == len(ref_hists) == (2 if run == "compare" else 1)
    for got, want in zip(hists, ref_hists):
        assert got.algorithm == want.algorithm and len(got.rounds) == len(want.rounds)
        for a, b in zip(got.rounds, want.rounds):
            np.testing.assert_array_equal(a.assignments, b.assignments)
            assert (a.energy_joules, a.estimated_joules, a.makespan_joules) == (
                b.energy_joules, b.estimated_joules, b.makespan_joules)
        assert got.total_energy == want.total_energy
        summary, ref_summary = got.summary(), want.summary()
        for key in ("algorithm", "rounds", "total_energy_J", "mean_makespan_J", "dp_compiles", "dp_cache_hits",
                    "pipeline_mode"):
            assert summary[key] == ref_summary[key], key


@pytest.mark.parametrize("run", FL_RUNS)
def test_fl_example_losses_are_within_tolerance_of_the_reference(run, fl_runs):
    (_, ref_hists), (_, hists) = fl_runs[run]
    for got, want in zip(hists, ref_hists):
        assert np.isfinite(got.losses).all()
        np.testing.assert_allclose(got.losses, np.asarray(want.losses, dtype=np.float64), rtol=LOSS_RTOL, atol=0)


def test_quickstart_runs_as_a_script_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "examples_torch/quickstart.py", *CPU], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2500:]
    assert "energy saved vs uniform split: 68.4%" in proc.stdout
    assert "n=256 clients -> 16 clusters (quantum 1)" in proc.stdout
