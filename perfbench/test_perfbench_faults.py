"""A run of each training cell on the CPU at small widths, the look for a
card skipped: with the timed path broken underneath (each fault of
perfbench.faults) it does not come out correct under the cell's own limits,
and a sound run reads far below the broken ones. The limits were set at the
cells' sizes on the card (PERF.md); at these widths fewer elements a leaf
leave a sound run's gaps larger, so it is not held to them here."""

import time

import pytest

from perfbench import compare, faults, registry, weights
from perfbench.modes import train
from perfbench.reference import decoder

CELLS = ("deepseek-7b.train-4k",)
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256)
SMALL_MOE = dict(num_experts=8, top_k=2, d_ff_expert=32)
SHAPE = dict(batch=1, seq_len=128, steps_drawn=6)
SEED = 2 ** 31 + 11


def _small(name):
    plan = registry.plan(name)
    model = dict(plan["config"]["model"], **SMALL)
    if model["family"] == "moe":
        model.update(SMALL_MOE)
    return plan, model, dict(plan["cell"], **SHAPE)


def _run(plan, model, cell, build):
    return train.run({"seed": SEED, "seconds": 0.2, "trace": 0, "cell": cell, "config": plan["config"],
                      "device": "cpu", "t_start": time.monotonic(), "log": lambda msg: None, "model": model,
                      "build_train_step": build})


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    from repro_torch.launch.steps import build_train_step

    out = _run(*_small(name), faults.FAULTS[fault](build_train_step))
    assert out["correct"] is False, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) <= set(compare.NUMBERS)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_reads_far_below_a_broken_one(name):
    from repro_torch.launch.steps import build_train_step

    plan, model, cell = _small(name)
    sound = _run(plan, model, cell, build_train_step)["checks"]
    for fault in faults.FAULTS.values():
        broken = _run(plan, model, cell, fault(build_train_step))["checks"]
        for k in ("grad_norm_gap", "change_norm_gap"):
            assert sound[k]["value"] < broken[k]["value"] / 10, (k, sound, broken)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    plan, model, cell = _small(name)
    pool = weights.batch_pool(SEED, cell["steps_drawn"], cell["batch"], cell["seq_len"], model["vocab_size"], "cpu")
    batches = [pool[i] for i in range(train.CHECK_STEPS)]
    hp = plan["config"]["train"]
    ref = decoder.follow(model, hp, SEED, batches, "cpu")
    control = decoder.follow(model, hp, SEED, batches, "cpu", precision="fp8")
    correct, checks = compare.judge(compare.readings(control, ref), cell["limits"])
    assert not correct, checks
