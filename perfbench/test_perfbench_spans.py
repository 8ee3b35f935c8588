"""The readers of the port's spans (``optimizer_ms.train``,
``loss_head_ms.train``, ``stack_ms.train``) on a fake run record and a
stubbed ``repro_torch.spans``, on the CPU: the value in ms a step, and
``None`` without a trace, without the spans, or where a span's count or
items depart from the traced steps and the configuration's widths."""

import importlib.util
import json
import sys
import types
from pathlib import Path

import pytest

from perfbench import weights

HERE = Path(__file__).resolve().parent
MODEL = json.loads((HERE / "configs" / "deepseek-7b.json").read_text())["model"]
CELL = {"batch": 1, "seq_len": 4096}
STEPS = 10
PARAMS = 4_076_998_656  # test_perfbench_work.py::test_layout_counts_the_published_parameters
TOKENS = 4096
# reader -> (its spans, items a step, device seconds of each span over the steps)
READERS = {
    "optimizer_ms.train": (("optim.update", "optim.apply"), PARAMS, (1.5, 0.3)),
    "loss_head_ms.train": (("model.loss_head", "model.loss_head.bwd"), TOKENS, (0.12, 0.18)),
    "stack_ms.train": (("model.stack", "model.stack.bwd"), TOKENS, (0.9, 1.95)),
}


def _reader(name):
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _summary(name, **change):
    """What ``repro_torch.spans.summary()`` gives after ``STEPS`` traced
    steps: the reader's spans, ``change`` applied to the first, and spans it
    does not read."""
    names, per_step, device = READERS[name]
    out = {"train.step": {"count": STEPS, "items": STEPS * TOKENS, "host_s": 5.3, "device_s": 5.2},
           "model.embed": {"count": STEPS, "items": STEPS * TOKENS, "host_s": 0.01, "device_s": 0.002}}
    for span, s in zip(names, device):
        out[span] = {"count": STEPS, "items": STEPS * per_step, "host_s": 2 * s, "device_s": s}
    out[names[0]].update(change)
    return out


@pytest.fixture
def stub_spans(monkeypatch):
    """Installs a ``repro_torch.spans`` whose ``summary()`` returns what
    ``set`` was given."""
    module = types.ModuleType("repro_torch.spans")
    module.summary = lambda: module.given
    monkeypatch.setitem(sys.modules, "repro_torch.spans", module)
    return lambda got: setattr(module, "given", got)


def _run(trace=True):
    return {"model": MODEL, "cell": CELL, "trace": {"steps": STEPS, "window_s": 5.29} if trace else None}


def test_the_layout_counts_the_parameters_the_optimizer_reader_expects():
    assert weights.numel(weights.layout(MODEL)) == PARAMS


@pytest.mark.parametrize("name", sorted(READERS))
def test_reads_device_ms_a_step(stub_spans, name):
    stub_spans(_summary(name))
    assert _reader(name)(_run()) == pytest.approx(1e3 * sum(READERS[name][2]) / STEPS, rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_a_trace_or_the_spans(stub_spans, monkeypatch, name):
    read = _reader(name)
    stub_spans(_summary(name))
    assert read(_run(trace=False)) is None
    stub_spans({})
    assert read(_run()) is None
    monkeypatch.delitem(sys.modules, "repro_torch.spans")
    assert read(_run()) is None


@pytest.mark.parametrize("change", [{"count": STEPS + 1}, {"count": STEPS - 1}, {"items": None}, {"device_s": None},
                                    "items + 1", "items a step short"],
                         ids=["count_high", "count_low", "no_items", "no_device", "items_high", "items_low"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_where_a_count_departs(stub_spans, name, change):
    """A span that fired once more or less than the traced steps, counted
    other work than the layout's parameters or the cell's tokens, or has no
    device time."""
    per_step = READERS[name][1]
    if change == "items + 1":
        change = {"items": STEPS * per_step + 1}
    elif change == "items a step short":
        change = {"items": (STEPS - 1) * per_step}
    stub_spans(_summary(name, **change))
    assert _reader(name)(_run()) is None
    # the second span too
    got = _summary(name)
    got[READERS[name][0][1]].update(change)
    stub_spans(got)
    assert _reader(name)(_run()) is None
