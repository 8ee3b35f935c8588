"""The spans of the port's training step (:mod:`repro_torch.spans`), on the
CPU through ``build_train_step`` on deepseek-7b's SMOKE config: off while
the profiler is off (no record, the same autograd graph, the same bits),
and on under ``torch.profiler`` (every span once a step, nested under
``train.step`` in the step's order, counting tokens and parameters, named
among the profiler's host events), with the same loss and gradients."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.fl.client import train_steps
from repro_torch.launch import build_train_step, value_and_grad
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import get_optimizer, tree_leaves

B, S = 2, 16
FORWARD = ["model.embed", "model.stack", "model.loss_head"]
BACKWARD = ["model.loss_head.bwd", "model.stack.bwd", "model.embed.bwd"]
OPTIM = ["optim.update", "optim.apply"]
# one step's spans in the order they open
STEP = ["train.step"] + FORWARD + BACKWARD + OPTIM


@pytest.fixture(autouse=True)
def _fresh_records():
    spans.reset()
    yield
    spans.reset()


def _cfg(**kw):
    return get_config("deepseek-7b", smoke=True).replace(**kw)


def _batch(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)}


def _steps(cfg, n, profiled):
    """``n`` train steps from the seed-0 parameters, under the CPU profiler
    or not: ``(params, losses, prof)``."""
    params = init_params(cfg, 0, device="cpu")
    step, opt = build_train_step(cfg)
    state, losses = opt.init(params), []
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext() as prof:
        for i in range(n):
            params, state, loss = step(params, state, _batch(cfg, i))
            losses.append(loss)
    return params, losses, prof


def _graph_names(loss):
    """The multiset of node names of ``loss``'s autograd graph, sorted."""
    seen, names, todo = set(), [], [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return sorted(names)


def _loss_with_graph(cfg, batch):
    params = init_params(cfg, 0, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    return loss_fn(params, cfg, batch)


def _stub(monkeypatch):
    """Spans stubbed out: never on, whatever the profiler does."""
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)


def test_profiler_off_keeps_no_record_and_the_same_graph(monkeypatch):
    cfg = _cfg()
    batch = _batch(cfg)
    x = torch.ones(3, requires_grad=True)
    assert spans.mark_backward(x, "model.stack.bwd", end=False) is x
    assert spans.span("train.step") is spans.span("optim.update")
    names = _graph_names(_loss_with_graph(cfg, batch))
    _steps(cfg, 1, profiled=False)
    assert spans.summary() == {}
    _stub(monkeypatch)
    assert _graph_names(_loss_with_graph(cfg, batch)) == names
    assert "_MarkBackward" not in names


def test_profiler_on_adds_only_the_marks_to_the_graph():
    """Six identities: the embedding table and output, the stack's input
    and output, the loss head's input and the loss."""
    cfg = _cfg()
    batch = _batch(cfg)
    names = _graph_names(_loss_with_graph(cfg, batch))
    with profile(activities=[ProfilerActivity.CPU]):
        marked = _graph_names(_loss_with_graph(cfg, batch))
    assert [n for n in marked if n != "_MarkBackward"] == names
    assert marked.count("_MarkBackward") == 6


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "profiled"])
def test_loss_and_gradients_are_bitwise_those_without_spans(monkeypatch, profiled):
    """Against spans stubbed out: the loss and every gradient of one
    ``value_and_grad``, and the parameters and losses of two steps."""
    cfg = _cfg()
    batch = _batch(cfg)

    def run():
        params = init_params(cfg, 0, device="cpu")
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                loss, grads = value_and_grad(params, cfg, batch)
        else:
            loss, grads = value_and_grad(params, cfg, batch)
        after, losses, _ = _steps(cfg, 2, profiled)
        return [loss, *tree_leaves(grads), *losses, *tree_leaves(after)]

    got = run()
    assert bool(spans.summary()) == profiled
    with monkeypatch.context() as m:
        _stub(m)
        want = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_every_span_fires_once_a_step_with_its_items(remat):
    """Two steps: each span twice (remat's recompute opens none), the model
    spans counting B x S tokens and the optimizer's the parameters, host
    times positive, no device time on the CPU; reading keeps the records."""
    cfg = _cfg(remat=remat)
    params, _, _ = _steps(cfg, 2, profiled=True)
    got = spans.summary()
    assert sorted(got) == sorted(STEP)
    n_params = sum(p.numel() for p in tree_leaves(params))
    for name, s in got.items():
        assert s["count"] == 2
        assert s["items"] == 2 * (n_params if name in OPTIM else B * S)
        assert s["host_s"] > 0 and s["device_s"] is None
    assert spans.summary() == got
    spans.reset()
    assert spans.summary() == {}


def test_spans_nest_under_the_step_in_its_order():
    """The profiler's host events: per step, ``train.step`` holds every
    other span; the forward spans, then the backward ones from the loss
    head down to the embedding, then the optimizer's update and apply, one
    after another."""
    cfg = _cfg()
    _, _, prof = _steps(cfg, 2, profiled=True)
    events = sorted((e for e in prof.events() if e.name in STEP), key=lambda e: e.time_range.start)
    assert [e.name for e in events] == STEP * 2
    for i in range(2):
        step, *children = events[i * len(STEP):(i + 1) * len(STEP)]
        for a, b in zip(children, children[1:]):
            assert a.time_range.end <= b.time_range.start
        assert step.time_range.start <= children[0].time_range.start
        assert children[-1].time_range.end <= step.time_range.end


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adafactor"])
def test_every_optimizer_updates_inside_its_span(name):
    """The one wrapper of every optimizer's ``update``, and
    ``apply_updates``, through the train step, counting the parameters."""
    cfg = _cfg(optimizer=name)
    params, _, _ = _steps(cfg, 2, profiled=True)
    n_params = sum(p.numel() for p in tree_leaves(params))
    got = spans.summary()
    for span in OPTIM:
        assert (got[span]["count"], got[span]["items"]) == (2, 2 * n_params)


def test_client_steps_get_the_optimizer_spans():
    """``fl/client.py::train_steps``: the optimizer's spans a step, and no
    ``train.step`` of its own."""
    cfg = _cfg()
    params = init_params(cfg, 0, device="cpu")
    batches = {"tokens": torch.stack([_batch(cfg, i)["tokens"] for i in range(3)])}
    with profile(activities=[ProfilerActivity.CPU]):
        train_steps(lambda p, b: loss_fn(p, cfg, b), get_optimizer("sgd", 1e-3), params, batches, 3)
    got = spans.summary()
    assert got["optim.update"]["count"] == got["optim.apply"]["count"] == got["model.loss_head.bwd"]["count"] == 3
    assert "train.step" not in got
