"""Spans at the layer boundaries of the training step: where the step's
device time goes, by layer.

A span is on only while ``torch.profiler`` records on the calling thread
(``torch.autograd._profiler_enabled()``; the autograd engine's threads
inherit that state). Off, :func:`span` returns a shared null context and
:func:`mark_backward` returns its tensor itself: no record, no node in the
autograd graph. On, a span

* opens ``torch.profiler.record_function(name)``, so the span lies on the
  profiler's clock beside the device records and names the host's place in
  a trace;
* records a pair of timing CUDA events on the current stream (once the
  process has initialised CUDA), its interval on the device;
* keeps its host interval (``time.perf_counter_ns``) and ``items``, the
  work counted at that boundary.

A backward span opens in the backward of an identity at its region's
output and closes in the backward of one at the region's input, both
applied by :func:`mark_backward`. The opening identity saves its input and
reads it back before the span opens: inside a region that
``torch.utils.checkpoint`` recomputes, the backward pass's first read of a
saved tensor starts the recompute, which so runs before any backward span
of the region opens. Records stay in memory until
:func:`reset`; :func:`summary` reads them. Nothing is written out.

The training step's spans outside the layers, each once a step (none
inside a region that ``torch.utils.checkpoint`` recomputes):

* ``train.step``: ``launch/steps.py::build_train_step``'s step; items
  the tokens predicted;
* ``model.embed``, ``model.embed.bwd``: ``models/dense.py``, the lookup
  (backward: from the gradient at its output until the table's gradient
  is done); items tokens;
* ``model.stack``, ``model.stack.bwd``: ``models/dense.py``, around
  ``stack_forward`` (backward: remat's recompute included); items tokens;
* ``model.loss_head``, ``model.loss_head.bwd``:
  ``models/dense.py::dense_loss``, ``_logits`` and ``cross_entropy``
  (backward: from the loss's gradient until the gradient leaves through
  the stack's output); items tokens;
* ``optim.update``: the body of every optimizer's ``update``;
  ``optim.apply``: ``optim/optimizers.py::apply_updates``; items the
  elements updated.

Spans inside a layer, items the layer's tokens. A layer under remat runs
its forward twice a step, once in the forward pass and once as the
backward pass's recompute, so each forward span fires twice a layer and
step (a recompute that ``torch.utils.checkpoint`` stops early closes the
open ones at the stop); each backward span, from the first forward's
graph, fires once, after the recompute, and the backward spans of one
layer do not overlap (the autograd engine runs the later region's backward
first):

* ``attn.mla``, ``attn.mla.bwd``: ``models/mla.py::mla_forward``, MLA's
  train/prefill attention from its input to its output projection;
* ``moe.route``, ``moe.route.bwd``: ``models/moe_dispatch.py::route``
  (backward: from the gates' gradient to the router input's);
* ``moe.held``, ``moe.shared`` and their ``.bwd``: the held route
  (``_held_experts``: the grouped products, the gates applied and the
  pairs summed at their tokens) and the shared expert, in
  ``models/moe_dispatch.py::moe_ffn``.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["mark_backward", "reset", "span", "summary"]

_OFF = contextlib.nullcontext()
# closed spans, in the order they closed
_records: list = []
# backward spans opened and not yet closed, by name
_open: dict = {}


class _Record:
    """One span: a context manager, or opened and closed by hand (the
    backward spans); kept in ``_records`` once closed."""

    __slots__ = ("name", "items", "range", "ev0", "ev1", "t0", "t1")

    def __init__(self, name: str, items):
        self.name, self.items = name, items

    def __enter__(self):
        if callable(self.items):
            self.items = self.items()
        self.range = record_function(self.name)
        self.range.__enter__()
        self.ev0 = self.ev1 = None
        if torch.cuda.is_initialized():
            self.ev0, self.ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev1 is not None:
            self.ev1.record()
        self.range.__exit__(None, None, None)
        _records.append(self)


def span(name: str, items=None):
    """A context manager: the span ``name`` around its body while the
    profiler records (module docstring), else a null context. ``items``:
    the work counted at this boundary, an int or a function of no arguments
    called only while the span is on."""
    if not _profiler_enabled():
        return _OFF
    return _Record(name, items)


class _Mark(torch.autograd.Function):
    """The identity forward; its backward opens (``end`` false) or closes
    (``end`` true) the backward span ``name``."""

    @staticmethod
    def forward(ctx, x, name, end, items):
        ctx.name, ctx.end, ctx.items = name, end, items
        if not end:
            ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.end:
            record = _open.pop(ctx.name, None)
            if record is not None:
                record.__exit__(None, None, None)
        else:
            ctx.saved_tensors  # under remat, the first read of a saved tensor starts the recompute: before the span
            _open[ctx.name] = _Record(ctx.name, ctx.items).__enter__()
        return g, None, None, None


def mark_backward(x: torch.Tensor, name: str, end: bool, items=None) -> torch.Tensor:
    """``x`` through an identity whose backward opens the backward span
    ``name`` (apply it at the region's output, ``end=False``, with the
    span's ``items``) or closes it (at the region's input, ``end=True``);
    ``x`` itself while the profiler is off or no gradient flows through
    ``x``."""
    if not _profiler_enabled() or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _Mark.apply(x, name, end, items)


def summary() -> dict:
    """``{name: {"count", "items", "host_s", "device_s"}}`` over the closed
    spans in memory: ``items`` summed (``None`` where the span counts none),
    ``host_s`` and ``device_s`` summed (``device_s`` ``None`` without CUDA
    events). Waits for the device once; keeps the records."""
    records = list(_records)
    if any(r.ev1 is not None for r in records):
        torch.cuda.synchronize()
    out = {}
    for r in records:
        s = out.setdefault(r.name, {"count": 0, "items": None, "host_s": 0.0, "device_s": None})
        s["count"] += 1
        if r.items is not None:
            s["items"] = (s["items"] or 0) + r.items
        s["host_s"] += (r.t1 - r.t0) / 1e9
        if r.ev0 is not None:
            s["device_s"] = (s["device_s"] or 0.0) + r.ev0.elapsed_time(r.ev1) / 1e3
    return out


def reset():
    """Drops every record, open backward spans included."""
    _records.clear()
    _open.clear()
