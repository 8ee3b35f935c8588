"""A traced sub-window of whole steps, and its reduction to device time.

:func:`profile_steps` runs ``fn`` a number of times under ``torch.profiler``
(CPU and CUDA activity), inside a ``record_function`` range that ends with
``torch.cuda.synchronize()``: the range is the traced window. It opens
``PROFILER_MARGIN_S`` after the profiler's start and the profiler closes as
long after it,
since it keeps a device record only if the record falls between its start
and its stop on the host's clock (``chip_smoke.py::device_ms_by`` in the
repository lost records without such a margin).

:func:`reduce_events` reads the raw kineto events (``key_averages`` costs
about 100 us of host time an event): the device operations (kernels,
copies, sets; not annotations, not CUPTI's "Command Buffer Full" markers)
clipped to the window, their union (busy time), the idle gaps between them,
and for each gap the innermost host operation that was running at its
middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

__all__ = ["PROFILER_MARGIN_S", "WINDOW_RANGE", "kind_of", "profile_steps", "reduce_events"]

PROFILER_MARGIN_S = 0.05
WINDOW_RANGE = "perfbench.window"
# host ops looked at backwards from a gap's middle for the one running there
_SCAN = 4096
# individual idle gaps kept, longest first, for the run's log
_LONGEST = 5


def kind_of(name: str) -> str:
    """The group of a device operation: the port's flash kernels, cuBLAS's
    products (``nvjet``) or the rest."""
    if "flash_" in name:
        return "flash"
    if "nvjet" in name:
        return "cublas_nvjet"
    return "other"


def profile_steps(fn, steps: int) -> dict:
    """Runs ``fn()`` ``steps`` times in a traced window; returns
    :func:`reduce_events` of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        with record_function(WINDOW_RANGE):
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    return reduce_events(prof.profiler.kineto_results.events())


def _union(intervals):
    """Sorted, merged ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """The trace's device time (module docstring):

    ``{"window_s", "busy_s", "ops": [(name, start_ns, end_ns)] (device ops
    in the window, clipped), "by_name": {name: s}, "by_kind": {kind: s},
    "idle_by_host_op": {name: s}, "gaps": int, "longest_gaps": [(s, s from
    the window's start, host op)]}``. Raises if the trace holds
    no window range or no device operation in it."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in events:
        name, s, t = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith("Command Buffer"):
                continue
            device.append((name, s, t))
        elif name == WINDOW_RANGE and e.is_user_annotation():
            window = (s, t)
        else:
            host.append((name, s, t))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    w0, w1 = window
    ops = [(n, max(s, w0), min(t, w1)) for n, s, t in device if t > w0 and s < w1]
    if not ops:
        raise RuntimeError("the profiler recorded no device operation in the traced window")
    by_name, by_kind = defaultdict(float), defaultdict(float)
    for n, s, t in ops:
        by_name[n] += (t - s) / 1e9
        by_kind[kind_of(n)] += (t - s) / 1e9
    busy = _union((s, t) for _, s, t in ops)
    busy_ns = sum(t - s for s, t in busy)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle, longest = defaultdict(float), []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = "(no host op)"
        # the latest-starting host op that still runs at mid: the innermost
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(-1, last - _SCAN), -1):
            if host[i][2] >= mid:
                name = host[i][0]
                break
        idle[name] += (g1 - g0) / 1e9
        longest.append(((g1 - g0) / 1e9, (g0 - w0) / 1e9, name))
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9, "ops": ops, "by_name": dict(by_name),
            "by_kind": dict(by_kind), "idle_by_host_op": dict(idle), "gaps": len(gaps),
            "longest_gaps": sorted(longest, reverse=True)[:_LONGEST]}
