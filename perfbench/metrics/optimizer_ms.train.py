"""``optimizer_ms.train``: the optimizer's device time a traced step, in
ms: the port's spans ``optim.update`` (every optimizer's arithmetic,
``optim/optimizers.py``) and ``optim.apply`` (``apply_updates``), timed by
CUDA events on the current stream (``repro_torch.spans``, on while the
profiler records), summed over the traced steps and divided by them. Read
only where each span fired once a traced step and counted the parameters
of the configuration's layout (:func:`perfbench.weights.layout`) each
time; else ``None``, as on a program without the spans. Moves
``train_tokens_per_s``."""

import sys

from perfbench import weights

SPANS = ("optim.update", "optim.apply")


def read(run):
    traced, spans = run.get("trace"), sys.modules.get("repro_torch.spans")
    if not traced or not traced.get("steps") or spans is None:
        return None
    steps, got = traced["steps"], spans.summary()
    items = steps * weights.numel(weights.layout(run["model"]))
    device_s = 0.0
    for name in SPANS:
        s = got.get(name)
        if s is None or s["count"] != steps or s["items"] != items or s["device_s"] is None:
            return None
        device_s += s["device_s"]
    return 1e3 * device_s / steps
