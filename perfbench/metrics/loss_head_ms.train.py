"""``loss_head_ms.train``: the loss head's device time a traced step, in
ms: the port's spans ``model.loss_head`` (``models/dense.py::dense_loss``:
the final norm, the head's product, the float32 logits and ``_NLL``) and
``model.loss_head.bwd`` (their backward, from the loss's gradient until the
gradient leaves through the stack's output), timed by CUDA events on the
current stream (``repro_torch.spans``, on while the profiler records),
summed over the traced steps and divided by them. Read only where each span
fired once a traced step and counted the cell's batch x seq_len tokens each
time; else ``None``, as on a program without the spans. Moves
``train_tokens_per_s``."""

import sys

SPANS = ("model.loss_head", "model.loss_head.bwd")


def read(run):
    traced, spans = run.get("trace"), sys.modules.get("repro_torch.spans")
    if not traced or not traced.get("steps") or spans is None:
        return None
    steps, got = traced["steps"], spans.summary()
    items = steps * run["cell"]["batch"] * run["cell"]["seq_len"]
    device_s = 0.0
    for name in SPANS:
        s = got.get(name)
        if s is None or s["count"] != steps or s["items"] != items or s["device_s"] is None:
            return None
        device_s += s["device_s"]
    return 1e3 * device_s / steps
