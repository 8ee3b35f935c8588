"""``moe_ms.train_v3``: the MoE layers' device time a traced step, in ms:
the port's spans ``moe.route`` (the router), ``moe.held`` (the held
experts' products) and ``moe.shared`` (the shared expert) and their
backward spans (``models/moe_dispatch.py::moe_ffn``), timed by CUDA events
on the current stream (``repro_torch.spans``, on while the profiler
records), summed over the traced steps and divided by them. ``moe.held``
holds the held route's combine (the gates applied, the pairs summed at
their tokens); the layer's recompute runs before its backward spans open
and lies outside them.
Read only where each forward span fired once a MoE layer and pass (remat
adds its recompute's pass) and each backward span once a MoE layer, every
traced step, each counting the cell's batch x seq_len tokens; else
``None``, as on a program without the spans. Moves
``train_tokens_per_s``."""

import sys

SPANS = ("moe.route", "moe.held", "moe.shared")


def device_ms(run, spans: tuple, layers: int):
    """Device ms a traced step in ``spans`` and their ``.bwd``, each
    forward span expected once a layer and pass and each backward span once
    a layer, ``layers`` layers; ``None`` where a count departs."""
    traced, module = run.get("trace"), sys.modules.get("repro_torch.spans")
    if not traced or not traced.get("steps") or module is None or not run.get("train"):
        return None
    steps, got = traced["steps"], module.summary()
    tokens = run["cell"]["batch"] * run["cell"]["seq_len"]
    passes = 2 if run["train"]["remat"] == "full" else 1
    device_s = 0.0
    for name in spans:
        for span, per_step in ((name, layers * passes), (name + ".bwd", layers)):
            s = got.get(span)
            n = steps * per_step
            if s is None or s["count"] != n or s["items"] != n * tokens or s["device_s"] is None:
                return None
            device_s += s["device_s"]
    return 1e3 * device_s / steps


def read(run):
    m = run["model"]
    return device_ms(run, SPANS, m["num_layers"] - m["dense_prefix_layers"])
