"""``mla_ms.train_v3``: latent attention's device time a traced step, in
ms: the port's span ``attn.mla`` (``models/mla.py::mla_forward``, from its
input to its output projection) and ``attn.mla.bwd``, in every layer,
timed by CUDA events on the current stream (``repro_torch.spans``, on while
the profiler records), summed over the traced steps and divided by them.
Read only where the forward span fired once a layer and pass (remat adds
its recompute's pass) and the backward span once a layer, every traced
step, each counting the cell's batch x seq_len tokens; else ``None``, as
on a program without the spans (the counts as ``moe_ms.train_v3`` checks
them). Moves ``train_tokens_per_s``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("perfbench_metric_moe_ms_train_v3",
                                               Path(__file__).with_name("moe_ms.train_v3.py"))
_moe_ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_moe_ms)


def read(run):
    return _moe_ms.device_ms(run, ("attn.mla",), run["model"]["num_layers"])
