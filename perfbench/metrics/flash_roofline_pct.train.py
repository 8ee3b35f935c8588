"""``flash_roofline_pct.train``: the flash-attention kernels' share of their
roofline over the traced steps, in %: the sum over the traced launches of
the port's forward, dQ and dK/dV kernels (selected by their exact names) of
each launch's least time (:func:`perfbench.work.flash_bound_s`, at the
cell's attention shape: every layer of the cells' models attends causally
over the whole sequence with the same heads), over the profiler's summed
device time of those launches. Every launch at these shapes is bound by its
operations, not its bytes. Moves ``train_tokens_per_s``."""

import re

from perfbench import work

# the port's bf16 tensor-core flash kernels (csrc/flash_fwd.cu,
# csrc/flash_bwd.cu) by name, and the launch kind of each
KERNELS = {"flash_fwd_tc_kernel": "fwd", "flash_dq_tc_kernel": "dq", "flash_dkv_tc_kernel": "dkv"}


def launch_kind(name: str):
    """The launch kind of a device record of one of the port's flash kernels,
    matched by whole identifier (``"void (anonymous namespace)::
    flash_dkv_tc_kernel<128>(CUtensorMap_st, ...)"`` gives ``"dkv"``), or
    ``None``: another kernel, such as the port's CUDA-core
    ``flash_fwd_kernel`` or a library's."""
    return next((KERNELS[w] for w in re.findall(r"[A-Za-z_]\w*", name) if w in KERNELS), None)


def read(run):
    traced = run.get("trace")
    if not traced:
        return None
    m, cell = run["model"], run["cell"]
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    bound = spent = 0.0
    for name, start, end in traced["ops"]:
        which = launch_kind(name)
        if which is None:
            continue
        least, _ = work.flash_bound_s(which, cell["batch"], m["num_heads"], m["num_kv_heads"], cell["seq_len"], hd)
        bound += least
        spent += (end - start) / 1e9
    if spent == 0.0:
        return None
    return 100.0 * bound / spent
