"""``flash_roofline_pct.train_v3``: the flash kernels' share of their
roofline in the DeepSeek-V3 cell, in %: the sum over the traced launches of
the port's forward, dQ and dK/dV tensor-core kernels (by exact name) of each
launch's least time at MLA's true work (:func:`perfbench.work_v3.flash_bound_s`:
q/k head dim 192, v head dim 128; every layer attends causally over the
whole sequence with the same heads), over the profiler's summed device time
of those launches. The kernels run on inputs zero-padded to their 256
instance, so the padding shows as lost share. Moves
``train_tokens_per_s``."""

import re

from perfbench import work_v3

# the port's bf16 tensor-core flash kernels (csrc/flash_fwd.cu,
# csrc/flash_bwd.cu) by name, and the launch kind of each
KERNELS = {"flash_fwd_tc_kernel": "fwd", "flash_dq_tc_kernel": "dq", "flash_dkv_tc_kernel": "dkv"}


def launch_kind(name: str):
    """The launch kind of a device record of one of the port's flash
    kernels, matched by whole identifier, or ``None``."""
    return next((KERNELS[w] for w in re.findall(r"[A-Za-z_]\w*", name) if w in KERNELS), None)


def read(run):
    traced = run.get("trace")
    if not traced:
        return None
    m, cell = run["model"], run["cell"]
    bound = spent = 0.0
    for name, start, end in traced["ops"]:
        which = launch_kind(name)
        if which is None:
            continue
        bound += work_v3.flash_bound_s(which, m, cell["batch"], cell["seq_len"])[0]
        spent += (end - start) / 1e9
    if spent == 0.0:
        return None
    return 100.0 * bound / spent
