"""``mfu.train_v3``: the DeepSeek-V3 training step's share of the card's
bf16 peak, in %: the model FLOPs of a step
(:func:`perfbench.work_v3.model_flops_per_step`, from the configuration's
widths: each token counts ``top_k`` times the held share of the routed
experts, and MLA's attention at its true head dims) times the steps of the
measured window, over the window's host-clock seconds and the peak (989e12
FLOP/s). Moves ``train_tokens_per_s``."""

from perfbench import work, work_v3


def read(run):
    window = run.get("window")
    if not window or not window["steps"]:
        return None
    flops = work_v3.model_flops_per_step(run["model"], run["cell"]["batch"], run["cell"]["seq_len"])
    return 100.0 * flops * window["steps"] / (window["seconds"] * work.PEAK_BF16_FLOPS)
