"""``device_idle_pct.train``: the share of the traced window's wall time in
which no operation runs on the card, in %, from the profiler's device
records (the union of their intervals; the profiler's margins lie outside
the window). Moves ``train_tokens_per_s``."""


def read(run):
    traced = run.get("trace")
    if not traced or traced["window_s"] <= 0:
        return None
    return 100.0 * (traced["window_s"] - traced["busy_s"]) / traced["window_s"]
