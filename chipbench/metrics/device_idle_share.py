"""device_idle_share: percent of the traced block's host-clock window in
which no operation ran on the device (rank 0)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device_s"] or ctx["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["trace_window_s"])
