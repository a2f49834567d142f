"""pairs_per_s: the required pairs whose similarity the window's returned
requests delivered, over the window's seconds (from its first send to its
last return, table draws included)."""


def read(ctx):
    return len(ctx["latency_s"]) * ctx["pairs_per_request"] / ctx["window_s"]
