"""host_dispatch_ms: mean host time from the entry's call to its return,
before the synchronize, over the requests of the measured window."""


def read(ctx):
    d = ctx["dispatch_s"]
    return 1e3 * sum(d) / len(d) if d else None
