"""finish_assembly_ms: device milliseconds per request of everything but
the Gram kernels (the metric finish, the assembly gather, copies and
memsets), from the profiler's trace."""

EXCLUDE = ("fused_gather_gram",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device_s"]:
        return None
    s = sum(v for name, v in tr["device_s"].items()
            if not any(k in name.lower() for k in EXCLUDE))
    return 1e3 * s / ctx["trace_requests"]
