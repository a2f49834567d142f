"""program_idle_ms: device milliseconds per request from the entry of the
program to its first Gram launch: the card waiting on the program's
prologue.

The interval from the CUDA event that the ``similarity`` span records at
its entry to the one that the request's first ``gram`` span records at its
entry, on the device's clock, averaged over the traced block's requests
(the last ``trace_requests`` ``similarity`` spans that carry device
events).  Where the stream is still busy with the request before at the
entry, both events wait behind that work and the interval is near 0.  None
where no such span was recorded (on the CPU, with observability off, or in
a program whose tracer has no device timing)."""

from repro_torch import obs


def read(ctx):
    tracer = obs.TRACER
    if not hasattr(tracer, "requests"):
        return None
    waits = []
    for root, members in tracer.requests("similarity",
                                         ctx["trace_requests"]):
        first = next((s for s in members if s.name == "gram"), None)
        if first is None:
            continue
        ms = obs.device_interval_ms(root.device_start, first.device_start)
        if ms is not None:
            waits.append(ms)
    return sum(waits) / len(waits) if waits else None
