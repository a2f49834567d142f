"""assemble_device_ms: device milliseconds per request of the assembly,
read from inside the program.

The ``assemble`` span (around ``allpairs._assemble_from_srcmap``: the
``cat`` of the bucket blocks and the source-map gather) records a CUDA
event at its entry and its exit while the profiler records.  The reading
is its interval, averaged over the traced block's requests: the last
``trace_requests`` ``similarity`` spans that carry device events.  None
where no such span was recorded (on the CPU, with observability off, or in
a program whose tracer has no device timing)."""

from repro_torch import obs


def read(ctx):
    tracer = obs.TRACER
    if not hasattr(tracer, "device_ms"):
        return None
    return tracer.device_ms("similarity", "assemble", ctx["trace_requests"])
