"""finish_device_ms: device milliseconds per request of the metric finish,
read from inside the program.

Each ``finish`` span (one per capacity bucket, around
``executors._finish_fused_blocks``: the Gram diagonal, the sqrt, the
divide, the mask and the ``where``) records a CUDA event at its entry and
its exit while the profiler records.  The reading is the sum of those
intervals within a request, averaged over the traced block's requests: the
last ``trace_requests`` ``similarity`` spans that carry device events.
None where no such span was recorded (on the CPU, with observability off,
or in a program whose tracer has no device timing)."""

from repro_torch import obs


def read(ctx):
    tracer = obs.TRACER
    if not hasattr(tracer, "device_ms"):
        return None
    return tracer.device_ms("similarity", "finish", ctx["trace_requests"])
