"""gram_device_ms: device milliseconds per request of the Gram launches,
read from inside the program.

Each ``gram`` span (one per capacity bucket, around the
``fused_gather_gram`` launch in ``FusedExecutor.run``) records a CUDA
event at its entry and its exit while the profiler records.  The reading
is the sum of those intervals within a request, averaged over the traced
block's requests: the last ``trace_requests`` ``similarity`` spans that
carry device events.  None where no such span was recorded (on the CPU,
with observability off, or in a program whose tracer has no device
timing)."""

from repro_torch import obs


def read(ctx):
    tracer = obs.TRACER
    if not hasattr(tracer, "device_ms"):
        return None
    return tracer.device_ms("similarity", "gram", ctx["trace_requests"])
