"""x2y.gram_device_ms: device milliseconds per request of the rect Gram
launches, read from inside the program.

Each ``gram`` span (one per rect bucket, around the
``fused_gather_gram_rect`` launch) records a CUDA event at its entry and
its exit while the profiler records: ``gram_device_ms``'s reading, in a
cell whose requests launch only the rect kernel.  None where no such span
was recorded (on the CPU, with observability off, or in a program whose
rect path has no span)."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("gram_device_ms")(ctx)
