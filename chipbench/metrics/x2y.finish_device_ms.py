"""x2y.finish_device_ms: device milliseconds per request of the rect
metric finish in torch, read from inside the program.

Each ``finish`` span (one per rect bucket, around
``executors._finish_rect_blocks`` in ``FusedExecutor.run_x2y``: the norm
gathers, the sqrt, the divide, the mask and the ``where`` over the whole
(R, Lx, Ly) stack) records a CUDA event at its entry and its exit while
the profiler records: ``finish_device_ms``'s reading.  None where no such
span was recorded."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("finish_device_ms")(ctx)
