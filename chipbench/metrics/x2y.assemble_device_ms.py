"""x2y.assemble_device_ms: device milliseconds per request of the X2Y
assembly, read from inside the program.

The ``assemble`` span of ``FusedExecutor.run_x2y`` holds the ``cat`` of
slot 0 and every bucket's finished blocks and the gather through the
(mx, my) source map; it records a CUDA event at its entry and its exit
while the profiler records: ``assemble_device_ms``'s reading.  None where
no such span was recorded."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("assemble_device_ms")(ctx)
