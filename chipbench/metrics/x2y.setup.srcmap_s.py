"""x2y.setup.srcmap_s: host seconds the program spent building the X2Y
assembly's source map (``allpairs._pair_source_map_rect``, an (mx, my)
int32 map built in numpy on a miss of its plan cache), read from inside
the program.

The total of the ``plan.srcmap`` spans in the tracer's per-name totals:
``setup.srcmap_s``'s reading.  None where no such span was recorded (or
in a program whose rect map has no span)."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("setup.srcmap_s")(ctx)
