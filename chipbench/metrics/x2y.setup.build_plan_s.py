"""x2y.setup.build_plan_s: host seconds the program spent building the
rectangular plan (``engine.build_x2y_plan``: the schema's reducer lists
flattened and split at the X / Y boundary, the rect capacity buckets),
read from inside the program.

The total of the ``plan.build`` spans in the tracer's per-name totals:
``setup.build_plan_s``'s reading.  In a run of the cell it is the cold
request's build, in set-up.  None where no such span was recorded (or in
a program whose X2Y build has no span)."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("setup.build_plan_s")(ctx)
