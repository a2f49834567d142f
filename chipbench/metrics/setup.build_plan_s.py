"""setup.build_plan_s: host seconds the program spent building reducer
plans (``engine.build_plan``: the schema's reducer lists flattened, the
capacity buckets), read from inside the program.

The total of the ``plan.build`` spans in the tracer's per-name totals,
which outlast its ring.  In a run of a cell it is the cold request's
build, in set-up.  None where no such span was recorded (with
observability off, or in a program whose tracer keeps no totals)."""

from repro_torch import obs


def read(ctx):
    totals = getattr(obs.TRACER, "totals", None)
    t = totals().get("plan.build") if totals else None
    return t["host_s"] if t else None
