"""setup.srcmap_s: host seconds the program spent building the fused
assembly's source maps (``allpairs._pair_source_map``, an (m, m) int32
map built in numpy on a miss of its plan cache), read from inside the
program.

The total of the ``plan.srcmap`` spans in the tracer's per-name totals,
which outlast its ring.  In a run of a cell it is the cold request's map,
in set-up.  None where no such span was recorded (with observability off,
or in a program whose tracer keeps no totals)."""

from repro_torch import obs


def read(ctx):
    totals = getattr(obs.TRACER, "totals", None)
    t = totals().get("plan.srcmap") if totals else None
    return t["host_s"] if t else None
