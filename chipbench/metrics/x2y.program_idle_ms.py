"""x2y.program_idle_ms: device milliseconds per request from the entry of
``x2y_similarity`` (its ``similarity`` span) to the first rect ``gram``
span's entry: the card waiting on the program's prologue.
``program_idle_ms``'s reading, in a cell whose first Gram launch is the
rect kernel's.  None where no such span was recorded."""

from chipbench import spec


def read(ctx):
    return spec.metric_reader("program_idle_ms")(ctx)
