"""setup.upload_s: host seconds the program spent uploading a plan's
arrays to the device (``engine.uploaded``, on a miss of its cache: the
bucket arrays and the source map's copy and widening), read from inside
the program.

The self time of the ``upload`` spans in the tracer's per-name totals
(which outlast its ring): their host seconds less what their child spans
cover, so a source map built inside an upload counts under
``setup.srcmap_s`` alone.  None where no such span was recorded (with
observability off, or in a program whose tracer keeps no totals)."""

from repro_torch import obs


def read(ctx):
    totals = getattr(obs.TRACER, "totals", None)
    t = totals().get("upload") if totals else None
    return t["self_s"] if t else None
