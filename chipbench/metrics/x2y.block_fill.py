"""x2y.block_fill: percent of the rect kernel's computed entries that are
wanted (x, y) pairs, counted by the program.

``FusedExecutor.run_x2y`` counts, per launch, ``fused.rect_entries``
``{kind=computed}`` (R Lx Ly, every entry of the bucket's block stack) and
``{kind=valid}`` (over its reducers, valid X slots times valid Y slots).
The reading is 100 valid / computed over everything counted in the run.
None where nothing was counted (with observability off, or in a program
that has no such counter)."""

from repro_torch import obs


def read(ctx):
    total = getattr(obs.REGISTRY, "counter_total", None)
    computed = total("fused.rect_entries", kind="computed") if total else 0
    if not computed:
        return None
    return 100.0 * total("fused.rect_entries", kind="valid") / computed
