"""planner.replication: input copies sent to reducers, per input.

Counted from the schema's bins and reducer lists (an input is sent once to
each reducer that holds it): the paper's communication cost in copies."""

from chipbench.reference import reducer_rows


def read(ctx):
    schema = ctx["schema"]
    copies = 0
    for rows in reducer_rows(schema.bins, schema.reducers):
        srt = rows.copy()
        srt.sort(axis=1)
        copies += int(rows.size - (srt[:, 1:] == srt[:, :-1]).sum())
    return copies / ctx["inputs"]
