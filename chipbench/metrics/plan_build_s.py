"""plan_build_s: host seconds of the set-up's planning and plan build.

The harness's host clock around the planner's call (``plan_a2a`` /
``plan_x2y``) plus the first request on the new schema, which builds the
reducer plan, its source maps (and, sharded, the shard maps) and uploads
them; the kernel library is loaded before either."""


def read(ctx):
    return ctx["plan_s"] + ctx["first_request_s"]
