"""Streaming subsystem: incremental mapping-schema maintenance (port of
``repro.stream``).

The planners in ``repro_torch.core`` are pure functions of a weight
profile; the executors in ``repro_torch.mapreduce`` run the resulting
static plan.  This package makes plans *mutable serving state* (DESIGN.md
1f).  The planners and ``PlanDelta`` are copies of the reference's numpy
code with their imports pointed at the port; the executor is PyTorch.

``IncrementalPlanner``
    ``insert`` / ``delete`` / ``reweight`` maintain a live mapping schema
    by localized bin repair, with a tracked optimality-gap drift threshold
    that triggers an amortized full re-plan through
    ``repro_torch.core.PLAN_CACHE`` (optionally on a background thread that
    runs numpy only).
``PlanDelta``
    The per-edit artifact: dirty reducers, the compact re-shuffle
    sub-plan, the touched matrix rows, and the coverage-restoration proof
    (``verify``).
``StreamingExecutor``
    The fifth registry executor (``executor="streaming"``): cold builds on
    the fused substrate, then keeps the (m, m) pair matrix on the device,
    recomputes only dirty reducers through the bucketed substrate, and
    patches the matrix with a delta max-scatter instead of rebuilding it.
``IncrementalX2YPlanner``
    The rectangular (DESIGN.md 1g) analogue under ``insert_x`` /
    ``insert_y`` / ``delete_x`` / ``delete_y``, whose deltas patch the
    (mx, my) matrix through ``StreamingExecutor.apply_delta_x2y``.

Importing this package registers the executor;
``repro_torch.mapreduce.get_executor("streaming")`` imports it lazily.
"""

from repro_torch.mapreduce.executors import register_executor

from .delta import PlanDelta, compact_plan, compact_x2y_plan
from .executor import StreamingExecutor
from .incremental import IncrementalPlanner
from .x2y import IncrementalX2YPlanner

register_executor(StreamingExecutor())

__all__ = ["IncrementalPlanner", "IncrementalX2YPlanner", "PlanDelta",
           "StreamingExecutor", "compact_plan", "compact_x2y_plan"]
