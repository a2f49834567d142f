"""PlanDelta: the artifact one streaming edit produces (DESIGN.md 1f).

A delta names exactly what changed between two consecutive maintained
mapping schemas:

  * ``touched_inputs`` — input ids whose row/column of the served (m, m)
    pair matrix must be re-patched (the edited input itself; empty for a
    pure weight change, which moves planning state but no feature rows);
  * ``dirty_rows``     — reducer ids (in the post-edit plan) whose Gram
    blocks must be recomputed on device;
  * ``sub_plan``       — a compact :class:`~repro_torch.mapreduce.engine.
    ReducerPlan` holding only the dirty reducers (idx/mask reference the
    *full* input table, so the streaming executor can gather straight from
    the live table), padded to power-of-two row counts / bucket widths so
    the jit cache sees a bounded shape set across an edit stream.

``verify`` is the coverage-restoration proof obligation: after an insert,
every pair involving the new input must be covered by the dirty reducers
alone (the new input exists nowhere else); after a delete or reweight no
new coverage is required, and a full re-plan re-covers everything by
construction.  The incremental planner calls it after every edit when
``check=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.mapreduce.engine import (
    ReducerBucket,
    ReducerPlan,
    _build_buckets,
    build_x2y_plan_arrays,
)

__all__ = ["PlanDelta", "compact_plan", "compact_x2y_plan"]


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _pad_bucket_rows(b: ReducerBucket,
                     pad_reducers_to: int = 1) -> ReducerBucket:
    """Pad a bucket's row count to the next power of two (all-masked
    padding rows, row id -1) so a long edit stream pushes a *bounded* set
    of (rows, width) shapes through the engine's jit cache instead of
    retracing on every distinct dirty-reducer count; then round up to a
    multiple of ``pad_reducers_to`` (the mesh device count) so the row
    axis stays divisible under sharded execution."""
    Rb = b.idx.shape[0]
    R = _pow2(Rb)
    R = -(-R // pad_reducers_to) * pad_reducers_to
    if R == Rb:
        return b
    pad = R - Rb
    return ReducerBucket(
        width=b.width,
        rows=np.concatenate([b.rows, np.full(pad, -1, np.int64)]),
        idx=np.concatenate([b.idx, np.zeros((pad, b.width), np.int32)]),
        mask=np.concatenate([b.mask, np.zeros((pad, b.width), bool)]))


def compact_plan(expanded: list[list[int]], *, comm_cost: float = 0.0,
                 algorithm: str = "stream-delta", max_buckets: int = 8,
                 pad_reducers_to: int = 1) -> ReducerPlan:
    """Compact ReducerPlan over an explicit reducer subset.

    ``expanded[r]`` lists *full-table* input ids, so the resulting plan
    gathers from the live (possibly tombstone-holding) table.  Capacity
    buckets use power-of-two widths (``compute_buckets``) and power-of-two
    row counts (``_pad_bucket_rows``), bounding the distinct program
    shapes across an edit stream; ``pad_reducers_to`` additionally rounds
    bucket rows to a device-count multiple for mesh execution.
    """
    R0 = len(expanded)
    L0 = max((len(ids) for ids in expanded), default=1)
    idx = np.zeros((max(R0, 1), L0), dtype=np.int32)
    mask = np.zeros((max(R0, 1), L0), dtype=bool)
    for r, ids in enumerate(expanded):
        idx[r, : len(ids)] = ids
        mask[r, : len(ids)] = True
    buckets = tuple(
        _pad_bucket_rows(b, pad_reducers_to)
        for b in _build_buckets(expanded, pad_slots_to=1, pad_reducers_to=1,
                                max_buckets=max_buckets))
    return ReducerPlan(
        idx=idx, mask=mask, num_reducers=R0, comm_cost=float(comm_cost),
        max_inputs=L0, algorithm=algorithm, lower_bound=None,
        buckets=buckets)


def _pad_rect_bucket_rows(b: ReducerBucket,
                          pad_reducers_to: int = 1) -> ReducerBucket:
    """Rectangular analogue of :func:`_pad_bucket_rows`: pad both sides'
    row counts (they share the row axis) to the next power of two, then to
    a device-count multiple."""
    Rb = b.idx.shape[0]
    R = _pow2(Rb)
    R = -(-R // pad_reducers_to) * pad_reducers_to
    if R == Rb:
        return b
    pad = R - Rb
    return ReducerBucket(
        width=b.width,
        rows=np.concatenate([b.rows, np.full(pad, -1, np.int64)]),
        idx=np.concatenate([b.idx, np.zeros((pad, b.width), np.int32)]),
        mask=np.concatenate([b.mask, np.zeros((pad, b.width), bool)]),
        ywidth=b.ywidth,
        yidx=np.concatenate([b.yidx, np.zeros((pad, b.ywidth), np.int32)]),
        ymask=np.concatenate([b.ymask, np.zeros((pad, b.ywidth), bool)]))


def compact_x2y_plan(xs: list[list[int]], ys: list[list[int]], *,
                     num_x: int, num_y: int, comm_cost: float = 0.0,
                     algorithm: str = "stream-delta-x2y",
                     max_buckets: int = 8,
                     pad_reducers_to: int = 1) -> ReducerPlan:
    """Compact rectangular ReducerPlan over an explicit dirty-reducer
    subset: ``xs[r]`` / ``ys[r]`` list *full-table* X and Y row ids, so
    the streaming executor gathers straight from the live tables.  Bucket
    rows are padded to power-of-two counts (:func:`_pad_rect_bucket_rows`)
    for the same bounded-shape jit-cache contract as :func:`compact_plan`.
    """
    plan = build_x2y_plan_arrays(
        xs, ys, num_x=num_x, num_y=num_y, comm_cost=comm_cost,
        algorithm=algorithm, pad_reducers_to=1, pad_slots_to=1,
        max_buckets=max_buckets)
    buckets = tuple(_pad_rect_bucket_rows(b, pad_reducers_to)
                    for b in plan.buckets)
    return dataclasses.replace(plan, buckets=buckets)


@dataclasses.dataclass(frozen=True)
class PlanDelta:
    """What one edit changed: dirty reducers + the re-shuffle map to run.

    kind            — 'init' | 'insert' | 'delete' | 'reweight' | 'replan'.
    input_id        — the edited input's full-table id (-1 for init).
    touched_inputs  — ids whose (m, m) row/col the executor must re-patch.
    dirty_rows      — post-edit reducer ids to recompute (ascending).
    sub_plan        — compact plan over exactly ``dirty_rows`` (None when
                      nothing recomputes, or on a full re-plan where the
                      full plan is the program).
    full_replan     — the repair path gave up (gap drift / infeasible
                      repair / opaque schema): every reducer is dirty.
    num_reducers    — reducer count after the edit (recompute-fraction
                      denominator).
    comm_cost / lower_bound — post-edit schema communication cost and the
                      instance's replication-rate lower bound.
    gap_drift       — optimality gap now / gap at the last full re-plan
                      (the planner re-plans when this crosses its
                      threshold).
    """

    kind: str
    input_id: int
    touched_inputs: np.ndarray
    dirty_rows: np.ndarray
    sub_plan: Optional[ReducerPlan]
    full_replan: bool
    num_reducers: int
    comm_cost: float
    lower_bound: float
    gap_drift: float
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def recompute_fraction(self) -> float:
        """Dirty reducers over total reducers (1.0 on a full re-plan)."""
        if self.full_replan:
            return 1.0
        return len(self.dirty_rows) / max(self.num_reducers, 1)

    @property
    def optimality_gap(self) -> Optional[float]:
        if self.lower_bound <= 0.0:
            return None
        return self.comm_cost / self.lower_bound

    def delta_comm_rows(self) -> float:
        """Weighted rows this edit actually ships — the streaming analogue
        of ``MappingSchema.communication_cost``: the dirty reducers' loads
        on a repair, the whole schema's cost on a full re-plan (that edit
        really pays the full re-shuffle).  Compare against ``comm_cost``
        (what a full re-shuffle always ships)."""
        if self.full_replan:
            return float(self.comm_cost)
        return float(self.sub_plan.comm_cost) if self.sub_plan is not None \
            else 0.0

    # ----------------------------------------------------- proof obligation
    def verify(self, expanded, active_ids: Sequence[int]) -> None:
        """Assert coverage of every affected pair is restored.

        ``expanded`` maps post-edit reducer id -> live input ids — a full
        list, or (for inserts) any mapping that covers the dirty rows;
        ``active_ids`` are the live inputs.  Insert: every (new, y) pair
        must meet inside the *dirty* reducers alone — the new input exists
        in no clean reducer, so dirty coverage is the whole proof.
        Reweight moves keep x rows unchanged but must still leave the
        moved input covered against everything (checked over all
        reducers).  Delete needs no new coverage.  Full re-plans are
        covered by the planner's schema construction (conformance-tested
        separately)."""
        if self.full_replan or self.kind in ("init", "delete"):
            return
        if self.kind == "insert":
            new = int(self.input_id)
            partners: set[int] = set()
            for r in self.dirty_rows:
                ids = expanded[int(r)]
                if new in ids:
                    partners.update(ids)
            missing = set(int(a) for a in active_ids) - partners - {new}
            assert not missing, (
                f"insert({new}): dirty reducers leave {len(missing)} pairs "
                f"uncovered, e.g. {sorted(missing)[:5]}")
            return
        if self.kind == "reweight":
            i = int(self.input_id)
            rows = (expanded.values() if isinstance(expanded, dict)
                    else expanded)
            partners = set()
            for ids in rows:
                if i in ids:
                    partners.update(ids)
            missing = set(int(a) for a in active_ids) - partners - {i}
            assert not missing, (
                f"reweight({i}): {len(missing)} pairs uncovered after the "
                f"move, e.g. {sorted(missing)[:5]}")

    def verify_x2y(self, x_expanded, y_expanded,
                   active_x: Sequence[int],
                   active_y: Sequence[int]) -> None:
        """Rectangular coverage proof (X2Y deltas from
        ``IncrementalX2YPlanner``).

        ``x_expanded`` / ``y_expanded`` map post-edit reducer id -> live
        X-table / Y-table ids — full lists, or any mapping covering the
        dirty rows.  Insert on either side: every cross pair involving the
        new input must meet inside the *dirty* reducers alone (the new
        input exists in no clean reducer).  Deletes need no new coverage;
        full re-plans are covered by the planner's schema construction."""
        if self.full_replan or self.kind in ("init", "delete_x",
                                             "delete_y"):
            return
        new = int(self.input_id)
        if self.kind == "insert_x":
            partners: set[int] = set()
            for r in self.dirty_rows:
                if new in x_expanded[int(r)]:
                    partners.update(int(j) for j in y_expanded[int(r)])
            missing = set(int(j) for j in active_y) - partners
            assert not missing, (
                f"insert_x({new}): dirty reducers leave {len(missing)} "
                f"cross pairs uncovered, e.g. {sorted(missing)[:5]}")
        elif self.kind == "insert_y":
            partners = set()
            for r in self.dirty_rows:
                if new in y_expanded[int(r)]:
                    partners.update(int(j) for j in x_expanded[int(r)])
            missing = set(int(j) for j in active_x) - partners
            assert not missing, (
                f"insert_y({new}): dirty reducers leave {len(missing)} "
                f"cross pairs uncovered, e.g. {sorted(missing)[:5]}")
