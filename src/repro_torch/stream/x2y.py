"""IncrementalX2YPlanner: online maintenance of an X2Y mapping schema.

The rectangular analogue of :class:`~repro_torch.stream.incremental.
IncrementalPlanner` for the paper's Section-10 bipartite workload: X
inputs pack into bins of size ``b``, Y inputs into bins of ``q - b``, and
every reducer meets one live X-bin with one live Y-bin — the maintained
invariant is exactly X2Y coverage (every (live x, live y) cross pair
meets at >= 1 reducer).

Repair rules:

  insert_x(w) — residual best-fit into the fullest live X-bin whose slack
                still holds ``w`` (its reducers go dirty: they gain one X
                row against their full Y side).  No slack: open a new
                X-bin and one new reducer per live Y-bin — coverage of
                the new input against every live Y input is restored by
                construction, and every new reducer's load is
                ``w + |y-bin| <= b + (q - b) = q``.
  insert_y(w) — symmetric with capacity ``q - b``.
  delete_x(i) / delete_y(j) — drop the input from its bin (emptied bins
                are tombstoned, never revived); no recompute — the
                executor zeroes row i / column j of the served matrix.

Triggers, background repacking, and the double-buffered re-plan live in
:class:`~repro_torch.stream.base.StreamPlannerBase` (shared with the all-pairs
planner).  The theorem bound is Thm 25 (``x2y_comm_lower_bound`` =
``2 s_x s_y / q``); the achievable reference is ``2x`` that — the
grid-of-bins family any feasible covering schema belongs to ships each
side once per opposite-side bin, which costs at least
``2 (2 s_x s_y / q)`` when both sides saturate their capacity split — so
ceilings fire on real degradation, not on the bound's intrinsic
looseness.  A full re-plan (through ``repro_torch.core.plan_x2y``, which may
move the split point ``b`` itself) adopts the fresh schema as planning
state but emits only a compact *patch* delta: pair values are
plan-independent, so the served matrix never rebuilds.
``PlanDelta.verify_x2y`` is the per-edit coverage proof when
``check=True``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.bounds import x2y_comm_lower_bound
from repro_torch.core.planner import plan_x2y
from repro_torch.core.schema import InfeasibleError
from repro_torch.mapreduce.engine import ReducerPlan, build_x2y_plan_arrays

from .base import StreamPlannerBase, _EPS
from .delta import PlanDelta, compact_x2y_plan

__all__ = ["IncrementalX2YPlanner"]


def _ffd_pack(ids: Sequence[int], weights: Sequence[float],
              cap: float) -> list[list[int]]:
    """First-fit-decreasing over explicit ids (the one-sided bootstrap
    path: no cross pairs exist yet, so any feasible packing works)."""
    bins: list[list[int]] = []
    loads: list[float] = []
    for i in sorted(ids, key=lambda i: -weights[i]):
        w = float(weights[i])
        if w > cap + _EPS:
            raise InfeasibleError(
                f"input {i} (w={w}) exceeds bin capacity {cap}")
        for b, load in enumerate(loads):
            if load + w <= cap + _EPS:
                bins[b].append(i)
                loads[b] += w
                break
        else:
            bins.append([i])
            loads.append(w)
    return bins


class IncrementalX2YPlanner(StreamPlannerBase):
    """Mutable X2Y mapping-schema state over growing/shrinking X and Y
    tables.

    Ids are stable full-table positions per side: ``insert_x`` appends a
    new X id (``insert_y`` a new Y id) and deleted ids are never reused,
    so the serving tier keeps two flat feature tables with tombstones.
    ``plan()`` returns the current rectangular :class:`ReducerPlan`
    (idx/mask into the X table, yidx/ymask into the Y table);
    ``snapshot_counts()`` exposes the live bin structure for validation.
    """

    def __init__(self, q: float, wx: Sequence[float] = (),
                 wy: Sequence[float] = (), *, replan_drift: float = 1.5,
                 max_gap: Optional[float] = 2.0,
                 repack_gap: Optional[float] = None,
                 background: bool = False,
                 pad_reducers_to: int = 1, max_buckets: int = 8,
                 check: bool = True):
        super().__init__(replan_drift=replan_drift, max_gap=max_gap,
                         repack_gap=repack_gap, background=background,
                         check=check)
        self.q = float(q)
        self._pad = dict(pad_reducers_to=pad_reducers_to,
                         max_buckets=max_buckets)
        self.wx: list[float] = [float(w) for w in wx]
        self.wy: list[float] = [float(w) for w in wy]
        self.active_x: list[bool] = [True] * len(self.wx)
        self.active_y: list[bool] = [True] * len(self.wy)
        self._adopt_replan()

    # ------------------------------------------------------------ properties
    @property
    def num_active_x(self) -> int:
        return int(np.sum(self.active_x))

    @property
    def num_active_y(self) -> int:
        return int(np.sum(self.active_y))

    @property
    def num_reducers(self) -> int:
        return len(self.reducers)

    def active_x_ids(self) -> np.ndarray:
        return np.flatnonzero(self.active_x)

    def active_y_ids(self) -> np.ndarray:
        return np.flatnonzero(self.active_y)

    def active_x_weights(self) -> np.ndarray:
        return np.asarray([self.wx[i] for i in self.active_x_ids()],
                          dtype=np.float64)

    def active_y_weights(self) -> np.ndarray:
        return np.asarray([self.wy[j] for j in self.active_y_ids()],
                          dtype=np.float64)

    # ---------------------------------------------------------------- bounds
    def _recompute_lb(self) -> None:
        """Thm 25 theorem bound, plus the grid-family achievable
        reference (2x Thm 25 — what a fresh split-point plan actually
        reaches when both sides saturate their capacity split)."""
        if self.num_active_x and self.num_active_y:
            self._lb = x2y_comm_lower_bound(
                self.active_x_weights(), self.active_y_weights(), self.q)
            self._lb_ach = 2.0 * self._lb
        else:
            self._lb = self._lb_ach = 0.0

    # -------------------------------------------------------------- adoption
    def _adopt_replan(self) -> None:
        """Full re-plan of the live profile through ``plan_x2y``; adopt
        the winning schema (including its split point ``b``) as the new
        mutable state.  One-sided profiles have no cross pairs: the
        present side is FFD-packed at the full capacity ``q`` and no
        reducers exist (nothing ships)."""
        x_ids = self.active_x_ids()
        y_ids = self.active_y_ids()
        wx = self.active_x_weights()
        wy = self.active_y_weights()
        if len(x_ids) == 0 or len(y_ids) == 0:
            algorithm = "empty" if not (len(x_ids) or len(y_ids)) \
                else "x2y-one-sided"
            # all capacity to the present side; the other side's first
            # insert forces a full re-plan (w > 0 slack), which then
            # picks a real split point
            b = self.q if len(y_ids) == 0 else 0.0
            xbins = _ffd_pack(x_ids, self.wx, self.q) if len(x_ids) else []
            ybins = _ffd_pack(y_ids, self.wy, self.q) if len(y_ids) else []
            reducers: list[tuple[int, int]] = []
        else:
            schema = plan_x2y(wx, wy, self.q)   # may raise InfeasibleError
            algorithm = schema.algorithm
            b = float(schema.meta["b"])
            nxb = int(schema.meta["x_bins"])
            nx = len(x_ids)
            xbins = [[int(x_ids[i]) for i in bin_]
                     for bin_ in schema.bins[:nxb]]
            ybins = [[int(y_ids[i - nx]) for i in bin_]
                     for bin_ in schema.bins[nxb:]]
            reducers = [(int(r[0]), int(r[1]) - nxb)
                        for r in schema.reducers]
        self._adopt_x2y_state(algorithm, b, xbins, ybins, reducers)
        self._recompute_lb()
        self._after_adopt()

    def _adopt_x2y_state(self, algorithm: str, b: float,
                         xbins: list[list[int]], ybins: list[list[int]],
                         reducers: list[tuple[int, int]]) -> None:
        """Install a split point + bin/reducer structure over full-table
        ids; shared by the synchronous adopt and the background swap."""
        self.algorithm = algorithm
        self.b = float(b)
        self.xbins = xbins
        self.ybins = ybins
        self.reducers = reducers
        self.dead_xbins: set[int] = {bx for bx, mem in enumerate(xbins)
                                     if not mem}
        self.dead_ybins: set[int] = {by for by, mem in enumerate(ybins)
                                     if not mem}
        self._bwx = np.asarray(
            [sum(self.wx[i] for i in bn) for bn in self.xbins], np.float64)
        self._bwy = np.asarray(
            [sum(self.wy[j] for j in bn) for bn in self.ybins], np.float64)
        self.xbin_of = {i: bx for bx, mem in enumerate(self.xbins)
                        for i in mem}
        self.ybin_of = {j: by for by, mem in enumerate(self.ybins)
                        for j in mem}
        self.reducers_of_xbin: dict[int, list[int]] = {
            bx: [] for bx in range(len(self.xbins))}
        self.reducers_of_ybin: dict[int, list[int]] = {
            by: [] for by in range(len(self.ybins))}
        for r, (xb, yb) in enumerate(self.reducers):
            self.reducers_of_xbin[xb].append(r)
            self.reducers_of_ybin[yb].append(r)
        self.comm_cost = float(sum(self._bwx[xb] + self._bwy[yb]
                                   for xb, yb in self.reducers))
        self._plan: Optional[ReducerPlan] = None

    # --------------------------------------------------- background re-plan
    def _capture_profile(self):
        return (self.active_x_ids().copy(), self.active_x_weights().copy(),
                self.active_y_ids().copy(), self.active_y_weights().copy())

    def _background_plan(self, payload):
        x_ids, wx, y_ids, wy = payload
        return x_ids, y_ids, plan_x2y(wx, wy, self.q)

    def _swap_in(self, result) -> bool:
        """Adopt a background plan built for a captured profile onto the
        *current* one: deletes since capture are filtered out of its
        bins, inserts on either side are replayed through the repair
        rules.  False (caller re-plans synchronously) when the plan went
        stale — a side emptied, or a bin overflows its split capacity."""
        x_ids, y_ids, schema = result
        if not (self.num_active_x and self.num_active_y):
            return False
        b = float(schema.meta["b"])
        nxb = int(schema.meta["x_bins"])
        nx = len(x_ids)
        xbins = [[i for i in (int(x_ids[k]) for k in bin_)
                  if self.active_x[i]]
                 for bin_ in schema.bins[:nxb]]
        ybins = [[j for j in (int(y_ids[k - nx]) for k in bin_)
                  if self.active_y[j]]
                 for bin_ in schema.bins[nxb:]]
        bwx = [sum(self.wx[i] for i in bn) for bn in xbins]
        bwy = [sum(self.wy[j] for j in bn) for bn in ybins]
        if (bwx and max(bwx) > b + _EPS) \
                or (bwy and max(bwy) > self.q - b + _EPS):
            return False
        self._adopt_x2y_state(
            schema.algorithm, b, xbins, ybins,
            [(int(r[0]), int(r[1]) - nxb) for r in schema.reducers])
        self._recompute_lb()
        # replay inserts that arrived after capture, ascending per side
        for i in self.active_x_ids():
            if int(i) not in self.xbin_of \
                    and self._place("x", int(i)) is None:
                return False
        for j in self.active_y_ids():
            if int(j) not in self.ybin_of \
                    and self._place("y", int(j)) is None:
                return False
        self._recompute_lb()
        self._after_adopt()
        return True

    # --------------------------------------------------------------- queries
    def x_expanded(self) -> list[list[int]]:
        """reducer -> live X-table ids (dead-bin sides are empty)."""
        return [sorted(self.xbins[xb]) for xb, _ in self.reducers]

    def y_expanded(self) -> list[list[int]]:
        return [sorted(self.ybins[yb]) for _, yb in self.reducers]

    def plan(self) -> ReducerPlan:
        """The current full rectangular ReducerPlan (X ids into the full
        X table, Y ids into the full Y table), rebuilt lazily."""
        if self._plan is None:
            self._plan = build_x2y_plan_arrays(
                self.x_expanded(), self.y_expanded(),
                num_x=len(self.wx), num_y=len(self.wy),
                comm_cost=self.comm_cost,
                algorithm=f"stream:x2y(b={self.b:.3g})",
                lower_bound=self._lb,
                pad_reducers_to=self._pad["pad_reducers_to"],
                max_buckets=self._pad["max_buckets"])
        return self._plan

    def delta_shapes(self, max_shapes: int = 256) \
            -> list[tuple[int, int, int]]:
        """The bounded set of ``(padded rows, x width, y width)`` sub-plan
        shapes a repair-path edit can produce, read off the live bin
        structure (insert into a bin's slack dirties that bin's reducers,
        one slot wider on its side; a forced new bin dirties one fresh
        reducer per live opposite bin).  Signatures go through
        ``compact_x2y_plan`` itself, so the shapes
        ``StreamingExecutor.warm_delta_shapes_x2y`` pre-compiles at load
        time are exactly the edit-time shapes by construction."""
        if not self.reducers:
            return []
        shapes: set[tuple[int, int, int]] = set()
        seen: set[tuple] = set()

        def add(pairs: list[tuple[int, int]]) -> None:
            sig = tuple(sorted(pairs))
            if not pairs or sig in seen:
                return
            seen.add(sig)
            sub = compact_x2y_plan(
                [list(range(cx)) for cx, _ in pairs],
                [list(range(cy)) for _, cy in pairs],
                num_x=max(len(self.wx), 1), num_y=max(len(self.wy), 1),
                comm_cost=0.0, algorithm="warmup",
                max_buckets=self._pad["max_buckets"],
                pad_reducers_to=self._pad["pad_reducers_to"])
            for bk in sub.buckets:
                shapes.add((int(bk.idx.shape[0]), int(bk.width),
                            int(bk.ywidth)))

        live_x = [bx for bx in range(len(self.xbins))
                  if bx not in self.dead_xbins and self.xbins[bx]]
        live_y = [by for by in range(len(self.ybins))
                  if by not in self.dead_ybins and self.ybins[by]]
        for bx in live_x:       # insert_x into bx's slack
            add([(len(self.xbins[bx]) + 1,
                  len(self.ybins[self.reducers[r][1]]))
                 for r in self.reducers_of_xbin[bx]])
        for by in live_y:       # insert_y into by's slack
            add([(len(self.xbins[self.reducers[r][0]]),
                  len(self.ybins[by]) + 1)
                 for r in self.reducers_of_ybin[by]])
        # forced new bin: one fresh reducer per live opposite bin
        add([(1, len(self.ybins[by])) for by in live_y])
        add([(len(self.xbins[bx]), 1) for bx in live_x])
        return sorted(shapes)[:max_shapes]

    # ----------------------------------------------------------------- edits
    def insert_x(self, weight: float) -> PlanDelta:
        """Add one X input; ``delta.input_id`` is the new X-table id.
        Raises ``InfeasibleError`` (edit rolled back) when no schema can
        hold the grown profile."""
        i = len(self.wx)
        self.wx.append(float(weight))
        self.active_x.append(True)
        try:
            return self._edited("insert_x", i, self._place("x", i))
        except InfeasibleError:
            self.wx.pop()
            self.active_x.pop()
            self.stats["edits"] -= 1
            raise

    def insert_y(self, weight: float) -> PlanDelta:
        """Add one Y input; symmetric to :meth:`insert_x`."""
        j = len(self.wy)
        self.wy.append(float(weight))
        self.active_y.append(True)
        try:
            return self._edited("insert_y", j, self._place("y", j))
        except InfeasibleError:
            self.wy.pop()
            self.active_y.pop()
            self.stats["edits"] -= 1
            raise

    def delete_x(self, i: int) -> PlanDelta:
        """Tombstone X input ``i``; no recompute — the executor zeroes
        row i of the served (mx, my) matrix."""
        i = int(i)
        assert self.active_x[i], f"x input {i} is not live"
        self.active_x[i] = False
        b = self.xbin_of.pop(i)
        self.xbins[b].remove(i)
        self._bwx[b] -= self.wx[i]
        self.comm_cost -= self.wx[i] * len(self.reducers_of_xbin[b])
        if not self.xbins[b]:
            self.dead_xbins.add(b)
            self.stats["dead_bins"] += 1
        return self._edited("delete_x", i,
                            dict(dirty=[], touched_x=[i], touched_y=[]))

    def delete_y(self, j: int) -> PlanDelta:
        """Tombstone Y input ``j``; the executor zeroes column j."""
        j = int(j)
        assert self.active_y[j], f"y input {j} is not live"
        self.active_y[j] = False
        b = self.ybin_of.pop(j)
        self.ybins[b].remove(j)
        self._bwy[b] -= self.wy[j]
        self.comm_cost -= self.wy[j] * len(self.reducers_of_ybin[b])
        if not self.ybins[b]:
            self.dead_ybins.add(b)
            self.stats["dead_bins"] += 1
        return self._edited("delete_y", j,
                            dict(dirty=[], touched_x=[], touched_y=[j]))

    # ---------------------------------------------------------------- repair
    def _place(self, side: str, i: int) -> Optional[dict]:
        """Place the new input into the maintained bin structure; None
        when only a full re-plan can absorb it (over-capacity weight, or
        a one-sided bootstrap that must now pick a real split point)."""
        if side == "x":
            w, cap = self.wx[i], self.b
            bins, bw, dead = self.xbins, self._bwx, self.dead_xbins
            own_reds, bin_of = self.reducers_of_xbin, self.xbin_of
            other_bins, other_dead = self.ybins, self.dead_ybins
            other_bw, other_reds = self._bwy, self.reducers_of_ybin
            touched = dict(touched_x=[i], touched_y=[])
        else:
            w, cap = self.wy[i], self.q - self.b
            bins, bw, dead = self.ybins, self._bwy, self.dead_ybins
            own_reds, bin_of = self.reducers_of_ybin, self.ybin_of
            other_bins, other_dead = self.xbins, self.dead_xbins
            other_bw, other_reds = self._bwx, self.reducers_of_xbin
            touched = dict(touched_x=[], touched_y=[i])
        live_other = [b for b in range(len(other_bins))
                      if b not in other_dead and other_bins[b]]
        if live_other and w > cap + _EPS:
            return None                      # re-plan may move b itself
        if not live_other:
            # no cross pairs yet: repair only if the present side's
            # capacity (q on a one-sided bootstrap) holds w
            if w > (cap if self.reducers else self.q) + _EPS:
                return None
        # residual best-fit: fullest live bin whose slack holds w
        fits = np.flatnonzero(bw + w <= cap + _EPS) if len(bw) else \
            np.asarray([], np.int64)
        fits = np.asarray([b for b in fits if b not in dead and bins[b]],
                          dtype=np.int64)
        if len(fits):
            b = int(fits[np.argmax(bw[fits])])
            bins[b].append(i)
            bw[b] += w
            bin_of[i] = b
            self.comm_cost += w * len(own_reds[b])
            return dict(dirty=list(own_reds[b]), **touched)
        # no slack anywhere: capacity forces a new bin + one reducer per
        # live bin of the other side (coverage by construction)
        nb = len(bins)
        bins.append([i])
        if side == "x":
            self._bwx = np.append(self._bwx, w)
        else:
            self._bwy = np.append(self._bwy, w)
        bin_of[i] = nb
        own_reds[nb] = []
        self.stats["opened_bins"] += 1
        dirty = []
        for ob in live_other:
            r = len(self.reducers)
            self.reducers.append((nb, ob) if side == "x" else (ob, nb))
            dirty.append(r)
            own_reds[nb].append(r)
            other_reds[ob].append(r)
            self.comm_cost += w + float(other_bw[ob])
        self.stats["opened_reducers"] += len(dirty)
        return dict(dirty=dirty, **touched)

    # --------------------------------------------------------------- repack
    def _repack_pass(self, max_bins: int = 4) -> tuple[int, int]:
        """Local repacking, per side: drain the lightest live bins into
        other bins' slack (whole-bin try-then-commit), tombstone the
        emptied bins, then prune reducers with a dead side — they cover
        no cross pair but still ship their live side's weight.  A
        migrated input's target bin already meets every live opposite
        bin (the X2Y grid invariant), so no pair value changes."""
        moved = 0
        moved += self._drain_side("x", max_bins)
        moved += self._drain_side("y", max_bins)
        pruned = self._prune_dead_reducers()
        return moved, pruned

    def _drain_side(self, side: str, max_bins: int) -> int:
        if side == "x":
            bins, bw, dead = self.xbins, self._bwx, self.dead_xbins
            cap, weights = self.b, self.wx
            own_reds, bin_of = self.reducers_of_xbin, self.xbin_of
        else:
            bins, bw, dead = self.ybins, self._bwy, self.dead_ybins
            cap, weights = self.q - self.b, self.wy
            own_reds, bin_of = self.reducers_of_ybin, self.ybin_of
        moved = 0
        live = sorted((b for b in range(len(bins))
                       if b not in dead and bins[b]),
                      key=lambda b: bw[b])
        for src in live[:max_bins]:
            if src in dead or not bins[src]:
                continue
            targets = [b for b in range(len(bins))
                       if b != src and b not in dead and bins[b]]
            if not targets:
                continue
            loads = bw.copy()
            assign = []
            for i in sorted(bins[src], key=lambda j: -weights[j]):
                w = weights[i]
                best, best_load = -1, -1.0
                for b in targets:
                    if loads[b] + w <= cap + _EPS and loads[b] > best_load:
                        best, best_load = b, float(loads[b])
                if best < 0:
                    assign = None
                    break
                loads[best] += w
                assign.append((i, best))
            if assign is None:
                continue
            deg_src = len(own_reds[src])
            for i, tgt in assign:
                w = weights[i]
                bins[src].remove(i)
                bins[tgt].append(i)
                bin_of[i] = tgt
                bw[src] -= w
                bw[tgt] += w
                self.comm_cost += w * (len(own_reds[tgt]) - deg_src)
                moved += 1
            dead.add(src)
            self.stats["dead_bins"] += 1
        return moved

    def _prune_dead_reducers(self) -> int:
        """Drop reducers whose X or Y bin is dead — they cover no cross
        pair (X2Y coverage is full bipartite between *live* bins), so
        pruning is always safe and saves the live side's shipped weight.
        Reducer ids are re-compacted; only called on empty-dirty edits,
        so no outstanding delta references old ids."""
        keep: list[tuple[int, int]] = []
        pruned = 0
        for (xb, yb) in self.reducers:
            x_dead = xb in self.dead_xbins or not self.xbins[xb]
            y_dead = yb in self.dead_ybins or not self.ybins[yb]
            if x_dead or y_dead:
                self.comm_cost -= float(self._bwx[xb] + self._bwy[yb])
                pruned += 1
            else:
                keep.append((xb, yb))
        if pruned:
            self.reducers = keep
            self.reducers_of_xbin = {
                b: [] for b in range(len(self.xbins))}
            self.reducers_of_ybin = {
                b: [] for b in range(len(self.ybins))}
            for r, (xb, yb) in enumerate(self.reducers):
                self.reducers_of_xbin[xb].append(r)
                self.reducers_of_ybin[yb].append(r)
        return pruned

    # ------------------------------------------------------------- finishing
    def _patch_after_replan(self, kind: str, i: int) -> dict:
        """Compact patch re-serving the edited input under the freshly
        adopted plan: an inserted input's reducers cover all its cross
        pairs (the X2Y grid property); deletes just zero their
        row/column."""
        if kind == "insert_x":
            rows = sorted(self.reducers_of_xbin[self.xbin_of[i]]) \
                if i in self.xbin_of else []
            return dict(dirty=rows, touched_x=[i], touched_y=[])
        if kind == "insert_y":
            rows = sorted(self.reducers_of_ybin[self.ybin_of[i]]) \
                if i in self.ybin_of else []
            return dict(dirty=rows, touched_x=[], touched_y=[i])
        if kind == "delete_x":
            return dict(dirty=[], touched_x=[i], touched_y=[])
        return dict(dirty=[], touched_x=[], touched_y=[i])

    def _finish_delta(self, kind: str, i: int, repair: dict,
                      extra_meta: Optional[dict] = None) -> PlanDelta:
        dirty = np.asarray(sorted(repair["dirty"]), dtype=np.int64)
        sub = None
        xs_map = {int(r): sorted(self.xbins[self.reducers[int(r)][0]])
                  for r in dirty}
        ys_map = {int(r): sorted(self.ybins[self.reducers[int(r)][1]])
                  for r in dirty}
        if len(dirty):
            xs = [xs_map[int(r)] for r in dirty]
            ys = [ys_map[int(r)] for r in dirty]
            comm = float(
                sum(self.wx[a] for row in xs for a in row)
                + sum(self.wy[a] for row in ys for a in row))
            sub = compact_x2y_plan(
                xs, ys, num_x=len(self.wx), num_y=len(self.wy),
                comm_cost=comm, algorithm=f"stream-delta:{kind}",
                max_buckets=self._pad["max_buckets"],
                pad_reducers_to=self._pad["pad_reducers_to"])
        meta = {"workload": "x2y", "algorithm": self.algorithm,
                "achievable_gap": float(self.achievable_gap),
                "touched_x": [int(a) for a in repair["touched_x"]],
                "touched_y": [int(a) for a in repair["touched_y"]]}
        if extra_meta:
            meta.update(extra_meta)
        delta = PlanDelta(
            kind=kind, input_id=i,
            touched_inputs=np.asarray(
                repair["touched_x"] + repair["touched_y"], dtype=np.int64),
            dirty_rows=dirty, sub_plan=sub, full_replan=False,
            num_reducers=self.num_reducers, comm_cost=self.comm_cost,
            lower_bound=self._lb, gap_drift=self.gap_drift,
            meta=meta)
        if self.check:
            delta.verify_x2y(xs_map, ys_map, self.active_x_ids(),
                             self.active_y_ids())
        return delta
