"""IncrementalPlanner: online maintenance of a mapping schema (DESIGN.md 1f).

The registry planner (``repro_torch.core.plan_a2a``) treats a plan as a pure
function of the weight profile: any change to the input list is a full
re-plan and a full re-shuffle.  Afrati et al. ("Upper and Lower Bounds on
the Cost of a Map-Reduce Computation") frame communication as the quantity
to bound *per unit of useful work* — and a one-input edit does O(m) useful
work (m new/removed pairs), not O(m^2).  This module makes plans mutable
state: ``insert`` / ``delete`` / ``reweight`` repair the maintained schema
locally and emit a :class:`~repro_torch.stream.delta.PlanDelta` naming exactly
the reducers whose blocks changed.

Repair strategy (the bin-packing family, ``binpack-k*`` and ``single``):

  insert(w)   — residual FFD/best-fit: place the new input into the
                fullest existing bin whose slack still holds it (every
                reducer containing that bin stays <= q because its bins
                stay <= q/k).  Only when no bin has slack does the planner
                open a new bin and new reducers — one reducer per (k-1)
                live bins, pairing the new bin against every live bin, so
                A2A coverage is restored by construction (capacity forces
                the new reducers: (k-1) * q/k + w <= q).
  delete(i)   — drop the input from its bin; an emptied bin is tombstoned
                (never packed into again — a revived bin would hold inputs
                that were never paired against bins opened while it was
                empty).  No recompute: surviving pair values are
                unchanged, the executor just zeroes row/column i.
  reweight    — in-place when the bin's slack absorbs the change (a pure
                planning-state update: feature rows are untouched, so no
                reducer is dirty), else delete + re-insert of the same id.

The maintained invariant — every pair of live bins meets at >= 1 reducer,
and every live bin sits in >= 1 reducer — is exactly A2A coverage, checked
by ``snapshot().validate('a2a')`` in the conformance suite and by
``PlanDelta.verify`` after every edit when ``check=True``.

Repairs drift; the re-plan trigger, background repacking, and the
double-buffered re-plan live in :class:`~repro_torch.stream.base.
StreamPlannerBase` (shared with the X2Y planner).  Two bounds are
maintained per edit: Thm 8 (``s^2/q`` — the theorem bound conformance
ships against) and the binpack strategy bound of Thm 9, which is what a
fresh ``binpack-k`` plan can actually reach; triggers compare against the
achievable one.  A full re-plan adopts the fresh schema as planning state
but emits only a compact *patch* delta (pair values are plan-independent),
and the superseded profile's ``PLAN_CACHE`` entry is dropped via
``PlanCache.invalidate`` so a churning stream does not evict live
request-serving profiles.  Schema shapes the repair rules do not
understand (hybrid Algorithm 5, the big-input path — both use overlapping
bins) re-plan on every edit; this is counted, never wrong.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.bounds import (
    a2a_binpack_comm_lower_bound,
    a2a_comm_lower_bound,
)
from repro_torch.core.planner import plan_a2a
from repro_torch.core.schema import InfeasibleError, MappingSchema
from repro_torch.core.strategies import PLAN_CACHE, PlanCache
from repro_torch.mapreduce.engine import ReducerPlan, build_plan

from .base import StreamPlannerBase, _EPS
from .delta import PlanDelta, compact_plan

__all__ = ["IncrementalPlanner"]


class IncrementalPlanner(StreamPlannerBase):
    """Mutable mapping-schema state over a growing/shrinking input table.

    Input ids are stable full-table positions: ``insert`` appends a new id
    and never reuses a deleted one, so the serving tier can keep feature
    rows in a flat table with tombstones.  ``plan()`` returns the current
    full :class:`ReducerPlan` (ids into the full table); ``snapshot()``
    returns a compacted :class:`MappingSchema` over the live inputs for
    validation and cold re-plan comparison.
    """

    def __init__(self, q: float, weights: Sequence[float] = (), *,
                 method: str = "auto", replan_drift: float = 1.5,
                 max_gap: Optional[float] = 2.0,
                 repack_gap: Optional[float] = None,
                 background: bool = False,
                 pad_reducers_to: int = 1, pad_slots_to: int = 1,
                 max_buckets: int = 8, check: bool = True):
        super().__init__(replan_drift=replan_drift, max_gap=max_gap,
                         repack_gap=repack_gap, background=background,
                         check=check)
        self.q = float(q)
        self.method = method
        self._pad = dict(pad_reducers_to=pad_reducers_to,
                         pad_slots_to=pad_slots_to, max_buckets=max_buckets)
        self.weights: list[float] = [float(w) for w in weights]
        self.active: list[bool] = [True] * len(self.weights)
        self._cache_key: Optional[tuple] = None
        self._adopt_replan()

    # ------------------------------------------------------------ properties
    @property
    def num_active(self) -> int:
        return int(np.sum(self.active))

    @property
    def num_reducers(self) -> int:
        return len(self.reducers)

    def active_ids(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    def active_weights(self) -> np.ndarray:
        ids = self.active_ids()
        return np.asarray([self.weights[i] for i in ids], dtype=np.float64)

    # ---------------------------------------------------------------- bounds
    def _recompute_lb(self) -> None:
        """Both instance bounds for the live profile: Thm 8 (theorem) and
        the strategy-level achievable reference of the schema family in
        force (Thm 9 for binpack-k; the single schema ships exactly s)."""
        w = self.active_weights()
        if not len(w):
            self._lb = self._lb_ach = 0.0
            return
        self._lb = a2a_comm_lower_bound(w, self.q)
        ach = self._lb
        if self.kind == "binpack" and self.k >= 1:
            ach = max(ach, a2a_binpack_comm_lower_bound(w, self.q, self.k))
        elif self.kind == "single":
            ach = max(ach, float(np.sum(w)))
        self._lb_ach = ach

    # -------------------------------------------------------------- adoption
    def _adopt_replan(self) -> None:
        """Full re-plan of the live profile through ``PLAN_CACHE``; adopt
        the winning schema as the new mutable state."""
        ids = self.active_ids()
        w = self.active_weights()
        old_key = self._cache_key
        if len(ids) == 0:
            schema = MappingSchema(w, self.q, [], [], algorithm="empty",
                                   lower_bound=0.0)
            self._cache_key = None
        else:
            schema = plan_a2a(w, self.q, self.method)   # may raise: the
            # planner state (including old_key) is untouched until it wins
            order = np.argsort(-w, kind="stable")
            self._cache_key = PlanCache.key(w[order], self.q, self.method)
        if old_key is not None and old_key != self._cache_key:
            # this stream has permanently moved off its previous profile
            PLAN_CACHE.invalidate(old_key)
        # bins from _remap_schema are fresh lists; the outer reducers list
        # is shallow-copied so appends stay private, and existing inner
        # reducer lists are never mutated (repairs touch bins, or append
        # brand-new reducer lists) — the PLAN_CACHE entry stays clean.
        self._adopt_schema_state(
            schema, [[int(ids[i]) for i in b] for b in schema.bins],
            list(schema.reducers))
        self.comm_cost = (schema.communication_cost() if self.overlapping
                          else self._comm_from_state())
        self._recompute_lb()
        self._after_adopt()

    def _adopt_schema_state(self, schema: MappingSchema,
                            bins: list[list[int]],
                            reducers: list[list[int]]) -> None:
        """Install a schema's shape (kind/k/bin_size) and bin/reducer
        structure over full-table ids; shared by the synchronous adopt and
        the background swap."""
        self.algorithm = schema.algorithm
        self.overlapping = bool(schema.meta.get("bins_overlap", False))
        self.bins = bins
        self.reducers = reducers
        self.dead_bins: set[int] = {b for b, mem in enumerate(bins)
                                    if not mem}
        n_live = sum(1 for b in bins if b) or (1 if self.num_active else 0)
        if schema.algorithm == "single" and self.num_active > 0:
            self.kind = "single"
            self.k, self.bin_size = 1, self.q
        elif schema.algorithm.startswith("binpack-k") \
                and not self.overlapping:
            self.kind = "binpack"
            self.k = int(schema.meta["k"])
            self.bin_size = float(schema.meta["bin_size"])
        elif n_live == 0:
            self.kind = "empty"
            self.k, self.bin_size = 0, 0.0
        else:
            self.kind = "opaque"
            self.k, self.bin_size = 0, 0.0
        self._bw = np.asarray(
            [sum(self.weights[i] for i in b) for b in self.bins],
            dtype=np.float64)
        self.bin_of = {i: b for b, members in enumerate(self.bins)
                       for i in members}
        self.reducers_of_bin: dict[int, list[int]] = {
            b: [] for b in range(len(self.bins))}
        for r, red in enumerate(self.reducers):
            for b in red:
                self.reducers_of_bin[b].append(r)
        self._plan: Optional[ReducerPlan] = None

    def _comm_from_state(self) -> float:
        """Disjoint-bin communication cost: sum of member bin weights over
        reducers (dead bins weigh 0)."""
        if not self.reducers:
            return 0.0
        flat = np.fromiter((b for red in self.reducers for b in red),
                           dtype=np.int64,
                           count=sum(len(r) for r in self.reducers))
        return float(np.sum(self._bw[flat])) if len(flat) else 0.0

    # --------------------------------------------------- background re-plan
    def _capture_profile(self):
        return self.active_ids().copy(), self.active_weights().copy()

    def _background_plan(self, payload):
        ids, w = payload
        # no PLAN_CACHE traffic from the daemon thread: the captured
        # profile is transient and must not evict live serving entries
        return ids, plan_a2a(w, self.q, self.method, use_cache=False)

    def _swap_in(self, result) -> bool:
        """Adopt a background plan built for a captured profile onto the
        *current* one: deletes since capture are filtered out of its bins,
        inserts are replayed through the repair rules, and reweights are
        re-validated against bin capacity.  False (state is then rebuilt
        by a synchronous re-plan) when the plan went stale."""
        ids, schema = result
        if schema.meta.get("bins_overlap", False):
            return False            # no local repair rules to replay with
        bins = [[i for i in (int(ids[j]) for j in b) if self.active[i]]
                for b in schema.bins]
        bw = np.asarray([sum(self.weights[i] for i in b) for b in bins],
                        dtype=np.float64)
        if schema.algorithm == "single":
            cap = self.q
            total = float(np.sum(self.active_weights()))
            if total > cap + _EPS:
                return False
        elif schema.algorithm.startswith("binpack-k"):
            cap = float(schema.meta["bin_size"])
            if len(bw) and float(np.max(bw, initial=0.0)) > cap + _EPS:
                return False        # an interleaved reweight overflowed
        else:
            return False
        old_key = self._cache_key
        self._cache_key = None      # planned off-cache for a stale profile
        if old_key is not None:
            PLAN_CACHE.invalidate(old_key)
        self._adopt_schema_state(schema, bins, list(schema.reducers))
        self.comm_cost = self._comm_from_state()
        self._recompute_lb()
        # replay inserts that arrived after capture (ascending = insertion
        # order); a failed placement leaves a half-adopted-but-consistent
        # structure that the caller's synchronous re-plan rebuilds anyway
        placed = set(self.bin_of)
        for i in self.active_ids():
            if int(i) in placed:
                continue
            if self._repair_place(int(i)) is None:
                return False
        self._recompute_lb()
        self._after_adopt()
        return True

    # --------------------------------------------------------------- queries
    def expanded(self) -> list[list[int]]:
        """reducer -> sorted live full-table input ids."""
        return [self.expand_row(r) for r in range(len(self.reducers))]

    def expand_row(self, r: int) -> list[int]:
        ids: set[int] = set()
        for b in self.reducers[r]:
            ids.update(self.bins[b])
        return sorted(ids)

    def plan(self) -> ReducerPlan:
        """The current full ReducerPlan (idx/mask into the full table),
        rebuilt lazily after edits."""
        if self._plan is None:
            w_full = np.asarray(
                [w if a else 0.0
                 for w, a in zip(self.weights, self.active)],
                dtype=np.float64)
            schema = MappingSchema(
                weights=w_full, q=self.q, bins=self.bins,
                reducers=self.reducers,
                algorithm=f"stream:{self.algorithm}",
                meta={"partial_cover": True,
                      "bins_overlap": self.overlapping},
                lower_bound=self._lb)
            self._plan = build_plan(schema, **self._pad)
        return self._plan

    def snapshot(self) -> MappingSchema:
        """Compacted MappingSchema over the live inputs (ids remapped to
        0..n-1) — what the conformance suite validates and what a cold
        re-plan is compared against."""
        ids = self.active_ids()
        remap = {int(g): i for i, g in enumerate(ids)}
        return MappingSchema(
            weights=self.active_weights(), q=self.q,
            bins=[[remap[i] for i in b] for b in self.bins],
            reducers=[list(r) for r in self.reducers],
            algorithm=f"stream:{self.algorithm}",
            meta={"bins_overlap": self.overlapping},
            lower_bound=self._lb)

    def delta_shapes(self, max_shapes: int = 256) -> list[tuple[int, int]]:
        """The bounded set of ``(padded rows, bucket width)`` sub-plan
        shapes a repair-path edit can produce, read off the live bin
        structure: an insert into bin ``b``'s slack dirties
        ``reducers_of_bin[b]`` (each reducer one slot wider), a forced new
        bin dirties ``ceil(B / (k-1))`` pairing reducers.  Each candidate
        dirty-set size signature is pushed through ``compact_plan`` itself
        (synthetic ids — only the lengths shape the program), so the
        shapes ``StreamingExecutor.warm_delta_shapes`` pre-compiles at
        load time are exactly the edit-time shapes by construction."""
        if self.kind not in ("binpack", "single"):
            return []
        shapes: set[tuple[int, int]] = set()
        seen: set[tuple] = set()

        def add(counts: list[int]) -> None:
            sig = tuple(sorted(counts))
            if not counts or sig in seen:
                return
            seen.add(sig)
            sub = compact_plan(
                [list(range(c)) for c in counts], comm_cost=0.0,
                algorithm="warmup",
                max_buckets=self._pad["max_buckets"],
                pad_reducers_to=self._pad["pad_reducers_to"])
            for b in sub.buckets:
                shapes.add((int(b.idx.shape[0]), int(b.width)))

        if self.kind == "single":
            add([self.num_active + 1])
        else:
            # disjoint bins: reducer size == sum of member bin sizes
            sizes = [sum(len(self.bins[b]) for b in red)
                     for red in self.reducers]
            live = [b for b in range(len(self.bins))
                    if b not in self.dead_bins and self.bins[b]]
            for b in live:
                add([sizes[r] + 1 for r in self.reducers_of_bin[b]])
            group = max(self.k - 1, 1)
            add([1 + sum(len(self.bins[b]) for b in live[lo: lo + group])
                 for lo in range(0, len(live), group)])
        return sorted(shapes)[:max_shapes]

    # ----------------------------------------------------------------- edits
    def insert(self, weight: float) -> PlanDelta:
        """Add one input; returns the delta (``delta.input_id`` is the new
        full-table id).  Raises ``InfeasibleError`` (edit rolled back) when
        no schema can hold the grown profile."""
        i = len(self.weights)
        self.weights.append(float(weight))
        self.active.append(True)
        try:
            return self._edited("insert", i, self._repair_place(i))
        except InfeasibleError:
            self.weights.pop()
            self.active.pop()
            self.stats["edits"] -= 1             # the edit never happened
            raise

    def delete(self, i: int) -> PlanDelta:
        """Tombstone input ``i``; its pairs need no recompute — the
        executor zeroes row/column i of the served matrix."""
        i = int(i)
        assert self.active[i], f"input {i} is not live"
        self.active[i] = False
        if self.kind in ("opaque", "empty"):
            return self._edited("delete", i, None)
        b = self.bin_of.pop(i)
        self.bins[b].remove(i)
        self._bw[b] -= self.weights[i]
        self.comm_cost -= self.weights[i] * len(self.reducers_of_bin[b])
        if not self.bins[b]:
            self.dead_bins.add(b)
            self.stats["dead_bins"] += 1
        return self._edited(
            "delete", i,
            dict(dirty=[], touched=[i], repaired=True))

    def reweight(self, i: int, weight: float) -> PlanDelta:
        """Change input ``i``'s size.  Feature rows are untouched, so no
        reducer block changes value — only planning state moves."""
        i = int(i)
        assert self.active[i], f"input {i} is not live"
        old = self.weights[i]
        self.weights[i] = float(weight)
        try:
            return self._reweight_placed(i, old, weight)
        except InfeasibleError:
            # roll back to a consistent pre-edit state (the pre-edit
            # profile was feasible, so this re-plan cannot raise)
            self.weights[i] = old
            self._adopt_replan()
            self.stats["edits"] -= 1             # the edit never happened
            raise

    def _reweight_placed(self, i: int, old: float,
                         weight: float) -> PlanDelta:
        if self.kind in ("opaque", "empty"):
            return self._edited("reweight", i, None)
        b = self.bin_of[i]
        # in-place when the capacity constraint still holds: the bin's
        # slack for binpack, the whole reducer's q for the single schema
        fits = (float(np.sum(self.active_weights())) <= self.q + _EPS
                if self.kind == "single"
                else self._bw[b] - old + weight <= self.bin_size + _EPS)
        if fits:
            self._bw[b] += weight - old
            self.comm_cost += (weight - old) * len(self.reducers_of_bin[b])
            return self._edited(
                "reweight", i, dict(dirty=[], touched=[], repaired=True))
        # move: out of the old bin, re-place like an insert (same id)
        self.bin_of.pop(i)
        self.bins[b].remove(i)
        self._bw[b] -= old
        self.comm_cost -= old * len(self.reducers_of_bin[b])
        if not self.bins[b]:
            self.dead_bins.add(b)
            self.stats["dead_bins"] += 1
        repair = self._repair_place(i)
        if repair is not None:
            # values of every pair are unchanged (feature rows untouched);
            # the opened reducers only need computing on the next cold build
            repair = dict(repair, touched=[], dirty=[], moved=True)
        return self._edited("reweight", i, repair)

    # ---------------------------------------------------------------- repair
    def _repair_place(self, i: int) -> Optional[dict]:
        """Place input ``i`` (already weighted) into the maintained
        structure; None when only a full re-plan can absorb it."""
        w = self.weights[i]
        if self.kind == "single":
            live = self.active_weights()
            if float(np.sum(live)) > self.q + _EPS:
                return None
            nb = self._open_bin(i)
            if not self.reducers:
                self.reducers.append([nb])
                self.reducers_of_bin[nb] = [0]
                self.stats["opened_reducers"] += 1
            else:
                self.reducers[0] = self.reducers[0] + [nb]
                self.reducers_of_bin[nb] = [0]
            self.comm_cost += w
            return dict(dirty=[0], touched=[i], repaired=True)
        if self.kind != "binpack" or w > self.bin_size + _EPS:
            return None
        # residual best-fit: fullest live bin whose slack holds w
        fits = np.flatnonzero(self._bw + w <= self.bin_size + _EPS)
        fits = np.asarray([b for b in fits if b not in self.dead_bins
                           and self.bins[b]], dtype=np.int64)
        if len(fits):
            b = int(fits[np.argmax(self._bw[fits])])
            self.bins[b].append(i)
            self._bw[b] += w
            self.bin_of[i] = b
            self.comm_cost += w * len(self.reducers_of_bin[b])
            return dict(dirty=list(self.reducers_of_bin[b]), touched=[i],
                        repaired=True)
        # no slack anywhere: capacity forces a new bin + pairing reducers
        nb = self._open_bin(i)
        live = [b for b in range(len(self.bins))
                if b != nb and b not in self.dead_bins and self.bins[b]]
        dirty = []
        group = max(self.k - 1, 1)
        for lo in range(0, len(live), group):
            chunk = live[lo: lo + group]
            r = len(self.reducers)
            self.reducers.append([nb] + chunk)
            dirty.append(r)
            self.reducers_of_bin[nb].append(r)
            for b in chunk:
                self.reducers_of_bin[b].append(r)
            self.comm_cost += w + float(np.sum(self._bw[chunk]))
        if not live:                         # first live bin: solo reducer
            r = len(self.reducers)
            self.reducers.append([nb])
            dirty.append(r)
            self.reducers_of_bin[nb].append(r)
            self.comm_cost += w
        self.stats["opened_reducers"] += len(dirty)
        return dict(dirty=dirty, touched=[i], repaired=True)

    def _open_bin(self, i: int) -> int:
        nb = len(self.bins)
        self.bins.append([i])
        self._bw = np.append(self._bw, self.weights[i])
        self.bin_of[i] = nb
        self.reducers_of_bin[nb] = []
        self.stats["opened_bins"] += 1
        return nb

    # --------------------------------------------------------------- repack
    def _repack_pass(self, max_bins: int = 4) -> tuple[int, int]:
        """Local repacking: drain the lightest live bins into other bins'
        slack (whole-bin try-then-commit), tombstone the emptied bins,
        then prune reducers left pairing nothing.  Pure planning-state
        surgery — a migrated input's new bin already meets every live bin
        (the A2A invariant), so no pair value changes and no reducer needs
        recomputing; the communication ledger just shrinks."""
        if self.kind != "binpack":
            return 0, 0
        moved = 0
        live = sorted((b for b in range(len(self.bins))
                       if b not in self.dead_bins and self.bins[b]),
                      key=lambda b: self._bw[b])
        for src in live[:max_bins]:
            if src in self.dead_bins or not self.bins[src]:
                continue        # drained into earlier in this pass
            assign = self._plan_drain(src)
            if assign is None:
                continue
            deg_src = len(self.reducers_of_bin[src])
            for i, tgt in assign:
                w = self.weights[i]
                self.bins[src].remove(i)
                self.bins[tgt].append(i)
                self.bin_of[i] = tgt
                self._bw[src] -= w
                self._bw[tgt] += w
                self.comm_cost += w * (len(self.reducers_of_bin[tgt])
                                       - deg_src)
                moved += 1
            self.dead_bins.add(src)
            self.stats["dead_bins"] += 1
        pruned = self._prune_dead_reducers()
        return moved, pruned

    def _plan_drain(self, src: int) -> Optional[list[tuple[int, int]]]:
        """Assignment draining bin ``src`` entirely into other live bins'
        slack (heaviest member first, fullest target that fits), or None
        when the whole bin does not fit — partial drains never retire a
        bin, so they are not worth the ledger churn."""
        loads = self._bw.copy()
        targets = [b for b in range(len(self.bins))
                   if b != src and b not in self.dead_bins and self.bins[b]]
        if not targets:
            return None
        assign = []
        for i in sorted(self.bins[src], key=lambda j: -self.weights[j]):
            w = self.weights[i]
            best, best_load = -1, -1.0
            for b in targets:
                if loads[b] + w <= self.bin_size + _EPS \
                        and loads[b] > best_load:
                    best, best_load = b, float(loads[b])
            if best < 0:
                return None
            loads[best] += w
            assign.append((i, best))
        return assign

    def _prune_dead_reducers(self) -> int:
        """Drop reducers whose member bins include <= 1 live bin — they
        pair nothing — provided the surviving bin keeps >= 1 other reducer
        (every live bin must stay in a reducer so its internal pairs stay
        covered).  Reducer ids are re-compacted; only called on
        empty-dirty edits, so no outstanding delta references old ids."""
        deg = {b: len(rs) for b, rs in self.reducers_of_bin.items()}
        keep: list[list[int]] = []
        pruned = 0
        for red in self.reducers:
            mem = [b for b in red
                   if b not in self.dead_bins and self.bins[b]]
            if len(mem) == 0 or (len(mem) == 1 and deg[mem[0]] > 1):
                self.comm_cost -= float(sum(self._bw[b] for b in mem))
                for b in red:
                    deg[b] -= 1
                pruned += 1
            else:
                keep.append(red)
        if pruned:
            self.reducers = keep
            self.reducers_of_bin = {b: [] for b in range(len(self.bins))}
            for r, red in enumerate(self.reducers):
                for b in red:
                    self.reducers_of_bin[b].append(r)
        return pruned

    # ------------------------------------------------------------- finishing
    def _patch_after_replan(self, kind: str, i: int) -> dict:
        """The compact patch that re-serves the edited input under the
        freshly adopted plan: inserts dirty every reducer containing the
        new input (they cover all its pairs — the A2A property), deletes
        just zero their row/column, reweights move no feature rows."""
        if kind == "insert":
            if not self.overlapping and i in self.bin_of:
                rows = sorted(self.reducers_of_bin[self.bin_of[i]])
            else:   # overlapping bins: scan for membership
                rows = sorted(r for r, red in enumerate(self.reducers)
                              if any(i in self.bins[b] for b in red))
            return dict(dirty=rows, touched=[i], repaired=True)
        if kind == "delete":
            return dict(dirty=[], touched=[i], repaired=True)
        return dict(dirty=[], touched=[], repaired=True)     # reweight

    def _finish_delta(self, kind: str, i: int, repair: dict,
                      extra_meta: Optional[dict] = None) -> PlanDelta:
        dirty = np.asarray(sorted(repair["dirty"]), dtype=np.int64)
        sub = None
        # expand only the dirty rows: per-edit host work stays O(dirty),
        # not O(R) (the full expansion is only needed to re-verify a
        # reweight *move*, which is the rare repair)
        rows_map = {int(r): self.expand_row(int(r)) for r in dirty}
        if len(dirty):
            rows = [rows_map[int(r)] for r in dirty]
            comm = float(sum(self.weights[j] for ids in rows for j in ids))
            sub = compact_plan(
                rows, comm_cost=comm, algorithm=f"stream-delta:{kind}",
                max_buckets=self._pad["max_buckets"],
                pad_reducers_to=self._pad["pad_reducers_to"])
        meta = {"algorithm": self.algorithm,
                "achievable_gap": float(self.achievable_gap)}
        if extra_meta:
            meta.update(extra_meta)
        delta = PlanDelta(
            kind=kind, input_id=i,
            touched_inputs=np.asarray(repair["touched"], dtype=np.int64),
            dirty_rows=dirty, sub_plan=sub, full_replan=False,
            num_reducers=self.num_reducers, comm_cost=self.comm_cost,
            lower_bound=self._lb, gap_drift=self.gap_drift,
            meta=meta)
        if self.check:
            if kind == "reweight":
                # an in-place reweight changes no structure: nothing to
                # re-verify; a move needs the full expansion (rare repair)
                if repair.get("moved"):
                    delta.verify(self.expanded(), self.active_ids())
            else:
                delta.verify(rows_map, self.active_ids())
        return delta
