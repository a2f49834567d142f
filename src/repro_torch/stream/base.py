"""StreamPlannerBase: the shared edit-finishing driver for incremental
planners (DESIGN.md 1f).

``IncrementalPlanner`` (all-pairs) and ``IncrementalX2YPlanner``
(rectangular) used to copy-paste the ``_edited`` finishing logic — and the
copies drifted apart exactly where it mattered: the re-plan trigger.  Both
measured gap drift *relative* to the gap at the last full re-plan, so a
schema that started at a mediocre gap never re-planned no matter how bad
it got (BENCH_stream: gap 2.05x, ``drift_replans: 0``).  This base class
owns the trigger so the two planners cannot diverge again, and fixes it in
three ways:

* **Unified lower-bound recomputation.**  Every edit recomputes the
  instance bounds *first*, on every path (repair, drift re-plan, forced
  re-plan), so reported ``gap_drift`` telemetry is always measured against
  the post-edit profile.  Two bounds are tracked: the paper's theorem
  bound (``lower_bound`` — Thm 8 ``s^2/q`` for all-pairs, Thm 25 for X2Y;
  what conformance checks ship against) and an *achievable* reference
  (``_lb_ach`` — the strategy-level bound of the maintained schema family,
  e.g. Thm 9 for binpack-k).  The theorem bound can sit a factor ~2 above
  what any covering schema can reach, which is how the old relative
  trigger died; triggers use the achievable gap.

* **Absolute ``max_gap`` ceiling.**  Alongside the relative
  ``replan_drift`` check, a re-plan fires whenever the achievable gap
  exceeds ``max(max_gap, base * 1.05)`` — the ``base * 1.05`` floor keeps
  a profile whose *fresh* plan already sits above ``max_gap`` from
  re-planning on every edit.

* **Background local repacking.**  When the achievable gap exceeds the
  soft ``repack_gap`` threshold (but not the re-plan ceiling), the planner
  migrates inputs out of underfilled bins and prunes reducers whose member
  bins died — shaving gap with pure planning-state surgery, no recompute
  (pair values are plan-independent).  Runs only on edits with an empty
  dirty set (delete / in-place reweight), so no outstanding delta
  references re-compacted reducer ids.

Re-plans are **double-buffered**: pair values do not depend on the plan
that produced them, so adopting a fresh schema never requires rebuilding
the served matrix — the re-plan delta is a compact *patch* (the edited
input's rows in the new plan) with ``full_replan=False``, and the
executor's 3.8s cold build is paid exactly once, at load time.  With
``background=True`` the re-plan itself moves off the edit path: a daemon
thread plans the captured profile while edits keep repairing the old
schema, and the finished plan is swapped in atomically on a later edit
(deletes since capture are filtered out of its bins, inserts are replayed
through the repair rules, reweights are re-validated against bin
capacity; any violation falls back to a synchronous re-plan).
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.obs import EVENTS as _OBS_EVENTS
from repro_torch.obs import REGISTRY as _OBS_REGISTRY

from .delta import PlanDelta

__all__ = ["StreamPlannerBase"]

_EPS = 1e-12

# a re-plan must beat the fresh plan's own achievable gap by this margin
# before the absolute ceiling may fire again — otherwise a profile whose
# best-known plan sits above max_gap would re-plan on every edit
_CEILING_MARGIN = 1.05
# same idea for the soft repack threshold
_REPACK_MARGIN = 1.02


class StreamPlannerBase:
    """Shared trigger/finishing driver for incremental stream planners.

    Subclasses implement the schema family (state, repair rules, adoption)
    and plug into the driver through these hooks:

    ``_recompute_lb()``          — set ``self._lb`` (theorem bound) and
                                   ``self._lb_ach`` (achievable reference)
                                   for the live profile.
    ``_adopt_replan()``          — synchronous full re-plan + adoption;
                                   must end with ``self._after_adopt()``.
    ``_finish_delta(kind, i, repair, extra_meta=None)``
                                 — build the repair-path PlanDelta.
    ``_patch_after_replan(kind, i)``
                                 — repair-dict describing the compact
                                   patch that re-serves the edited input
                                   under the freshly adopted plan.
    ``_repack_pass()``           — local repacking; returns
                                   ``(migrations, pruned_reducers)``.
    ``_capture_profile()``       — snapshot payload for the background
                                   planner thread.
    ``_background_plan(payload)`` — plan the captured profile (runs on the
                                   daemon thread; must not touch planner
                                   state).
    ``_swap_in(result)``         — adopt a background plan onto the
                                   *current* profile; False when the plan
                                   went stale (caller re-plans sync).
    """

    def __init__(self, *, replan_drift: float = 1.5,
                 max_gap: Optional[float] = 2.0,
                 repack_gap: Optional[float] = None,
                 background: bool = False, check: bool = True):
        assert replan_drift >= 1.0, replan_drift
        assert max_gap is None or max_gap >= 1.0, max_gap
        assert repack_gap is None or repack_gap >= 1.0, repack_gap
        self.replan_drift = float(replan_drift)
        self.max_gap = None if max_gap is None else float(max_gap)
        self.repack_gap = None if repack_gap is None else float(repack_gap)
        self.background = bool(background)
        self.check = check
        self._bg: Optional[dict] = None
        self._lb = 0.0
        self._lb_ach = 0.0
        self._base_gap = 1.0
        self._base_ach = 1.0
        self.stats = {
            "edits": 0, "repairs": 0, "replans": 0, "drift_replans": 0,
            "opened_bins": 0, "opened_reducers": 0, "dead_bins": 0,
            "repacks": 0, "migrations": 0, "pruned_reducers": 0,
            "swaps": 0,
        }

    # ------------------------------------------------------------ gap state
    @property
    def lower_bound(self) -> float:
        """The paper's theorem lower bound for the live profile (what
        conformance ships against)."""
        return self._lb

    @property
    def optimality_gap(self) -> float:
        return self.comm_cost / self._lb if self._lb > 0 else 1.0

    @property
    def achievable_gap(self) -> float:
        """Maintained cost over the *achievable* reference bound — the
        strategy-level bound of the schema family actually in force.  The
        theorem bound can be ~2x loose (binpack-k2 vs Thm 8), which is
        what killed the old relative-only trigger; ceilings use this."""
        return self.comm_cost / self._lb_ach if self._lb_ach > 0 else 1.0

    @property
    def gap_drift(self) -> float:
        """Current gap over the gap at the last full re-plan (>= ~1)."""
        return self.optimality_gap / max(self._base_gap, _EPS)

    def _gap_ceiling(self) -> float:
        if self.max_gap is None:
            return float("inf")
        return max(self.max_gap, self._base_ach * _CEILING_MARGIN)

    def _repack_threshold(self) -> float:
        if self.repack_gap is None:
            return float("inf")
        return max(self.repack_gap, self._base_ach * _REPACK_MARGIN)

    def _bump(self, key: str, by: int = 1) -> None:
        """Increment a planner stat and mirror it into the obs registry as
        ``stream.<key>{planner=<class>}``."""
        self.stats[key] = self.stats.get(key, 0) + by
        _OBS_REGISTRY.counter(f"stream.{key}",
                              planner=type(self).__name__).inc(by)

    def _after_adopt(self) -> None:
        """Re-anchor the drift baselines after any adoption (sync re-plan
        or background swap) — called by subclasses at the end of
        ``_adopt_replan`` and by the swap path."""
        self._base_gap = self.optimality_gap
        self._base_ach = self.achievable_gap
        self._plan = None
        self._bump("replans")

    # ----------------------------------------------------- finishing driver
    def _edited(self, kind: str, i: int,
                repair: Optional[dict]) -> PlanDelta:
        self._bump("edits")
        self._plan = None
        # a finished background re-plan lands *before* this edit is
        # served: the edit's repair was applied to the superseded schema,
        # so its delta becomes the swap patch for the new one
        if repair is not None and self._bg is not None \
                and self._bg["done"].is_set():
            if self._finish_background():
                self._recompute_lb()
                return self._replan_patch(kind, i, swap=True)
        self._recompute_lb()
        drift, ach = self.gap_drift, self.achievable_gap
        trigger = {"gap_drift": drift, "achievable_gap": ach}
        if repair is None:
            # forced: only a full re-plan can absorb this edit (opaque
            # schema, over-capacity weight, one-sided bootstrap)
            self._discard_background()
            _OBS_EVENTS.emit("forced_replan", planner=type(self).__name__,
                             edit=kind, input=int(i), **trigger)
            self._adopt_replan()
            return self._replan_patch(kind, i, forced=True,
                                      trigger=trigger)
        if drift > self.replan_drift or ach > self._gap_ceiling():
            if not self.background:
                self._bump("drift_replans")
                _OBS_EVENTS.emit("drift_replan",
                                 planner=type(self).__name__, mode="sync",
                                 edit=kind, input=int(i), **trigger)
                self._adopt_replan()
                return self._replan_patch(kind, i, trigger=trigger)
            if self._start_background():
                self._bump("drift_replans")
                _OBS_EVENTS.emit("drift_replan",
                                 planner=type(self).__name__,
                                 mode="background", edit=kind,
                                 input=int(i), **trigger)
            # keep serving repairs off the old schema while the re-plan
            # builds off to the side
            self._bump("repairs")
            return self._finish_delta(kind, i, repair,
                                      extra_meta={"replan_pending": True})
        if self.repack_gap is not None and self._bg is None \
                and not repair.get("dirty") \
                and ach > self._repack_threshold():
            moved, pruned = self._repack_pass()
            if moved or pruned:
                self._bump("repacks")
                self._bump("migrations", moved)
                self._bump("pruned_reducers", pruned)
                _OBS_EVENTS.emit("soft_repack",
                                 planner=type(self).__name__,
                                 migrations=int(moved),
                                 pruned_reducers=int(pruned),
                                 achievable_gap=float(ach))
        self._bump("repairs")
        return self._finish_delta(kind, i, repair)

    def _replan_patch(self, kind: str, i: int, *, swap: bool = False,
                      forced: bool = False,
                      trigger: Optional[dict] = None) -> PlanDelta:
        """The re-plan delta as a compact patch, not a cold rebuild: pair
        values are plan-independent, so the served matrix only needs the
        edited input's rows under the new plan (``full_replan`` stays
        False and the executor's cold build is first-build-only)."""
        patch = self._patch_after_replan(kind, i)
        meta = {"replan": True, "swap": bool(swap), "forced": bool(forced)}
        if trigger is not None:
            meta["trigger"] = {k: float(v) for k, v in trigger.items()}
        return self._finish_delta(kind, i, patch, extra_meta=meta)

    # ------------------------------------------------- background re-plan
    def _start_background(self) -> bool:
        """Kick off a daemon-thread re-plan of the captured live profile;
        False when one is already in flight."""
        if self._bg is not None:
            return False
        payload = self._capture_profile()
        box = {"done": threading.Event(), "result": None, "error": None}

        def work():
            try:
                box["result"] = self._background_plan(payload)
            except Exception as e:      # noqa: BLE001 — stale plans are
                box["error"] = e        # discarded, never raised late
            finally:
                box["done"].set()

        t = threading.Thread(target=work, daemon=True,
                             name="stream-replan")
        box["thread"] = t
        self._bg = box
        t.start()
        return True

    def _discard_background(self) -> None:
        """Drop any in-flight background plan (its thread finishes into a
        dead box); the caller is about to re-plan synchronously."""
        self._bg = None

    def _finish_background(self) -> bool:
        """Land the background plan: swap-adopt it onto the current
        profile (falling back to a synchronous re-plan if it went stale).
        Returns False — with planner state untouched — when the thread
        errored (e.g. the captured profile raced infeasible)."""
        box, self._bg = self._bg, None
        box["thread"].join()
        if box["error"] is not None or box["result"] is None:
            return False
        stale = not self._swap_in(box["result"])
        if stale:
            # the plan went stale (interleaved edits broke capacity or
            # placement): rebuild synchronously from the live profile
            self._adopt_replan()
        self._bump("swaps")
        _OBS_EVENTS.emit("background_swap", planner=type(self).__name__,
                         stale=stale)
        return True

    def flush_replan(self) -> bool:
        """Block until any in-flight background re-plan lands.  Planning
        state only: served pair values are plan-independent, so the cached
        matrix stays correct across the swap.  Returns True if a schema
        was adopted."""
        if self._bg is None:
            return False
        if not self._finish_background():
            return False
        self._recompute_lb()
        self._plan = None
        return True
