"""StreamingExecutor: delta execution of maintained plans (DESIGN.md 1f).

Port of ``repro.stream.executor``.  The fifth registry executor
("streaming").  Cold builds run the fused substrate like any other
executor (``fused_gather_gram`` per bucket on the card, the rectangular
kernel for X2Y); after that the executor keeps the assembled (m, m) pair
matrix as serving state and consumes
:class:`~repro_torch.stream.delta.PlanDelta` artifacts: only the delta's
dirty reducers are recomputed (their compact sub-plan runs through the
bucketed gather+Gram substrate at power-of-two shapes, so with
``use_kernel=True`` reducers each bucket is one ``pairwise_gram`` launch),
and the cached matrix is *patched* in place — touched rows/columns are
invalidated and refilled by a delta max-scatter — instead of being rebuilt.
A full re-plan delta (gap drift, opaque schema) falls back to a cold build,
counted in ``stats()``.

With a ``mesh`` (a ``torch.distributed.ProcessGroup``) the cold build
runs on the substrate over the group and every delta's sub-plan through
the bucketed runner over it: each rank computes its block of every
bucket's rows and the all-gathered blocks patch the maintained matrix,
which stays whole and identical on every rank.  Plans and delta sub-plans
must pad their bucket rows to the group's size (the service's
``load_table`` sets ``pad_reducers_to``).

The reference's arrays are immutable, so its ``sims[:m, :m]`` can never
change under the caller.  Here the maintained matrix is invalidated and
scattered in place, so every patch returns a copy of the live block (m^2
entries, where patching a fresh copy would copy the capacity's cap^2), and
the maintained tensor never leaves the executor.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.mapreduce.assembly import (
    _finish_pair_matrix,
    _finish_x2y_matrix,
    _scatter_blocks,
    _scatter_blocks_x2y,
)
from repro_torch.mapreduce.engine import (
    ReducerBucket,
    ReducerPlan,
    _as_tables,
    as_table,
    run_reducers_bucketed,
    run_reducers_x2y_bucketed,
)
from repro_torch.mapreduce.executors import (
    Executor,
    _bucket_valid_slots,
    _row_bytes,
    make_executor,
)
from repro_torch.obs import LEDGER as _LEDGER
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import _config as _obs_config

from .delta import PlanDelta, _pow2

__all__ = ["StreamingExecutor"]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


class StreamingExecutor(Executor):
    """Incremental pair-matrix serving over a mutable plan.

    ``run_pairs`` is the cold path: it delegates to the ``substrate``
    executor ("fused" by default) and caches the assembled matrix.
    ``apply_delta`` is the streaming path: recompute the delta's dirty
    reducers only, patch the cached matrix.  State is keyed by the reducer
    function object, so the serving tier's memoized ``_block_fn`` reuses
    the cache across edits.

    Patch correctness: every value a dirty reducer produces is computed
    from the *current* table, so scattering dirty blocks over the cached
    matrix (max-combine, after invalidating touched rows/columns to -inf)
    writes only current-correct values — overlapping clean pairs agree,
    touched pairs are refilled, and touched pairs no longer covered
    (deleted inputs) decay to 0.  ``PlanDelta.verify`` proves the dirty
    reducers cover every touched pair.
    """

    name = "streaming"

    def __init__(self, stats: Optional[dict] = None,
                 substrate: str = "fused"):
        super().__init__(stats)
        self.substrate = substrate
        self._sub = make_executor(substrate)     # private: isolated counters
        self._sims: Optional[torch.Tensor] = None
        self._fn: Optional[Callable] = None
        self._sims_x2y: Optional[torch.Tensor] = None
        self._fn_x2y: Optional[Callable] = None

    def _fresh_stats(self) -> dict:
        return {"calls": 0, "full_builds": 0, "delta_updates": 0,
                "dirty_reducers": 0, "reducers_total": 0,
                "patched_inputs": 0, "fallbacks": 0,
                "warmed_shapes": 0, "recompute_fraction": 0.0}

    # ------------------------------------------------------------- protocol
    def run(self, inputs, plan, reducer_fn, *, mesh=None, device=None,
            **kwargs):
        """Non-pairs reducer execution has no serving state to patch:
        delegate to the substrate (counted as a fallback)."""
        self._count("calls")
        self._count("fallbacks")
        return self._sub.run(inputs, plan, reducer_fn, mesh=mesh,
                             device=device, **kwargs)

    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        """Cold build: execute the full plan on the substrate and adopt the
        (m, m) matrix as streaming state."""
        self._count("calls")
        return self._rebuild(as_table(x, device), plan, reducer_fn, m,
                             mesh=mesh, use_kernel=use_kernel)

    def reset(self) -> None:
        super().reset()
        self._sub.reset()

    # --------------------------------------------------------- reconciliation
    def _note_stream(self, table, plan, workload: str, *,
                     cold: bool) -> None:
        """Ledger record for a cold (full-plan) build: the streaming
        executor paid the whole re-shuffle, so measured == predicted."""
        if not _obs_config.ENABLED:
            return
        d, isz = _row_bytes(table)
        slots = _bucket_valid_slots(plan)
        _LEDGER.record(
            executor=self.name, workload=workload,
            predicted_rows=float(plan.comm_cost),
            lb_rows=plan.lower_bound, plan_slots=slots,
            measured_slots=slots, d=d, itemsize=isz,
            meta={"cold": cold})
        _OBS_REGISTRY.histogram("stream.recompute_fraction",
                                executor=self.name).observe(1.0)

    def _note_delta(self, table, delta: PlanDelta, workload: str,
                    executed: bool) -> None:
        """Ledger record for one delta: predicted traffic is the delta
        ledger (``delta_comm_rows``), measured is what the patch program
        actually gathered, and the lower bound stays the *full instance's*
        theorem bound."""
        if not _obs_config.ENABLED:
            return
        d, isz = _row_bytes(table)
        sp = delta.sub_plan
        slots = _bucket_valid_slots(sp) if sp is not None else 0
        _LEDGER.record(
            executor=self.name, workload=workload,
            predicted_rows=delta.delta_comm_rows(),
            lb_rows=delta.lower_bound, plan_slots=slots,
            measured_slots=slots if executed else 0, d=d, itemsize=isz,
            meta={"kind": delta.kind,
                  "recompute_fraction": float(delta.recompute_fraction),
                  "dirty_reducers": int(len(delta.dirty_rows))})
        _OBS_REGISTRY.histogram("stream.recompute_fraction",
                                executor=self.name).observe(
                                    float(delta.recompute_fraction))

    def _count_delta(self, delta: PlanDelta, patched: int) -> None:
        self._count("delta_updates")
        self._count("dirty_reducers", int(len(delta.dirty_rows)))
        self._count("reducers_total", int(delta.num_reducers))
        self._count("patched_inputs", int(patched))
        self._stats["recompute_fraction"] = float(delta.recompute_fraction)

    def _count_cold(self, plan) -> None:
        self._count("full_builds")
        self._count("dirty_reducers", plan.num_reducers)
        self._count("reducers_total", plan.num_reducers)
        self._stats["recompute_fraction"] = 1.0

    # ------------------------------------------------------------ streaming
    @property
    def sims(self) -> Optional[torch.Tensor]:
        """The maintained matrix at table capacity — a power-of-two square
        so consecutive inserts keep their shapes until the capacity
        doubles; rows/cols past the live table are zero.  (None before the
        first build.)  Patched in place by later edits."""
        return self._sims

    def invalidate(self) -> None:
        """Drop the maintained state; the next call rebuilds cold."""
        self._sims = None
        self._fn = None
        self._sims_x2y = None
        self._fn_x2y = None

    @staticmethod
    def _cap(n: int) -> int:
        """Serving capacity for ``n`` live rows: the next power of two
        *above* ``max(n + 1, 1.25 n)``.  With the headroom, the capacity
        chosen at ``load_table`` time survives the first ~25% of growth,
        so the shapes ``warm_delta_shapes`` ran are the shapes the first
        edit runs."""
        if n <= 0:
            return 1
        return _pow2(max(n + 1, -(-n * 5 // 4)))

    @classmethod
    def _at_capacity(cls, x: torch.Tensor, square: bool = False):
        """Zero-pad the leading axis (both axes with ``square=True``) to
        serving capacity (:meth:`_cap`).  Padding rows are never referenced
        (the plan indexes live rows only)."""
        pad = cls._cap(x.shape[0]) - x.shape[0]
        if pad > 0:
            x = F.pad(x, (0, pad, 0, pad) if square
                      else (0, 0) * (x.dim() - 1) + (0, pad))
        return x

    def _rebuild(self, x, plan, reducer_fn, m, *, mesh=None,
                 use_kernel=False):
        sims = self._sub.run_pairs(x, plan, reducer_fn, m, mesh=mesh,
                                   use_kernel=use_kernel, device=x.device)
        self._sims = self._at_capacity(sims, square=True)   # a new tensor
        self._fn = reducer_fn
        self._count_cold(plan)
        self._note_stream(x, plan, "pairs", cold=True)
        return sims

    def _patch(self, sims, xt, sub_plan, reducer_fn, t,
               mesh=None) -> torch.Tensor:
        """Invalidate rows/cols ``t`` to -inf and max-scatter the sub-plan's
        blocks (computed from the capacity-padded table ``xt``, over
        ``mesh``'s ranks) in place, in this order on the current stream,
        then finish the matrix."""
        sims[t, :] = float("-inf")
        sims[:, t] = float("-inf")
        if sub_plan is not None:
            for b, blocks in run_reducers_bucketed(
                    xt, sub_plan, reducer_fn, mesh=mesh, combine="buckets",
                    device=xt.device):
                _scatter_blocks(sims, blocks,
                                torch.as_tensor(b.idx, device=xt.device),
                                torch.as_tensor(b.mask, device=xt.device))
        return _finish_pair_matrix(sims)

    def apply_delta(self, x, delta: PlanDelta, reducer_fn, m, *,
                    plan_provider: Optional[Callable[[], ReducerPlan]] = None,
                    mesh=None, use_kernel=False, device=None):
        """Apply one edit: patch the maintained matrix through the delta.

        ``x`` is the *current* full table (tombstoned rows included);
        ``m = x.shape[0]``.  ``plan_provider`` supplies the full post-edit
        plan, called only when a cold rebuild is unavoidable (full-re-plan
        delta, or no maintained state / different reducer function).
        Returns a copy of the live (m, m) block of the maintained matrix,
        which later edits leave as it is.
        """
        x = as_table(x, device)
        self._count("calls")
        cold = (self._sims is None or self._fn is not reducer_fn
                or delta.full_replan)
        if cold:
            assert plan_provider is not None, (
                "cold streaming rebuild needs the full plan")
            return self._rebuild(x, plan_provider(), reducer_fn, m,
                                 mesh=mesh, use_kernel=use_kernel)

        sims = self._sims
        if m > sims.shape[0]:                     # capacity doubled
            grow = m - sims.shape[0]
            sims = self._at_capacity(F.pad(sims, (0, grow, 0, grow)),
                                     square=True)
        touched = delta.touched_inputs
        if len(touched):
            sub = (delta.sub_plan if delta.sub_plan is not None
                   and len(delta.dirty_rows) else None)
            sims = self._patch(sims, self._at_capacity(x), sub, reducer_fn,
                               _ids(touched, x.device), mesh)
        self._sims = sims
        self._count_delta(delta, len(touched))
        self._note_delta(
            x, delta, "delta",
            executed=bool(len(touched) and delta.sub_plan is not None
                          and len(delta.dirty_rows)))
        return sims[:m, :m].clone()

    # ------------------------------------------------------- rectangular X2Y
    @property
    def sims_x2y(self) -> Optional[torch.Tensor]:
        """The maintained (capacity-padded) cross matrix; None before the
        first rectangular build."""
        return self._sims_x2y

    def run_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                use_kernel=False, device=None):
        """Cold rectangular build: execute the full rect plan on the
        substrate and adopt the (mx, my) matrix as streaming state.
        Payload-carrying outputs (trailing dims — the skew join) execute
        identically but are not adopted as patchable state."""
        self._count("calls")
        return self._rebuild_x2y(_as_tables(tables, device), plan,
                                 reducer_fn, shape, mesh=mesh,
                                 use_kernel=use_kernel)

    @classmethod
    def _at_rect_capacity(cls, s: torch.Tensor) -> torch.Tensor:
        """Zero-pad both matrix axes to serving capacity."""
        px = cls._cap(s.shape[0]) - s.shape[0]
        py = cls._cap(s.shape[1]) - s.shape[1]
        return F.pad(s, (0, py, 0, px)) if px or py else s

    def _rebuild_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                     use_kernel=False):
        xt, yt = tables
        sims = self._sub.run_x2y((xt, yt), plan, reducer_fn, shape,
                                 mesh=mesh, use_kernel=use_kernel,
                                 device=xt.device)
        if sims.dim() == 2:
            self._sims_x2y = self._at_rect_capacity(sims)   # a new tensor
            self._fn_x2y = reducer_fn
        self._count_cold(plan)
        self._note_stream(xt, plan, "x2y", cold=True)
        return sims

    def _patch_x2y(self, sims, xt, yt, sub_plan, reducer_fn, tx, ty,
                   mesh=None):
        """The rectangular :meth:`_patch`: rows ``tx`` and columns ``ty``
        invalidated and the sub-plan's cross blocks (over ``mesh``'s
        ranks) max-scattered in place, in this order, then the matrix
        finished."""
        sims[tx, :] = float("-inf")
        sims[:, ty] = float("-inf")
        if sub_plan is not None:
            dev = xt.device
            for b, blocks in run_reducers_x2y_bucketed(
                    (xt, yt), sub_plan, reducer_fn, mesh=mesh,
                    combine="buckets", device=dev):
                _scatter_blocks_x2y(
                    sims, blocks, *(torch.as_tensor(a, device=dev) for a in
                                    (b.idx, b.mask, b.yidx, b.ymask)))
        return _finish_x2y_matrix(sims)

    def apply_delta_x2y(self, tables, delta: PlanDelta, reducer_fn,
                        shape, *,
                        plan_provider: Optional[
                            Callable[[], ReducerPlan]] = None,
                        mesh=None, use_kernel=False, device=None):
        """Apply one X2Y edit: patch the maintained (mx, my) matrix.

        ``tables`` are the *current* full (X, Y) tables (tombstoned rows
        included); ``shape = (mx, my)`` their live leading sizes.  The
        delta's ``meta['touched_x']`` rows and ``meta['touched_y']``
        columns are invalidated and the dirty reducers' rect sub-plan is
        recomputed and scattered back — the two-sided analogue of
        :meth:`apply_delta`.  Returns a copy of the live (mx, my) block."""
        xt, yt = _as_tables(tables, device)
        self._count("calls")
        mx, my = shape
        cold = (self._sims_x2y is None or self._fn_x2y is not reducer_fn
                or delta.full_replan)
        if cold:
            assert plan_provider is not None, (
                "cold streaming rebuild needs the full rect plan")
            return self._rebuild_x2y((xt, yt), plan_provider(), reducer_fn,
                                     shape, mesh=mesh, use_kernel=use_kernel)

        sims = self._sims_x2y
        if mx > sims.shape[0] or my > sims.shape[1]:  # capacity doubled
            sims = self._at_rect_capacity(F.pad(sims, (
                0, max(my - sims.shape[1], 0),
                0, max(mx - sims.shape[0], 0))))
        tx = np.asarray(delta.meta.get("touched_x", ()), np.int64)
        ty = np.asarray(delta.meta.get("touched_y", ()), np.int64)
        executed = False
        if len(tx) or len(ty):
            sub = (delta.sub_plan if delta.sub_plan is not None
                   and len(delta.dirty_rows) else None)
            executed = sub is not None
            sims = self._patch_x2y(
                sims, self._at_capacity(xt), self._at_capacity(yt), sub,
                reducer_fn, _ids(tx, xt.device), _ids(ty, xt.device), mesh)
        self._sims_x2y = sims
        self._count_delta(delta, len(tx) + len(ty))
        self._note_delta(xt, delta, "delta_x2y", executed=executed)
        return sims[:mx, :my].clone()

    # ------------------------------------------------------------ AOT warmup
    @staticmethod
    def _warm_plan(R: int, width: int, ywidth: int = 0) -> ReducerPlan:
        """A synthetic one-bucket plan at exactly the given padded shape:
        all rows masked out (row id -1 — the padding convention), so the
        path runs against zeros without reading anything."""
        bucket = ReducerBucket(
            width=int(width), rows=np.full(R, -1, np.int64),
            idx=np.zeros((R, width), np.int32),
            mask=np.zeros((R, width), bool),
            ywidth=int(ywidth),
            yidx=(np.zeros((R, ywidth), np.int32) if ywidth else None),
            ymask=(np.zeros((R, ywidth), bool) if ywidth else None))
        return ReducerPlan(
            idx=bucket.idx, mask=bucket.mask, num_reducers=R,
            comm_cost=0.0, max_inputs=int(width), algorithm="warmup",
            lower_bound=None, buckets=(bucket,),
            yidx=bucket.yidx, ymask=bucket.ymask,
            max_y_inputs=int(ywidth))

    def warm_delta_shapes(self, x, shapes, reducer_fn, *, mesh=None,
                          device=None) -> int:
        """Run the delta path once for every ``(rows, width)`` sub-plan
        shape in ``shapes`` (``IncrementalPlanner.delta_shapes()``), plus
        the invalidate/scatter/finish patch at serving capacity, on a
        scratch matrix.

        Runs the *exact* :meth:`apply_delta` code path, so the first real
        edit finds every kernel it launches already built and loaded (with
        ``use_kernel=True`` reducers that includes ``pairwise_gram``) and
        the capacity-padded table signature already served.  Returns the
        number of shapes warmed (also counted in
        ``stats()['warmed_shapes']``)."""
        if not shapes:
            return 0
        x = as_table(x, device)
        cap = (self._sims.shape[0] if self._sims is not None
               else self._cap(x.shape[0]))
        # a scratch matrix: the patch runs in place, and must not touch the
        # maintained one
        scratch = torch.zeros((cap, cap), dtype=torch.float32,
                              device=x.device)
        t = _ids([0], x.device)
        xt = self._at_capacity(x)
        for shape in shapes:
            R, width = int(shape[0]), int(shape[1])
            self._patch(scratch, xt, self._warm_plan(R, width), reducer_fn,
                        t, mesh)
        _sync(scratch)
        self._count("warmed_shapes", len(shapes))
        return len(shapes)

    def warm_delta_shapes_x2y(self, tables, shapes, reducer_fn, *,
                              mesh=None, device=None) -> int:
        """Rectangular warmup: run the :meth:`apply_delta_x2y` path once
        for every ``(rows, x width, y width)`` shape
        (``IncrementalX2YPlanner.delta_shapes()``), on a scratch matrix."""
        if not shapes:
            return 0
        xt, yt = _as_tables(tables, device)
        if self._sims_x2y is not None:
            cx, cy = self._sims_x2y.shape
        else:
            cx, cy = self._cap(xt.shape[0]), self._cap(yt.shape[0])
        scratch = torch.zeros((cx, cy), dtype=torch.float32,
                              device=xt.device)
        t = _ids([0], xt.device)
        xt, yt = self._at_capacity(xt), self._at_capacity(yt)
        for shape in shapes:
            R, wx, wy = (int(shape[0]), int(shape[1]), int(shape[2]))
            self._patch_x2y(scratch, xt, yt, self._warm_plan(R, wx, wy),
                            reducer_fn, t, t, mesh)
        _sync(scratch)
        self._count("warmed_shapes", len(shapes))
        return len(shapes)
