"""Executor protocol + registry (port of ``repro.mapreduce.executors``).

An :class:`Executor` decides how a
:class:`~repro_torch.mapreduce.engine.ReducerPlan` runs on the device:

  ``run(inputs, plan, reducer_fn, ...)``     — execute the plan;
  ``run_pairs(x, plan, reducer_fn, m, ...)`` — execute + assemble the
        (m, m) pair matrix;
  ``run_x2y(tables, plan, reducer_fn, shape, ...)`` — execute a
        rectangular (X2Y) plan + assemble the (mx, my[, c]) cross output;
  ``run_block(x, sparse, reducer_fn, i0, i1, j0, j1, ...)`` — serve one
        block of the pair matrix through ``run_x2y`` on the block's
        sub-plan;
  ``stats()`` / ``reset()``                  — instance-scoped dispatch
        telemetry, also published into ``repro_torch.obs`` under the
        reference's series names (``executor.<key>{executor=<name>}``), and
        every pair / X2Y request reconciled into the comm ledger.

Registered executors:

``dense``     — one gather padded to the global max slot count (oracle).
``bucketed``  — skew-aware: one gather+reduce per capacity bucket (oracle).
``fused``     — per bucket, ONE launch of a hand-written gather+Gram kernel
                (``kernels.pairwise.fused_gather_gram``: the square kernel
                for ``run_pairs``, the rectangular one for ``run_x2y`` and
                so for block serving, where a bucket launches once per
                tight class of its reducers, ``assembly.rect_launch_plan``;
                their plain versions on a CPU table), then ONE assembly
                gather through the inverse-shuffle source map.  The
                square kernel finishes the metric in its epilogue for
                buckets up to 32 wide and writes each bucket into its
                slice of the vector the assembly gathers from
                (``assembly``); the rect kernel does the same up to
                32 x 32.  Wider buckets and the CPU finish in torch, in
                the kernels' wrappers.  Non-Gram reducers fall back to
                bucketed, counted.

``sharded``   — shard-balanced execution over a process group (the
                "mesh", see ``repro_torch.compat``): ``partition_plan``
                LPT-balances the reducers over the group's ranks, each rank
                runs the gather+Gram kernel over its own reducers only, and
                ONE all-gather of the finished blocks assembles the matrix
                through a source map (``run_pairs`` / ``run_x2y``) or a
                scatter into reducer order (``run``).
``coded``     — coded shuffle execution (Afrati et al., arXiv:1206.4377):
                every reducer is replicated on ``r`` ranks, the output is
                row-sliced over the ranks, a rank serves its slice's cells
                from local blocks where it holds a replica, and only the
                residual entries cross ranks, in ONE all-to-all; a final
                all-gather of the row slices gives every rank the matrix.
``streaming`` — ``repro_torch.stream.StreamingExecutor``, registered on
                its first lookup: cold builds on ``fused``, then the
                maintained pair matrix patched per edit.

On dense and bucketed, ``use_kernel=True`` reducers (``allpairs._block_fn``)
compute each block with the ``pairwise_gram`` kernel, one batched launch
per gather.  Every executor takes a ``mesh`` (a
``torch.distributed.ProcessGroup``).  ``dense``, ``bucketed``, ``fused``
and ``streaming`` split each bucket's reducer rows over its ranks and
all-gather the blocks once per request (``mesh=None``: local);
``sharded`` and ``coded`` partition the plan over it (``mesh=None``: the
default group if one is initialised).  Every executor's ``lower`` raises
(see ``Executor.lower``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import compat as _compat
from repro_torch.core.planner import PlanPartition, partition_plan
from repro_torch.kernels.pairwise.fused_gather_gram import (
    fused_gather_gram,
    fused_gather_gram_rect,
    rect_table_norms,
)
from repro_torch.obs import EVENTS as _EVENTS
from repro_torch.obs import LEDGER as _LEDGER
from repro_torch.obs import REGISTRY as _REGISTRY_OBS
from repro_torch.obs import _config as _obs_config

from .assembly import (
    BlockLayout,
    _assemble_from_srcmap,
    _pair_source_map,
    _pair_source_map_rect,
    assemble_pair_matrix,
    assemble_pair_matrix_bucketed,
    assemble_x2y_matrix_bucketed,
    block_layout,
    check_int32,
    rect_launch_plan,
    source_map,
    with_zero_slot,
)
from .engine import (
    ReducerPlan,
    _as_tables,
    all_ranks,
    as_table,
    block_subplan,
    bucket_arrays,
    plan_memo,
    rank_rows,
    rect_bucket_arrays,
    run_reducers,
    run_reducers_bucketed,
    run_reducers_x2y,
    run_reducers_x2y_bucketed,
    uploaded,
)

__all__ = [
    "Executor",
    "DenseExecutor",
    "BucketedExecutor",
    "FusedExecutor",
    "ShardedExecutor",
    "CodedExecutor",
    "coded_assembly_model",
    "choose_replication",
    "register_executor",
    "get_executor",
    "make_executor",
    "list_executors",
]


# ---------------------------------------------------------------------------
# protocol + registry
# ---------------------------------------------------------------------------
class Executor:
    """Base executor: run / run_pairs / stats / reset.

    ``_stats`` is a plain dict owned by the instance (pass one in to share
    counters across instances).  Every ``_count`` also publishes into the
    observability registry as ``executor.<key>{executor=<name>}``, and pair
    requests reconcile into the comm ledger: measured gather slots vs the
    plan's predicted cost and lower bound."""

    name: str = "?"

    def __init__(self, stats: Optional[dict] = None):
        self._stats = stats if stats is not None else self._fresh_stats()

    def _fresh_stats(self) -> dict:
        return {"calls": 0}

    # -- protocol ----------------------------------------------------------
    def run(self, inputs, plan: ReducerPlan, reducer_fn: Callable, *,
            mesh=None, device=None, **kwargs):
        raise NotImplementedError

    def run_pairs(self, x, plan: ReducerPlan, reducer_fn: Callable, m: int,
                  *, mesh=None, use_kernel: bool = False, device=None):
        """Execute the plan and assemble the (m, m) pair matrix."""
        raise NotImplementedError

    def run_x2y(self, tables, plan: ReducerPlan, reducer_fn: Callable,
                shape: tuple[int, int], *, mesh=None,
                use_kernel: bool = False, device=None):
        """Execute a rectangular (X2Y) plan and assemble the (mx, my[, c])
        cross output.

        ``tables`` is an (x_table, y_table) pair (or one shared table);
        ``reducer_fn(xblock, xmask, yblock, ymask)`` emits (Lx, Ly[, c])
        cross blocks; ``shape = (mx, my)`` sizes the assembled output."""
        raise NotImplementedError

    def run_block(self, x, sparse, reducer_fn: Callable,
                  i0: int, i1: int, j0: int, j1: int, *, mesh=None,
                  use_kernel: bool = False, pad_reducers_to: int = 1,
                  pad_slots_to: int = 1, max_buckets: int = 8,
                  device=None):
        """Serve the ``[i0:i1) x [j0:j1)`` sub-block of the (m, m) pair
        matrix without materializing the whole matrix.

        ``sparse`` is a :class:`~repro_torch.mapreduce.engine.SparsePlan`;
        ``reducer_fn`` is a two-sided (X2Y) reducer.  The block's reducers
        — selected by :func:`~repro_torch.mapreduce.engine.block_subplan`
        — run through this executor's own ``run_x2y`` on the row slices
        ``x[i0:i1]`` and ``x[j0:j1]``; global-diagonal cells are then
        zeroed to match the pair matrix's convention."""
        x = as_table(x, device)
        bx, by = i1 - i0, j1 - j0
        sub = block_subplan(
            sparse, i0, i1, j0, j1, pad_reducers_to=pad_reducers_to,
            pad_slots_to=pad_slots_to, max_buckets=max_buckets)
        if sub is None or bx == 0 or by == 0:
            out = torch.zeros((max(bx, 0), max(by, 0)), dtype=torch.float32,
                              device=x.device)
        else:
            out = self.run_x2y((x[i0:i1], x[j0:j1]), sub, reducer_fn,
                               (bx, by), mesh=mesh, use_kernel=use_kernel,
                               device=x.device)
        lo, hi = max(i0, j0), min(i1, j1)
        if lo < hi:  # the block crosses the global diagonal: zero it
            d = torch.arange(lo, hi, device=out.device)
            out[d - i0, d - j0] = 0.0
        self._count("block_calls")
        return out

    def lower(self, *args, **kwargs):
        """The reference lowers an executor's program to XLA for its
        dry-run and roofline analysis; eager PyTorch has no such lowering,
        so this raises.  The port's dry run,
        ``repro_torch.launch.dryrun_engine``, runs the executor instead and
        reads the package's work models (``repro_torch.launch.roofline``),
        the obs collective counters and the card's events."""
        raise NotImplementedError(
            f"{self.name}: there is no XLA lowering in the PyTorch port")

    def stats(self) -> dict:
        """Snapshot of this instance's dispatch counters."""
        return dict(self._stats)

    def reset(self) -> None:
        """Zero this instance's counters (in place: shared dicts stay
        shared)."""
        for k in self._stats:
            self._stats[k] = 0 if not isinstance(self._stats[k], float) \
                else 0.0

    def _count(self, key: str, by: int = 1) -> None:
        self._stats[key] = self._stats.get(key, 0) + by
        _REGISTRY_OBS.counter(f"executor.{key}", executor=self.name).inc(by)

    def _count_fallback(self, reason: str) -> None:
        """A non-fusable dispatch fell back to the bucketed path: count it
        and emit the lifecycle event."""
        self._count("fallbacks")
        _EVENTS.emit("executor_fallback", executor=self.name, reason=reason)

    def _reconcile(self, plan, workload: str, table, *,
                   measured_slots: int, replication: float = 1.0,
                   assembled_bytes: int = 0, local_bytes: int = 0,
                   residual_bytes: int = 0, meta: Optional[dict] = None
                   ) -> None:
        """Record this execution's comm reconciliation (no-op when obs is
        disabled).  ``table`` supplies the input row size (d, itemsize)."""
        if not _obs_config.ENABLED:
            return
        d, itemsize = _row_bytes(table)
        _LEDGER.record(
            executor=self.name, workload=workload,
            predicted_rows=float(plan.comm_cost),
            lb_rows=plan.lower_bound,
            plan_slots=_plan_valid_slots(plan),
            measured_slots=int(measured_slots), d=d, itemsize=itemsize,
            replication=replication, assembled_bytes=assembled_bytes,
            local_bytes=local_bytes, residual_bytes=residual_bytes,
            meta=meta)


def _row_bytes(table) -> tuple[int, int]:
    """(d, itemsize) of one input row — the ledger's byte scale; anything
    shapeless falls back to (0, 4)."""
    shape = getattr(table, "shape", None)
    if not shape or len(shape) < 2:
        return 0, 4
    itemsize = getattr(getattr(table, "dtype", None), "itemsize", 4)
    return int(shape[-1]), int(itemsize)


def _plan_valid_slots(plan) -> int:
    """Valid gather slots the plan books (X + Y sides for rect plans) —
    the ledger's ``plan_slots`` denominator.  Cached on the plan."""
    return plan_memo(plan, "_obs_plan_slots", lambda: int(
        np.asarray(plan.mask).sum()) + (0 if plan.ymask is None else int(
            np.asarray(plan.ymask).sum())))


def _bucket_valid_slots(plan) -> int:
    """Valid gather slots the bucketed/fused path executes (sum of
    per-bucket masks; padding rows are all-False, so this equals the dense
    mask sum — the 1.0-ratio invariant).  Cached on the plan."""
    return plan_memo(plan, "_obs_bucket_slots", lambda: sum(
        int(np.asarray(b.mask).sum())
        + (0 if b.ymask is None else int(np.asarray(b.ymask).sum()))
        for b in plan.buckets) if plan.buckets else _plan_valid_slots(plan))


def _group_valid_slots(plan, cache_key, groups, count_y: bool) -> int:
    """Valid gather slots in stacked shard groups (the sharded/coded
    executors' measured side).  5-tuple groups carry (xi, xm, yi, ym,
    rows); ``count_y=False`` for the square coded path, where xm and ym
    are the same gather and copies must be counted once.  Cached on the
    plan per (shards, replication, rect) key."""
    def build() -> int:
        n = 0
        for grp in groups:
            n += int(np.asarray(grp[1]).sum())
            if count_y and len(grp) >= 5:
                n += int(np.asarray(grp[3]).sum())
        return n
    return plan_memo(plan, "_obs_group_slots", build, cache_key)


def _group_gram_entries(plan, cache_key, groups) -> int:
    """Gram entries the stacked shard groups produce — what the sharded
    all-gather assembly ships.  Cached on the plan (same cache as the slot
    sums, disjoint keys)."""
    # rect groups are (xi, xm, yi, ym, rows), square ones (idx, mask, rows)
    return plan_memo(plan, "_obs_group_slots", lambda: sum(
        int(np.prod(g[0].shape)) * g[-3].shape[2] for g in groups), cache_key)


_REGISTRY: dict[str, Executor] = {}
_CLASSES: dict[str, type] = {}


def register_executor(executor: Executor) -> Executor:
    """Register ``executor`` as the default instance for its ``name``
    (latest registration wins — extension point for custom executors)."""
    _REGISTRY[executor.name] = executor
    _CLASSES[executor.name] = type(executor)
    return executor


def get_executor(name) -> Executor:
    """Default registry instance by name; Executor instances pass through.
    ``"streaming"`` is registered on its first lookup.  Unknown names raise
    ``ValueError``."""
    if isinstance(name, Executor):
        return name
    ex = _REGISTRY.get(name)
    if ex is None and name == "streaming":
        # the streaming package registers its executor on import; loaded
        # lazily so the engine never pays for it unless it is used
        import repro_torch.stream  # noqa: F401
        ex = _REGISTRY.get(name)
    if ex is None:
        raise ValueError(
            f"unknown executor {name!r} (registered: {list_executors()})")
    return ex


def make_executor(name: str, **kwargs) -> Executor:
    """Fresh instance (own stats) of the executor registered under
    ``name``."""
    get_executor(name)                       # raise on unknown names
    return _CLASSES[name](**kwargs)


def list_executors() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# dense + bucketed: wrappers over the engine substrate
# ---------------------------------------------------------------------------
class DenseExecutor(Executor):
    """One gather padded to the global max slot count (the oracle path)."""

    name = "dense"

    def run(self, inputs, plan, reducer_fn, *, mesh=None, device=None,
            **kwargs):
        self._count("calls")
        return run_reducers(inputs, plan, reducer_fn, mesh=mesh,
                            device=device, **kwargs)

    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        x = as_table(x, device)
        self._count("calls")
        self._reconcile(plan, "pairs", x,
                        measured_slots=_plan_valid_slots(plan))
        blocks = run_reducers(x, plan, reducer_fn, mesh=mesh,
                              device=x.device)
        return assemble_pair_matrix(blocks, plan, m)

    def run_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                use_kernel=False, device=None):
        xt, yt = _as_tables(tables, device)
        self._count("calls")
        self._reconcile(plan, "x2y", xt,
                        measured_slots=_plan_valid_slots(plan))
        blocks = run_reducers_x2y((xt, yt), plan, reducer_fn, mesh=mesh,
                                  device=xt.device)
        # the plan's dense idx/mask/yidx/ymask rows are bucket-shaped, so
        # the whole plan assembles as a single "bucket"
        return assemble_x2y_matrix_bucketed([(plan, blocks)], shape,
                                            device=xt.device)


class BucketedExecutor(Executor):
    """Skew-aware: one gather+reduce per capacity bucket."""

    name = "bucketed"

    def run(self, inputs, plan, reducer_fn, *, mesh=None, device=None,
            combine: str = "dense", **kwargs):
        self._count("calls")
        return run_reducers_bucketed(inputs, plan, reducer_fn, mesh=mesh,
                                     combine=combine, device=device,
                                     **kwargs)

    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        x = as_table(x, device)
        self._count("calls")
        self._reconcile(plan, "pairs", x,
                        measured_slots=_bucket_valid_slots(plan))
        per_bucket = run_reducers_bucketed(x, plan, reducer_fn, mesh=mesh,
                                           combine="buckets", device=x.device)
        return assemble_pair_matrix_bucketed(per_bucket, m, device=x.device)

    def run_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                use_kernel=False, device=None):
        xt, yt = _as_tables(tables, device)
        self._count("calls")
        self._reconcile(plan, "x2y", xt,
                        measured_slots=_bucket_valid_slots(plan))
        per_bucket = run_reducers_x2y_bucketed(
            (xt, yt), plan, reducer_fn, mesh=mesh, combine="buckets",
            device=xt.device)
        return assemble_x2y_matrix_bucketed(per_bucket, shape,
                                            device=xt.device)


# ---------------------------------------------------------------------------
# fused (gather+Gram kernel) executor
# ---------------------------------------------------------------------------
# the fused rect launches' entries: each computes R Lx Ly, of which the
# valid pairs are wanted (every launch counts where its finish ran in
# ``fused.finish{shape=rect}``, in the kernel's wrapper)
_RECT_VALID = _REGISTRY_OBS.counter("fused.rect_entries", kind="valid")
_RECT_COMPUTED = _REGISTRY_OBS.counter("fused.rect_entries", kind="computed")


def _rect_valid_pairs(plan, i: int, rows: slice) -> int:
    """Valid (x, y) pairs in rows ``rows`` of rect bucket ``i``: over its
    reducers, valid X slots times valid Y slots.  Cached on the plan."""
    b = plan.buckets[i]
    return plan_memo(plan, "_rect_valid_pairs", lambda: int((
        b.mask[rows].sum(1, dtype=np.int64)
        * b.ymask[rows].sum(1, dtype=np.int64)).sum()),
        (i, rows.start, rows.stop))


def _largest_first(plan, rows) -> list:
    """Positions of the rect launches (the buckets of ``plan``: a launch
    plan's classes without a process group, the plan's own buckets with
    one) by the entries each computes, the most first (ties in bucket
    order); ``rows`` are this rank's row slices."""
    return sorted(range(len(plan.buckets)), key=lambda i: -(
        (rows[i].stop - rows[i].start) * plan.buckets[i].width
        * plan.buckets[i].ywidth))


class FusedExecutor(Executor):
    """Fused shuffle execution: the gathered block stays out of memory.

    Per capacity bucket (on the X2Y path without a process group, per
    tight class of a bucket's reducers, see :meth:`run_x2y`), the plan's
    ``idx``/``mask`` rows drive ONE launch of the hand-written
    gather+Gram kernel on a CUDA table (its plain
    version on a CPU table: no other path exists, so nothing on the card
    takes the plain version silently).  The ``kernel`` counter counts
    requests served by the kernel, ``streamed`` those served by the plain
    version on the CPU (the reference's name for its non-kernel path).

    Without a process group every bucket is written, finished, into its
    slice of ONE vector ``[0.0, blocks_0.ravel(), blocks_1.ravel(), ...]``
    (the kernel's epilogue finishes buckets up to 32 wide; see
    ``fused_gather_gram``), which the pair assembly gathers from with no
    copy; with a group, each rank's finished blocks are all-gathered and
    concatenated.

    Only Gram-block reducers are fusable: ``reducer_fn`` must carry a
    ``fused_metric`` attribute (see ``allpairs._block_fn``).  Any other
    reducer — and bucketless plans — falls back to the bucketed executor
    with identical outputs; fallbacks are counted in ``stats()``.
    """

    name = "fused"

    def _fresh_stats(self) -> dict:
        return {"calls": 0, "kernel": 0, "streamed": 0, "fallbacks": 0}

    def run(self, inputs, plan, reducer_fn, *, mesh=None, device=None,
            combine: str = "dense", postprocess: Optional[Callable] = None,
            postprocess_arg=None):
        """``combine`` follows the bucketed executor ('dense' / 'buckets');
        ``postprocess(per_bucket, postprocess_arg)`` replaces the combine
        step (``run_pairs`` passes its inverse-shuffle assembly).  With a
        ``mesh``, each rank launches the kernel on its block of every
        bucket's rows and ONE all-gather of the finished blocks gives
        every rank all of them before the combine."""
        assert combine in ("dense", "buckets"), combine
        x = as_table(inputs, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or not plan.buckets:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "no_buckets")
            out = run_reducers_bucketed(
                x, plan, reducer_fn, mesh=mesh, device=x.device,
                combine="buckets" if postprocess is not None else combine)
            if postprocess is not None:
                arrays = uploaded("buckets", plan, x,
                                  lambda dev: bucket_arrays(plan, dev))
                per_bucket = [(arr, blocks)
                              for arr, (_, blocks) in zip(arrays, out)]
                return postprocess(per_bucket, postprocess_arg)
            return out

        per_bucket, _flat = self._finished(x, plan, metric, mesh)
        if postprocess is not None:
            return postprocess(per_bucket, postprocess_arg)
        if combine == "buckets":
            return [g for _, g in per_bucket]
        # dense combine: scatter bucket blocks (padded to the dense width)
        # into original reducer order; padding rows land in the extra row R
        R, L = plan.R, plan.L
        acc = torch.zeros((R + 1, L, L), dtype=torch.float32,
                          device=x.device)
        for (_, _, rows), g in per_bucket:
            pad = L - g.shape[1]
            acc[rows] = torch.nn.functional.pad(g, (0, pad, 0, pad))
        return acc[:R]

    def _finished(self, x, plan, metric: str, mesh):
        """``(per_bucket, flat)``: each bucket's arrays beside its finished
        ``(Rb, Lb, Lb)`` blocks, and ``flat``, the vector ``[0.0,
        blocks_0.ravel(), ...]`` the blocks are views of, without a process
        group (``None`` with one: the blocks are all-gathered)."""
        group, S, rank = _compat.reducer_group(mesh)
        mine = [rank_rows(b.R, S, rank) for b in plan.buckets]
        self._count("kernel" if x.is_cuda else "streamed")
        arrays = uploaded("buckets", plan, x,
                          lambda dev: bucket_arrays(plan, dev))
        # the kernel is called with positional arguments only, so that a
        # wrapper of ``fused_gather_gram`` sees them all in ``*args``
        if group is None:
            layout = block_layout(plan)
            flat = layout.vector(x.device)
            blocks = [fused_gather_gram(x, idx, msk, metric,
                                        layout.view(flat, i))
                      for i, (idx, msk, _) in enumerate(arrays)]
            flat[:1].zero_()        # after the launches, off the prologue
            return list(zip(arrays, blocks)), flat
        local = [fused_gather_gram(x, idx[r], msk[r], metric)
                 for r, (idx, msk, _) in zip(mine, arrays)]
        return list(zip(arrays, all_ranks(local, group, S))), None

    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        """``use_kernel`` is accepted for signature parity: on a CUDA table
        the fused path always runs the kernel."""
        x = as_table(x, device)
        # reconcile here, not in run(): the delegation below must not
        # double-record the request
        self._reconcile(plan, "pairs", x,
                        measured_slots=_bucket_valid_slots(plan))
        srcmap = uploaded(
            f"srcmap:{m}", plan, x,
            lambda dev: torch.as_tensor(_pair_source_map(plan, m),
                                        device=dev).long())
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or not plan.buckets:
            return self.run(x, plan, reducer_fn, mesh=mesh, device=x.device,
                            postprocess=_assemble_from_srcmap,
                            postprocess_arg=srcmap)
        self._count("calls")
        per_bucket, flat = self._finished(x, plan, metric, mesh)
        return _assemble_from_srcmap(per_bucket, srcmap, flat)

    def run_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                use_kernel=False, device=None):
        """Rectangular fused path: independent X/Y gather maps drive the
        rectangular gather+Gram kernel, and ONE inverse-shuffle gather
        assembles the (mx, my) matrix.  Without a process group the
        launches are those of ``assembly.rect_launch_plan``: ONE per tight
        ``(wx, wy)`` class of each bucket's reducers, so a launch computes
        little more than its valid pairs; each writes straight into its
        class's view of that launch plan's block vector
        (``assembly.block_layout``), which the assembly gathers from with
        no copy, through the launch plan's source map.  With a ``mesh``,
        ONE launch per plan bucket on this rank's block of its rows (the
        plan's padding makes the rows split evenly), then ONE all-gather.
        Each launch finishes the metric (in the kernel's epilogue up to
        32 wide a side, see ``fused_gather_gram_rect``).  Non-Gram
        reducers fall back to the rect-bucketed path (identical outputs;
        counted).  ``use_kernel`` is accepted for signature parity.  Each
        launch counts its entries in
        ``fused.rect_entries{kind=valid|computed}``; the assembly runs in
        an ``assemble`` span."""
        xt, yt = _as_tables(tables, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or not plan.buckets:
            self._reconcile(plan, "x2y", xt,
                            measured_slots=_bucket_valid_slots(plan))
            self._count_fallback(
                "non_gram_reducer" if metric is None else "no_buckets")
            per_bucket = run_reducers_x2y_bucketed(
                (xt, yt), plan, reducer_fn, mesh=mesh, combine="buckets",
                device=xt.device)
            return assemble_x2y_matrix_bucketed(per_bucket, shape,
                                                device=xt.device)
        group, S, rank = _compat.reducer_group(mesh)
        launch = plan if group is not None else rect_launch_plan(plan)
        mine = [rank_rows(b.R, S, rank) for b in launch.buckets]
        self._count("kernel" if xt.is_cuda else "streamed")
        mx, my = shape
        arrays = uploaded("x2y-buckets", launch, xt,
                          lambda dev: rect_bucket_arrays(launch, dev),
                          ytable=yt)
        layout = block_layout(launch) if group is None else None
        flat = None if layout is None else layout.vector(xt.device)
        # the epilogue reads the tables' norms: two small reductions first
        norms = rect_table_norms(xt, yt, metric)
        # the largest block first, and each later block's view, the ledger
        # and the source map after its launch: the card starts on its
        # longest kernel while the host does the rest (small buckets first,
        # and the host's bookkeeping before any launch, kept the card
        # waiting on the host)
        local = [None] * len(arrays)
        for i in _largest_first(launch, mine):
            r = mine[i]
            s = [a[r] for a in arrays[i][:4]]
            _RECT_VALID.inc(_rect_valid_pairs(launch, i, r))
            _RECT_COMPUTED.inc(s[0].numel() * s[2].shape[1])
            out = None if flat is None else layout.view(flat, i)
            local[i] = fused_gather_gram_rect(xt, yt, *s, metric, out,
                                              norms)
        if flat is not None:
            flat[:1].zero_()        # after the launches, off the prologue
        self._reconcile(plan, "x2y", xt,
                        measured_slots=_bucket_valid_slots(plan))
        srcmap = uploaded(
            f"srcmap-rect:{mx}x{my}", launch, xt,
            lambda dev: torch.as_tensor(
                _pair_source_map_rect(launch, mx, my), device=dev).long(),
            ytable=yt)
        # rectangular inverse shuffle: ONE assembly gather through the
        # host-built source map (slot 0 -> 0.0 for uncovered cells)
        per_bucket = (None if group is None else
                      list(zip(arrays, all_ranks(local, group, S))))
        return _assemble_from_srcmap(per_bucket, srcmap, flat)


# ---------------------------------------------------------------------------
# sharded (LPT-balanced, one rank per shard) executor
# ---------------------------------------------------------------------------
def _stacked_groups(plan: ReducerPlan, part: PlanPartition,
                    rows_by_shard=None):
    """Stack the partition into uniform per-width arrays.

    For every execution width ``w`` appearing in the partition, build
    ``idx (S, Rw, w)`` / ``mask (S, Rw, w)`` / ``rows (S, Rw)`` where
    ``Rw = max_s |shard s's width-w reducers|`` — each shard's rows padded
    (masked, rows -> plan.R) to the common count, so every rank runs the
    same shapes and the ranks' blocks concatenate into one all-gather.
    LPT balances total work, so the cross-shard padding this stacking adds
    is small exactly when the balance factor is small.  Returns
    ``[(idx, mask, rows), ...]`` with widths ascending (numpy; the executor
    uploads its rank's slice once per plan).

    ``rows_by_shard`` overrides the per-shard row sets (default: the
    partition's primary ``shard_rows``) — the coded executor passes
    ``part.replica_rows`` so every shard's stack holds all of its
    replicas, not just its primary assignment.
    """
    S = part.num_shards
    R0 = plan.num_reducers
    widths = part.widths
    if rows_by_shard is None:
        rows_by_shard = part.shard_rows
    # per-global-row source arrays at the row's execution width
    if plan.buckets:
        src_idx = {}
        src_mask = {}
        for b in plan.buckets:
            rows = np.asarray(b.rows)
            for i, g in enumerate(rows):
                if 0 <= g < R0:
                    src_idx[int(g)] = np.asarray(b.idx)[i]
                    src_mask[int(g)] = np.asarray(b.mask)[i]
    else:
        src_idx = {r: np.asarray(plan.idx)[r] for r in range(R0)}
        src_mask = {r: np.asarray(plan.mask)[r] for r in range(R0)}

    groups = []
    for w in sorted(set(int(x) for x in widths)) if R0 else []:
        per_shard = [rows[widths[rows] == w] for rows in rows_by_shard]
        Rw = max((len(p) for p in per_shard), default=0)
        if Rw == 0:
            continue
        idx = np.zeros((S, Rw, w), np.int32)
        mask = np.zeros((S, Rw, w), bool)
        rows_out = np.full((S, Rw), plan.R, np.int32)   # padding -> row R
        for s, p in enumerate(per_shard):
            for k, g in enumerate(p):
                idx[s, k, :] = src_idx[int(g)][:w]
                mask[s, k, :] = src_mask[int(g)][:w]
                rows_out[s, k] = int(g)
        groups.append((idx, mask, rows_out))
    return groups


def _flat_stack(a: np.ndarray) -> np.ndarray:
    """An ``(S, Rw, w)`` stacked slot array as ``(S * Rw, w)`` rows."""
    return a.reshape(-1, a.shape[-1])


def _sharded_srcmap(groups, m: int) -> np.ndarray:
    """Inverse-shuffle map for the cross-shard assembly gather: (m, m)
    int32 positions into ``[0.0, group_0.ravel(), group_1.ravel(), ...]``
    of the stacked per-width Gram outputs (each ``(S, Rw, w, w)``).
    Uncovered cells and the diagonal point at slot 0 (-> 0.0)."""
    return source_map(((_flat_stack(i), _flat_stack(k)) * 2
                       for i, k, _rows in groups), (m, m), True)


def _stacked_rect_groups(plan: ReducerPlan, part: PlanPartition,
                         rows_by_shard=None):
    """Rectangular analogue of :func:`_stacked_groups`: groups keyed by the
    (wx, wy) execution-width *pair*, each stacked into
    ``xidx/xmask (S, Rw, wx)``, ``yidx/ymask (S, Rw, wy)``, ``rows (S, Rw)``
    arrays (padding rows masked, rows -> plan.R).  ``rows_by_shard``
    overrides the per-shard row sets as in :func:`_stacked_groups`."""
    S = part.num_shards
    R0 = plan.num_reducers
    widths = part.widths
    ywidths = part.ywidths
    if rows_by_shard is None:
        rows_by_shard = part.shard_rows
    src = {}
    if plan.buckets:
        for b in plan.buckets:
            rows = np.asarray(b.rows)
            for i, g in enumerate(rows):
                if 0 <= g < R0:
                    src[int(g)] = (np.asarray(b.idx)[i],
                                   np.asarray(b.mask)[i],
                                   np.asarray(b.yidx)[i],
                                   np.asarray(b.ymask)[i])
    else:
        for r in range(R0):
            src[r] = (np.asarray(plan.idx)[r], np.asarray(plan.mask)[r],
                      np.asarray(plan.yidx)[r], np.asarray(plan.ymask)[r])

    keys = sorted({(int(widths[r]), int(ywidths[r]))
                   for r in range(R0)}) if R0 else []
    groups = []
    for wx, wy in keys:
        per_shard = [rows[(widths[rows] == wx) & (ywidths[rows] == wy)]
                     for rows in rows_by_shard]
        Rw = max((len(p) for p in per_shard), default=0)
        if Rw == 0:
            continue
        xidx = np.zeros((S, Rw, wx), np.int32)
        xmask = np.zeros((S, Rw, wx), bool)
        yidx = np.zeros((S, Rw, wy), np.int32)
        ymask = np.zeros((S, Rw, wy), bool)
        rows_out = np.full((S, Rw), plan.R, np.int32)   # padding -> row R
        for s, p in enumerate(per_shard):
            for k, g in enumerate(p):
                xi, xm, yi, ym = src[int(g)]
                xidx[s, k, :] = xi[:wx]
                xmask[s, k, :] = xm[:wx]
                yidx[s, k, :] = yi[:wy]
                ymask[s, k, :] = ym[:wy]
                rows_out[s, k] = int(g)
        groups.append((xidx, xmask, yidx, ymask, rows_out))
    return groups


def _sharded_rect_srcmap(groups, shape: tuple[int, int]) -> np.ndarray:
    """Rectangular cross-shard assembly map: (mx, my) int32 positions into
    ``[0.0, group_0.ravel(), ...]`` of the stacked per-(wx, wy) cross-Gram
    outputs (each ``(S, Rw, wx, wy)``).  No diagonal to zero — an (x, y)
    pair is never a self-pair; uncovered cells point at slot 0."""
    return source_map((tuple(_flat_stack(a) for a in g[:4]) for g in groups),
                      shape, False)


def _rank_slices(kind: str, plan, xt, groups, rank: int, n: int, yt=None):
    """This rank's slice ``a[rank]`` of the first ``n`` arrays of every
    stacked group, on the table's device, uploaded once per (plan, device,
    ``kind``) through the upload LRU."""
    return uploaded(kind, plan, xt, lambda dev: tuple(
        tuple(torch.as_tensor(a[rank], device=dev) for a in grp[:n])
        for grp in groups), ytable=yt)


def _by_group(gathered: torch.Tensor, shapes, S: int) -> list:
    """The all-gathered vector is rank-major (rank 0's blocks of every
    group, then rank 1's, ...); the source maps index the groups one after
    the other, each ``(S, Rw, wx, wy)``.  Returns one such view per
    group."""
    per = gathered.view(S, -1).split([r * a * b for r, a, b in shapes], 1)
    return [p.reshape(S, *shape) for p, shape in zip(per, shapes)]


class ShardedExecutor(Executor):
    """Shard-balanced execution of a reducer plan over a process group.

    ``repro_torch.core.planner.partition_plan`` LPT-balances the plan's
    reducers (weighted by per-reducer gather+FLOP work at their
    capacity-bucket width) over the group's ranks.  The partition is
    stacked into uniform per-width arrays, and every rank launches the
    gather+Gram kernel once per width group over exactly its own slice
    (its plain version on a CPU table).  The only cross-rank communication
    is ONE all-gather of the finished blocks, which the (m, m) matrix is
    then gathered from through a host-built source map (``run_pairs``),
    or which is scattered back into reducer order (``run``).  Every rank
    returns the whole result.

    ``mesh`` is a ``torch.distributed.ProcessGroup`` (``None``: the default
    group if one is initialised, else one shard; see
    ``repro_torch.compat.shard_group``).  Like the fused executor, only
    Gram-block reducers (``fused_metric`` tag) take the sharded path;
    anything else, and an empty plan, falls back to the bucketed executor
    (counted in ``stats()``), which then runs whole on every rank.
    """

    name = "sharded"

    def _fresh_stats(self) -> dict:
        return {"calls": 0, "sharded": 0, "fallbacks": 0, "num_shards": 0,
                "balance_factor": 0.0}

    # -- partition plumbing (host-side static artifacts, cached on plan) --
    def partition(self, plan: ReducerPlan,
                  num_shards: int) -> PlanPartition:
        """The plan's LPT partition for ``num_shards`` (cached on the plan
        like the index matrix: a static artifact reused across waves)."""
        return plan_memo(plan, "_shard_partition_cache",
                         lambda: partition_plan(plan, num_shards), num_shards)

    def _groups_for(self, plan, part):
        return plan_memo(plan, "_shard_groups_cache",
                         lambda: _stacked_groups(plan, part), part.num_shards)

    def _srcmap_for(self, plan, groups, num_shards: int, m: int):
        return plan_memo(plan, "_shard_srcmap_cache",
                         lambda: _sharded_srcmap(groups, m), (num_shards, m))

    def _rect_groups_for(self, plan, part):
        return plan_memo(plan, "_shard_rect_groups_cache",
                         lambda: _stacked_rect_groups(plan, part),
                         part.num_shards)

    def _rect_srcmap_for(self, plan, groups, num_shards: int, shape):
        return plan_memo(plan, "_shard_rect_srcmap_cache",
                         lambda: _sharded_rect_srcmap(groups, shape),
                         (num_shards, shape))

    def _note(self, part: PlanPartition) -> None:
        self._stats["num_shards"] = part.num_shards
        self._stats["balance_factor"] = float(part.balance_factor)
        _REGISTRY_OBS.gauge("executor.num_shards",
                            executor=self.name).set(part.num_shards)
        _REGISTRY_OBS.gauge("executor.balance_factor",
                            executor=self.name).set(part.balance_factor)

    def _dispatch(self, x, plan, metric, combine, srcmap_m, mesh,
                  shard_axes, workload: str = "reduce"):
        group, S, rank = _compat.shard_group(mesh, shard_axes)
        part = self.partition(plan, S)
        groups = self._groups_for(plan, part)
        self._count("sharded")
        self._note(part)
        if _obs_config.ENABLED:
            assembled = 0
            meta = {"num_shards": S, "combine": combine}
            if combine == "pairs":
                _d, isz = _row_bytes(x)
                per_shard = int(_group_gram_entries(
                    plan, ("gram", S), groups) * isz * (S - 1) / S)
                assembled = S * per_shard
                meta["assembly_bytes_per_shard"] = per_shard
            self._reconcile(
                plan, workload, x,
                measured_slots=_group_valid_slots(
                    plan, ("sharded", S), groups, count_y=False),
                assembled_bytes=assembled, meta=meta)
        local = torch.cat([
            fused_gather_gram(x, idx, msk, metric).reshape(-1)
            for idx, msk in _rank_slices(f"sharded:{S}:{rank}", plan, x,
                                         groups, rank, 2)])
        # ONE cross-rank collective: every rank's finished blocks
        blocks = _by_group(_compat.all_gather(local, group),
                           [(i.shape[1], i.shape[2], i.shape[2])
                            for i, _k, _r in groups], S)
        if combine == "pairs":
            srcmap = uploaded(
                f"sharded-srcmap:{S}:{srcmap_m}", plan, x,
                lambda dev: torch.as_tensor(
                    self._srcmap_for(plan, groups, S, srcmap_m),
                    device=dev).long())
            return with_zero_slot(blocks, x.device)[srcmap]
        # dense combine: scatter the blocks (padded to the dense width)
        # back into reducer order; padding rows drop into row R
        rows = uploaded(f"sharded-rows:{S}", plan, x, lambda dev: tuple(
            torch.as_tensor(r.reshape(-1), device=dev).long()
            for _i, _k, r in groups))
        R, L = plan.R, plan.L
        acc = torch.zeros((R + 1, L, L), dtype=torch.float32,
                          device=x.device)
        for r, g in zip(rows, blocks):
            w = g.shape[-1]
            acc[r] = torch.nn.functional.pad(g.reshape(-1, w, w),
                                             (0, L - w, 0, L - w))
        return acc[:R]

    # -- protocol ----------------------------------------------------------
    def run(self, inputs, plan, reducer_fn, *, mesh=None, shard_axes=None,
            device=None, combine: str = "dense"):
        """Dense-combine semantics match ``run_reducers`` for Gram-block
        reducers; non-Gram reducers fall back to the bucketed executor
        (identical outputs — sharding is a pure execution-plan change)."""
        assert combine == "dense", combine
        x = as_table(inputs, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or plan.num_reducers == 0:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "empty_plan")
            return run_reducers_bucketed(x, plan, reducer_fn,
                                         combine=combine, device=x.device)
        return self._dispatch(x, plan, metric, "dense", None, mesh,
                              shard_axes)

    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        """``use_kernel`` is accepted for signature parity: on a CUDA table
        every rank runs the kernel."""
        x = as_table(x, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or plan.num_reducers == 0:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "empty_plan")
            self._reconcile(plan, "pairs", x,
                            measured_slots=_bucket_valid_slots(plan))
            per_bucket = run_reducers_bucketed(x, plan, reducer_fn,
                                               combine="buckets",
                                               device=x.device)
            return assemble_pair_matrix_bucketed(per_bucket, m,
                                                 device=x.device)
        return self._dispatch(x, plan, metric, "pairs", m, mesh, None,
                              workload="pairs")

    def run_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                use_kernel=False, device=None):
        """LPT-balance the rectangular plan over the group (per-reducer
        work = wx + wy + flop·wx·wy), launch the rectangular gather+Gram
        kernel per (wx, wy) group on every rank's own slice, and assemble
        the (mx, my) matrix from ONE all-gather.  Non-Gram reducers fall
        back to the rect-bucketed path (counted)."""
        xt, yt = _as_tables(tables, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or plan.num_reducers == 0:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "empty_plan")
            self._reconcile(plan, "x2y", xt,
                            measured_slots=_bucket_valid_slots(plan))
            per_bucket = run_reducers_x2y_bucketed(
                (xt, yt), plan, reducer_fn, combine="buckets",
                device=xt.device)
            return assemble_x2y_matrix_bucketed(per_bucket, shape,
                                                device=xt.device)
        group, S, rank = _compat.shard_group(mesh)
        part = self.partition(plan, S)
        groups = self._rect_groups_for(plan, part)
        self._count("sharded")
        self._note(part)
        if _obs_config.ENABLED:
            _d, isz = _row_bytes(xt)
            per_shard = int(_group_gram_entries(
                plan, ("gram_rect", S), groups) * isz * (S - 1) / S)
            self._reconcile(
                plan, "x2y", xt,
                measured_slots=_group_valid_slots(
                    plan, ("sharded_rect", S), groups, count_y=True),
                assembled_bytes=S * per_shard,
                meta={"num_shards": S,
                      "assembly_bytes_per_shard": per_shard})
        norms = rect_table_norms(xt, yt, metric)
        local = torch.cat([
            fused_gather_gram_rect(xt, yt, *s, metric, None,
                                   norms).reshape(-1)
            for s in _rank_slices(f"sharded-x2y:{S}:{rank}", plan, xt,
                                  groups, rank, 4, yt)])
        # ONE cross-rank collective, then the inverse shuffle
        blocks = _by_group(_compat.all_gather(local, group),
                           [(xi.shape[1], xi.shape[2], yi.shape[2])
                            for xi, _xm, yi, _ym, _r in groups], S)
        mx, my = shape
        srcmap = uploaded(
            f"sharded-srcmap-rect:{S}:{mx}x{my}", plan, xt,
            lambda dev: torch.as_tensor(
                self._rect_srcmap_for(plan, groups, S, (mx, my)),
                device=dev).long(), ytable=yt)
        return with_zero_slot(blocks, xt.device)[srcmap]


# ---------------------------------------------------------------------------
# coded (replicated shuffle) executor
# ---------------------------------------------------------------------------
def _coded_maps(groups, shape: tuple[int, int], row_block: int,
                zero_diag: bool):
    """Host-side maps for the coded combining stage.

    ``groups`` are replica-stacked rect groups
    ``[(xidx (S,Rw,wx), xmask, yidx (S,Rw,wy), ymask, rows (S,Rw)), ...]``
    where ``rows`` holds each shard's full replica set (padding slots have
    all-false masks and are skipped).  The output ``(mx, my)`` matrix is
    row-sliced: shard ``s`` owns rows ``[s*row_block, (s+1)*row_block)``.

    Per output cell the serving Gram entry is resolved to either a
    position in the owning shard's *local* value vector (a replica is
    held: zero traffic) or a slot in the residual exchange: for every
    (block, destination) pair with no local replica, the block rows whose
    output rows fall in the destination's slice — never the whole block —
    are stride-split across ALL replica holders (least-filled lane
    first), so each holder ships ~1/r of the residual and the exchange
    lanes shrink as replication grows.  The residual is batched into
    per-destination lanes and moved by ONE all-to-all sized by the
    maximum lane.

    Returns ``(sendmap (S, S, E) int32`` into the shard-local value
    vector, ``srcmap (S, row_block, my) int32`` into
    ``[vals_local (Lv), recv (S*E)]``, and a stats dict).  Slot 0 of the
    value vector is 0.0 (uncovered cells, padding lanes, the diagonal).
    """
    mx, my = shape
    S = groups[0][0].shape[0] if groups else 1
    # a shard's value vector holds its own (Rw, wx, wy) block of each group
    bases = BlockLayout((xidx.shape[1], xidx.shape[2], yidx.shape[2])
                        for xidx, _xm, yidx, _ym, _rows in groups).bases
    Lv = bases[-1]

    # holders: global row -> [(shard, group, slot), ...] (replica set)
    holders: dict[int, list] = {}
    for gi, (_xi, xmask, _yi, ymask, rows) in enumerate(groups):
        live = xmask.any(axis=2) & ymask.any(axis=2)      # (S, Rw)
        for s, k in np.argwhere(live):
            holders.setdefault(int(rows[s, k]), []).append(
                (int(s), gi, int(k)))

    send: list[list[list]] = [[[] for _ in range(S)] for _ in range(S)]
    cnt = np.zeros((S, S), dtype=np.int64)
    recv_fill: list[list] = [[] for _ in range(S)]
    srcmap = np.zeros((S, row_block, my), dtype=np.int64)
    local_entries = 0
    for _b, hl in holders.items():
        s0, gi, k0 = hl[0]
        xidx, xmask, yidx, ymask, _rows = groups[gi]
        wx, wy = xidx.shape[2], yidx.shape[2]
        pv = np.flatnonzero(xmask[s0, k0])
        qv = np.flatnonzero(ymask[s0, k0])
        if not pv.size or not qv.size:
            continue
        gx = xidx[s0, k0][pv].astype(np.int64)
        gy = yidx[s0, k0][qv].astype(np.int64)
        ds = gx // row_block
        hpos = {s: bases[g] + k * wx * wy for s, g, k in hl}
        for s in np.unique(ds):
            s = int(s)
            sel = ds == s
            p_s, gx_s = pv[sel], gx[sel]
            if s in hpos:                      # local replica: no traffic
                pos = hpos[s] + (p_s[:, None] * wy + qv[None, :])
                srcmap[s][np.ix_(gx_s - s * row_block, gy)] = pos
                local_entries += pos.size
            else:                              # residual: split over holders
                hs = sorted(hpos, key=lambda tt: cnt[tt, s])
                for j, t in enumerate(hs):
                    p_j, gx_j = p_s[j::len(hs)], gx_s[j::len(hs)]
                    if not p_j.size:
                        continue
                    pos = hpos[t] + (p_j[:, None] * wy + qv[None, :])
                    send[t][s].append(pos.ravel())
                    recv_fill[s].append((t, int(cnt[t, s]), gx_j, gy))
                    cnt[t, s] += pos.size
    E = max(1, int(cnt.max(initial=0)))
    sendmap = np.zeros((S, S, E), dtype=np.int64)
    for t in range(S):
        for s in range(S):
            if send[t][s]:
                v = np.concatenate(send[t][s])
                sendmap[t, s, :len(v)] = v
    for s in range(S):
        for t, e0, gx_s, gy in recv_fill[s]:
            e = e0 + np.arange(len(gx_s) * len(gy), dtype=np.int64)
            srcmap[s][np.ix_(gx_s - s * row_block, gy)] = (
                Lv + t * E + e.reshape(len(gx_s), len(gy)))
    if zero_diag:
        for s in range(S):
            d = np.arange(s * row_block, min((s + 1) * row_block, mx))
            srcmap[s, d - s * row_block, d] = 0
    stats = {
        "local_entries": int(local_entries),
        "residual_entries": int(cnt.sum()),
        "lane_max": E,
        "lane_fill": float(cnt.sum() / max(S * S * E, 1)),
        "vals_len": int(Lv),
    }
    return (sendmap.astype(np.int32), srcmap.astype(np.int32), stats)


class CodedExecutor(ShardedExecutor):
    """Coded shuffle execution: trade replication for cross-rank traffic.

    The sharded executor pays ONE all-gather to assemble the (m, m)
    matrix — every rank receives every Gram stack.  The coded executor
    (the coded-MapReduce tradeoff of Afrati et al., arXiv:1206.4377)
    spends replication to cut that traffic: ``partition_plan(...,
    replication=r)`` materializes each reducer's sub-plan on r LPT-chosen
    ranks, the output matrix is row-sliced across ranks, and assembly
    becomes a coded combining stage — a rank holding a replica serves its
    slice's cells from local Gram entries (zero traffic), and only the
    residual entries (block rows owned by a slice with no replica) are
    exchanged, batched into per-destination lanes and moved by ONE
    all-to-all.  Per rank the residual is ~``2G/S * (1 - r/S)`` entries
    (G = total Gram entries) vs ~``G`` for the uncoded all-gather;
    ``choose_replication`` picks the knee of the
    replication-vs-communication frontier.

    Every rank runs the rectangular gather+Gram kernel once per stacked
    group over its replicas (the square path passes one table as both
    sides).  The reference returns a row-sharded global array; here every
    rank returns the whole matrix, so a last all-gather of the row slices
    follows the coded exchange (the comm ledger does not count it, as the
    reference does not count reading its global array).  Same fallback
    rules as the sharded executor (Gram-block reducers only);
    ``replication`` is clamped to the group's size.
    """

    name = "coded"

    def __init__(self, stats: Optional[dict] = None, replication: int = 2):
        super().__init__(stats=stats)
        self.replication = int(replication)

    def _fresh_stats(self) -> dict:
        return {"calls": 0, "coded": 0, "fallbacks": 0, "num_shards": 0,
                "balance_factor": 0.0, "replication": 0,
                "local_entries": 0, "residual_entries": 0,
                "local_fraction": 0.0}

    # -- replication-aware partition plumbing (cached on the plan) --------
    def partition_coded(self, plan: ReducerPlan, num_shards: int,
                        replication: Optional[int] = None) -> PlanPartition:
        r = min(self.replication if replication is None else int(replication),
                num_shards)
        return plan_memo(
            plan, "_coded_partition_cache",
            lambda: partition_plan(plan, num_shards, replication=r),
            (num_shards, r))

    def _coded_groups_for(self, plan, part, rect: bool):
        def build():
            if rect:
                return _stacked_rect_groups(
                    plan, part, rows_by_shard=part.replica_rows)
            return [(i, k, i, k, r) for i, k, r in _stacked_groups(
                plan, part, rows_by_shard=part.replica_rows)]
        return plan_memo(plan, "_coded_groups_cache", build,
                         (part.num_shards, part.replication, rect))

    def _coded_maps_for(self, plan, groups, part, shape, zero_diag: bool):
        def build():
            check_int32(1 + sum(g[0].size * g[2].shape[2] for g in groups))
            rb = -(-shape[0] // part.num_shards)
            maps = _coded_maps(groups, tuple(shape), rb, zero_diag)
            check_int32(maps[2]["vals_len"]
                        + part.num_shards * maps[2]["lane_max"])
            return maps
        return plan_memo(plan, "_coded_maps_cache", build, (
            part.num_shards, part.replication, tuple(shape), zero_diag))

    def _note_coded(self, part: PlanPartition, mstats: dict) -> None:
        self._note(part)
        self._stats["replication"] = int(part.replication)
        self._stats["local_entries"] = mstats["local_entries"]
        self._stats["residual_entries"] = mstats["residual_entries"]
        tot = mstats["local_entries"] + mstats["residual_entries"]
        self._stats["local_fraction"] = (
            mstats["local_entries"] / tot if tot else 1.0)
        _REGISTRY_OBS.gauge("executor.replication",
                            executor=self.name).set(part.replication)
        _REGISTRY_OBS.gauge("executor.local_fraction",
                            executor=self.name).set(
                                self._stats["local_fraction"])

    def _coded_dispatch(self, xt, yt, plan, metric, shape, zero_diag,
                        mesh, shard_axes, rect: bool,
                        workload: str = "pairs"):
        group, S, rank = _compat.shard_group(mesh, shard_axes)
        part = self.partition_coded(plan, S)
        groups = self._coded_groups_for(plan, part, rect)
        sendmap, srcmap, mstats = self._coded_maps_for(
            plan, groups, part, shape, zero_diag)
        self._count("coded")
        self._note_coded(part, mstats)
        if _obs_config.ENABLED:
            # identical ring accounting to ``coded_assembly_model``:
            # residual lanes x itemsize x (S-1)/S per shard
            _d, isz = _row_bytes(xt)
            frac = (S - 1) / S if S > 1 else 0.0
            per_shard = int(sendmap.shape[1] * sendmap.shape[2]
                            * isz * frac)
            self._reconcile(
                plan, workload, xt,
                measured_slots=_group_valid_slots(
                    plan, ("coded", S, part.replication, rect), groups,
                    count_y=rect),
                replication=float(part.replication),
                assembled_bytes=S * per_shard,
                local_bytes=int(mstats["local_entries"]) * isz,
                residual_bytes=int(mstats["residual_entries"]) * isz,
                meta={"num_shards": S,
                      "replication": int(part.replication),
                      "assembly_bytes_per_shard": per_shard,
                      "lane_max": mstats["lane_max"]})
        key = f"coded:{S}:{part.replication}:{rect}:{rank}"
        slices = _rank_slices(key, plan, xt, groups, rank, 4, yt)
        send_r, src_r = uploaded(
            f"{key}:maps:{shape[0]}x{shape[1]}:{zero_diag}", plan, xt,
            lambda dev: (torch.as_tensor(sendmap[rank], device=dev).long(),
                         torch.as_tensor(srcmap[rank], device=dev).long()),
            ytable=yt)
        norms = rect_table_norms(xt, yt, metric)
        vloc = with_zero_slot([fused_gather_gram_rect(xt, yt, *s, metric,
                                                      None, norms)
                               for s in slices], xt.device)
        # coded combining: replicas serve locally through the source map;
        # ONLY the residual lanes cross ranks, in one all-to-all
        recv = _compat.all_to_all(vloc[send_r], group)          # (S, E)
        mine = torch.cat([vloc, recv.reshape(-1)])[src_r]      # (rb, my)
        # every rank returns the whole matrix: gather the row slices
        rows = _compat.all_gather(mine.reshape(-1), group)
        return rows.view(-1, shape[1])[:shape[0]]

    # -- protocol ----------------------------------------------------------
    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        x = as_table(x, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or plan.num_reducers == 0:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "empty_plan")
            self._reconcile(plan, "pairs", x,
                            measured_slots=_bucket_valid_slots(plan))
            per_bucket = run_reducers_bucketed(x, plan, reducer_fn,
                                               combine="buckets",
                                               device=x.device)
            return assemble_pair_matrix_bucketed(per_bucket, m,
                                                 device=x.device)
        return self._coded_dispatch(x, x, plan, metric, (m, m), True, mesh,
                                    None, rect=False, workload="pairs")

    def run_x2y(self, tables, plan, reducer_fn, shape, *, mesh=None,
                use_kernel=False, device=None):
        xt, yt = _as_tables(tables, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or plan.num_reducers == 0:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "empty_plan")
            self._reconcile(plan, "x2y", xt,
                            measured_slots=_bucket_valid_slots(plan))
            per_bucket = run_reducers_x2y_bucketed(
                (xt, yt), plan, reducer_fn, combine="buckets",
                device=xt.device)
            return assemble_x2y_matrix_bucketed(per_bucket, shape,
                                                device=xt.device)
        return self._coded_dispatch(xt, yt, plan, metric, tuple(shape),
                                    False, mesh, None, rect=True,
                                    workload="x2y")


def coded_assembly_model(plan, num_shards: int, replication: int, m: int,
                         *, itemsize: int = 4) -> dict:
    """Analytic bytes of the coded combining stage at replication ``r`` —
    host-only (builds the real send/recv maps, runs nothing).

    ``assembly_bytes_per_shard`` uses the reference's ring accounting
    (result bytes x (S-1)/S for the all-to-all), so model and measured
    numbers are directly comparable;
    ``uncoded_assembly_bytes_per_shard`` is the sharded executor's
    all-gather of the full primary Gram stacks under the same accounting.
    """
    S = int(num_shards)
    r = min(int(replication), S)
    part = partition_plan(plan, S, replication=r)
    sq = _stacked_groups(plan, part, rows_by_shard=part.replica_rows)
    groups = [(i, k, i, k, rows) for i, k, rows in sq]
    rb = -(-int(m) // S)
    sendmap, _srcmap, st = _coded_maps(groups, (int(m), int(m)), rb, True)
    frac = (S - 1) / S if S > 1 else 0.0
    primary = _stacked_groups(plan, part)
    gram_entries = sum(int(np.prod(i.shape[:2])) * i.shape[2] ** 2
                       for i, _k, _r in primary)
    return {
        "replication": r,
        "num_shards": S,
        "local_entries": st["local_entries"],
        "residual_entries": st["residual_entries"],
        "local_fraction": (
            st["local_entries"]
            / max(st["local_entries"] + st["residual_entries"], 1)),
        "lane_max": st["lane_max"],
        "lane_fill": st["lane_fill"],
        "assembly_bytes_per_shard": int(sendmap.shape[1] * sendmap.shape[2]
                                        * itemsize * frac),
        "uncoded_assembly_bytes_per_shard": int(gram_entries * itemsize
                                                * frac),
        "replica_slots": [int(x) for x in part.replica_slots],
    }


def choose_replication(plan, num_shards: int, m: int, d: int, *,
                       itemsize: int = 4,
                       candidates=None) -> tuple[int, list[dict]]:
    """Auto-``r``: sweep the replication-vs-communication frontier and
    pick the knee for ``num_shards`` shards.

    Total cluster communication at replication r =
    ``r x shipped input bytes`` (every replica shard receives its
    sub-plan's input rows: the paper's map->reduce cost scales linearly
    with r) ``+ S x assembly bytes per shard`` (falls with r as replicas
    serve locally).  The knee is the argmin of that total — past it,
    extra replicas ship more input rows than they save in assembly.
    Returns ``(best_r, frontier)`` with one model row per candidate,
    each including the total and both terms.
    """
    S = int(num_shards)
    if candidates is None:
        candidates = []
        r = 1
        while r <= S:
            candidates.append(r)
            r *= 2
    shipped_bytes = float(plan.comm_cost) * d * itemsize
    frontier = []
    for r in sorted(set(min(int(c), S) for c in candidates)):
        rec = coded_assembly_model(plan, S, r, m, itemsize=itemsize)
        rec["shipped_bytes"] = r * shipped_bytes
        rec["total_comm_bytes"] = (rec["shipped_bytes"]
                                   + S * rec["assembly_bytes_per_shard"])
        frontier.append(rec)
    best = min(frontier, key=lambda rec: rec["total_comm_bytes"])
    return best["replication"], frontier


# ---------------------------------------------------------------------------
# default registry instances
# ---------------------------------------------------------------------------
register_executor(DenseExecutor())
register_executor(BucketedExecutor())
register_executor(FusedExecutor())
register_executor(ShardedExecutor())
register_executor(CodedExecutor())
