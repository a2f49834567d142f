"""Mapping schema -> static gather plan -> reducer execution, in PyTorch.

Port of ``repro.mapreduce.engine``.  The plan substrate (``ReducerBucket``,
``ReducerPlan``, ``build_plan``, the rectangular ``build_x2y_plan`` and the
CSR ``SparsePlan`` / ``block_subplan`` of block serving) is the reference's
numpy code unchanged, so both packages build byte-equal plans from one
schema.  Execution is eager PyTorch on an explicit device:

``run_reducers``           — the dense path: one gather padded to the global
                             max slot count, ``reducer_fn`` applied over the
                             reducer axis through ``torch.func.vmap``.
``run_reducers_bucketed``  — the skew-aware path: one gather+reduce per
                             capacity bucket, each padded only to its own
                             width; ``combine='dense'`` scatters bucket
                             outputs back into original reducer order,
                             ``combine='buckets'`` keeps them unpadded.
``run_reducers_x2y[_bucketed]`` — the rectangular (X2Y) twins: two
                             gathers (X side, Y side) per reducer, each
                             padded to its own width.

``reducer_fn(block (L, d), mask (L,)) -> tensor`` (rectangular:
``reducer_fn(xblock, xmask, yblock, ymask)``) is generic here; the fused
executor (``executors.FusedExecutor``) runs Gram-block reducers through the
hand-written gather+Gram kernels instead.  Gathers never read a masked
slot's index: a plan may leave anything there.

With no ``jit`` to cache, the engine's bounded LRU holds what each
(plan, device) pair uploads: index/mask/row tensors and the fused
assembly's source maps.  ``jit_cache_stats()`` keeps the reference's keys so
serving telemetry reads both packages alike; a ``shape_miss`` is a table
shape or dtype that an entry has not served before.

``plan_from_arrays`` rebuilds a plan from the fields of a reference plan
(``dataclasses.asdict``), so both packages can run one plan.  Block
sub-plans are LRU-cached per ``SparsePlan`` under one shared cap
(``REPRO_BLOCK_CACHE_SIZE`` / ``configure_block_cache``).

Every runner takes a ``mesh``: a ``torch.distributed.ProcessGroup`` of
``S`` ranks over which each bucket's reducer rows are split, as the
reference shards the reducer axis of ``idx`` / ``mask`` and the output
over its mesh while the table stays replicated.  Rank ``r`` runs rows
``[r Rb/S, (r+1) Rb/S)`` of every bucket (of the dense plan, for the dense
runners) and the ranks' outputs are assembled by ONE all-gather per call,
so every rank returns the whole result.  A bucket whose rows do not divide
by ``S`` raises ``ValueError``: plans for a group are built with
``pad_reducers_to=S``.  ``mesh=None`` runs locally, even when a default
group is initialised.  The ``sharded`` / ``coded`` executors partition a
plan over a group instead (``run_reducers_sharded`` is the shim over the
former).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import compat as _compat
from repro_torch._device import resolve_device
from repro_torch.core.planner import compute_buckets, compute_rect_buckets
from repro_torch.core.schema import MappingSchema
from repro_torch.kernels.pairwise.fused_gather_gram import gather_rows
from repro_torch.obs import EVENTS as _OBS_EVENTS
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import span as _obs_span

__all__ = [
    "ReducerBucket",
    "ReducerPlan",
    "build_plan",
    "build_x2y_plan",
    "build_x2y_plan_arrays",
    "SparsePlan",
    "build_sparse_plan",
    "block_subplan",
    "configure_block_cache",
    "block_cache_stats",
    "plan_from_arrays",
    "run_reducers",
    "run_reducers_bucketed",
    "run_reducers_x2y",
    "run_reducers_x2y_bucketed",
    "jit_cache_stats",
    "configure_jit_cache",
    "table_signatures",
    "FUSED_STATS",
    "fused_stats",
    "reset_fused_stats",
    "run_reducers_fused",
    "run_reducers_sharded",
]


@dataclasses.dataclass(frozen=True)
class ReducerBucket:
    """One capacity bucket of the plan: reducers padded to a shared width.

    rows  (Rb,) int64 — original plan-row ids in bucket order; -1 marks a
          padding row added so the bucket divides the device count.
    idx   (Rb, width) int32 / mask (Rb, width) bool — same layout as the
          dense plan, but only ``width`` slots wide.

    ``ywidth`` / ``yidx`` / ``ymask`` carry the Y side of rectangular (X2Y)
    buckets; ``yidx is None`` marks the square case.
    """

    width: int
    rows: np.ndarray
    idx: np.ndarray
    mask: np.ndarray
    ywidth: int = 0
    yidx: Optional[np.ndarray] = None
    ymask: Optional[np.ndarray] = None

    @property
    def R(self) -> int:
        return int(self.idx.shape[0])

    @property
    def is_rect(self) -> bool:
        return self.yidx is not None

    @property
    def padded_elements(self) -> int:
        """Gather slots this bucket materializes (both sides for rect)."""
        if self.is_rect:
            return self.R * (self.width + self.ywidth)
        return self.R * self.width


@dataclasses.dataclass(frozen=True)
class ReducerPlan:
    """Static arrays derived from a MappingSchema.

    idx   (R, L) int32 — input ids per reducer slot; padded entries point at
          input 0 and are masked out.
    mask  (R, L) bool  — slot validity.
    buckets — capacity buckets over the same reducers (skew-aware executor);
          every real reducer row appears in exactly one bucket.

    The plan also carries the schema's provenance (winning strategy, paper
    lower bound) for telemetry.  Rectangular (X2Y) plans add the Y side:
    ``yidx``/``ymask`` (R, Ly) index rows of a second table.
    """

    idx: np.ndarray
    mask: np.ndarray
    num_reducers: int          # before padding
    comm_cost: float           # schema communication cost (weighted bytes)
    max_inputs: int
    algorithm: str = "unknown"             # winning strategy (provenance)
    lower_bound: Optional[float] = None    # paper's comm lower bound
    buckets: tuple[ReducerBucket, ...] = ()
    yidx: Optional[np.ndarray] = None      # (R, Ly) int32 Y-table rows
    ymask: Optional[np.ndarray] = None     # (R, Ly) bool Y-slot validity
    max_y_inputs: int = 0
    num_x: int = 0                         # X-table size (rect plans)
    num_y: int = 0                         # Y-table size (rect plans)

    @property
    def R(self) -> int:
        return int(self.idx.shape[0])

    @property
    def L(self) -> int:
        return int(self.idx.shape[1])

    @property
    def is_rect(self) -> bool:
        """True for rectangular (X2Y) plans carrying a Y side."""
        return self.yidx is not None

    @property
    def Ly(self) -> int:
        """Dense Y-side slot count (== L for square plans)."""
        return int(self.yidx.shape[1]) if self.is_rect else self.L

    @property
    def optimality_gap(self) -> Optional[float]:
        """comm_cost / lower_bound (>= 1.0), or None without a bound."""
        if self.lower_bound is None or self.lower_bound <= 0.0:
            return None
        return self.comm_cost / self.lower_bound

    # ---------------------------------------------------------- telemetry
    @property
    def dense_padded_elements(self) -> int:
        """Gather slots the dense executor materializes (R x L; both sides
        for rectangular plans)."""
        if self.is_rect:
            return self.R * (self.L + self.Ly)
        return self.R * self.L

    @property
    def bucketed_padded_elements(self) -> int:
        """Gather slots the bucketed executor materializes."""
        if not self.buckets:
            return self.dense_padded_elements
        return sum(b.padded_elements for b in self.buckets)

    @property
    def padding_savings(self) -> float:
        """dense / bucketed padded elements (>= 1.0 up to row padding)."""
        return self.dense_padded_elements / max(self.bucketed_padded_elements,
                                                1)

    def bucket_widths(self) -> list[int]:
        return [b.width for b in self.buckets]


def _build_buckets(expanded: list[list[int]], *, pad_slots_to: int,
                   pad_reducers_to: int,
                   max_buckets: int) -> tuple[ReducerBucket, ...]:
    """Capacity buckets over expanded reducers (original row order kept
    within each bucket; rows padded to a multiple of ``pad_reducers_to``)."""
    counts = [len(ids) for ids in expanded]
    out = []
    for width, rows in compute_buckets(counts, pad_slots_to=pad_slots_to,
                                       max_buckets=max_buckets):
        Rb = -(-max(len(rows), 1) // pad_reducers_to) * pad_reducers_to
        idx = np.zeros((Rb, width), dtype=np.int32)
        mask = np.zeros((Rb, width), dtype=bool)
        rows_padded = np.full(Rb, -1, dtype=np.int64)
        rows_padded[: len(rows)] = rows
        for i, r in enumerate(rows):
            ids = expanded[r]
            idx[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        out.append(ReducerBucket(width=width, rows=rows_padded, idx=idx,
                                 mask=mask))
    return tuple(out)


def build_plan(schema: MappingSchema, *, pad_reducers_to: int = 1,
               pad_slots_to: int = 1, max_buckets: int = 8) -> ReducerPlan:
    """Flatten a schema into (idx, mask) plus capacity buckets.

    ``pad_reducers_to`` rounds reducer counts up to a multiple (device
    count) — applied to the dense plan and to every bucket independently;
    ``pad_slots_to`` rounds slot counts (kernel tile alignment);
    ``max_buckets`` bounds the number of capacity buckets (one kernel
    launch each on the fused square path; the fused X2Y path launches
    each rect bucket once per tight ``(wx, wy)`` class of its reducers,
    see ``assembly.rect_launch_plan``)."""
    with _obs_span("plan.build") as sp:
        expanded = schema.expand()
        R0 = len(expanded)
        L0 = max((len(ids) for ids in expanded), default=1)
        L = -(-L0 // pad_slots_to) * pad_slots_to
        R = -(-max(R0, 1) // pad_reducers_to) * pad_reducers_to
        idx = np.zeros((R, L), dtype=np.int32)
        mask = np.zeros((R, L), dtype=bool)
        for r, ids in enumerate(expanded):
            idx[r, : len(ids)] = ids
            mask[r, : len(ids)] = True
        buckets = _build_buckets(expanded, pad_slots_to=pad_slots_to,
                                 pad_reducers_to=pad_reducers_to,
                                 max_buckets=max_buckets)
        if sp is not None:
            sp.attrs.update(reducers=R0, buckets=len(buckets))
        return ReducerPlan(idx=idx, mask=mask, num_reducers=R0,
                           comm_cost=schema.communication_cost(),
                           max_inputs=L0, algorithm=schema.algorithm,
                           lower_bound=schema.lower_bound,
                           buckets=buckets)


# ---------------------------------------------------------------------------
# rectangular (X2Y) plans: per-reducer X-side and Y-side index lists
# ---------------------------------------------------------------------------
def _build_rect_buckets(xs: list[list[int]], ys: list[list[int]], *,
                        pad_slots_to: int, pad_reducers_to: int,
                        max_buckets: int) -> tuple[ReducerBucket, ...]:
    """Rectangular capacity buckets: reducers grouped by (wx, wy) width
    pairs (``compute_rect_buckets``), each side padded to its own
    power-of-two width; rows padded to a multiple of ``pad_reducers_to``."""
    out = []
    for wx, wy, rows in compute_rect_buckets(
            [len(a) for a in xs], [len(a) for a in ys],
            pad_slots_to=pad_slots_to, max_buckets=max_buckets):
        Rb = -(-max(len(rows), 1) // pad_reducers_to) * pad_reducers_to
        idx = np.zeros((Rb, wx), dtype=np.int32)
        mask = np.zeros((Rb, wx), dtype=bool)
        yidx = np.zeros((Rb, wy), dtype=np.int32)
        ymask = np.zeros((Rb, wy), dtype=bool)
        rows_padded = np.full(Rb, -1, dtype=np.int64)
        rows_padded[: len(rows)] = rows
        for i, r in enumerate(rows):
            a, b = xs[r], ys[r]
            idx[i, : len(a)] = a
            mask[i, : len(a)] = True
            yidx[i, : len(b)] = b
            ymask[i, : len(b)] = True
        out.append(ReducerBucket(width=wx, rows=rows_padded, idx=idx,
                                 mask=mask, ywidth=wy, yidx=yidx,
                                 ymask=ymask))
    return tuple(out)


def build_x2y_plan_arrays(
    xs: list[list[int]],               # per-reducer X-table row ids
    ys: list[list[int]],               # per-reducer Y-table row ids
    *,
    num_x: int,
    num_y: int,
    comm_cost: float = 0.0,
    algorithm: str = "x2y",
    lower_bound: Optional[float] = None,
    pad_reducers_to: int = 1,
    pad_slots_to: int = 1,
    max_buckets: int = 8,
) -> ReducerPlan:
    """Rectangular plan from explicit per-reducer X/Y id lists.

    The low-level builder ``build_x2y_plan`` and ``block_subplan`` share:
    reducer ``r`` gathers ``xs[r]`` from the X table and ``ys[r]`` from the
    Y table and emits the (|xs[r]|, |ys[r]|) cross block."""
    assert len(xs) == len(ys), (len(xs), len(ys))
    R0 = len(xs)
    Lx0 = max((len(a) for a in xs), default=1)
    Ly0 = max((len(a) for a in ys), default=1)
    Lx = -(-Lx0 // pad_slots_to) * pad_slots_to
    Ly = -(-Ly0 // pad_slots_to) * pad_slots_to
    R = -(-max(R0, 1) // pad_reducers_to) * pad_reducers_to
    idx = np.zeros((R, Lx), dtype=np.int32)
    mask = np.zeros((R, Lx), dtype=bool)
    yidx = np.zeros((R, Ly), dtype=np.int32)
    ymask = np.zeros((R, Ly), dtype=bool)
    for r in range(R0):
        a, b = xs[r], ys[r]
        idx[r, : len(a)] = a
        mask[r, : len(a)] = True
        yidx[r, : len(b)] = b
        ymask[r, : len(b)] = True
    buckets = _build_rect_buckets(xs, ys, pad_slots_to=pad_slots_to,
                                  pad_reducers_to=pad_reducers_to,
                                  max_buckets=max_buckets)
    return ReducerPlan(
        idx=idx, mask=mask, num_reducers=R0, comm_cost=float(comm_cost),
        max_inputs=Lx0, algorithm=algorithm, lower_bound=lower_bound,
        buckets=buckets, yidx=yidx, ymask=ymask, max_y_inputs=Ly0,
        num_x=int(num_x), num_y=int(num_y))


# ---------------------------------------------------------------------------
# sparse plans: CSR gather maps for block-addressed serving (no O(m^2) host)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SparsePlan:
    """CSR view of a schema for block-addressed execution.

    ``build_plan`` expands reducer -> original input ids, which at m = 10^6
    with thousands of inputs per reducer is ~10^9 host entries before a
    single gather runs.  The sparse plan stays at the schema's own
    granularity — three CSR maps totaling O(m + assignments):

      bin_indptr / bin_inputs    — bin -> original input ids (disjoint);
      bin_of                     — input -> bin (inverse of the above);
      red_indptr / red_bins      — reducer -> bin ids;
      binred_indptr / bin_reds   — bin -> reducer ids (inverse shuffle).

    ``block_subplan`` materializes only the reducers a requested
    ``[i0:i1) x [j0:j1)`` output block needs, as a rectangular
    :class:`ReducerPlan` in block-local coordinates, so every registry
    executor serves blocks through its existing ``run_x2y`` path.  Built
    sub-plans are LRU-cached on the instance (``_block_cache``) because
    the fused executor caches its inverse-shuffle srcmap per plan object.
    """

    num_inputs: int
    q: float
    bin_indptr: np.ndarray
    bin_inputs: np.ndarray
    bin_of: np.ndarray
    red_indptr: np.ndarray
    red_bins: np.ndarray
    binred_indptr: np.ndarray
    bin_reds: np.ndarray
    comm_cost: float = 0.0
    lower_bound: Optional[float] = None
    algorithm: str = "unknown"

    @property
    def num_bins(self) -> int:
        return int(len(self.bin_indptr) - 1)

    @property
    def num_reducers(self) -> int:
        return int(len(self.red_indptr) - 1)

    @property
    def host_entries(self) -> int:
        """Total host-side index entries — o(m^2) by construction."""
        return int(self.bin_inputs.size + self.bin_of.size
                   + 2 * self.red_bins.size)

    @property
    def optimality_gap(self) -> Optional[float]:
        if self.lower_bound is None or self.lower_bound <= 0.0:
            return None
        return self.comm_cost / self.lower_bound


def build_sparse_plan(schema: MappingSchema) -> SparsePlan:
    """CSR maps from a disjoint-bins schema, no per-input Python loops.

    Raises on overlapping-bin schemas (hybrid / big-input paths): those are
    small-m constructions that the dense ``build_plan`` already serves.
    """
    if schema.meta.get("bins_overlap", False):
        raise ValueError(
            "sparse plans require disjoint bins; use build_plan for the "
            "overlapping hybrid/big-input schemas")
    m = schema.m
    nb = len(schema.bins)
    bin_counts = np.asarray([len(b) for b in schema.bins], dtype=np.int64)
    bin_inputs = (np.concatenate(
        [np.asarray(b, dtype=np.int64) for b in schema.bins])
        if nb else np.zeros(0, dtype=np.int64))
    bin_indptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(bin_counts, out=bin_indptr[1:])
    bin_of = np.full(m, -1, dtype=np.int64)
    bin_of[bin_inputs] = np.repeat(
        np.arange(nb, dtype=np.int64), bin_counts)

    nr = len(schema.reducers)
    red_counts = np.asarray([len(r) for r in schema.reducers],
                            dtype=np.int64)
    red_bins = (np.concatenate(
        [np.asarray(r, dtype=np.int64) for r in schema.reducers])
        if nr else np.zeros(0, dtype=np.int64))
    red_indptr = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(red_counts, out=red_indptr[1:])

    # invert to bin -> reducers (the inverse-shuffle direction)
    red_of = np.repeat(np.arange(nr, dtype=np.int64), red_counts)
    order = np.lexsort((red_of, red_bins))
    binred_indptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(red_bins, minlength=nb), out=binred_indptr[1:])
    return SparsePlan(
        num_inputs=m, q=float(schema.q), bin_indptr=bin_indptr,
        bin_inputs=bin_inputs, bin_of=bin_of, red_indptr=red_indptr,
        red_bins=red_bins, binred_indptr=binred_indptr,
        bin_reds=red_of[order], comm_cost=schema.communication_cost(),
        lower_bound=schema.lower_bound, algorithm=schema.algorithm)


def _gather_csr(indptr: np.ndarray, data: np.ndarray,
                keys: np.ndarray) -> np.ndarray:
    """Concatenate ``data[indptr[k]:indptr[k+1]]`` over ``keys``."""
    if keys.size == 0:
        return np.zeros(0, dtype=data.dtype)
    return np.concatenate(
        [data[indptr[k]:indptr[k + 1]] for k in keys])


def block_subplan(sparse: SparsePlan, i0: int, i1: int, j0: int, j1: int,
                  *, pad_reducers_to: int = 1, pad_slots_to: int = 1,
                  max_buckets: int = 8,
                  cache_size: Optional[int] = None) -> Optional[ReducerPlan]:
    """Rectangular sub-plan serving output block ``[i0:i1) x [j0:j1)``.

    Selects exactly the reducers hosting at least one row bin *and* one
    column bin — for any required pair (i, j) in the block, the reducer
    the schema covers it with hosts ``bin_of[i]`` (a row bin) and
    ``bin_of[j]`` (a column bin), so it is selected and the block inherits
    the schema's full coverage.  Each selected reducer is restricted to
    the block-local X / Y ids it actually hosts; the result is an ordinary
    rectangular plan any executor runs via ``run_x2y``.  Returns ``None``
    for a block no reducer touches (empty ranges).  LRU-cached on the
    sparse plan so repeated requests reuse executor-side srcmaps;
    ``cache_size=None`` (default) takes the shared cap set by
    ``REPRO_BLOCK_CACHE_SIZE`` / :func:`configure_block_cache`, and
    hit/miss/evict counters feed :func:`block_cache_stats`.
    """
    if cache_size is None:
        cache_size = _BLOCK_CACHE_MAX
    if not (0 <= i0 <= i1 <= sparse.num_inputs
            and 0 <= j0 <= j1 <= sparse.num_inputs):
        raise IndexError(
            f"block [{i0}:{i1}) x [{j0}:{j1}) outside "
            f"m={sparse.num_inputs}")
    key = (i0, i1, j0, j1, pad_reducers_to, pad_slots_to, max_buckets)
    cache = plan_memo(sparse, "_block_cache", OrderedDict)
    if key in cache:
        cache.move_to_end(key)
        _BLOCK_CACHE_STATS["hits"] += 1
        _OBS_REGISTRY.counter("cache.hits", cache="block").inc()
        return cache[key]
    _BLOCK_CACHE_STATS["misses"] += 1
    _OBS_REGISTRY.counter("cache.misses", cache="block").inc()

    row_bins = np.unique(sparse.bin_of[i0:i1])
    col_bins = np.unique(sparse.bin_of[j0:j1])
    row_bins = row_bins[row_bins >= 0]
    col_bins = col_bins[col_bins >= 0]
    row_reds = np.unique(
        _gather_csr(sparse.binred_indptr, sparse.bin_reds, row_bins))
    col_reds = np.unique(
        _gather_csr(sparse.binred_indptr, sparse.bin_reds, col_bins))
    cand = np.intersect1d(row_reds, col_reds, assume_unique=True)

    xs: list[np.ndarray] = []
    ys: list[np.ndarray] = []
    for r in cand:
        bins_r = sparse.red_bins[
            sparse.red_indptr[r]:sparse.red_indptr[r + 1]]
        inputs_r = _gather_csr(sparse.bin_indptr, sparse.bin_inputs, bins_r)
        xr = inputs_r[(inputs_r >= i0) & (inputs_r < i1)] - i0
        yr = inputs_r[(inputs_r >= j0) & (inputs_r < j1)] - j0
        if xr.size and yr.size:
            xs.append(xr)
            ys.append(yr)
    if not xs:
        plan = None
    else:
        plan = build_x2y_plan_arrays(
            xs, ys, num_x=i1 - i0, num_y=j1 - j0,
            comm_cost=float(sum(len(a) + len(b)
                                for a, b in zip(xs, ys))),
            algorithm=f"block+{sparse.algorithm}",
            pad_reducers_to=pad_reducers_to, pad_slots_to=pad_slots_to,
            max_buckets=max_buckets)
    cache[key] = plan
    while len(cache) > cache_size:
        evicted, _ = cache.popitem(last=False)
        _BLOCK_CACHE_STATS["evictions"] += 1
        _OBS_REGISTRY.counter("cache.evictions", cache="block").inc()
        _OBS_EVENTS.emit("cache_eviction", cache="block",
                         key=str(evicted))
    return plan


def build_x2y_plan(schema: MappingSchema, num_x: int, *,
                   pad_reducers_to: int = 1, pad_slots_to: int = 1,
                   max_buckets: int = 8) -> ReducerPlan:
    """Flatten an X2Y schema (``plan_x2y`` convention: global ids
    ``0..num_x-1`` are X, ``num_x..`` are Y) into a rectangular plan:
    each reducer's expanded ids are split at the X/Y boundary, Y ids are
    re-based to Y-table-local rows, and capacity buckets group reducers by
    (wx, wy) power-of-two width pairs.  Runs in a ``plan.build`` span, as
    ``build_plan`` does."""
    with _obs_span("plan.build") as sp:
        expanded = schema.expand()
        xs = [[i for i in ids if i < num_x] for ids in expanded]
        ys = [[i - num_x for i in ids if i >= num_x] for ids in expanded]
        plan = build_x2y_plan_arrays(
            xs, ys, num_x=num_x, num_y=len(schema.weights) - num_x,
            comm_cost=schema.communication_cost(),
            algorithm=schema.algorithm, lower_bound=schema.lower_bound,
            pad_reducers_to=pad_reducers_to, pad_slots_to=pad_slots_to,
            max_buckets=max_buckets)
        if sp is not None:
            sp.attrs.update(reducers=plan.num_reducers,
                            buckets=len(plan.buckets))
        return plan


def _opt_array(a, dtype) -> Optional[np.ndarray]:
    return None if a is None else np.asarray(a, dtype=dtype)


def plan_from_arrays(fields: dict) -> ReducerPlan:
    """A plan from the fields of another plan as numpy arrays and scalars —
    what ``dataclasses.asdict`` gives for a reference ``ReducerPlan``
    (buckets as dicts).  The plan is the state this system carries: this is
    how a plan built elsewhere is handed to the port."""
    buckets = tuple(
        ReducerBucket(width=int(b["width"]),
                      rows=np.asarray(b["rows"], dtype=np.int64),
                      idx=np.asarray(b["idx"], dtype=np.int32),
                      mask=np.asarray(b["mask"], dtype=bool),
                      ywidth=int(b.get("ywidth", 0)),
                      yidx=_opt_array(b.get("yidx"), np.int32),
                      ymask=_opt_array(b.get("ymask"), bool))
        for b in fields.get("buckets", ()))
    lb = fields.get("lower_bound")
    return ReducerPlan(
        idx=np.asarray(fields["idx"], dtype=np.int32),
        mask=np.asarray(fields["mask"], dtype=bool),
        num_reducers=int(fields["num_reducers"]),
        comm_cost=float(fields["comm_cost"]),
        max_inputs=int(fields["max_inputs"]),
        algorithm=str(fields.get("algorithm", "unknown")),
        lower_bound=None if lb is None else float(lb),
        buckets=buckets,
        yidx=_opt_array(fields.get("yidx"), np.int32),
        ymask=_opt_array(fields.get("ymask"), bool),
        max_y_inputs=int(fields.get("max_y_inputs", 0)),
        num_x=int(fields.get("num_x", 0)),
        num_y=int(fields.get("num_y", 0)))


def as_table(inputs, device=None) -> torch.Tensor:
    """The ``(m, d)`` input table on the resolved device (``None`` means
    CUDA, see ``repro_torch.resolve_device``)."""
    return torch.as_tensor(inputs, device=resolve_device(device))


# ---------------------------------------------------------------------------
# bounded LRU of per-(plan, device) uploads
# ---------------------------------------------------------------------------
# A serving loop runs the same static plan many times; its index tensors and
# the fused assembly's (m, m) source map are uploaded once per device and
# reused.  The cache is a bounded LRU (``REPRO_JIT_CACHE_SIZE``, default 64)
# keyed by (kind, plan token, device); the plan token is assigned on first
# use, so keys never alias another plan, and a plan's entries leave the
# cache when the plan is garbage-collected (serving builds a fresh plan per
# request, so stale device tensors would otherwise wait for eviction).
def _env_cache_size(default: int = 64,
                    var: str = "REPRO_JIT_CACHE_SIZE") -> int:
    """``var`` as a cap >= 1; malformed or non-positive values fall back
    to the default."""
    raw = os.environ.get(var, "")
    try:
        size = int(raw)
    except ValueError:
        return default
    return size if size >= 1 else default


_JIT_CACHE: OrderedDict = OrderedDict()
_JIT_CACHE_MAX = _env_cache_size()
_JIT_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0,
                    "shape_hits": 0, "shape_misses": 0}
_JIT_CACHE_HITS: dict = {}                    # key -> hit count (live entries)
_JIT_SHAPES: dict = {}                # key -> table signatures seen
_PLAN_TOKENS = itertools.count(1)


_TABLE_SIGNATURES: set = set()      # every table signature ever served


def configure_jit_cache(max_size: Optional[int] = None) -> int:
    """Set the upload LRU cap; with no argument, re-read
    ``REPRO_JIT_CACHE_SIZE`` from the environment (default 64).  Evicts
    oldest entries immediately if the cache exceeds the new cap.  Returns
    the active cap."""
    global _JIT_CACHE_MAX
    if max_size is None:
        max_size = _env_cache_size()
    assert max_size >= 1, max_size
    _JIT_CACHE_MAX = max_size
    while len(_JIT_CACHE) > _JIT_CACHE_MAX:
        _evict_oldest()
    return _JIT_CACHE_MAX


def _evict_oldest():
    key, _ = _JIT_CACHE.popitem(last=False)
    _JIT_CACHE_HITS.pop(key, None)
    _JIT_SHAPES.pop(key, None)
    _JIT_CACHE_STATS["evictions"] += 1
    _OBS_REGISTRY.counter("cache.evictions", cache="jit").inc()
    _OBS_EVENTS.emit("cache_eviction", cache="jit", key=_key_label(key))


def _record_shape(key, tables) -> None:
    """A table shape/dtype signature (both tables of a rectangular request)
    an entry has served before is a ``shape_hit``; a new one is a
    ``shape_miss``."""
    sig = tuple((tuple(t.shape), str(t.dtype)) for t in tables)
    _TABLE_SIGNATURES.add((key[0], key[2]) + sig)
    seen = _JIT_SHAPES.setdefault(key, set())
    if sig in seen:
        _JIT_CACHE_STATS["shape_hits"] += 1
        _OBS_REGISTRY.counter("cache.shape_hits", cache="jit").inc()
    else:
        seen.add(sig)
        _JIT_CACHE_STATS["shape_misses"] += 1
        _OBS_REGISTRY.counter("cache.shape_misses", cache="jit").inc()


def _cache_get(key, factory):
    value = _JIT_CACHE.get(key)
    if value is None:
        _JIT_CACHE_STATS["misses"] += 1
        _OBS_REGISTRY.counter("cache.misses", cache="jit").inc()
        value = factory()
        _JIT_CACHE[key] = value
        _JIT_CACHE_HITS[key] = 0
        while len(_JIT_CACHE) > _JIT_CACHE_MAX:
            _evict_oldest()
    else:
        _JIT_CACHE_STATS["hits"] += 1
        _OBS_REGISTRY.counter("cache.hits", cache="jit").inc()
        _JIT_CACHE_HITS[key] = _JIT_CACHE_HITS.get(key, 0) + 1
        _JIT_CACHE.move_to_end(key)
    return value


def _key_label(key) -> str:
    """Short human-readable label for a cache key (telemetry only)."""
    if isinstance(key, tuple):
        return "|".join(_key_label(k) for k in key)
    return str(key)


def jit_cache_stats() -> dict:
    """Upload-cache counters (size / hits / misses / evictions / shape
    hits and misses), plus per-key hit counts for the live entries."""
    per_key: dict = {}
    for key, hits in dict(_JIT_CACHE_HITS).items():
        label = _key_label(key)
        per_key[label] = per_key.get(label, 0) + hits
    return {**_JIT_CACHE_STATS, "size": len(_JIT_CACHE),
            "max_size": _JIT_CACHE_MAX, "per_key": per_key}


def table_signatures() -> frozenset:
    """Every ``(kind, device, table shapes and dtypes)`` the upload cache
    has served in this process.  Entries are keyed by plan, so a new plan
    always misses the cache; a new *signature* is what a request brings
    that no earlier one did (the counterpart of a new program shape)."""
    return frozenset(_TABLE_SIGNATURES)


# The block sub-plan LRU (``block_subplan``) lives per SparsePlan instance
# but all instances share one configurable cap and one set of counters,
# mirroring the upload cache above: ``REPRO_BLOCK_CACHE_SIZE`` /
# ``configure_block_cache()`` set the cap, ``block_cache_stats()`` feeds
# the serving telemetry.  The cap is applied at insert time, so lowering
# it trims each plan's cache on that plan's next block request.
_BLOCK_CACHE_MAX = _env_cache_size(var="REPRO_BLOCK_CACHE_SIZE")
_BLOCK_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def configure_block_cache(max_size: Optional[int] = None) -> int:
    """Set the block sub-plan LRU cap; with no argument, re-read
    ``REPRO_BLOCK_CACHE_SIZE`` from the environment (default 64).
    Returns the active cap."""
    global _BLOCK_CACHE_MAX
    if max_size is None:
        max_size = _env_cache_size(var="REPRO_BLOCK_CACHE_SIZE")
    assert max_size >= 1, max_size
    _BLOCK_CACHE_MAX = max_size
    return _BLOCK_CACHE_MAX


def block_cache_stats() -> dict:
    """Block sub-plan cache counters (shared across all SparsePlans)."""
    return {**_BLOCK_CACHE_STATS, "max_size": _BLOCK_CACHE_MAX}


def _drop_plan(tok: int) -> None:
    for key in [k for k in _JIT_CACHE if k[1] == tok]:
        del _JIT_CACHE[key]
        _JIT_CACHE_HITS.pop(key, None)
        _JIT_SHAPES.pop(key, None)


def plan_memo(obj, attr: str, build: Callable, key=None, *,
              keep_last: bool = False):
    """``build()``, memoized on ``obj`` (a plan or schema; frozen ones are
    set through ``object.__setattr__``).  Without a ``key`` the value
    itself is kept as ``obj.<attr>``; with one, ``obj.<attr>`` is a dict of
    values by key, which holds only the last key's with ``keep_last``."""
    if key is None:
        value = obj.__dict__.get(attr)
        if value is None:
            value = build()
            object.__setattr__(obj, attr, value)
        return value
    cache = obj.__dict__.get(attr)
    if cache is None or (keep_last and key not in cache):
        cache = {}
        object.__setattr__(obj, attr, cache)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _plan_token(plan) -> int:
    def new() -> int:
        tok = next(_PLAN_TOKENS)
        weakref.finalize(plan, _drop_plan, tok)
        return tok
    return plan_memo(plan, "_upload_token", new)


def _masked_range(pairs) -> tuple[int, int]:
    """(min, max) over the valid slots of ``(idx, mask)`` arrays; (0, -1)
    when no slot is valid."""
    valid = [np.asarray(idx)[np.asarray(mask, dtype=bool)]
             for idx, mask in pairs]
    valid = [v for v in valid if v.size]
    if not valid:
        return 0, -1
    return (min(int(v.min()) for v in valid),
            max(int(v.max()) for v in valid))


def _check_indices(plan, mx: int, my: Optional[int] = None) -> None:
    """Every index the plan gathers through a valid slot must be a row of
    its table: X-side ``idx`` of the ``mx``-row table and, on a
    rectangular plan, Y-side ``yidx`` of the ``my``-row table.  Masked
    slots are never gathered, so whatever they hold is not checked.  The
    device gathers cannot raise, so a plan built elsewhere
    (``plan_from_arrays``) is checked here, once per plan (cached)."""
    def build() -> list:
        ranges = [_masked_range([(plan.idx, plan.mask)]
                                + [(b.idx, b.mask) for b in plan.buckets])]
        if plan.is_rect:
            ranges.append(_masked_range(
                [(plan.yidx, plan.ymask)]
                + [(b.yidx, b.ymask) for b in plan.buckets]))
        return ranges
    ranges = plan_memo(plan, "_index_range", build)
    sides = [("", mx)] + ([("Y-side ", mx if my is None else my)]
                          if plan.is_rect else [])
    for (side, m), (lo, hi) in zip(sides, ranges):
        if hi >= 0 and (lo < 0 or hi >= m):
            raise IndexError(f"plan gathers {side}rows {lo}..{hi} from a "
                             f"table of {m} rows")


def uploaded(kind: str, plan, table: torch.Tensor, factory,
             ytable: Optional[torch.Tensor] = None):
    """``factory(device)`` for (kind, plan, table.device), through the LRU,
    after checking the plan's indices against the table (and, for a
    rectangular plan, its Y side against ``ytable``); the tables' shapes
    and dtypes feed the shape counters."""
    tables = (table,) if ytable is None else (table, ytable)
    _check_indices(plan, *(t.shape[0] for t in tables))
    key = (kind, _plan_token(plan), str(table.device))

    def miss():
        with _obs_span("upload", kind=kind):
            return factory(table.device)
    value = _cache_get(key, miss)
    _record_shape(key, tables)
    return value


def _dense_arrays(plan, device):
    return (torch.as_tensor(plan.idx, device=device),
            torch.as_tensor(plan.mask, device=device))


def _scatter_rows(bucket: ReducerBucket, R: int) -> np.ndarray:
    """Bucket rows for drop-style scatter: padding rows (-1) -> row R."""
    return np.where(bucket.rows >= 0, bucket.rows, R).astype(np.int64)


def bucket_arrays(plan, device):
    """Per-bucket ``(idx int32, mask bool, scatter rows int64)`` tensors on
    ``device``."""
    return tuple(
        (torch.as_tensor(b.idx, device=device),
         torch.as_tensor(b.mask, device=device),
         torch.as_tensor(_scatter_rows(b, plan.R), device=device))
        for b in plan.buckets)


def _dense_rect_arrays(plan, device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in (plan.idx, plan.mask, plan.yidx, plan.ymask))


def rect_bucket_arrays(plan, device):
    """Per-bucket ``(xidx int32, xmask bool, yidx int32, ymask bool,
    scatter rows int64)`` tensors of a rectangular plan on ``device``."""
    return tuple(
        tuple(torch.as_tensor(a, device=device)
              for a in (b.idx, b.mask, b.yidx, b.ymask))
        + (torch.as_tensor(_scatter_rows(b, plan.R), device=device),)
        for b in plan.buckets)


# ---------------------------------------------------------------------------
# reducer rows over a process group
# ---------------------------------------------------------------------------
def rank_rows(R: int, S: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous block of a bucket's ``R`` reducer rows
    split over ``S`` ranks (what ``NamedSharding(P(axes))`` gives on the
    leading axis).  Raises ``ValueError`` unless ``S`` divides ``R``."""
    if R % S:
        raise ValueError(
            f"{R} reducer rows do not split over a group of {S} ranks: "
            f"build the plan with pad_reducers_to={S}")
    n = R // S
    return slice(rank * n, (rank + 1) * n)


def all_ranks(local: list, group, S: int) -> list:
    """Every rank's rows of each tensor in ``local`` (this rank's row block
    of one output per bucket), stacked in rank order: ONE all-gather of
    the concatenation.  ``group`` ``None`` returns ``local``."""
    if group is None:
        return local
    assert len({t.dtype for t in local}) == 1, [t.dtype for t in local]
    flat = torch.cat([t.reshape(-1) for t in local])
    full = _compat.all_gather(flat, group).reshape(S, flat.numel())
    parts = full.split([t.numel() for t in local], dim=1)
    return [p.reshape((S * t.shape[0],) + tuple(t.shape[1:]))
            for p, t in zip(parts, local)]


# ---------------------------------------------------------------------------
# dense + bucketed runners
# ---------------------------------------------------------------------------
def _gather_reduce(x, idx, mask, reducer_fn):
    gathered = gather_rows(x, idx, mask)                  # the shuffle
    return torch.func.vmap(reducer_fn)(gathered, mask)


def run_reducers(
    inputs,                                # (m, d) one row per input
    plan: ReducerPlan,
    reducer_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    mesh=None,
    device=None,
) -> torch.Tensor:
    """Execute ``reducer_fn(block (L, d), mask (L,)) -> tensor`` per
    reducer, every reducer padded to the plan's dense width; with a
    ``mesh``, each rank runs its block of the rows (see the module
    docstring)."""
    group, S, rank = _compat.reducer_group(mesh)
    rows = rank_rows(plan.R, S, rank)
    x = as_table(inputs, device)
    idx, mask = uploaded("dense", plan, x,
                         lambda dev: _dense_arrays(plan, dev))
    local = _gather_reduce(x, idx[rows], mask[rows], reducer_fn)
    return all_ranks([local], group, S)[0]


def _pad_to(t: torch.Tensor, target_shape) -> torch.Tensor:
    """Zero-pad trailing extents of ``t`` (past its leading batch axis) up
    to ``target_shape``."""
    pads = []
    for have, want in zip(reversed(t.shape[1:]), reversed(target_shape)):
        assert have <= want, (t.shape, target_shape)
        pads += [0, want - have]
    return F.pad(t, pads) if any(pads) else t


def run_reducers_bucketed(
    inputs,                                # (m, d) one row per input
    plan: ReducerPlan,
    reducer_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    mesh=None,
    combine: str = "dense",
    device=None,
):
    """Skew-aware execution: one gather+reduce per capacity bucket (with a
    ``mesh``, each rank's block of every bucket's rows, then ONE
    all-gather).

    combine='dense'    — one tensor shaped exactly like the ``run_reducers``
        output: bucket outputs are zero-padded along their slot-sized axes
        to the dense width and scattered back into original reducer order.
    combine='buckets'  — ``[(bucket, out), ...]`` unpadded.
    """
    assert combine in ("dense", "buckets"), combine
    if not plan.buckets:
        out = run_reducers(inputs, plan, reducer_fn, mesh=mesh,
                           device=device)
        return out if combine == "dense" else []
    group, S, rank = _compat.reducer_group(mesh)
    rows = [rank_rows(b.R, S, rank) for b in plan.buckets]
    x = as_table(inputs, device)
    arrays = uploaded("buckets", plan, x,
                      lambda dev: bucket_arrays(plan, dev))
    local = [_gather_reduce(x, idx[r], mask[r], reducer_fn)
             for r, (idx, mask, _) in zip(rows, arrays)]
    per_bucket = list(zip(plan.buckets, all_ranks(local, group, S)))
    if combine == "buckets":
        return per_bucket

    # the dense output shape: the reducer on one zero block of width L
    probe = torch.func.vmap(reducer_fn)(
        x.new_zeros((1, plan.L, x.shape[1])),
        torch.zeros((1, plan.L), dtype=torch.bool, device=x.device))
    acc = x.new_zeros((plan.R + 1,) + probe.shape[1:], dtype=probe.dtype)
    for (b, out), (_, _, rows) in zip(per_bucket, arrays):
        acc[rows] = _pad_to(out, probe.shape[1:])    # padding rows -> row R
    return acc[: plan.R]


# ---------------------------------------------------------------------------
# rectangular (X2Y) runners
# ---------------------------------------------------------------------------
def _gather_reduce_x2y(xt, yt, xidx, xmask, yidx, ymask, reducer_fn):
    gx = gather_rows(xt, xidx, xmask)                     # X-side shuffle
    gy = gather_rows(yt, yidx, ymask)                     # Y-side shuffle
    return torch.func.vmap(reducer_fn)(gx, xmask, gy, ymask)


def _as_tables(tables, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_table, y_table) on the resolved device from a pair or a single
    shared table (X == Y)."""
    if isinstance(tables, (tuple, list)):
        xt, yt = tables
    else:
        xt = yt = tables
    return as_table(xt, device), as_table(yt, device)


def run_reducers_x2y(
    tables,                                # (x (mx, dx), y (my, dy)) pair
    plan: ReducerPlan,
    reducer_fn: Callable,
    *,
    mesh=None,
    device=None,
):
    """Dense rectangular execution: ``reducer_fn(xblock (Lx, dx),
    xmask (Lx,), yblock (Ly, dy), ymask (Ly,)) -> tensor`` per reducer
    (with a ``mesh``, each rank's block of the rows).

    The two gathers are the bipartite shuffle — X rows and Y rows ship to
    their reducer slots independently.  ``tables`` may be one tensor
    (shared table) or an (x, y) pair."""
    assert plan.is_rect, "run_reducers_x2y needs a rectangular plan"
    group, S, rank = _compat.reducer_group(mesh)
    rows = rank_rows(plan.R, S, rank)
    xt, yt = _as_tables(tables, device)
    arrays = uploaded("x2y-dense", plan, xt,
                      lambda dev: _dense_rect_arrays(plan, dev), ytable=yt)
    local = _gather_reduce_x2y(xt, yt, *(a[rows] for a in arrays),
                               reducer_fn)
    return all_ranks([local], group, S)[0]


def run_reducers_x2y_bucketed(
    tables,
    plan: ReducerPlan,
    reducer_fn: Callable,
    *,
    mesh=None,
    combine: str = "dense",
    device=None,
):
    """Skew-aware rectangular execution: one double-gather+reduce per
    (wx, wy) capacity bucket (with a ``mesh``, each rank's block of every
    bucket's rows, then ONE all-gather).  Semantics mirror
    :func:`run_reducers_bucketed`: ``combine='dense'`` scatters bucket
    outputs (padded on both slot axes to the dense (Lx, Ly)) back into
    original reducer order; ``combine='buckets'`` returns
    ``[(bucket, out), ...]`` unpadded."""
    assert combine in ("dense", "buckets"), combine
    assert plan.is_rect, "run_reducers_x2y_bucketed needs a rect plan"
    if not plan.buckets:
        out = run_reducers_x2y(tables, plan, reducer_fn, mesh=mesh,
                               device=device)
        return out if combine == "dense" else []
    group, S, rank = _compat.reducer_group(mesh)
    rows = [rank_rows(b.R, S, rank) for b in plan.buckets]
    xt, yt = _as_tables(tables, device)
    arrays = uploaded("x2y-buckets", plan, xt,
                      lambda dev: rect_bucket_arrays(plan, dev), ytable=yt)
    local = [_gather_reduce_x2y(xt, yt, *(a[r] for a in arr[:4]),
                                reducer_fn)
             for r, arr in zip(rows, arrays)]
    per_bucket = list(zip(plan.buckets, all_ranks(local, group, S)))
    if combine == "buckets":
        return per_bucket

    # the dense output shape: the reducer on zero blocks of width (L, Ly)
    def zeros(n, t):
        return (t.new_zeros((1, n, t.shape[1])),
                torch.zeros((1, n), dtype=torch.bool, device=t.device))
    probe = torch.func.vmap(reducer_fn)(*zeros(plan.L, xt),
                                        *zeros(plan.Ly, yt))
    acc = xt.new_zeros((plan.R + 1,) + probe.shape[1:], dtype=probe.dtype)
    for (b, out), arr in zip(per_bucket, arrays):
        acc[arr[4]] = _pad_to(out, probe.shape[1:])  # padding rows -> row R
    return acc[: plan.R]


# ---------------------------------------------------------------------------
# fused executor: module-level shims over the executor registry
# ---------------------------------------------------------------------------
# ``fused_stats()`` is the aggregate view: every ``FusedExecutor`` instance
# publishes its increments into the obs registry's
# ``executor.<key>{executor=fused}`` series, and this shim sums them.
# ``FUSED_STATS`` is kept as the reference's legacy name only; no instance
# writes to it.
FUSED_STATS = {"calls": 0, "kernel": 0, "streamed": 0, "fallbacks": 0}

_FUSED_KEYS = ("calls", "kernel", "streamed", "fallbacks")


def fused_stats() -> dict:
    """Aggregate fused dispatch counters across every ``FusedExecutor``
    instance, read from the observability registry."""
    return {k: int(_OBS_REGISTRY.counter_total(f"executor.{k}",
                                               executor="fused"))
            for k in _FUSED_KEYS}


def reset_fused_stats() -> None:
    """Zero the aggregate fused counters (all instances' published
    series)."""
    for k in _FUSED_KEYS:
        _OBS_REGISTRY.reset_counters(f"executor.{k}", executor="fused")
    for k in FUSED_STATS:
        FUSED_STATS[k] = 0


def run_reducers_fused(inputs, plan, reducer_fn, **kwargs):
    """Fused shuffle execution: shim over ``get_executor("fused").run`` (see
    :class:`repro_torch.mapreduce.executors.FusedExecutor`)."""
    from .executors import get_executor
    return get_executor("fused").run(inputs, plan, reducer_fn, **kwargs)


def run_reducers_sharded(inputs, plan, reducer_fn, **kwargs):
    """Shard-balanced execution over a process group: shim over
    ``get_executor("sharded").run`` (see
    :class:`repro_torch.mapreduce.executors.ShardedExecutor`: the plan is
    LPT-partitioned over the group's ranks and each rank runs the
    gather+Gram kernel over its own reducers)."""
    from .executors import get_executor
    return get_executor("sharded").run(inputs, plan, reducer_fn, **kwargs)
