"""A2A and X2Y applications: similarity through a mapping schema.

Port of ``repro.mapreduce.allpairs``.  Every input is a feature row; the
planner guarantees each required pair of rows meets at >= 1 reducer;
reducers compute the pairwise block; results land in the output matrix:

* ``pairwise_similarity`` — the (m, m) all-pairs matrix.  ``dense`` /
  ``bucketed`` max-scatter per-reducer blocks into a ``-inf`` matrix
  (``scatter_reduce_(reduce="amax")``); ``fused`` gathers the matrix in ONE
  step from the concatenated bucket blocks through the host-built
  inverse-shuffle source map.  ``use_kernel=True`` computes each reducer's
  block with the ``pairwise_gram`` kernel (one batched launch per bucket).
* ``x2y_similarity`` — the (mx, my) cross matrix of an X2Y schema, through
  every executor's ``run_x2y`` (rectangular blocks, never a padded square).
* ``pairwise_similarity_block`` — one ``[i0:i1) x [j0:j1)`` block of the
  all-pairs matrix of a hierarchical schema, through ``run_block``, without
  anything O(m^2) on the host or the device.
* ``some_pairs_similarity`` — the (m, m) matrix of an explicit pair set
  through a some-pairs schema (``plan_some_pairs``), masked to the
  required pairs.

The streaming executor (``repro_torch.stream``) patches a maintained matrix
with the same max-scatter (``_scatter_blocks``, ``_scatter_blocks_x2y``)
and finish (``_finish_pair_matrix``, ``_finish_x2y_matrix``) as assembly.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (plan_a2a, plan_a2a_hierarchical,
                              plan_some_pairs, plan_x2y)
from repro_torch.core.schema import MappingSchema
from repro_torch.kernels.pairwise.ops import pairwise_kernel
from repro_torch.obs import span as _obs_span

from repro_torch.compat import shard_group

from .engine import (ReducerPlan, SparsePlan, _as_tables, as_table,
                     build_plan, build_sparse_plan, build_x2y_plan)
from .executors import get_executor

__all__ = [
    "pairwise_similarity",
    "pairwise_similarity_block",
    "some_pairs_similarity",
    "x2y_similarity",
    "assemble_pair_matrix",
    "assemble_pair_matrix_bucketed",
    "assemble_x2y_matrix_bucketed",
    "block_similarity",
    "block_similarity_x2y",
]


def block_similarity(block: torch.Tensor, mask: torch.Tensor, *,
                     metric: str = "dot", use_kernel: bool = False):
    """(L, d), (L,) -> (L, L) similarity of the valid rows; invalid -> 0.

    ``use_kernel=True`` computes the Gram block with the ``pairwise_gram``
    kernel and finishes the metric as the reference's ``ops._finish`` does
    (cosine: ``sqrt(clip(n2, 1e-18))``); under ``torch.func.vmap`` the
    kernel launches once for the whole reducer axis."""
    if use_kernel:
        sims = pairwise_kernel(block, metric=metric)
    elif metric == "dot":
        sims = block @ block.T
    elif metric == "l2":
        n2 = torch.sum(block * block, dim=-1)
        sims = n2[:, None] + n2[None, :] - 2.0 * (block @ block.T)
    elif metric == "cosine":
        nrm = torch.sqrt(torch.sum(block * block, dim=-1) + 1e-9)
        sims = (block @ block.T) / (nrm[:, None] * nrm[None, :])
    else:
        raise ValueError(metric)
    valid = mask[:, None] & mask[None, :]
    return torch.where(valid, sims, 0.0)


@functools.lru_cache(maxsize=None)
def _block_fn(metric: str, use_kernel: bool):
    """Memoized reducer: the same (metric, use_kernel) maps to the *same*
    function object.  The ``fused_metric`` tag is what lets the fused
    executor recognize this reducer as a Gram block and compute it through
    the gather+Gram kernel (untagged reducers fall back to bucketed)."""
    def fn(block, mask):
        return block_similarity(block, mask, metric=metric,
                                use_kernel=use_kernel)
    fn.__name__ = f"block_similarity_{metric}"
    fn.fused_metric = metric
    return fn


def block_similarity_x2y(xblock: torch.Tensor, xmask: torch.Tensor,
                         yblock: torch.Tensor, ymask: torch.Tensor, *,
                         metric: str = "dot"):
    """(Lx, d), (Lx,), (Ly, d), (Ly,) -> (Lx, Ly) cross similarity of the
    valid rows; invalid pairs -> 0.  The rectangular analogue of
    :func:`block_similarity` (which is the degenerate X == Y case)."""
    if metric == "dot":
        sims = xblock @ yblock.T
    elif metric == "l2":
        n2x = torch.sum(xblock * xblock, dim=-1)
        n2y = torch.sum(yblock * yblock, dim=-1)
        sims = n2x[:, None] + n2y[None, :] - 2.0 * (xblock @ yblock.T)
    elif metric == "cosine":
        nx = torch.sqrt(torch.sum(xblock * xblock, dim=-1) + 1e-9)
        ny = torch.sqrt(torch.sum(yblock * yblock, dim=-1) + 1e-9)
        sims = (xblock @ yblock.T) / (nx[:, None] * ny[None, :])
    else:
        raise ValueError(metric)
    valid = xmask[:, None] & ymask[None, :]
    return torch.where(valid, sims, 0.0)


@functools.lru_cache(maxsize=None)
def _block_fn_x2y(metric: str):
    """Memoized two-sided reducer (same contract as ``_block_fn``).  The
    ``fused_metric`` tag lets the fused executor run the rectangular
    gather+Gram kernel instead of materializing the gathers."""
    def fn(xblock, xmask, yblock, ymask):
        return block_similarity_x2y(xblock, xmask, yblock, ymask,
                                    metric=metric)
    fn.__name__ = f"block_similarity_x2y_{metric}"
    fn.fused_metric = metric
    return fn


def _mesh_pad(mesh) -> int:
    """Reducer-row padding for ``mesh``: its group's size, as the reference
    pads to the mesh's device count (1 without a mesh), for every
    executor.  A ``mesh`` that is not a process group raises here, before
    any planning."""
    return 1 if mesh is None else shard_group(mesh)[1]


def _plan_for(schema, *, pad_reducers_to: int, pad_slots_to: int):
    """``build_plan`` memoized on the schema object: a caller that passes
    the same ``MappingSchema`` again (``pairwise_similarity(schema=...)``)
    skips the host plan build.  A ``PLAN_CACHE`` hit does not: ``plan_a2a``
    wraps every hit in a new schema (``core.planner._remap_schema``), so
    each planned request builds its plan anew."""
    key = (pad_reducers_to, pad_slots_to)
    cache = schema.__dict__.setdefault("_reducer_plan_cache", {})
    plan = cache.get(key)
    if plan is None:
        plan = build_plan(schema, pad_reducers_to=pad_reducers_to,
                          pad_slots_to=pad_slots_to)
        cache[key] = plan
    return plan


def _x2y_plan_for(schema, num_x: int, *, pad_reducers_to: int,
                  pad_slots_to: int):
    """``build_x2y_plan`` memoized on the schema object (the same contract
    as ``_plan_for``: reused for the same schema object only)."""
    key = ("x2y", num_x, pad_reducers_to, pad_slots_to)
    cache = schema.__dict__.setdefault("_reducer_plan_cache", {})
    plan = cache.get(key)
    if plan is None:
        plan = build_x2y_plan(schema, num_x,
                              pad_reducers_to=pad_reducers_to,
                              pad_slots_to=pad_slots_to)
        cache[key] = plan
    return plan


def _check_srcmap_size(plan: ReducerPlan, entries_of) -> None:
    """Source-map positions are int32 as in the reference, so the bucket
    blocks' total entries must stay below 2**31."""
    total = 1 + sum(entries_of(b) for b in plan.buckets)
    if total > np.iinfo(np.int32).max:
        raise OverflowError(
            f"{total} block entries overflow the int32 source map")


def _pair_source_map_rect(plan: ReducerPlan, mx: int,
                          my: int) -> np.ndarray:
    """Rectangular inverse-shuffle map: (mx, my) int32 positions into the
    concatenation ``[0.0, blocks_0.ravel(), ...]`` of per-bucket cross-Gram
    stacks.  Like :func:`_pair_source_map` with decoupled axes — rows come
    from each bucket's X-side ids, columns from its Y-side ids, and there
    is no diagonal to zero (an (x, y) pair is never a self-pair).
    Uncovered cells point at slot 0 (-> 0.0).  Cached on the plan; a build
    runs in a ``plan.srcmap`` span."""
    cached = plan.__dict__.get("_pair_srcmap_rect")
    if cached is not None and cached[0] == (mx, my):
        return cached[1]
    _check_srcmap_size(plan, lambda b: b.R * b.width * b.ywidth)
    with _obs_span("plan.srcmap", mx=mx, my=my):
        srcmap = np.zeros((mx, my), np.int32)
        base = 1
        for b in plan.buckets:
            Rb, Lx = b.idx.shape
            Ly = b.yidx.shape[1]
            rows = np.broadcast_to(b.idx[:, :, None], (Rb, Lx, Ly))
            cols = np.broadcast_to(b.yidx[:, None, :], (Rb, Lx, Ly))
            valid = b.mask[:, :, None] & b.ymask[:, None, :]
            pos = np.arange(base, base + Rb * Lx * Ly,
                            dtype=np.int64).reshape(Rb, Lx, Ly)
            srcmap[rows[valid], cols[valid]] = pos[valid]
            base += Rb * Lx * Ly
    object.__setattr__(plan, "_pair_srcmap_rect", ((mx, my), srcmap))
    return srcmap


def assemble_x2y_matrix_bucketed(per_bucket, shape: tuple[int, int], *,
                                 device=None):
    """Scatter per-bucket (Rb, Lx, Ly[, c]) cross blocks into the global
    (mx, my[, c]) output.

    ``per_bucket`` is ``run_reducers_x2y_bucketed(..., combine='buckets')``
    output (the dense executor passes its whole plan as one "bucket").
    Invalid slots drop into a scratch row (duplicate covered cells agree,
    so a plain ``index_put_`` is deterministic where it matters), which
    also handles payload-carrying blocks — the skew join's (Lx, Ly, dx+dy)
    concat outputs assemble through the same path as similarity
    matrices.  Uncovered cells are 0 (no diagonal to zero: an (x, y) pair
    is never a self-pair)."""
    mx, my = shape
    if not per_bucket:
        return torch.zeros((mx, my), dtype=torch.float32, device=device)
    out = None
    for b, blocks in per_bucket:
        trailing = tuple(blocks.shape[3:])
        dev = blocks.device
        if out is None:
            out = torch.zeros((mx + 1, max(my, 1)) + trailing,
                              dtype=blocks.dtype, device=dev)
        xidx = torch.as_tensor(b.idx, device=dev).long()
        yidx = torch.as_tensor(b.yidx, device=dev).long()
        valid = (torch.as_tensor(b.mask, device=dev)[:, :, None]
                 & torch.as_tensor(b.ymask, device=dev)[:, None, :])
        rows = torch.where(valid, xidx[:, :, None], mx)  # invalid -> scratch
        cols = torch.where(valid, yidx[:, None, :], 0)
        out[rows.reshape(-1), cols.reshape(-1)] = \
            blocks.reshape((-1,) + trailing)
    return out[:mx, :my]


def _pair_source_map(plan: ReducerPlan, m: int) -> np.ndarray:
    """Inverse-shuffle map for fused assembly: (m, m) int32 positions into
    the concatenation ``[0.0, blocks_0.ravel(), blocks_1.ravel(), ...]`` of
    per-bucket Gram stacks (bucket order = ``plan.buckets``).

    A pair covered by several reducers keeps one (deterministic) source —
    duplicate block values agree, so assembly is a gather instead of a
    max-combine scatter.  Uncovered cells and the diagonal point at slot 0
    (-> 0.0).  Cached on the plan.  Positions are int32 as in the
    reference, so the total Gram entries must stay below 2**31."""
    cached = plan.__dict__.get("_pair_srcmap")
    if cached is not None and cached[0] == m:
        return cached[1]
    _check_srcmap_size(plan, lambda b: b.R * b.width * b.width)
    with _obs_span("plan.srcmap", m=m):
        srcmap = np.zeros((m, m), np.int32)
        base = 1
        for b in plan.buckets:
            Rb, Lb = b.idx.shape
            rows = np.broadcast_to(b.idx[:, :, None], (Rb, Lb, Lb))
            cols = np.broadcast_to(b.idx[:, None, :], (Rb, Lb, Lb))
            valid = b.mask[:, :, None] & b.mask[:, None, :]
            pos = np.arange(base, base + Rb * Lb * Lb,
                            dtype=np.int64).reshape(Rb, Lb, Lb)
            srcmap[rows[valid], cols[valid]] = pos[valid]
            base += Rb * Lb * Lb
        np.fill_diagonal(srcmap, 0)
    object.__setattr__(plan, "_pair_srcmap", (m, srcmap))
    return srcmap


def _assemble_from_srcmap(per_bucket, srcmap: torch.Tensor, flat=None):
    """Fused assembly: gather the (m, m) matrix from the concatenated
    bucket blocks through the inverse-shuffle map (int64, on device).
    ``flat``, when the blocks were written into that concatenation
    ``[0.0, blocks_0.ravel(), ...]`` in place, is gathered from as it is;
    otherwise the blocks are concatenated first."""
    with _obs_span("assemble", device=srcmap.device):
        if flat is None:
            vals = [torch.zeros(1, dtype=torch.float32,
                                device=srcmap.device)]
            vals += [g.reshape(-1) for _, g in per_bucket]
            flat = torch.cat(vals)
        return flat[srcmap]


def _run_and_assemble(x, plan, fn, m, mesh, executor,
                      use_kernel: bool = False):
    """Single dispatch point: ``executor`` is a registry name or an
    :class:`Executor` instance (the serving tier passes its own so
    telemetry stays instance-scoped)."""
    return get_executor(executor).run_pairs(
        x, plan, fn, m, mesh=mesh, use_kernel=use_kernel, device=x.device)


def pairwise_similarity(
    x,                                  # (m, d) tensor or array
    *,
    q: float,
    weights=None,                       # per-input sizes; default: uniform
    schema: Optional[MappingSchema] = None,
    metric: str = "dot",
    mesh=None,
    use_kernel: bool = False,
    pad_slots_to: int = 1,
    executor: str = "bucketed",
    device=None,
):
    """All-pairs similarity executed through a mapping schema.

    ``executor='bucketed'`` (default) runs the skew-aware capacity-bucket
    executor; ``'dense'`` the global-max-padded oracle; ``'fused'`` one
    gather+Gram kernel launch per bucket and one assembly gather;
    ``'sharded'`` / ``'coded'`` run the fused pipeline per rank of the
    process group ``mesh`` (``None``: the default group if one is
    initialised, else one shard) and assemble across ranks; the others
    split each bucket's reducer rows over ``mesh``'s ranks (``None``:
    local).  Reducer rows are padded to the group's size as the reference
    pads to its mesh.
    ``executor`` may also be an :class:`~repro_torch.mapreduce.executors.
    Executor` instance.  ``device=None`` runs on CUDA (raises without a
    card); pass ``device="cpu"`` for the plain CPU path.  Returns
    (sims (m, m) with zero diagonal, plan, schema)."""
    x = as_table(x, device)
    m = x.shape[0]
    with _obs_span("similarity", device=x.device, workload="pairs", m=m):
        pad = _mesh_pad(mesh)
        with _obs_span("plan", workload="pairs", m=m):
            if schema is None:
                w = (np.full(m, 1.0) if weights is None
                     else np.asarray(weights, float))
                schema = plan_a2a(w, q)
            plan = _plan_for(schema, pad_reducers_to=pad,
                             pad_slots_to=pad_slots_to)
        fn = _block_fn(metric, use_kernel)
        with _obs_span("execute", workload="pairs",
                       reducers=plan.num_reducers):
            sims = _run_and_assemble(x, plan, fn, m, mesh, executor,
                                     use_kernel=use_kernel)
    return sims, plan, schema


def _sparse_plan_for(schema) -> SparsePlan:
    """Memoized CSR plan for a schema (one sparse plan per schema object,
    shared across block requests so executor-side source maps and the
    sub-plan LRU persist)."""
    cached = schema.__dict__.get("_sparse_plan")
    if cached is None:
        cached = build_sparse_plan(schema)
        schema.__dict__["_sparse_plan"] = cached
    return cached


def pairwise_similarity_block(
    x,                                  # (m, d) tensor or array
    i0: int, i1: int, j0: int, j1: int,
    *,
    q: Optional[float] = None,
    weights=None,                       # per-input sizes; default: uniform
    schema: Optional[MappingSchema] = None,
    metric: str = "dot",
    mesh=None,
    pad_slots_to: int = 1,
    executor: str = "bucketed",
    device=None,
):
    """One ``[i0:i1) x [j0:j1)`` sub-block of the all-pairs similarity
    matrix, without materializing (m, m) anywhere.

    The schema is planned hierarchically (``plan_a2a_hierarchical``: the
    flat planner at small m, two-level super-input packing at large m) and
    lowered once to a CSR :class:`~repro_torch.mapreduce.engine.SparsePlan`
    cached on the schema; each block request then routes through the
    executor's ``run_block``, which selects only the reducers covering the
    block and serves them via ``run_x2y``.  Global-diagonal cells inside
    the block are zeroed, matching ``pairwise_similarity``.

    Returns (block (i1-i0, j1-j0), sparse plan, schema)."""
    x = as_table(x, device)
    m = x.shape[0]
    if schema is None:
        if q is None:
            raise ValueError("pass q or a pre-planned schema")
        w = np.full(m, 1.0) if weights is None else np.asarray(weights, float)
        schema = plan_a2a_hierarchical(w, q)
    sparse = _sparse_plan_for(schema)
    fn = _block_fn_x2y(metric)
    block = get_executor(executor).run_block(
        x, sparse, fn, int(i0), int(i1), int(j0), int(j1), mesh=mesh,
        pad_slots_to=pad_slots_to, device=x.device)
    return block, sparse, schema


def some_pairs_similarity(
    x,                                  # (m, d) tensor or array
    pairs: Sequence[tuple[int, int]],   # required pairs (i, j)
    *,
    q: float,
    weights=None,                       # per-input sizes; default: uniform
    schema: Optional[MappingSchema] = None,
    metric: str = "dot",
    mesh=None,
    use_kernel: bool = False,
    pad_slots_to: int = 1,
    executor: str = "bucketed",
    device=None,
):
    """Similarity for an explicit pair set through a some-pairs schema.

    Unlike :func:`pairwise_similarity`, only inputs incident to a required
    pair are shipped to reducers (the planner's sparse strategies leave the
    rest unplaced), and the returned matrix is masked to the required pairs
    (symmetric) on the device.  ``executor='fused'`` serves the some-pairs
    workload on the same fused gather+Gram path as A2A.  ``device`` as in
    :func:`pairwise_similarity`.  Returns (sims (m, m), plan, schema)."""
    x = as_table(x, device)
    m = x.shape[0]
    with _obs_span("similarity", device=x.device, workload="some_pairs",
                   m=m):
        pad = _mesh_pad(mesh)
        with _obs_span("plan", workload="some_pairs", m=m):
            if schema is None:
                w = (np.full(m, 1.0) if weights is None
                     else np.asarray(weights, float))
                schema = plan_some_pairs(w, q, pairs)
            plan = _plan_for(schema, pad_reducers_to=pad,
                             pad_slots_to=pad_slots_to)
        fn = _block_fn(metric, use_kernel)
        with _obs_span("execute", workload="some_pairs",
                       reducers=plan.num_reducers):
            sims = _run_and_assemble(x, plan, fn, m, mesh, executor,
                                     use_kernel=use_kernel)
        p = torch.as_tensor(np.asarray(list(pairs), dtype=np.int64)
                            .reshape(-1, 2), device=sims.device)
        want = torch.zeros((m, m), dtype=torch.bool, device=sims.device)
        want[p[:, 0], p[:, 1]] = True
        want[p[:, 1], p[:, 0]] = True
        sims = torch.where(want, sims, 0.0)
    return sims, plan, schema


def x2y_similarity(
    x,                                  # (mx, d) X-side feature rows
    y,                                  # (my, d) Y-side feature rows
    *,
    q: float,
    wx=None,                            # X-side input sizes; default uniform
    wy=None,                            # Y-side input sizes; default uniform
    schema: Optional[MappingSchema] = None,
    metric: str = "dot",
    mesh=None,
    use_kernel: bool = False,
    pad_slots_to: int = 1,
    executor: str = "bucketed",
    device=None,
):
    """Cross similarity of every X row against every Y row through an X2Y
    mapping schema (paper Section 10).

    The planner packs X into bins of size b and Y into bins of q - b; each
    reducer meets one X bin with one Y bin, so every cross pair is covered.
    Execution is rectangular end to end: reducers emit (Lx, Ly) cross
    blocks (never a padded square), and ``executor='fused'`` runs the
    rectangular gather+Gram kernel with independent row/column gather maps
    and one assembly gather; ``'sharded'`` / ``'coded'`` LPT-balance the
    rectangular sub-plans over the ranks of ``mesh``.  ``use_kernel`` is
    accepted for signature parity (the fused executor runs its kernel on a
    CUDA table anyway).
    ``plan_x2y`` is not memoized (as in the reference), so every call
    plans.  Returns (sims (mx, my), plan, schema)."""
    x, y = _as_tables((x, y), device)
    mx, my = x.shape[0], y.shape[0]
    with _obs_span("similarity", device=x.device, workload="x2y", mx=mx,
                   my=my):
        pad = _mesh_pad(mesh)
        with _obs_span("plan", workload="x2y", mx=mx, my=my):
            if schema is None:
                wx_ = (np.full(mx, 1.0) if wx is None
                       else np.asarray(wx, float))
                wy_ = (np.full(my, 1.0) if wy is None
                       else np.asarray(wy, float))
                schema = plan_x2y(wx_, wy_, q)
            plan = _x2y_plan_for(schema, mx, pad_reducers_to=pad,
                                 pad_slots_to=pad_slots_to)
        fn = _block_fn_x2y(metric)
        with _obs_span("execute", workload="x2y",
                       reducers=plan.num_reducers):
            sims = get_executor(executor).run_x2y(
                (x, y), plan, fn, (mx, my), mesh=mesh,
                use_kernel=use_kernel, device=x.device)
    return sims, plan, schema


def _scatter_blocks(out: torch.Tensor, blocks: torch.Tensor,
                    idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """max-scatter (R, L, L) reducer blocks into the running (m, m) matrix
    (initialized to -inf), in place.  A pair may meet at several reducers;
    values agree, so `max` combine is deterministic.  A masked slot's index
    is never read: its -inf entries land on cell (0, 0) instead."""
    m = out.shape[0]
    idx = torch.where(mask, idx, 0).long()
    flat = (idx[:, :, None] * m + idx[:, None, :]).reshape(-1)
    valid = mask[:, :, None] & mask[:, None, :]
    vals = torch.where(valid, blocks, float("-inf")).reshape(-1)
    out.view(-1).scatter_reduce_(0, flat, vals.to(out.dtype), reduce="amax")
    return out


def _finish_pair_matrix(out: torch.Tensor) -> torch.Tensor:
    """Uncovered cells -> 0 and the diagonal multiplied by 0 (no self-pairs
    in A2A), as the reference multiplies by ``1 - eye``: a non-finite
    self-product stays NaN there."""
    out = torch.where(torch.isneginf(out), 0.0, out)
    out.diagonal().mul_(0.0)
    return out


def _scatter_blocks_x2y(out: torch.Tensor, blocks: torch.Tensor,
                        xidx: torch.Tensor, xmask: torch.Tensor,
                        yidx: torch.Tensor,
                        ymask: torch.Tensor) -> torch.Tensor:
    """max-scatter (R, Lx, Ly) cross blocks into the running (mx, my)
    matrix (initialized to -inf), in place; duplicates agree, so max is
    deterministic.  The streaming patch relies on the max-combine (clean
    cells keep their value after -inf invalidation).  A masked slot's index
    is never read: its -inf entries land on cell (0, 0), a real pair that
    amax leaves as it was."""
    my = out.shape[1]
    xidx = torch.where(xmask, xidx, 0).long()
    yidx = torch.where(ymask, yidx, 0).long()
    flat = (xidx[:, :, None] * my + yidx[:, None, :]).reshape(-1)
    valid = xmask[:, :, None] & ymask[:, None, :]
    vals = torch.where(valid, blocks, float("-inf")).reshape(-1)
    out.view(-1).scatter_reduce_(0, flat, vals.to(out.dtype), reduce="amax")
    return out


def _finish_x2y_matrix(out: torch.Tensor) -> torch.Tensor:
    """Uncovered / invalidated cells -> 0 (no diagonal to zero: an (x, y)
    pair is never a self-pair)."""
    return torch.where(torch.isneginf(out), 0.0, out)


def assemble_pair_matrix(blocks: torch.Tensor, plan: ReducerPlan, m: int):
    """Scatter per-reducer (L, L) blocks into the global (m, m) matrix.

    Diagonal is zeroed (no self-pairs in A2A)."""
    out = torch.full((m, m), float("-inf"), dtype=blocks.dtype,
                     device=blocks.device)
    _scatter_blocks(out, blocks,
                    torch.as_tensor(plan.idx, device=blocks.device),
                    torch.as_tensor(plan.mask, device=blocks.device))
    return _finish_pair_matrix(out)


def assemble_pair_matrix_bucketed(per_bucket, m: int, *, device=None):
    """Scatter per-bucket (Rb, Lb, Lb) blocks into the global (m, m) matrix.

    ``per_bucket`` is ``run_reducers_bucketed(..., combine='buckets')``
    output.  Each bucket scatters at its own width — no block is padded to
    the dense L.  Padding rows (all-masked) contribute nothing."""
    if not per_bucket:
        return torch.zeros((m, m), dtype=torch.float32, device=device)
    first = per_bucket[0][1]
    out = torch.full((m, m), float("-inf"), dtype=first.dtype,
                     device=first.device)
    for b, blocks in per_bucket:
        _scatter_blocks(out, blocks,
                        torch.as_tensor(b.idx, device=blocks.device),
                        torch.as_tensor(b.mask, device=blocks.device))
    return _finish_pair_matrix(out)
