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

The assembly of every executor (the block vector, its source maps, the
bucketed max-scatter) lives in ``assembly``, below the executors; the
``assemble_*`` names are re-exported here.
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

from .assembly import (assemble_pair_matrix, assemble_pair_matrix_bucketed,
                       assemble_x2y_matrix_bucketed)
from .engine import (SparsePlan, _as_tables, as_table, build_plan,
                     build_sparse_plan, build_x2y_plan, plan_memo)
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
    return plan_memo(schema, "_reducer_plan_cache", lambda: build_plan(
        schema, pad_reducers_to=pad_reducers_to, pad_slots_to=pad_slots_to),
        (pad_reducers_to, pad_slots_to))


def _x2y_plan_for(schema, num_x: int, *, pad_reducers_to: int,
                  pad_slots_to: int):
    """``build_x2y_plan`` memoized on the schema object (the same contract
    as ``_plan_for``: reused for the same schema object only)."""
    return plan_memo(schema, "_reducer_plan_cache", lambda: build_x2y_plan(
        schema, num_x, pad_reducers_to=pad_reducers_to,
        pad_slots_to=pad_slots_to),
        ("x2y", num_x, pad_reducers_to, pad_slots_to))


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
    return plan_memo(schema, "_sparse_plan",
                     lambda: build_sparse_plan(schema))


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
