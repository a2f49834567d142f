"""A2A application: all-pairs similarity through a mapping schema.

Port of the square all-pairs path of ``repro.mapreduce.allpairs``.  Every
input is a feature row; the planner guarantees each pair of rows meets at
>= 1 reducer; reducers compute the pairwise block; results land in the
(m, m) matrix:

* ``dense`` / ``bucketed`` max-scatter per-reducer blocks into a ``-inf``
  matrix (``scatter_reduce_(reduce="amax")``);
* ``fused`` gathers the matrix in ONE step from the concatenated bucket
  blocks through the host-built inverse-shuffle source map.

Later slices: ``some_pairs_similarity``, ``x2y_similarity`` and
``pairwise_similarity_block``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan_a2a
from repro_torch.core.schema import MappingSchema
from repro_torch.obs import span as _obs_span

from .engine import ReducerPlan, as_table, build_plan
from .executors import get_executor

__all__ = [
    "pairwise_similarity",
    "assemble_pair_matrix",
    "assemble_pair_matrix_bucketed",
    "block_similarity",
]


def block_similarity(block: torch.Tensor, mask: torch.Tensor, *,
                     metric: str = "dot", use_kernel: bool = False):
    """(L, d), (L,) -> (L, L) similarity of the valid rows; invalid -> 0.

    ``use_kernel=True`` reaches the ``pairwise_gram`` kernel in the
    reference, which is not ported yet: it raises."""
    if use_kernel:
        raise NotImplementedError(
            "block_similarity(use_kernel=True) needs the pairwise_gram "
            "kernel, which is not ported yet")
    if metric == "dot":
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


def _plan_for(schema, *, pad_reducers_to: int, pad_slots_to: int):
    """``build_plan`` memoized on the schema object, so repeated weight
    profiles (``PLAN_CACHE`` hits return the same schema) skip the host
    plan build."""
    key = (pad_reducers_to, pad_slots_to)
    cache = schema.__dict__.setdefault("_reducer_plan_cache", {})
    plan = cache.get(key)
    if plan is None:
        plan = build_plan(schema, pad_reducers_to=pad_reducers_to,
                          pad_slots_to=pad_slots_to)
        cache[key] = plan
    return plan


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
    total = 1 + sum(b.R * b.width * b.width for b in plan.buckets)
    if total > np.iinfo(np.int32).max:
        raise OverflowError(
            f"{total} Gram entries overflow the int32 source map")
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


def _assemble_from_srcmap(per_bucket, srcmap: torch.Tensor):
    """Fused assembly: gather the (m, m) matrix from the concatenated
    bucket blocks through the inverse-shuffle map (int64, on device)."""
    vals = [torch.zeros(1, dtype=torch.float32, device=srcmap.device)]
    vals += [g.reshape(-1) for _, g in per_bucket]
    return torch.cat(vals)[srcmap]


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
    gather+Gram kernel launch per bucket and one assembly gather.
    ``executor`` may also be an :class:`~repro_torch.mapreduce.executors.
    Executor` instance.  ``device=None`` runs on CUDA (raises without a
    card); pass ``device="cpu"`` for the plain CPU path.  Returns
    (sims (m, m) with zero diagonal, plan, schema)."""
    x = as_table(x, device)
    m = x.shape[0]
    if mesh is not None:
        raise NotImplementedError(
            "sharded execution over a mesh is not ported yet")
    with _obs_span("plan", workload="pairs", m=m):
        if schema is None:
            w = (np.full(m, 1.0) if weights is None
                 else np.asarray(weights, float))
            schema = plan_a2a(w, q)
        plan = _plan_for(schema, pad_reducers_to=1,
                         pad_slots_to=pad_slots_to)
    fn = _block_fn(metric, use_kernel)
    with _obs_span("execute", workload="pairs",
                   reducers=plan.num_reducers):
        sims = _run_and_assemble(x, plan, fn, m, mesh, executor,
                                 use_kernel=use_kernel)
    return sims, plan, schema


def _scatter_blocks(out: torch.Tensor, blocks: torch.Tensor,
                    idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """max-scatter (R, L, L) reducer blocks into the running (m, m) matrix
    (initialized to -inf), in place.  A pair may meet at several reducers;
    values agree, so `max` combine is deterministic."""
    m = out.shape[0]
    idx = idx.long()
    flat = (idx[:, :, None] * m + idx[:, None, :]).reshape(-1)
    valid = mask[:, :, None] & mask[:, None, :]
    vals = torch.where(valid, blocks, float("-inf")).reshape(-1)
    out.view(-1).scatter_reduce_(0, flat, vals.to(out.dtype), reduce="amax")
    return out


def _finish_pair_matrix(out: torch.Tensor) -> torch.Tensor:
    """Uncovered cells -> 0 and a zero diagonal (no self-pairs in A2A)."""
    out = torch.where(torch.isneginf(out), 0.0, out)
    return out.fill_diagonal_(0.0)


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
