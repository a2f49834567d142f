"""The block vector and its inverse shuffle: where every gather+Gram launch
writes its blocks, and how the output matrix is assembled from them.

A request's ``(R, Lx, Ly)`` blocks (a square block is the case
``Lx == Ly``) lie one after the other in ONE fp32 vector
``[0.0, blocks_0.ravel(), blocks_1.ravel(), ...]``; slot 0 reads 0.0 for
every output cell that no block covers.  The host builds an int32 *source
map* per plan: each output cell's position in that vector (where several
reducers cover a pair, one of them: duplicate values agree).  Assembly is
then one gather, ``vector[srcmap]``.

* :class:`BlockLayout` / :func:`block_layout` — the blocks' bases in the
  vector, the vector and each block's view of it; :func:`with_zero_slot`
  the vector built from finished blocks.
* :func:`rect_launch_plan` — the rect launches of a fused X2Y request:
  each plan bucket split into tight ``(wx, wy)`` classes of its reducers'
  valid extents, one launch (and one block) each.
* :func:`source_map` — the one function that builds a map, with the one int32
  check (:func:`check_int32`).  The fused executor's maps
  (:func:`_pair_source_map`, :func:`_pair_source_map_rect`) and the
  sharded executor's (``executors._sharded_srcmap``,
  ``executors._sharded_rect_srcmap``) call it.
* :func:`_assemble_from_srcmap` — the fused assembly gather.
* The bucketed assembly max-scatters per-bucket blocks into a ``-inf``
  matrix (``assemble_*``); the streaming executor patches its maintained
  matrix with the same scatters (:func:`_scatter_blocks`,
  :func:`_scatter_blocks_x2y`) and finishes (:func:`_finish_pair_matrix`,
  :func:`_finish_x2y_matrix`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs import span as _obs_span

from .engine import ReducerBucket, ReducerPlan, plan_memo


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
class BlockLayout:
    """Where ``(R, Lx, Ly)`` blocks lie in the block vector:
    ``bases[i]`` is block ``i``'s first position and ``bases[-1]`` the
    vector's length (slot 0 comes first)."""

    __slots__ = ("shapes", "bases")

    def __init__(self, shapes):
        self.shapes = [tuple(int(n) for n in s) for s in shapes]
        self.bases = [1]
        for R, Lx, Ly in self.shapes:
            self.bases.append(self.bases[-1] + R * Lx * Ly)

    def vector(self, device) -> torch.Tensor:
        """The vector, uninitialised: each launch writes its block's
        :meth:`view`, and the caller zeroes slot 0 after the launches."""
        return torch.empty(self.bases[-1], dtype=torch.float32,
                           device=device)

    def view(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i``'s ``(R, Lx, Ly)`` view of ``flat``."""
        return flat[self.bases[i]:self.bases[i + 1]].view(self.shapes[i])


def block_layout(plan) -> BlockLayout:
    """The layout of the plan's buckets in bucket order, cached on the
    plan: the one :func:`_pair_source_map` and
    :func:`_pair_source_map_rect` index."""
    return plan_memo(plan, "_block_layout", lambda: BlockLayout(
        (b.R, b.idx.shape[1], (b.idx if b.yidx is None else b.yidx).shape[1])
        for b in plan.buckets))


def _tight_widths(mask: np.ndarray, width: int) -> np.ndarray:
    """Per row of an ``(R, L)`` slot mask, the smallest power of two that
    holds its valid extent (last valid slot + 1; at least 1), at most
    ``width``."""
    L = mask.shape[1]
    extent = np.where(mask.any(axis=1),
                      L - np.argmax(mask[:, ::-1], axis=1), 1)
    return np.minimum(2 ** np.ceil(np.log2(extent)).astype(np.int64), width)


def rect_launch_plan(plan: ReducerPlan) -> ReducerPlan:
    """The rect launches of a fused X2Y request without a process group:
    the plan's dense fields, and each plan bucket split, in bucket order,
    into classes of its real reducers (padding rows dropped) by the
    tightest power of two per side that holds each reducer's valid extent,
    capped at the bucket's widths.  A class keeps the bucket's rows in
    their order, its slots cut to the class's widths, so it holds the same
    valid (x, y) pairs; classes follow by area.  The plan itself when no
    bucket splits.  Cached on the plan."""
    def build():
        buckets, split = [], False
        for b in plan.buckets:
            real = np.flatnonzero(b.rows >= 0)
            # a class as one small integer, wx (ywidth + 1) + wy: found by
            # a count, where sorting millions of (wx, wy) rows took seconds
            ny = b.ywidth + 1
            key = (_tight_widths(b.mask[real], b.width) * ny
                   + _tight_widths(b.ymask[real], b.ywidth))
            classes = sorted(
                (divmod(int(k), ny) for k in np.flatnonzero(np.bincount(key))),
                key=lambda c: (c[0] * c[1], c))
            split |= real.size < b.R or classes != [(b.width, b.ywidth)]
            for cx, cy in classes:
                sel = real[key == cx * ny + cy]
                buckets.append(ReducerBucket(
                    width=cx, rows=b.rows[sel],
                    idx=np.ascontiguousarray(b.idx[sel, :cx]),
                    mask=np.ascontiguousarray(b.mask[sel, :cx]),
                    ywidth=cy, yidx=np.ascontiguousarray(b.yidx[sel, :cy]),
                    ymask=np.ascontiguousarray(b.ymask[sel, :cy])))
        return dataclasses.replace(plan, buckets=tuple(buckets)) if split \
            else plan
    return plan_memo(plan, "_rect_launch_plan", build)


def with_zero_slot(blocks, device) -> torch.Tensor:
    """The block vector of finished ``blocks`` on ``device``: their
    concatenation behind slot 0 (0.0)."""
    return torch.cat([torch.zeros(1, dtype=torch.float32, device=device)]
                     + [b.reshape(-1) for b in blocks])


# ---------------------------------------------------------------------------
# the inverse shuffle
# ---------------------------------------------------------------------------
def check_int32(entries: int) -> None:
    """Source-map positions are int32, as in the reference, so a vector a
    map indexes must stay below 2**31 entries (the reference wraps; the
    port raises)."""
    if entries > np.iinfo(np.int32).max:
        raise OverflowError(
            f"{entries} block entries overflow the int32 source map")


def source_map(stacks, shape: tuple[int, int],
               zero_diag: bool) -> np.ndarray:
    """The ``shape`` int32 map into the block vector of ``stacks``: 2-D
    ``(xidx, xmask, yidx, ymask)`` slot arrays, one ``(R, Lx, Ly)`` block
    each, in vector order.  Entry ``(r, p, q)`` of a block serves cell
    ``(xidx[r, p], yidx[r, q])`` where both slots are valid; a cell served
    several times keeps the last.  Uncovered cells, and with ``zero_diag``
    the diagonal (no self-pairs in A2A), point at slot 0.  Raises
    ``OverflowError`` past int32 positions, before building anything."""
    stacks = list(stacks)
    layout = BlockLayout((xi.shape[0], xi.shape[1], yi.shape[1])
                         for xi, _xm, yi, _ym in stacks)
    check_int32(layout.bases[-1])
    srcmap = np.zeros(shape, np.int32)
    for (xi, xm, yi, ym), (R, Lx, Ly), base in zip(stacks, layout.shapes,
                                                   layout.bases):
        rows = np.broadcast_to(xi[:, :, None], (R, Lx, Ly))
        cols = np.broadcast_to(yi[:, None, :], (R, Lx, Ly))
        valid = xm[:, :, None] & ym[:, None, :]
        pos = np.arange(base, base + R * Lx * Ly,
                        dtype=np.int64).reshape(R, Lx, Ly)
        srcmap[rows[valid], cols[valid]] = pos[valid]
    if zero_diag:
        np.fill_diagonal(srcmap, 0)
    return srcmap


def _pair_source_map(plan: ReducerPlan, m: int) -> np.ndarray:
    """The fused A2A assembly's (m, m) map into the plan's block vector
    (bucket order = ``plan.buckets``); the diagonal points at slot 0.
    Cached on the plan (the last ``m``); a build runs in a ``plan.srcmap``
    span."""
    def build():
        with _obs_span("plan.srcmap", m=m):
            return source_map(((b.idx, b.mask, b.idx, b.mask)
                               for b in plan.buckets), (m, m), True)
    return plan_memo(plan, "_pair_srcmap", build, m, keep_last=True)


def _pair_source_map_rect(plan: ReducerPlan, mx: int,
                          my: int) -> np.ndarray:
    """The fused X2Y assembly's (mx, my) map into the plan's block vector:
    rows from each bucket's X-side ids, columns from its Y-side ids, no
    diagonal to zero (an (x, y) pair is never a self-pair).  Cached on the
    plan (the last shape); a build runs in a ``plan.srcmap`` span."""
    def build():
        with _obs_span("plan.srcmap", mx=mx, my=my):
            return source_map(((b.idx, b.mask, b.yidx, b.ymask)
                               for b in plan.buckets), (mx, my), False)
    return plan_memo(plan, "_pair_srcmap_rect", build, (mx, my),
                     keep_last=True)


def _assemble_from_srcmap(per_bucket, srcmap: torch.Tensor, flat=None):
    """Fused assembly: gather the output matrix from the block vector
    through the source map (int64, on device).  ``flat``, when the blocks
    were written into the vector in place, is gathered from as it is;
    otherwise the vector is built from ``per_bucket``'s blocks first."""
    with _obs_span("assemble", device=srcmap.device):
        if flat is None:
            flat = with_zero_slot([g for _, g in per_bucket], srcmap.device)
        return flat[srcmap]


# ---------------------------------------------------------------------------
# the bucketed assembly and the streaming patch: max-scatter into -inf
# ---------------------------------------------------------------------------
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
