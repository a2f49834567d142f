"""Per-rank pieces of a sharded forward: where an operation is exact on
each rank's own rows or heads, it runs on the local shards through
``torch.distributed.tensor.experimental.local_map`` (:func:`map_local`)
instead of through DTensor's sharding propagation.

  ``per_head(fn, q, *operands, **kw)`` — ``fn`` on each rank's own
        (batch, head) block: the flash and SSD kernels, which pass raw
        pointers and must never see a DTensor.  Operands whose head dim is
        not split where ``q``'s is give each rank the heads its query heads
        read (query head ``h`` reads head ``h // G``, ``G`` the global
        ratio of query to operand heads), so a replicated KV head is
        indexed by the GLOBAL query head, not the local one.
  ``per_row(fn, like, *args, out_placements=...)`` — ``fn`` on each
        rank's own batch rows: the MoE dispatch and the depthwise
        convolution.
  ``write_rows(buf, upd, at)`` — ``buf[:, at] = upd`` for a cache buffer,
        on whatever ranks hold those rows.
  ``gathered(w)`` — a weight whole over the data axes (FSDP's gather on
        use); ``MeshPlacer`` — each rank's box of a parameter, to build it
        on a mesh without the whole tensor.

On plain tensors each is the plain call.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["MeshPlacer", "implicit_replication", "per_head", "per_row",
           "write_rows", "is_dtensor", "global_offset", "batch_placements",
           "gathered", "zeros_placed", "whole", "map_local", "DATA_AXES"]


_IMPLICIT_DEPTH = [0]


@contextlib.contextmanager
def implicit_replication(on: bool = True):
    """DTensor's ``implicit_replication`` (plain tensors taken as
    replicated: positions, masks, zero accumulators), re-entrant: the
    outermost entry turns it on and its exit off, so a nested use (a
    forward inside a train step, a rematerialised block inside a backward)
    does not end it early.  ``on=False`` does nothing."""
    if not on or _IMPLICIT_DEPTH[0]:
        _IMPLICIT_DEPTH[0] += bool(on)
        try:
            yield
        finally:
            _IMPLICIT_DEPTH[0] -= bool(on)
        return
    from torch.distributed.tensor.experimental import \
        implicit_replication as _ir
    _IMPLICIT_DEPTH[0] += 1
    try:
        with _ir():
            yield
    finally:
        _IMPLICIT_DEPTH[0] -= 1


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def global_offset(t) -> tuple:
    """``(local shape, global offset)`` of this rank's shard of DTensor
    ``t``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)


DATA_AXES = ("pod", "data")


def gathered(t):
    """A weight ``t`` whole over the data axes on every rank: FSDP's
    all-gather on use (the gradient's way back is the reduce-scatter).  A
    plain tensor, or a DTensor not split over them, as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in DATA_AXES else p
                 for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else \
        t.redistribute(t.device_mesh, want)


class MeshPlacer:
    """Where a parameter of given logical axes lives on ``mesh`` under
    ``rules``: ``box(shape, axes)`` is this rank's ``(offsets, local
    shape)`` of it, ``wrap(local, shape, axes)`` the DTensor of that local
    part."""

    def __init__(self, mesh, rules):
        self.mesh, self.rules = mesh, rules

    def placements(self, axes) -> tuple:
        from .sharding import logical_to_spec, placements
        return placements(self.mesh, logical_to_spec(self.rules, axes))

    def box(self, shape, axes) -> tuple:
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        loc, off = compute_local_shape_and_global_offset(
            torch.Size(shape), self.mesh, self.placements(axes))
        return tuple(off), tuple(loc)

    def wrap(self, local, shape, axes):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            local, self.mesh, self.placements(axes), run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())


def zeros_placed(shape, dtype, device, mesh, placements_) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` with ``placements_`` on
    ``mesh``, each rank's shard allocated on ``device`` (meta in the dry
    run: nothing allocated)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, placements_)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, placements_,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def whole(t):
    """``t`` as a plain tensor holding all of it (a DTensor's
    ``full_tensor()``, one collective); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _check(t, allowed: tuple, what: str) -> None:
    from torch.distributed.tensor import Replicate, Shard
    for p in t.placements:
        if isinstance(p, Replicate):
            continue
        if isinstance(p, Shard) and p.dim in allowed:
            continue
        raise ValueError(f"{what}: placement {p} splits a dim the local "
                         f"computation is not exact over (allowed: "
                         f"Shard{allowed} and Replicate)")


def map_local(fn, mesh, in_placements, out_placements):
    """``local_map`` with ``out_placements`` one placements tuple (one
    output) or a tuple of them (several).  An input that is whole on a
    mesh dim where an output is split (or partial) gets a partial
    gradient there: each rank's local function read only its own part of
    it."""
    from torch.distributed.tensor import Partial, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = (tuple(out_placements),)
    split = [any(not isinstance(o[i], Replicate) for o in out_placements)
             for i in range(mesh.ndim)]
    grad_pl = tuple(
        None if pl is None else tuple(
            Partial() if isinstance(p, Replicate) and split[i] else p
            for i, p in enumerate(pl))
        for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=False)


def per_head(fn, q, *operands, head_dim: int = 2, split_seq=(), **kw):
    """``fn(q, *operands, **kw)`` -> a tensor shaped and placed like
    ``q`` ``(B, S, H, ...)``, run on each rank's own batch rows and heads.
    Every operand is ``(B, ..., H', ...)`` with heads at ``head_dim``, and
    ``H' `` divides ``H``.  A split of any dim but batch and heads raises:
    the functions are exact per (batch, head) and nothing else, except
    that operands keep their dim-1 split on the mesh dims ``split_seq``
    lists, for a ``fn`` that merges its result over them itself."""
    if not is_dtensor(q):
        return fn(q, *operands, **kw)
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    _check(q, (0, head_dim), "query")
    H = q.shape[head_dim]
    q_loc, q_off = global_offset(q)
    h0, h_loc = q_off[head_dim], q_loc[head_dim]
    placed, slicers = [], []
    for t in operands:
        # batch split as q's; heads split where both split them, else whole
        want = tuple(
            Shard(1) if i in split_seq
            else Shard(0) if qp == Shard(0)
            else tp if qp == Shard(head_dim) and tp == Shard(head_dim)
            else Replicate()
            for i, (qp, tp) in enumerate(zip(q.placements, t.placements)))
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        placed.append(t)
        # the heads this rank's query heads read, in the operand's local
        # index: global query head h reads global operand head h // G
        G = H // t.shape[head_dim]
        t_loc, t_off = global_offset(t)
        need = (h0 + torch.arange(h_loc)) // G - t_off[head_dim]
        if need.numel() and (need.min() < 0
                             or need.max() >= t_loc[head_dim]):
            raise ValueError("an operand's local heads do not cover the "
                             "heads its query heads read")
        slicers.append(_head_select(need, head_dim))

    def local(ql, *ols):
        ols = [sl(o) for sl, o in zip(slicers, ols)]
        return fn(ql, *ols, **kw)

    in_pl = (tuple(q.placements),) + tuple(tuple(t.placements)
                                           for t in placed)
    return map_local(local, mesh, in_pl, tuple(q.placements))(q, *placed)


def _head_select(need: torch.Tensor, dim: int):
    """A function taking a local operand to the heads ``need`` lists: a
    slice when they are a contiguous run each read by the same number of
    query heads (no copy, strides kept), else an index."""
    n = int(need.numel())
    if n == 0:
        return lambda o: o
    lo, hi = int(need[0]), int(need[-1]) + 1
    run = hi - lo
    if n % run == 0 and torch.equal(
            need, lo + torch.arange(n) // (n // run)):
        return lambda o: o.narrow(dim, lo, run) \
            if (lo, run) != (0, o.shape[dim]) else o
    return lambda o: o.index_select(dim, need.to(o.device))


def per_row(fn, like, *args, out_placements=None):
    """``fn(*local args)`` on each rank's own batch rows.  An argument is a
    tensor (split over batch as ``like`` is, whole on the other mesh
    dims), a ``(tensor, placements)`` pair (placed so), or anything else
    (passed as it is).  Outputs are placed as ``out_placements`` (default:
    ``like``'s batch split, replicated elsewhere; a tuple of them for
    several outputs)."""
    if not is_dtensor(like):
        return fn(*(a[0] if isinstance(a, tuple) else a for a in args))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    rows = batch_placements(like)
    placed, in_pl = [], []
    for a in args:
        t, want = a if isinstance(a, tuple) else (a, rows)
        if not isinstance(t, torch.Tensor):
            placed.append(t)
            in_pl.append(None)
            continue
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != tuple(want):
            t = t.redistribute(mesh, want)
        placed.append(t)
        in_pl.append(tuple(want))
    if out_placements is None:
        out_placements = rows
    return map_local(fn, mesh, tuple(in_pl), out_placements)(*placed)


def batch_placements(like) -> tuple:
    """``like``'s split of dim 0, ``Replicate()`` on every other mesh
    dim."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in like.placements)


def write_rows(buf: torch.Tensor, upd: torch.Tensor, at: slice) -> None:
    """``buf[:, at] = upd`` in place: ``buf`` (B, L, ...) a cache buffer,
    ``upd`` (B, at.stop - at.start, ...).  On a DTensor ``buf`` each rank
    writes the part of ``upd`` that falls in its own rows of ``buf``
    (split over batch, sequence or heads), so a sequence-sharded cache is
    written where it lives."""
    if not is_dtensor(buf):
        buf[:, at] = upd
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    # the update on buf's placements, except that its sequence dim is
    # whole on every rank (each rank cuts out its own rows)
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in buf.placements]
    if not is_dtensor(upd):
        from torch.distributed.tensor import DTensor
        upd = DTensor.from_local(upd, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(upd.placements) != tuple(want):
        upd = upd.redistribute(mesh, want)
    (b_loc, b_off) = global_offset(buf)
    lo = max(at.start, b_off[1])
    hi = min(at.stop, b_off[1] + b_loc[1])
    if hi > lo:
        buf.to_local()[:, lo - b_off[1]:hi - b_off[1]] = \
            upd.to_local()[:, lo - at.start:hi - at.start]
