"""GPipe-style pipeline parallelism over a process group (port of
``repro.parallel.pipeline``).

Layers are split into S stages, one per rank of the group; each rank holds
only its own stage's parameters.  Microbatches stream through the
pipeline: every tick each rank runs its stage, then the boundary
activation moves from rank r to rank r + 1 (the reference's
``ppermute``; here a ``batch_isend_irecv`` ring, through the host on
gloo as ``compat`` does).  The schedule runs M + S - 1 ticks (classic
GPipe bubble = (S-1)/(M+S-1)); bubble ticks compute values that are never
read, as in the reference.  The last stage's finished microbatches reach
every rank by a sum of masked buffers (the reference's masked ``psum``).
Each transfer adds to the ``collective.bytes`` / ``collective.calls``
counters of ``repro_torch.obs`` (label ``op``) and its host time to
``pipeline.comm_ms``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..compat import _count, _on_wire
from ..obs import REGISTRY as _REGISTRY

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)


def _ring(buf: torch.Tensor, group, rank: int, S: int) -> torch.Tensor:
    """``buf`` sent to rank ``rank + 1`` and what rank ``rank - 1`` sent
    received (cyclic), on ``buf``'s device."""
    t0 = time.perf_counter()
    send = _on_wire(buf.contiguous(), group)
    recv = torch.empty_like(send)
    peer = lambda r: dist.get_global_rank(group, r % S)  # noqa: E731
    ops = [dist.P2POp(dist.isend, send, peer(rank + 1), group),
           dist.P2POp(dist.irecv, recv, peer(rank - 1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("send_recv", send)
    out = recv.to(buf.device)
    _REGISTRY.counter("pipeline.comm_ms").inc(
        (time.perf_counter() - t0) * 1e3)
    return out


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None):
    """Run M microbatches through S pipeline stages; returns (M, Bm, ...)
    on every rank.

    ``stage_fn(stage_params, x (Bm, ...)) -> (Bm, ...)``; ``stage_params``
    are THIS rank's stage's (rank r of ``group`` is stage r);
    ``x_micro`` (M, Bm, ...) is the whole input, the same on every rank.
    ``group`` ``None`` is the default group when one is initialised, else
    one stage."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    S = 1 if group is None else dist.get_world_size(group)
    sid = 0 if group is None else dist.get_rank(group)
    M = x_micro.shape[0]
    T = M + S - 1
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(T):
        # receive boundary activation from the previous stage
        recv = buf if S == 1 else _ring(buf, group, sid, S)
        x_in = x_micro[t if t < M else 0] if sid == 0 else recv
        y = stage_fn(stage_params, x_in)
        slot = t - (S - 1)           # the last stage finishes this one
        if sid == S - 1 and slot >= 0:
            outs[slot] = y
        buf = y
    if S == 1:
        return outs
    # every rank's buffer is zero but the last stage's: their sum is it
    wire = _on_wire(outs, group)
    dist.all_reduce(wire, group=group)
    _count("all_reduce", wire)
    return wire.to(outs.device)
