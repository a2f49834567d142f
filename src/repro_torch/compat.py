"""Process groups and collectives for sharded execution (port of
``repro.compat``'s mesh and collective shims).

The reference shards over a JAX device mesh and moves data with
``shard_map`` collectives.  Here a "mesh" is a
``torch.distributed.ProcessGroup``: one rank per shard, SPMD — every rank
plans the same inputs the same way and runs only its own shard.

  ``shard_group(mesh, shard_axes)`` — ``(group, num_shards, rank)``; a
        ``mesh`` of ``None`` means the default group when one has been
        initialised, else one shard and no collective.
  ``reducer_group(mesh)`` — the same for the executors that
        split each bucket's reducer rows over a group (dense, bucketed,
        fused, streaming): there ``mesh=None`` is always local.
  ``all_gather(vec, group)`` — every rank's equal-length vector,
        concatenated in rank order (one collective).
  ``all_to_all(send, group)`` — ``send`` is ``(S, E)``; lane ``s``
        of the result is what rank ``s`` addressed to this rank (one
        collective), as the reference's tiled ``all_to_all``.
  ``run_local_group(fn, world_size, *args)`` — run ``fn`` on
        ``world_size`` spawned processes joined in one group on this host:
        the counterpart of the reference's forced multi-device CPU mesh.

Where a collective's tensors live is fixed by the group's backend: NCCL
takes them on the rank's CUDA device, any other backend (gloo) on the host,
so the rank copies its send tensor to the host and the result back.  Each
collective adds its bytes and its count to the ``collective.bytes`` /
``collective.calls`` counters of ``repro_torch.obs`` (label ``op``).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.obs import REGISTRY as _REGISTRY_OBS

__all__ = ["shard_group", "reducer_group", "all_gather", "all_to_all",
           "run_local_group"]

# ``all_gather_single`` replaces ``all_gather_into_tensor`` in newer torch
# (which warns on the old name); the card's torch may predate it
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def shard_group(mesh, shard_axes=None) -> tuple:
    """``(group, num_shards, rank)`` the sharded executors run over.

    ``mesh`` is a ``ProcessGroup``; ``None`` means the default group if one
    has been initialised, else one shard (``group`` ``None``, no
    collective).  A group has one axis, so ``shard_axes`` must be
    ``None``."""
    if shard_axes is not None:
        raise ValueError("a process group has one axis: shard_axes must be "
                         f"None, got {shard_axes!r}")
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 1, 0
        mesh = dist.group.WORLD
    if not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed.ProcessGroup, "
                        f"got {type(mesh).__name__}")
    return mesh, dist.get_world_size(mesh), dist.get_rank(mesh)


def reducer_group(mesh) -> tuple:
    """``(group, num_ranks, rank)`` the dense, bucketed, fused and
    streaming executors split reducer rows over.  Unlike
    :func:`shard_group`, ``mesh=None`` means no group even when a default
    group has been initialised: these executors run locally unless a group
    is passed, as the reference runs them on one device without a mesh."""
    if mesh is None:
        return None, 1, 0
    return shard_group(mesh)


def _on_wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend takes collective tensors."""
    return t if dist.get_backend(group) == "nccl" else t.cpu()


def _count(op: str, t: torch.Tensor) -> None:
    _REGISTRY_OBS.counter("collective.calls", op=op).inc()
    _REGISTRY_OBS.counter("collective.bytes", op=op).inc(
        t.numel() * t.element_size())


def all_gather(vec: torch.Tensor, group) -> torch.Tensor:
    """``(n,)`` on every rank -> ``(S * n,)``, rank ``s``'s vector at
    ``[s * n, (s + 1) * n)``, on ``vec``'s device.  ``group`` ``None`` is
    one shard: ``vec`` itself."""
    if group is None:
        return vec
    send = _on_wire(vec.contiguous(), group)
    out = send.new_empty((dist.get_world_size(group) * send.numel(),))
    _ALL_GATHER(out, send, group=group)
    _count("all_gather", out)
    return out.to(vec.device)


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """``(S, E)`` on every rank, row ``t`` addressed to rank ``t`` ->
    ``(S, E)`` whose row ``s`` is what rank ``s`` addressed to this rank,
    on ``send``'s device.  ``group`` ``None`` is one shard: ``send``
    itself."""
    if group is None:
        return send
    wire = _on_wire(send.contiguous(), group)
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    _count("all_to_all", wire)
    return recv.to(send.device)


def _rank_main(fn, rank, world_size, store, backend, timeout_s, queue,
               args):
    """One spawned rank: join the group, run ``fn``, report to the
    parent."""
    # the ranks talk over the loopback interface: nothing leaves the host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            queue.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:   # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_local_group(fn: Callable, world_size: int, *args,
                    backend: str = "gloo", timeout_s: float = 120.0) -> list:
    """``[fn(rank, world_size, *args) for every rank]``, each rank a process
    spawned on this host and joined in one process group (a file store in
    a temporary directory, so no port is opened for the rendezvous).  ``fn`` and ``args`` are pickled: ``fn`` must be a
    module-level function.  The collectives time out after ``timeout_s``
    and the whole run after twice that; a rank that fails or times out
    raises here, after every rank has been stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, store, backend,
                                   timeout_s, queue, args), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=2 * timeout_s)
        try:
            while len(results) < world_size:
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(
                        f"{world_size - len(results)} of {world_size} ranks "
                        f"did not report within {2 * timeout_s:.0f} s")
                if queue.empty():
                    if not any(p.is_alive() for p in procs) \
                            and queue.empty():
                        raise RuntimeError(
                            f"ranks exited without reporting: codes "
                            f"{[p.exitcode for p in procs]}")
                    for p in procs:
                        p.join(0.05)
                    continue
                rank, ok, value = queue.get()
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(5.0)
    return [results[r] for r in range(world_size)]
