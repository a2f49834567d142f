"""Executor protocol + registry, ported for the square all-pairs slice.

Port of ``repro.mapreduce.executors``.  An :class:`Executor` decides how a
:class:`~repro_torch.mapreduce.engine.ReducerPlan` runs on the device:

  ``run(inputs, plan, reducer_fn, ...)``     — execute the plan;
  ``run_pairs(x, plan, reducer_fn, m, ...)`` — execute + assemble the
        (m, m) pair matrix;
  ``stats()`` / ``reset()``                  — instance-scoped dispatch
        telemetry, also published into ``repro_torch.obs`` under the
        reference's series names (``executor.<key>{executor=<name>}``), and
        every pair request reconciled into the comm ledger.

Registered executors:

``dense``     — one gather padded to the global max slot count (oracle).
``bucketed``  — skew-aware: one gather+reduce per capacity bucket (oracle).
``fused``     — per bucket, ONE launch of the hand-written gather+Gram
                kernel (``kernels.pairwise.fused_gather_gram``; its plain
                version on a CPU table), the metric finish in torch, then
                ONE assembly gather through the inverse-shuffle source map.
                Non-Gram reducers fall back to bucketed, counted.

Later slices: ``sharded``, ``coded`` and ``streaming``; X2Y (``run_x2y``)
and block serving (``run_block``).  A ``mesh`` raises
``NotImplementedError``, and so does ``use_kernel=True`` on dense/bucketed
(it reaches the ``pairwise_gram`` kernel through ``block_similarity``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.pairwise.fused_gather_gram import fused_gather_gram
from repro_torch.obs import EVENTS as _EVENTS
from repro_torch.obs import LEDGER as _LEDGER
from repro_torch.obs import REGISTRY as _REGISTRY_OBS
from repro_torch.obs import _config as _obs_config

from .engine import (
    ReducerPlan,
    _no_mesh,
    as_table,
    bucket_arrays,
    run_reducers,
    run_reducers_bucketed,
    uploaded,
)

__all__ = [
    "Executor",
    "DenseExecutor",
    "BucketedExecutor",
    "FusedExecutor",
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
    """Valid gather slots the plan books — the ledger's ``plan_slots``
    denominator.  Cached on the plan."""
    n = plan.__dict__.get("_obs_plan_slots")
    if n is None:
        n = int(np.asarray(plan.mask).sum())
        if plan.ymask is not None:
            n += int(np.asarray(plan.ymask).sum())
        object.__setattr__(plan, "_obs_plan_slots", n)
    return n


def _bucket_valid_slots(plan) -> int:
    """Valid gather slots the bucketed/fused path executes (sum of
    per-bucket masks; padding rows are all-False, so this equals the dense
    mask sum — the 1.0-ratio invariant).  Cached on the plan."""
    n = plan.__dict__.get("_obs_bucket_slots")
    if n is None:
        if plan.buckets:
            n = sum(int(np.asarray(b.mask).sum()) for b in plan.buckets)
        else:
            n = _plan_valid_slots(plan)
        object.__setattr__(plan, "_obs_bucket_slots", n)
    return n


def _no_kernel(use_kernel: bool) -> None:
    if use_kernel:
        raise NotImplementedError(
            "use_kernel=True reaches the pairwise_gram kernel, which is not "
            "ported yet")


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
    Unknown names raise ``ValueError``."""
    if isinstance(name, Executor):
        return name
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
        from .allpairs import assemble_pair_matrix
        _no_mesh(mesh)
        _no_kernel(use_kernel)
        x = as_table(x, device)
        self._count("calls")
        self._reconcile(plan, "pairs", x,
                        measured_slots=_plan_valid_slots(plan))
        blocks = run_reducers(x, plan, reducer_fn, device=x.device)
        return assemble_pair_matrix(blocks, plan, m)


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
        from .allpairs import assemble_pair_matrix_bucketed
        _no_mesh(mesh)
        _no_kernel(use_kernel)
        x = as_table(x, device)
        self._count("calls")
        self._reconcile(plan, "pairs", x,
                        measured_slots=_bucket_valid_slots(plan))
        per_bucket = run_reducers_bucketed(x, plan, reducer_fn,
                                           combine="buckets", device=x.device)
        return assemble_pair_matrix_bucketed(per_bucket, m, device=x.device)


# ---------------------------------------------------------------------------
# fused (gather+Gram kernel) executor
# ---------------------------------------------------------------------------
def _finish_fused_blocks(g, mask, metric: str):
    """Metric post-processing of a masked per-reducer Gram stack.

    Mirrors ``allpairs.block_similarity`` exactly: norms are the Gram
    diagonal (masked rows were zeroed at gather time, so their norms are 0),
    invalid pairs -> 0.
    """
    if metric != "dot":
        n2 = torch.diagonal(g, dim1=1, dim2=2)            # (Rb, Lb)
        if metric == "l2":
            g = n2[:, :, None] + n2[:, None, :] - 2.0 * g
        elif metric == "cosine":
            nrm = torch.sqrt(n2 + 1e-9)
            g = g / (nrm[:, :, None] * nrm[:, None, :])
        else:
            raise ValueError(metric)
    valid = mask[:, :, None] & mask[:, None, :]
    return torch.where(valid, g, 0.0)


class FusedExecutor(Executor):
    """Fused shuffle execution: the gathered block stays out of memory.

    Per capacity bucket, the plan's ``idx``/``mask`` rows drive ONE launch
    of the hand-written gather+Gram kernel on a CUDA table (its plain
    version on a CPU table: no other path exists, so nothing on the card
    takes the plain version silently).  The ``kernel`` counter counts
    requests served by the kernel, ``streamed`` those served by the plain
    version on the CPU (the reference's name for its non-kernel path).

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
        step (allpairs passes its inverse-shuffle assembly)."""
        assert combine in ("dense", "buckets"), combine
        _no_mesh(mesh)
        x = as_table(inputs, device)
        self._count("calls")
        metric = getattr(reducer_fn, "fused_metric", None)
        if metric is None or not plan.buckets:
            self._count_fallback(
                "non_gram_reducer" if metric is None else "no_buckets")
            out = run_reducers_bucketed(
                x, plan, reducer_fn, device=x.device,
                combine="buckets" if postprocess is not None else combine)
            if postprocess is not None:
                arrays = uploaded("buckets", plan, x,
                                  lambda dev: bucket_arrays(plan, dev))
                per_bucket = [(arr, blocks)
                              for arr, (_, blocks) in zip(arrays, out)]
                return postprocess(per_bucket, postprocess_arg)
            return out

        self._count("kernel" if x.is_cuda else "streamed")
        arrays = uploaded("buckets", plan, x,
                          lambda dev: bucket_arrays(plan, dev))
        per_bucket = []
        for idx, msk, rows in arrays:
            g = fused_gather_gram(x, idx, msk)
            per_bucket.append(((idx, msk, rows),
                               _finish_fused_blocks(g, msk, metric)))
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

    def run_pairs(self, x, plan, reducer_fn, m, *, mesh=None,
                  use_kernel=False, device=None):
        """``use_kernel`` is accepted for signature parity: on a CUDA table
        the fused path always runs the kernel."""
        from .allpairs import _assemble_from_srcmap, _pair_source_map
        _no_mesh(mesh)
        x = as_table(x, device)
        # reconcile here, not in run(): the delegation below must not
        # double-record the request
        self._reconcile(plan, "pairs", x,
                        measured_slots=_bucket_valid_slots(plan))
        srcmap = uploaded(
            f"srcmap:{m}", plan, x,
            lambda dev: torch.as_tensor(_pair_source_map(plan, m),
                                        device=dev).long())
        return self.run(x, plan, reducer_fn, device=x.device,
                        postprocess=_assemble_from_srcmap,
                        postprocess_arg=srcmap)


# ---------------------------------------------------------------------------
# default registry instances
# ---------------------------------------------------------------------------
register_executor(DenseExecutor())
register_executor(BucketedExecutor())
register_executor(FusedExecutor())
