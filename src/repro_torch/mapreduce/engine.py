"""Mapping schema -> static gather plan -> reducer execution, in PyTorch.

Port of ``repro.mapreduce.engine`` for the square all-pairs slice.  The plan
substrate (``ReducerBucket``, ``ReducerPlan``, ``build_plan``) is the
reference's numpy code unchanged, so both packages build byte-equal plans
from one schema.  Execution is eager PyTorch on an explicit device:

``run_reducers``           — the dense path: one gather padded to the global
                             max slot count, ``reducer_fn`` applied over the
                             reducer axis through ``torch.func.vmap``.
``run_reducers_bucketed``  — the skew-aware path: one gather+reduce per
                             capacity bucket, each padded only to its own
                             width; ``combine='dense'`` scatters bucket
                             outputs back into original reducer order,
                             ``combine='buckets'`` keeps them unpadded.

``reducer_fn(block (L, d), mask (L,)) -> tensor`` is generic here; the fused
executor (``executors.FusedExecutor``) runs Gram-block reducers through the
hand-written gather+Gram kernel instead.

With no ``jit`` to cache, the engine's bounded LRU holds what each
(plan, device) pair uploads: index/mask/row tensors and the fused
assembly's source map.  ``jit_cache_stats()`` keeps the reference's keys so
serving telemetry reads both packages alike; a ``shape_miss`` is a table
shape or dtype that an entry has not served before.

``plan_from_arrays`` rebuilds a plan from the fields of a reference plan
(``dataclasses.asdict``), so both packages can run one plan.

Meshes (sharded execution) are a later slice: ``mesh`` other than ``None``
raises ``NotImplementedError``.
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

from repro_torch._device import resolve_device
from repro_torch.core.planner import compute_buckets
from repro_torch.core.schema import MappingSchema
from repro_torch.obs import EVENTS as _OBS_EVENTS
from repro_torch.obs import REGISTRY as _OBS_REGISTRY

__all__ = [
    "ReducerBucket",
    "ReducerPlan",
    "build_plan",
    "plan_from_arrays",
    "run_reducers",
    "run_reducers_bucketed",
    "jit_cache_stats",
]


@dataclasses.dataclass(frozen=True)
class ReducerBucket:
    """One capacity bucket of the plan: reducers padded to a shared width.

    rows  (Rb,) int64 — original plan-row ids in bucket order; -1 marks a
          padding row added so the bucket divides the device count.
    idx   (Rb, width) int32 / mask (Rb, width) bool — same layout as the
          dense plan, but only ``width`` slots wide.

    ``ywidth`` / ``yidx`` / ``ymask`` carry the Y side of rectangular (X2Y)
    buckets (a later slice); ``yidx is None`` marks the square case.
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
    lower bound) for telemetry.  The rectangular fields (``yidx`` ...) keep
    the reference's layout for the X2Y slice.
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
    launch each on the fused path)."""
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
    return ReducerPlan(idx=idx, mask=mask, num_reducers=R0,
                       comm_cost=schema.communication_cost(), max_inputs=L0,
                       algorithm=schema.algorithm,
                       lower_bound=schema.lower_bound,
                       buckets=buckets)


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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded execution over a mesh is not ported yet")


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
def _env_cache_size(default: int = 64) -> int:
    """``REPRO_JIT_CACHE_SIZE`` as a cap >= 1; malformed or non-positive
    values fall back to the default."""
    raw = os.environ.get("REPRO_JIT_CACHE_SIZE", "")
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


def _evict_oldest():
    key, _ = _JIT_CACHE.popitem(last=False)
    _JIT_CACHE_HITS.pop(key, None)
    _JIT_SHAPES.pop(key, None)
    _JIT_CACHE_STATS["evictions"] += 1
    _OBS_REGISTRY.counter("cache.evictions", cache="jit").inc()
    _OBS_EVENTS.emit("cache_eviction", cache="jit", key=_key_label(key))


def _record_shape(key, table) -> None:
    """A table shape/dtype an entry has served before is a ``shape_hit``;
    a new one is a ``shape_miss``."""
    sig = (tuple(table.shape), str(table.dtype))
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


def _drop_plan(tok: int) -> None:
    for key in [k for k in _JIT_CACHE if k[1] == tok]:
        del _JIT_CACHE[key]
        _JIT_CACHE_HITS.pop(key, None)
        _JIT_SHAPES.pop(key, None)


def _plan_token(plan) -> int:
    tok = plan.__dict__.get("_upload_token")
    if tok is None:
        tok = next(_PLAN_TOKENS)
        object.__setattr__(plan, "_upload_token", tok)
        weakref.finalize(plan, _drop_plan, tok)
    return tok


def _check_indices(plan, m: int) -> None:
    """Every index the plan gathers must be a row of the ``m``-row table:
    the device gathers cannot raise, so a plan built elsewhere
    (``plan_from_arrays``) is checked here, once per plan (cached)."""
    lo, hi = plan.__dict__.get("_index_range") or (None, None)
    if lo is None:
        arrays = [plan.idx] + [b.idx for b in plan.buckets]
        lo = min(int(a.min(initial=0)) for a in arrays)
        hi = max(int(a.max(initial=0)) for a in arrays)
        object.__setattr__(plan, "_index_range", (lo, hi))
    if lo < 0 or hi >= m:
        raise IndexError(f"plan gathers rows {lo}..{hi} from a table of "
                         f"{m} rows")


def uploaded(kind: str, plan, table: torch.Tensor, factory):
    """``factory(device)`` for (kind, plan, table.device), through the LRU,
    after checking the plan's indices against the table; the table's shape
    and dtype feed the shape counters."""
    _check_indices(plan, table.shape[0])
    key = (kind, _plan_token(plan), str(table.device))
    value = _cache_get(key, lambda: factory(table.device))
    _record_shape(key, table)
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


# ---------------------------------------------------------------------------
# dense + bucketed runners
# ---------------------------------------------------------------------------
def _gather_reduce(x, idx, mask, reducer_fn):
    R, L = idx.shape
    gathered = x.index_select(0, idx.reshape(-1)).reshape(R, L, x.shape[1])
    gathered = torch.where(mask[..., None], gathered, 0.0)   # the shuffle
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
    reducer, every reducer padded to the plan's dense width."""
    _no_mesh(mesh)
    x = as_table(inputs, device)
    idx, mask = uploaded("dense", plan, x,
                         lambda dev: _dense_arrays(plan, dev))
    return _gather_reduce(x, idx, mask, reducer_fn)


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
    """Skew-aware execution: one gather+reduce per capacity bucket.

    combine='dense'    — one tensor shaped exactly like the ``run_reducers``
        output: bucket outputs are zero-padded along their slot-sized axes
        to the dense width and scattered back into original reducer order.
    combine='buckets'  — ``[(bucket, out), ...]`` unpadded.
    """
    assert combine in ("dense", "buckets"), combine
    _no_mesh(mesh)
    if not plan.buckets:
        out = run_reducers(inputs, plan, reducer_fn, device=device)
        return out if combine == "dense" else []
    x = as_table(inputs, device)
    arrays = uploaded("buckets", plan, x,
                      lambda dev: bucket_arrays(plan, dev))
    per_bucket = [(b, _gather_reduce(x, idx, mask, reducer_fn))
                  for b, (idx, mask, _) in zip(plan.buckets, arrays)]
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
