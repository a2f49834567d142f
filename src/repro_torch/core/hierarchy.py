"""Hierarchical (two-level) A2A planner for million-input instances.

The paper's bin-packing approximation (Theorem 9 / the Theorem 10
construction) packs the m inputs into bins of size ``q/2`` and pairs bins in
reducers.  At m = 10^6 the flat planner is sound but slow: packing, schema
construction and the portfolio all walk per-input Python structures.  The
hierarchical planner composes the packing *twice*:

  1. inner pack (``binpack.pack_prefix``, array-native): inputs -> super-
     inputs of size <= ``b = q / (2c)`` for a grouping factor ``c >= 1``;
  2. outer plan (``planner.plan_a2a``, the full strategy registry): the G
     super-input *weights* form a G-item A2A instance over the same
     capacity ``q``; G ~ thousands, so every existing strategy, estimate
     and cache applies unchanged.

Because the inner bins are disjoint, flattening the composition preserves
communication cost exactly and Theorem 8's lower bound ``s^2/q`` depends
only on the total weight ``s`` — which grouping preserves.  The optimality
gap therefore *composes multiplicatively*, and the planner surfaces the
ledger on the schema like every other plan in this repo:

  ``gap_inner``  = G / ceil(s / b)   — inner packing's bin-count gap
                   (<= 2 + o(1) by the prefix pack's half-full guarantee);
  ``gap_outer``  = outer cost / outer lower bound — the registry plan's
                   measured gap over the super weights;
  ``gap_total``  = gap_outer * gap_inner — a provable constant upper bound
                   on the composed schema's gap (the measured composed gap
                   equals ``gap_outer`` exactly; see DESIGN.md section 1h).

Composed plans are memoized in ``PLAN_CACHE`` under a method tag embedding
``c`` (``hier-c{c}|{method}``) so hierarchical entries never collide with
flat plans or with each other across grouping factors.  Unlike the flat
planner the key uses the literal weight order — remapping a million-entry
schema on every hit would cost more than planning.

``sampled_pair_coverage`` replaces ``MappingSchema.validate``'s dense
O(m^2) met-matrix at large m: it checks random required pairs against a
CSR bin -> reducers map, so conformance at m = 10^6 is O(samples).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .binpack import pack_prefix
from .bounds import a2a_comm_lower_bound
from .planner import plan_a2a
from .schema import InfeasibleError, MappingSchema
from .strategies import PLAN_CACHE, PlanCache

__all__ = [
    "plan_a2a_hierarchical",
    "choose_grouping_factor",
    "sampled_pair_coverage",
]

_EPS = 1e-12


def choose_grouping_factor(weights: Sequence[float], q: float,
                           target_super: int = 4096) -> int:
    """Grouping factor c aiming for ~``target_super`` super-inputs.

    ``b = q/(2c)`` and the prefix pack yields G ~ s/b super-inputs, so
    ``c ~ q * target_super / (2s)``, clamped to ``[1, q / (2 * wmax)]`` so
    every input fits in a super-input bin.  Returns 0 when no grouping is
    possible (an input exceeds q/2 — the big-input path owns that case).
    """
    w = np.asarray(weights, dtype=np.float64)
    if w.size == 0:
        return 0
    wmax = float(np.max(w))
    s = float(np.sum(w))
    if wmax > q / 2 + _EPS or s <= 0:
        return 0
    cmax = int(q / (2.0 * wmax) + _EPS) if wmax > 0 else 2 ** 20
    if cmax < 1:
        return 0
    c = int(round(q * target_super / (2.0 * s))) if s > 0 else 1
    return max(1, min(c, cmax))


def plan_a2a_hierarchical(weights: Sequence[float], q: float, *,
                          c: Optional[int] = None, method: str = "auto",
                          use_cache: bool = True,
                          target_super: int = 4096) -> MappingSchema:
    """Two-level A2A plan: inner prefix pack to bins of ``q/(2c)``, outer
    registry plan over the super-input weights, flattened composition.

    ``c=None`` picks the grouping factor automatically (and falls back to
    the flat planner when grouping cannot help: a big input, or m already
    at most ``target_super``).  The returned schema's ``meta`` carries the
    composed ledger: ``c``, ``b``, ``num_super``, ``gap_inner``,
    ``gap_outer`` and ``gap_total = gap_outer * gap_inner``.

    Treat the result as immutable — cache hits share structure, exactly
    like ``plan_a2a``.
    """
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    if np.any(w > q + _EPS):
        raise InfeasibleError("an input exceeds the reducer capacity")
    if c is None:
        if m <= target_super:
            return plan_a2a(w, q, method, use_cache=use_cache)
        c = choose_grouping_factor(w, q, target_super)
        if c == 0:  # big input: grouping cannot host it, flat path owns it
            return plan_a2a(w, q, method, use_cache=use_cache)
    elif c < 1:
        raise ValueError(f"grouping factor must be >= 1, got {c}")
    b = q / (2.0 * c)
    if m and float(np.max(w)) > b + _EPS:
        raise InfeasibleError(
            f"an input exceeds the super-input size q/(2c) = {b}")

    hkey = PlanCache.key(w, q, f"hier-c{c}|{method}")
    if use_cache:
        cached = PLAN_CACHE.get(hkey)
        if cached is not None:
            return cached

    # inner: array-native pack into super-inputs of size <= b
    bin_of = pack_prefix(w, b)
    super_w = np.bincount(bin_of, weights=w)
    num_super = len(super_w)
    s = float(np.sum(w))
    inner_lb = max(1, int(math.ceil(s / b - _EPS))) if s > 0 else max(
        1, num_super)
    gap_inner = num_super / inner_lb

    # outer: the existing registry portfolio over the super weights
    outer = plan_a2a(super_w, q, method, use_cache=use_cache)
    gap_outer = outer.optimality_gap()
    if gap_outer is None:  # degenerate bound (s < q): cost == lower bound
        gap_outer = 1.0

    # compose: outer bins expand to original inputs; reducers carry over.
    # Inner CSR (inputs grouped by super id) built with one argsort; each
    # outer bin concatenates its supers' input slices — per-bin work only,
    # and overlapping outer bins (the hybrid path) stay overlapping.
    order = np.argsort(bin_of, kind="stable")
    indptr = np.zeros(num_super + 1, dtype=np.int64)
    np.cumsum(np.bincount(bin_of, minlength=num_super), out=indptr[1:])
    bins = []
    for outer_bin in outer.bins:
        parts = [order[indptr[sid]:indptr[sid + 1]] for sid in outer_bin]
        bins.append(np.concatenate(parts) if parts
                    else np.zeros(0, dtype=np.int64))

    meta = dict(outer.meta)
    meta.update(
        hierarchy={
            "c": int(c), "b": b, "num_super": int(num_super),
            "inner_bins_lb": int(inner_lb),
            "gap_inner": float(gap_inner),
            "gap_outer": float(gap_outer),
            "gap_total": float(gap_outer * gap_inner),
        },
        outer_algorithm=outer.algorithm,
    )
    schema = MappingSchema(
        weights=w, q=q, bins=bins, reducers=outer.reducers,
        algorithm=f"hier-c{c}+{outer.algorithm}", meta=meta,
        lower_bound=a2a_comm_lower_bound(w, q))
    if use_cache:
        PLAN_CACHE.put(hkey, schema)
    return schema


# ---------------------------------------------------------------------------
# sampled conformance: random required pairs, no dense met matrix
# ---------------------------------------------------------------------------
def _bin_of_inputs(schema: MappingSchema) -> np.ndarray:
    counts = np.asarray([len(b) for b in schema.bins], dtype=np.int64)
    flat = (np.concatenate([np.asarray(b, dtype=np.int64)
                            for b in schema.bins])
            if len(schema.bins) else np.zeros(0, dtype=np.int64))
    out = np.full(schema.m, -1, dtype=np.int64)
    out[flat] = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    return out


def _bin_reducers_csr(schema: MappingSchema):
    """CSR bin -> sorted reducer ids over the schema's reducer lists."""
    nb = len(schema.bins)
    pairs_b = (np.concatenate([np.asarray(r, dtype=np.int64)
                               for r in schema.reducers])
               if schema.reducers else np.zeros(0, dtype=np.int64))
    pairs_r = np.repeat(
        np.arange(len(schema.reducers), dtype=np.int64),
        np.asarray([len(r) for r in schema.reducers], dtype=np.int64))
    order = np.lexsort((pairs_r, pairs_b))
    indptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(pairs_b, minlength=nb), out=indptr[1:])
    return indptr, pairs_r[order]


def sampled_pair_coverage(schema: MappingSchema, num_samples: int = 2048,
                          seed: int = 0) -> float:
    """Fraction of sampled required pairs (i != j) that meet at a reducer.

    O(num_samples) once the CSR bin -> reducers map is built (O(m + A) for
    A total reducer assignments) — usable at m = 10^6 where ``validate()``'s
    dense met matrix would need 10^12 cells.  Requires disjoint bins (every
    planner schema except the overlapping hybrid/big-input paths, which are
    small enough for ``validate()``).
    """
    if schema.meta.get("bins_overlap", False):
        raise ValueError("sampled coverage requires disjoint bins")
    m = schema.m
    if m < 2:
        return 1.0
    bin_of = _bin_of_inputs(schema)
    indptr, red = _bin_reducers_csr(schema)
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, m, size=num_samples)
    jj = rng.integers(0, m - 1, size=num_samples)
    jj = np.where(jj >= ii, jj + 1, jj)  # j != i, uniform over the rest
    hit = 0
    for i, j in zip(ii, jj):
        bi, bj = bin_of[i], bin_of[j]
        if bi < 0 or bj < 0:
            continue
        if bi == bj:
            hit += indptr[bi + 1] > indptr[bi]  # any reducer hosting the bin
            continue
        ri = red[indptr[bi]:indptr[bi + 1]]
        rj = red[indptr[bj]:indptr[bj + 1]]
        hit += np.intersect1d(ri, rj, assume_unique=False).size > 0
    return hit / num_samples
