"""Planner: different-sized inputs -> mapping schema (paper Sections 4-10).

``plan_a2a`` is the main entry point.  It reproduces the paper's case
analysis:

  * one input with  q/2 < w < q            -> big-input path (Section 9)
  * all inputs <= q/k for some k >= 2      -> bin packing to bins of q/k,
    then a unit-size scheduler on the bins (Sections 4-7)
  * mixed profile around q/3 .. q/2        -> hybrid Algorithm 5 (Section 8)

Going beyond the paper, ``method='auto'`` runs a *portfolio* over the
strategy registry (``repro_torch.core.strategies``): every applicable strategy —
all feasible k, every unit scheduler, the hybrid — is *estimated* with its
exact closed-form cost, and only the argmin winner is built.  The paper
picks one strategy per case a priori; taking the argmin is strictly better
(the paper's choice is always in the portfolio), and estimate-all/build-one
makes it O(packing) instead of O(sum of candidate schema sizes) — see
``benchmarks/bench_planner.py`` for the speedup curve and
``plan_a2a_materialized`` for the measure-everything baseline it replaced.

``plan_x2y`` implements Section 10 with a swept bin-size split.
``plan_some_pairs`` covers an explicit required-pair subset (Ullman &
Ullman, "Some Pairs Problems"), reusing the same registry for its dense
fallback and exploiting sparsity otherwise.

Every schema returned by this module carries the matching replication-rate
communication lower bound (``schema.lower_bound``, from ``repro_torch.core.bounds``)
so plans self-report their optimality gap.

Results are memoized in ``strategies.PLAN_CACHE`` keyed by the
(sorted-weights, q, method) profile; permutations of the same weight
multiset share one cache entry.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

import numpy as np

from .binpack import pack
from .bounds import (
    a2a_comm_lower_bound,
    some_pairs_comm_lower_bound,
    x2y_comm_lower_bound,
)
from .schema import InfeasibleError, MappingSchema
from .strategies import (
    A2AProfile,
    BinpackStrategy,
    HybridStrategy,
    PLAN_CACHE,
    PlanCache,
    a2a_portfolio,
    argmin_estimate,
    best_unit,
)

__all__ = [
    "plan_a2a",
    "plan_a2a_materialized",
    "plan_x2y",
    "plan_unit",
    "plan_some_pairs",
    "estimate_a2a",
    "estimate_x2y",
    "naive_pairs",
    "compute_buckets",
    "compute_rect_buckets",
    "bucket_summary",
    "PlanPartition",
    "partition_plan",
    "reducer_work",
]


# ---------------------------------------------------------------------------
# unit-size dispatcher (items are bins; capacity k items per reducer)
# ---------------------------------------------------------------------------
def plan_unit(n: int, k: int, method: str = "auto") -> tuple[list[list[int]], str]:
    """Best unit-size schema for n items, integer capacity k >= 2.

    Returns (reducers over range(n), algorithm-name).  Selection is the
    registry argmin over exact per-strategy costs — no candidate is built.
    """
    assert k >= 2
    if n <= 0:
        return [], "empty"
    if method == "au":          # historical alias
        method = "au_square"
    strat, _ = best_unit(np.ones(n), k, method)
    return strat.build(n, k), strat.name


# ---------------------------------------------------------------------------
# A2A for different-sized inputs
# ---------------------------------------------------------------------------
def _check_a2a_feasible(w: np.ndarray, q: float) -> np.ndarray:
    if np.any(w > q + 1e-12):
        raise InfeasibleError("an input exceeds the reducer capacity")
    big = np.flatnonzero(w > q / 2 + 1e-12)
    if len(big) >= 2:
        raise InfeasibleError(
            "two inputs larger than q/2 cannot share a reducer")
    return big


def plan_a2a(weights: Sequence[float], q: float, method: str = "auto",
             use_cache: bool = True) -> MappingSchema:
    """All-pairs mapping schema for different-sized inputs.

    Treat the returned schema as immutable: cache hits share their reducer
    lists with the ``PLAN_CACHE`` entry (copying them would defeat the O(m)
    hit path), so mutating ``schema.reducers``/``schema.bins`` in place
    would poison every future plan for the same weight profile.  Pass
    ``use_cache=False`` to get a schema with no shared state.
    """
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    if m == 0:
        return MappingSchema(w, q, [], [], algorithm="empty", lower_bound=0.0)
    _check_a2a_feasible(w, q)

    # canonicalize to descending weights: plans depend only on the weight
    # multiset, so permutations share one cache entry and one computation.
    order = np.argsort(-w, kind="stable")
    ws = w[order]
    key = PlanCache.key(ws, q, method)
    schema_s = PLAN_CACHE.get(key) if use_cache else None
    if schema_s is None:
        schema_s = _plan_a2a_sorted(ws, q, method, use_cache)
        if use_cache:
            PLAN_CACHE.put(key, schema_s)
    return _remap_schema(schema_s, order, w)


def _remap_schema(schema: MappingSchema, order: np.ndarray,
                  w: np.ndarray) -> MappingSchema:
    """Translate a canonical-order schema back to the caller's input ids.
    Reducer lists are shared with the cached schema — treat plans as
    immutable."""
    bins = [[int(order[i]) for i in b] for b in schema.bins]
    return MappingSchema(
        weights=w, q=schema.q, bins=bins, reducers=schema.reducers,
        algorithm=schema.algorithm, meta=dict(schema.meta),
        lower_bound=schema.lower_bound,
    )


def _plan_a2a_sorted(w: np.ndarray, q: float, method: str,
                     use_cache: bool) -> MappingSchema:
    """Plan for descending-sorted weights (canonical cache order)."""
    m = len(w)
    lb = a2a_comm_lower_bound(w, q)
    big = np.flatnonzero(w > q / 2 + 1e-12)
    if float(np.sum(w)) <= q + 1e-12:
        # everything fits in one reducer
        return MappingSchema(
            w, q, [[i] for i in range(m)], [list(range(m))],
            algorithm="single", lower_bound=lb)
    if len(big) == 1:
        out = _plan_big_input(w, q, int(big[0]), method, use_cache)
        out.lower_bound = lb
        return out

    prof = A2AProfile(w, q)
    if method == "auto":
        portfolio = a2a_portfolio(prof)
        assert portfolio, "portfolio produced no strategy"
        strat, est = argmin_estimate(portfolio)
        schema = strat.build(prof)
        schema.lower_bound = lb
        schema.meta["estimated_cost"] = est
        schema.meta["portfolio"] = {s.name: c for s, c in portfolio}
        return schema
    if method.startswith("binpack"):
        # e.g. 'binpack-k2', 'binpack-k3'
        k = int(method.split("k")[-1]) if "k" in method else 2
        strat = BinpackStrategy(k)
        if not strat.applicable(prof):
            raise InfeasibleError(f"inputs too large for bins of q/{k}")
        schema = strat.build(prof)
        schema.lower_bound = lb
        return schema
    if method == "hybrid":
        strat = HybridStrategy()
        if not strat.applicable(prof):
            raise InfeasibleError("hybrid (Alg 5) inapplicable")
        schema = strat.build(prof)
        schema.lower_bound = lb
        return schema
    raise ValueError(f"unknown method {method!r}")


def plan_a2a_materialized(weights: Sequence[float], q: float) -> MappingSchema:
    """The seed portfolio: materialize every applicable candidate schema and
    return the argmin by *measured* communication cost.

    Kept as the baseline for ``benchmarks/bench_planner.py`` and as the
    oracle the estimate-based ``plan_a2a(method='auto')`` is validated
    against: both must return schemas of identical cost.
    """
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    if m == 0:
        return MappingSchema(w, q, [], [], algorithm="empty", lower_bound=0.0)
    big = _check_a2a_feasible(w, q)
    lb = a2a_comm_lower_bound(w, q)
    if float(np.sum(w)) <= q + 1e-12:
        return MappingSchema(
            w, q, [[i] for i in range(m)], [list(range(m))],
            algorithm="single", lower_bound=lb)
    if len(big) == 1:
        out = _plan_big_input(w, q, int(big[0]), "auto", use_cache=False)
        out.lower_bound = lb
        return out
    prof = A2AProfile(w, q)
    cands = [strat.build(prof) for strat, _ in a2a_portfolio(prof)]
    assert cands, "portfolio produced no schema"
    out = min(cands, key=lambda s: s.communication_cost())
    out.lower_bound = lb
    return out


def estimate_a2a(weights: Sequence[float], q: float) -> tuple[str, float]:
    """(winning strategy label, exact cost) without building any schema.

    This is the planning fast path: it mirrors ``plan_a2a``'s dispatch
    (single reducer / big input / registry portfolio) but never materializes
    reducers, so it is safe to call on instances whose plan would have
    millions of them.
    """
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    if m == 0:
        return "empty", 0.0
    big = _check_a2a_feasible(w, q)
    s = float(np.sum(w))
    if s <= q + 1e-12:
        return "single", s
    if len(big) == 1:
        b = int(big[0])
        wb = float(w[b])
        rest_w = np.delete(w, b)
        if len(rest_w) and float(np.max(rest_w)) > q - wb + 1e-12:
            raise InfeasibleError(
                "an input cannot share a reducer with the big input")
        n_small = len(pack(rest_w, q - wb, "best"))
        s_rest = float(np.sum(rest_w))
        sub_name, sub_cost = estimate_a2a(rest_w, q)
        return (f"big-input+{sub_name}",
                wb * n_small + s_rest + sub_cost)
    prof = A2AProfile(w, q)
    portfolio = a2a_portfolio(prof)
    assert portfolio, "portfolio produced no strategy"
    strat, est = argmin_estimate(portfolio)
    return strat.name, est


def _plan_big_input(w: np.ndarray, q: float, big: int, method: str,
                    use_cache: bool = True) -> MappingSchema:
    """Section 9: one input of size in (q/2, q)."""
    wb = float(w[big])
    rest = [i for i in range(len(w)) if i != big]
    rest_w = w[rest]
    if len(rest) and float(np.max(rest_w)) > q - wb + 1e-12:
        raise InfeasibleError(
            "an input cannot share a reducer with the big input")
    # (a) pair the big input with everything: bins of size q - w_big
    small_bins = [[rest[i] for i in bn]
                  for bn in pack(rest_w, q - wb, "best")]
    bins: list[list[int]] = [[big]] + small_bins
    reducers: list[list[int]] = [[0, 1 + b] for b in range(len(small_bins))]
    schema_a = MappingSchema(
        weights=w, q=q, bins=bins, reducers=reducers,
        algorithm="big-input-pairing", meta={"bins_overlap": True})
    # (b) all pairs among the small inputs: recurse on the sub-universe
    sub = plan_a2a(rest_w, q, method="auto" if method == "auto" else method,
                   use_cache=use_cache)
    sub_bins = [[rest[i] for i in bn] for bn in sub.bins]
    schema_b = MappingSchema(
        weights=w, q=q, bins=sub_bins, reducers=sub.reducers,
        algorithm=f"rest:{sub.algorithm}", meta={"bins_overlap": True})
    out = MappingSchema.concat(schema_a, schema_b)
    out.algorithm = f"big-input+{sub.algorithm}"
    out.meta["bins_overlap"] = True
    return out


# ---------------------------------------------------------------------------
# some-pairs (Ullman & Ullman): cover an explicit subset of the pairs
# ---------------------------------------------------------------------------
def _normalize_pairs(m: int, pairs) -> np.ndarray:
    p = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
    if p.size == 0:
        return p
    if np.any(p < 0) or np.any(p >= m):
        raise ValueError("pair references an input id out of range")
    p = p[p[:, 0] != p[:, 1]]
    p = np.sort(p, axis=1)                       # unordered pairs
    return np.unique(p, axis=0)


def _sparse_layout(w: np.ndarray, q: float, p: np.ndarray):
    """Bins of q/2 over pair-incident inputs; a reducer per *needed* bin
    pair.  Returns (bins, cross, lone, cost): cross = distinct inter-bin
    pairs, lone = bins whose internal pairs are covered by no cross reducer.
    """
    incident = np.unique(p.ravel())
    sub_bins = pack(w[incident], q / 2.0, "best")
    bins = [[int(incident[i]) for i in bn] for bn in sub_bins]
    bin_of = np.full(len(w), -1, dtype=np.int64)
    for b, members in enumerate(bins):
        bin_of[members] = b
    pb = np.sort(np.stack([bin_of[p[:, 0]], bin_of[p[:, 1]]], axis=1), axis=1)
    nb = len(bins)
    bw = np.array([float(np.sum(w[np.asarray(b)])) for b in bins])
    codes = np.unique(pb[:, 0] * nb + pb[:, 1])
    b1, b2 = codes // nb, codes % nb
    inter = b1 != b2
    cross = np.stack([b1[inter], b2[inter]], axis=1)
    internal = b1[~inter]                        # bins with an internal pair
    covered = np.zeros(nb, dtype=bool)
    covered[cross.ravel()] = True
    lone = internal[~covered[internal]]
    cost = float(np.sum(bw[cross.ravel()])) + float(np.sum(bw[lone]))
    return bins, cross, lone, cost


def plan_some_pairs(weights: Sequence[float], q: float, pairs,
                    method: str = "auto") -> MappingSchema:
    """Mapping schema covering an explicit set of required pairs.

    The some-pairs problem (Ullman & Ullman) sits between A2A (all pairs
    required) and nothing: when the pair set is dense the A2A portfolio is
    the right tool, and when it is sparse a schema should only pay for the
    pairs that exist.  Three registered strategies, argmin by exact
    estimate, only the winner is built:

      'a2a'     — the full A2A registry portfolio (covers every pair);
      'sparse'  — bins of q/2 over pair-incident inputs, one reducer per
                  *needed* bin pair (inputs with no required pair are never
                  shipped: meta['partial_cover']=True);
      'pairs'   — one reducer per required pair (optimal for very sparse P).

    ``pairs`` is an iterable of (i, j) index pairs; order and duplicates are
    ignored.  The returned schema carries the replication-rate lower bound
    for the pair set (``some_pairs_comm_lower_bound``).
    """
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    p = _normalize_pairs(m, pairs)
    if m == 0 or len(p) == 0:
        return MappingSchema(w, q, [], [], algorithm="some-pairs-empty",
                             meta={"partial_cover": True}, lower_bound=0.0)
    pair_w = w[p[:, 0]] + w[p[:, 1]]
    if float(np.max(pair_w)) > q + 1e-12:
        i, j = p[int(np.argmax(pair_w))]
        raise InfeasibleError(f"required pair ({i},{j}) exceeds q")
    lb = some_pairs_comm_lower_bound(w, q, p)

    candidates: list[tuple[str, float]] = []
    sparse = None
    incident = np.unique(p.ravel())
    if method in ("auto", "sparse") and \
            float(np.max(w[incident])) <= q / 2.0 + 1e-12:
        sparse = _sparse_layout(w, q, p)
        candidates.append(("sparse", sparse[3]))
    if method in ("auto", "pairs"):
        candidates.append(("pairs", float(np.sum(pair_w))))
    if method in ("auto", "a2a"):
        try:
            _, a2a_cost = estimate_a2a(w, q)
            candidates.append(("a2a", a2a_cost))
        except InfeasibleError:
            pass
    if not candidates:
        raise InfeasibleError(f"no some-pairs strategy for method={method!r}")
    winner, est = min(candidates, key=lambda c: c[1])

    if winner == "a2a":
        schema = plan_a2a(w, q)
        schema.algorithm = f"some-pairs:a2a:{schema.algorithm}"
    elif winner == "sparse":
        bins, cross, lone, _ = sparse
        reducers = [[int(a), int(b)] for a, b in cross]
        reducers += [[int(b)] for b in lone]
        schema = MappingSchema(
            weights=w, q=q, bins=bins, reducers=reducers,
            algorithm="some-pairs:sparse-bins",
            meta={"partial_cover": True, "num_bins": len(bins)})
    else:  # 'pairs'
        incident_list = [int(i) for i in incident]
        bin_of = {i: b for b, i in enumerate(incident_list)}
        schema = MappingSchema(
            weights=w, q=q,
            bins=[[i] for i in incident_list],
            reducers=[[bin_of[int(i)], bin_of[int(j)]] for i, j in p],
            algorithm="some-pairs:pair-per-reducer",
            meta={"partial_cover": True})
    schema.lower_bound = lb
    schema.meta["required_pairs"] = int(len(p))
    schema.meta["estimated_cost"] = est
    schema.meta["portfolio"] = dict(candidates)
    return schema


# ---------------------------------------------------------------------------
# X2Y (Section 10)
# ---------------------------------------------------------------------------
def _x2y_grid(wx: np.ndarray, wy: np.ndarray, q: float,
              num_splits: int) -> list[float]:
    """Shared bin-size grid of the X2Y estimator and builder (identical by
    construction so ``estimate_x2y``'s winner is the schema ``plan_x2y``
    materializes)."""
    lo, hi = float(np.max(wx)), q - float(np.max(wy))
    return sorted({lo, hi, q / 2, *np.linspace(lo, hi, num_splits).tolist()})


def estimate_x2y(wx: Sequence[float], wy: Sequence[float], q: float,
                 num_splits: int = 8) -> tuple[float, float]:
    """Closed-form X2Y cost estimate: ``(best_b, best_cost)``.

    After packing X into ``nx`` bins of size ``b`` and Y into ``ny`` bins of
    ``q - b``, every X bin meets every Y bin, so the built schema ships
    exactly ``ny * sum(wx) + nx * sum(wy)`` — the estimate is *exact* (the
    same estimate-all/build-one contract as ``estimate_a2a``; enforced by
    ``tests/test_planner_registry.py``).  Packing is O(m log m) per grid
    point; the ``nx * ny`` reducer list is never materialized here.
    """
    wx = np.asarray(wx, dtype=np.float64)
    wy = np.asarray(wy, dtype=np.float64)
    if len(wx) == 0 or len(wy) == 0:
        return 0.0, 0.0
    max_x, max_y = float(np.max(wx)), float(np.max(wy))
    if max_x + max_y > q + 1e-12:
        raise InfeasibleError("largest X and Y inputs cannot co-reduce")
    sx, sy = float(wx.sum()), float(wy.sum())
    best_b, best_est = None, math.inf
    for b in _x2y_grid(wx, wy, q, num_splits):
        if b < max_x - 1e-12 or q - b < max_y - 1e-12:
            continue
        nx = len(pack(wx, b, "best"))
        ny = len(pack(wy, q - b, "best"))
        est = ny * sx + nx * sy
        if est < best_est:
            best_b, best_est = b, est
    assert best_b is not None
    return best_b, best_est


def plan_x2y(wx: Sequence[float], wy: Sequence[float], q: float,
             num_splits: int = 8) -> MappingSchema:
    """Bipartite schema: X ids are 0..m-1, Y ids are m..m+n-1.

    Paper: pack X into bins of size b, Y into bins of q - b, cross product.
    We sweep b over a small grid (the paper fixes b = max_x resp. q/2) and
    keep the cheapest — the paper's choices are grid points.  The sweep
    runs on ``estimate_x2y``'s closed-form costs; only the winning split is
    materialized, and ``meta['estimated_cost']`` records the estimate (==
    the built schema's measured cost).
    """
    wx = np.asarray(wx, dtype=np.float64)
    wy = np.asarray(wy, dtype=np.float64)
    m, n = len(wx), len(wy)
    if m == 0 or n == 0:
        return MappingSchema(np.concatenate([wx, wy]), q, [], [],
                             algorithm="empty", lower_bound=0.0)
    b, est = estimate_x2y(wx, wy, q, num_splits)
    w_all = np.concatenate([wx, wy])
    lb = x2y_comm_lower_bound(wx, wy, q)
    xbins = pack(wx, b, "best")
    ybins = [[m + i for i in bn] for bn in pack(wy, q - b, "best")]
    bins = [list(bn) for bn in xbins] + ybins
    nx = len(xbins)
    reducers = [[i, nx + j] for i in range(nx) for j in range(len(ybins))]
    return MappingSchema(
        weights=w_all, q=q, bins=bins, reducers=reducers,
        algorithm=f"x2y-binpack(b={b:.3g})",
        meta={"b": b, "x_bins": nx, "y_bins": len(ybins),
              "estimated_cost": est},
        lower_bound=lb)


# ---------------------------------------------------------------------------
# capacity buckets: group reducers by padded slot count (skew-aware shuffle)
# ---------------------------------------------------------------------------
def compute_buckets(slot_counts: Sequence[int], *, pad_slots_to: int = 1,
                    max_buckets: int = 8) -> list[tuple[int, np.ndarray]]:
    """Group reducers into a small number of capacity buckets.

    ``slot_counts[r]`` is the number of input slots at reducer ``r``.  A
    dense execution plan pads every reducer to ``max(slot_counts)`` — on a
    skewed schema (one heavy reducer, many light ones) that wastes
    memory and compute quadratically in the reducer function.  Instead,
    reducers are grouped by *bucket width*: the smallest
    ``pad_slots_to * 2^j`` (clamped to the dense width) that holds their
    slot count.  Each bucket is then executed as its own vmapped batch
    padded only to its own width.

    If more than ``max_buckets`` distinct widths appear, the narrowest
    buckets are merged upward (a reducer never lands in a bucket narrower
    than its slot count), keeping per-execution dispatch overhead bounded.

    Returns ``[(width, reducer_ids), ...]`` with widths ascending and
    ``reducer_ids`` the sorted original reducer indices of the bucket.
    Empty input -> empty list.
    """
    counts = np.asarray(list(slot_counts), dtype=np.int64)
    if counts.size == 0:
        return []
    assert pad_slots_to >= 1 and max_buckets >= 1
    dense_w = -(-max(int(counts.max()), 1) // pad_slots_to) * pad_slots_to
    # width(n) = pad_slots_to * 2^ceil(log2(n / pad_slots_to)), <= dense_w
    tiles = np.maximum(-(-counts // pad_slots_to), 1)
    widths = pad_slots_to * (
        2 ** np.ceil(np.log2(tiles)).astype(np.int64))
    widths = np.minimum(widths, dense_w)
    uniq = np.unique(widths)
    while len(uniq) > max_buckets:
        # merge the narrowest bucket into the next width up
        widths[widths == uniq[0]] = uniq[1]
        uniq = uniq[1:]
    return [(int(w), np.flatnonzero(widths == w)) for w in uniq]


def compute_rect_buckets(x_counts: Sequence[int], y_counts: Sequence[int],
                         *, pad_slots_to: int = 1,
                         max_buckets: int = 8
                         ) -> list[tuple[int, int, np.ndarray]]:
    """Rectangular capacity buckets: group reducers by (x-width, y-width).

    The rectangular analogue of :func:`compute_buckets` for X2Y plans:
    reducer ``r`` holds ``x_counts[r]`` X-side and ``y_counts[r]`` Y-side
    slots; each side is padded to the smallest ``pad_slots_to * 2^j``
    (clamped to its dense width) and reducers sharing a ``(wx, wy)`` pair
    execute as one vmapped batch.  When more than ``max_buckets`` distinct
    pairs appear, the two smallest-area pairs are merged into their
    component-wise max (a reducer never lands in a bucket narrower than its
    slot counts on either side).

    Returns ``[(wx, wy, reducer_ids), ...]`` ordered by ascending area with
    ``reducer_ids`` sorted original indices.  Empty input -> empty list.
    """
    xc = np.asarray(list(x_counts), dtype=np.int64)
    yc = np.asarray(list(y_counts), dtype=np.int64)
    assert xc.shape == yc.shape, (xc.shape, yc.shape)
    if xc.size == 0:
        return []
    assert pad_slots_to >= 1 and max_buckets >= 1

    def _side_widths(counts: np.ndarray) -> np.ndarray:
        dense = -(-max(int(counts.max()), 1) // pad_slots_to) * pad_slots_to
        tiles = np.maximum(-(-counts // pad_slots_to), 1)
        w = pad_slots_to * (2 ** np.ceil(np.log2(tiles)).astype(np.int64))
        return np.minimum(w, dense)

    wx = _side_widths(xc)
    wy = _side_widths(yc)
    pairs = {(int(a), int(b)) for a, b in zip(wx, wy)}
    while len(pairs) > max_buckets:
        by_area = sorted(pairs, key=lambda p: (p[0] * p[1], p))
        a, b = by_area[0], by_area[1]
        merged = (max(a[0], b[0]), max(a[1], b[1]))
        sel = ((wx == a[0]) & (wy == a[1])) | ((wx == b[0]) & (wy == b[1]))
        wx[sel], wy[sel] = merged
        pairs = (pairs - {a, b}) | {merged}
    out = [(px, py, np.flatnonzero((wx == px) & (wy == py)))
           for px, py in sorted(pairs, key=lambda p: (p[0] * p[1], p))]
    return out


def bucket_summary(schema: MappingSchema, *, pad_slots_to: int = 1,
                   max_buckets: int = 8) -> dict:
    """plan -> buckets telemetry: how much padding bucketing saves.

    Returns a dict with the dense padded-slot count (every reducer padded
    to the global max), the bucketed count (each reducer padded to its
    bucket width), the savings ratio, and a per-bucket breakdown — the
    numbers the serving dashboards and ``benchmarks/bench_engine.py``
    report.  Pure schema arithmetic; nothing is executed.
    """
    expanded = schema.expand()
    counts = [len(ids) for ids in expanded]
    buckets = compute_buckets(counts, pad_slots_to=pad_slots_to,
                              max_buckets=max_buckets)
    dense_w = -(-max(counts, default=1) // pad_slots_to) * pad_slots_to
    dense_slots = dense_w * len(expanded)
    rows = [{"width": w, "reducers": int(len(ids)),
             "padded_slots": int(w * len(ids)),
             "valid_slots": int(sum(counts[i] for i in ids))}
            for w, ids in buckets]
    bucketed_slots = sum(r["padded_slots"] for r in rows)
    return {
        "algorithm": schema.algorithm,
        "num_reducers": len(expanded),
        "dense_width": int(dense_w),
        "dense_padded_slots": int(dense_slots),
        "bucketed_padded_slots": int(bucketed_slots),
        "padding_savings": float(dense_slots / max(bucketed_slots, 1)),
        "buckets": rows,
    }


# ---------------------------------------------------------------------------
# shard partitioning: LPT balancing of reducers across a device mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanPartition:
    """LPT partition of a ReducerPlan's reducers over ``num_shards`` shards.

    shards        — per-shard *compact* sub-plans (same type as the input
                    plan; each holds only its own reducers' idx/mask rows
                    and re-grouped capacity buckets whose ``rows`` are
                    local to the sub-plan).
    shard_rows    — per-shard arrays of *global* plan-row ids (ascending);
                    the union over shards is exactly the real reducers,
                    each appearing once.
    widths        — (R0,) per-reducer execution width (bucket width, or the
                    dense L without buckets) — the padded gather cost.
    loads         — (S,) per-shard work in gather+FLOP units
                    (``sum(width + flop_weight * width^2)`` over the
                    shard's reducers).
    shipped_rows  — (S,) valid slots per shard: the shard's share of the
                    schema's shipped input copies (the paper's comm cost in
                    rows); sums to the plan's total valid slots.
    comm_cost     — (S,) the plan's weighted communication cost prorated by
                    shipped rows; sums to ``plan.comm_cost``.
    balance_factor — max(loads) / mean(loads) (1.0 = perfectly balanced;
                    inflated when num_shards > num_reducers since empty
                    shards drag the mean down).
    replication   — r: every reducer's sub-plan is *materialized* on r
                    shards (primary + r-1 LPT-chosen replicas).  The
                    primary assignment — and with it coverage, capacity,
                    ``shipped_rows`` and ``comm_cost`` — is byte-identical
                    to the r=1 partition; replication only adds holders.
    replica_rows  — per-shard sorted arrays of ALL global rows the shard
                    holds (primary ∪ replicas); every row appears on
                    exactly r shards, and shard s's array is a superset of
                    ``shard_rows[s]``.
    replica_loads — (S,) per-shard work including replicas (what the
                    coded executor's redundant compute actually costs).
    replica_slots — (S,) valid slots held per shard including replicas;
                    sums to exactly ``replication * sum(shipped_rows)``
                    (the replication ledger).
    """

    num_shards: int
    shards: tuple
    shard_rows: tuple
    widths: np.ndarray
    loads: np.ndarray
    shipped_rows: np.ndarray
    comm_cost: np.ndarray
    balance_factor: float
    flop_weight: float
    ywidths: Optional[np.ndarray] = None   # (R0,) Y-side widths (rect plans)
    replication: int = 1
    replica_rows: Optional[tuple] = None
    replica_loads: Optional[np.ndarray] = None
    replica_slots: Optional[np.ndarray] = None

    def report(self) -> dict:
        """Telemetry dict (benchmarks, dryrun, serving dashboards)."""
        rrows = (self.replica_rows if self.replica_rows is not None
                 else self.shard_rows)
        rloads = (self.replica_loads if self.replica_loads is not None
                  else self.loads)
        rslots = (self.replica_slots if self.replica_slots is not None
                  else self.shipped_rows)
        rmean = float(rloads.sum()) / max(self.num_shards, 1)
        return {
            "num_shards": self.num_shards,
            "reducers_per_shard": [int(len(r)) for r in self.shard_rows],
            "loads": [float(x) for x in self.loads],
            "shipped_rows": [int(x) for x in self.shipped_rows],
            "comm_cost": [float(x) for x in self.comm_cost],
            "balance_factor": float(self.balance_factor),
            "max_load": float(self.loads.max(initial=0.0)),
            "padded_elements_per_shard": [
                int(np.sum(self.widths[rows])) for rows in self.shard_rows],
            "replication": int(self.replication),
            "replica_reducers_per_shard": [int(len(r)) for r in rrows],
            "replica_slots": [int(x) for x in rslots],
            "replica_balance_factor": (
                float(rloads.max(initial=0.0)) / rmean if rmean > 0
                else 1.0),
        }


def reducer_work(plan, flop_weight: float = 1.0) -> np.ndarray:
    """(R0,) per-reducer work estimate: gather slots + Gram FLOPs, both at
    the reducer's *execution* width (its capacity-bucket width — what the
    bucketed/fused pipelines actually pad to), so the balance the LPT
    achieves is the balance the hardware sees.  Rectangular (X2Y) plans
    count both sides' gather slots and the cross block's ``wx * wy``
    FLOPs."""
    widths = _execution_widths(plan)
    w = widths.astype(np.float64)
    yw = _execution_ywidths(plan)
    if yw is not None:
        y = yw.astype(np.float64)
        return w + y + flop_weight * w * y
    return w + flop_weight * w * w


def _execution_widths(plan) -> np.ndarray:
    """Per-real-reducer execution width: bucket width where the plan has
    capacity buckets, the dense L otherwise.  (The X side of a rectangular
    plan.)"""
    R0 = int(plan.num_reducers)
    widths = np.full(R0, int(plan.L) if R0 else 0, dtype=np.int64)
    for b in getattr(plan, "buckets", ()) or ():
        rows = np.asarray(b.rows)
        real = rows[(rows >= 0) & (rows < R0)].astype(np.int64)
        widths[real] = int(b.width)
    return widths


def _execution_ywidths(plan) -> Optional[np.ndarray]:
    """Per-real-reducer Y-side execution width of a rectangular plan
    (bucket ``ywidth``, dense ``Ly`` fallback) — ``None`` for square
    plans."""
    if getattr(plan, "yidx", None) is None:
        return None
    R0 = int(plan.num_reducers)
    widths = np.full(R0, int(plan.yidx.shape[1]) if R0 else 0,
                     dtype=np.int64)
    for b in getattr(plan, "buckets", ()) or ():
        if getattr(b, "yidx", None) is None:
            continue
        rows = np.asarray(b.rows)
        real = rows[(rows >= 0) & (rows < R0)].astype(np.int64)
        widths[real] = int(b.ywidth)
    return widths


def partition_plan(plan, num_shards: int, *,
                   flop_weight: float = 1.0,
                   replication: int = 1) -> PlanPartition:
    """LPT/greedy balance of a ReducerPlan's reducers into per-shard
    compact sub-plans.

    Longest-processing-time-first: reducers sorted by descending work
    (``reducer_work``: per-reducer gather + FLOP cost at its bucket width)
    are assigned to the least-loaded shard.  Greedy guarantees
    ``max_load <= mean + (1 - 1/S) * max_work``, so the balance factor is
    bounded by ``1 + S * max_work / total_work`` — tight (→ 1.0) whenever
    reducers are plentiful relative to shards, which is exactly the regime
    the mesh runs in.

    Every *real* reducer (row < ``plan.num_reducers``) lands in exactly one
    shard with its idx/mask rows copied verbatim — coverage and reducer
    capacity are preserved by construction, and the per-shard
    ``shipped_rows``/``comm_cost`` shares sum to the plan's totals (the
    schema's communication cost is a cluster quantity; sharding only
    re-buckets it).  Works on any plan-shaped object exposing ``idx`` /
    ``mask`` / ``num_reducers`` / ``buckets``; sub-plans are built with
    ``type(plan)`` so this module stays free of engine imports.

    ``replication=r > 1`` additionally materializes every reducer on r-1
    *replica* shards (coded execution, after Afrati et al.'s
    replication-rate framing, arXiv:1206.4377): round by round, each
    reducer — heaviest first — is placed on the least replica-loaded
    shard not already holding it, so holder sets are nested across r
    (the r-replica holders contain the (r-1)-replica holders).  The
    primary assignment and every coverage/capacity/comm ledger above are
    *unchanged*; replication is accounted separately in ``replica_rows``
    / ``replica_loads`` / ``replica_slots`` and in ``report()``.
    """
    assert num_shards >= 1, num_shards
    replication = int(replication)
    assert 1 <= replication <= num_shards, (replication, num_shards)
    R0 = int(plan.num_reducers)
    widths = _execution_widths(plan)
    ywidths = _execution_ywidths(plan)
    work = reducer_work(plan, flop_weight)
    mask = np.asarray(plan.mask)
    slots = (mask[:R0].sum(axis=1).astype(np.int64) if R0
             else np.zeros(0, np.int64))
    if getattr(plan, "ymask", None) is not None and R0:
        slots = slots + np.asarray(plan.ymask)[:R0].sum(axis=1).astype(
            np.int64)
    total_slots = int(slots.sum())

    # LPT: stable sort by descending work, min-heap of (load, shard)
    order = np.argsort(-work, kind="stable")
    loads = np.zeros(num_shards, dtype=np.float64)
    assign: list[list[int]] = [[] for _ in range(num_shards)]
    heap = [(0.0, s) for s in range(num_shards)]
    heapq.heapify(heap)
    for r in order:
        load, s = heapq.heappop(heap)
        assign[s].append(int(r))
        load += float(work[r])
        loads[s] = load
        heapq.heappush(heap, (load, s))

    shard_rows = tuple(np.asarray(sorted(a), dtype=np.int64) for a in assign)
    shipped = np.array([int(slots[rows].sum()) for rows in shard_rows],
                       dtype=np.int64)
    comm = (shipped / max(total_slots, 1)) * float(plan.comm_cost)
    shards = tuple(_sub_plan(plan, rows, widths) for rows in shard_rows)
    total = float(work.sum())
    bf = (float(loads.max()) / (total / num_shards)) if total > 0 else 1.0

    # replica placement: nested LPT rounds over the replica-load tally
    held = np.zeros((num_shards, R0), dtype=bool)
    for s, rows in enumerate(shard_rows):
        held[s, rows] = True
    rloads = loads.copy()
    for _ in range(replication - 1):
        for r in order:
            cand = np.flatnonzero(~held[:, r])
            s = int(cand[np.argmin(rloads[cand])])
            held[s, r] = True
            rloads[s] += float(work[r])
    replica_rows = tuple(np.flatnonzero(held[s]).astype(np.int64)
                         for s in range(num_shards))
    replica_slots = np.array([int(slots[rows].sum())
                              for rows in replica_rows], dtype=np.int64)
    return PlanPartition(
        num_shards=num_shards, shards=shards, shard_rows=shard_rows,
        widths=widths, loads=loads, shipped_rows=shipped, comm_cost=comm,
        balance_factor=bf, flop_weight=flop_weight, ywidths=ywidths,
        replication=replication, replica_rows=replica_rows,
        replica_loads=rloads, replica_slots=replica_slots)


def _sub_plan(plan, rows: np.ndarray, widths: np.ndarray):
    """Compact sub-plan holding only ``rows`` (global plan-row ids).

    idx/mask rows are copied verbatim; capacity buckets are re-grouped from
    the parent's buckets with ``rows`` re-indexed to sub-plan-local ids, so
    the sub-plan is a self-consistent plan of the same type.  Rectangular
    plans carry their Y-side rows (``yidx`` / ``ymask`` / bucket
    ``ywidth``) through the same row selection."""
    idx = np.asarray(plan.idx)
    mask = np.asarray(plan.mask)
    rect = getattr(plan, "yidx", None) is not None
    n = len(rows)
    sub_idx = idx[rows] if n else np.zeros((0, idx.shape[1]), idx.dtype)
    sub_mask = mask[rows] if n else np.zeros((0, mask.shape[1]), mask.dtype)
    local = {int(g): i for i, g in enumerate(rows)}
    buckets = []
    for b in getattr(plan, "buckets", ()) or ():
        b_rows = np.asarray(b.rows)
        pos = np.flatnonzero(np.isin(b_rows, rows))      # bucket-local slots
        if not len(pos):
            continue
        sel = b_rows[pos].astype(np.int64)               # global row ids
        extra = {}
        if getattr(b, "yidx", None) is not None:
            extra = dict(ywidth=int(b.ywidth),
                         yidx=np.asarray(b.yidx)[pos],
                         ymask=np.asarray(b.ymask)[pos])
        buckets.append(type(b)(
            width=int(b.width),
            rows=np.asarray([local[int(g)] for g in sel], dtype=np.int64),
            idx=np.asarray(b.idx)[pos],
            mask=np.asarray(b.mask)[pos],
            **extra,
        ))
    max_inputs = int(sub_mask.sum(axis=1).max(initial=0))
    shipped = int(sub_mask.sum())
    total_slots = int(mask[:plan.num_reducers].sum())
    extra = {}
    if rect:
        ymask = np.asarray(plan.ymask)
        yidx = np.asarray(plan.yidx)
        sub_yidx = yidx[rows] if n else np.zeros((0, yidx.shape[1]),
                                                 yidx.dtype)
        sub_ymask = ymask[rows] if n else np.zeros((0, ymask.shape[1]),
                                                   ymask.dtype)
        shipped += int(sub_ymask.sum())
        total_slots += int(ymask[:plan.num_reducers].sum())
        extra = dict(yidx=sub_yidx, ymask=sub_ymask,
                     max_y_inputs=int(sub_ymask.sum(axis=1).max(initial=0)),
                     num_x=getattr(plan, "num_x", 0),
                     num_y=getattr(plan, "num_y", 0))
    share = shipped / max(total_slots, 1)
    return type(plan)(
        idx=sub_idx, mask=sub_mask, num_reducers=n,
        comm_cost=float(plan.comm_cost) * share,
        max_inputs=max_inputs, algorithm=plan.algorithm,
        lower_bound=None, buckets=tuple(buckets), **extra)


# ---------------------------------------------------------------------------
# naive baseline: one reducer per pair (worst-case comm, used in benchmarks)
# ---------------------------------------------------------------------------
def naive_pairs(weights: Sequence[float], q: float) -> MappingSchema:
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    reducers = []
    for i in range(m):
        for j in range(i + 1, m):
            if w[i] + w[j] > q + 1e-12:
                raise InfeasibleError(f"pair ({i},{j}) exceeds q")
            reducers.append([i, j])
    return MappingSchema(w, q, [[i] for i in range(m)], reducers,
                         algorithm="naive-pairs",
                         lower_bound=a2a_comm_lower_bound(w, q))
