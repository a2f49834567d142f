"""Strategy registry: estimate-all, build-one planning (DESIGN.md section 3).

The paper (Sections 4-10) picks one construction per case a priori.  The seed
planner generalized that to a portfolio — materialize *every* applicable
candidate schema and keep the argmin by measured communication cost — which
is strictly better but O(sum of schema sizes) per plan: at m = 10^4 inputs a
single k=2 candidate already has millions of reducers, so the portfolio
spends minutes building schemas it will throw away.

This module replaces materialization with *registered strategies*.  Each
strategy knows three things:

  applicable(...)  — can this construction serve the instance at all?
  estimate(...)    — the **exact** communication cost its ``build`` would
                     incur, in closed form over the bin-weight vector
                     (vectorized NumPy; no reducers are created);
  build(...)       — materialize the schema (invoked only for the winner).

The estimates are exact, not heuristic: every unit construction in the paper
replicates each item a number of times that depends only on (n, k) and the
item's position in the layout, so cost = sum_i w_i * rep_i collapses to a few
NumPy reductions (e.g. Algorithm 2 replicates every item exactly u_p - 1
times, the AU square exactly k + 1 times, Algorithm 4 exactly
(k+1)^(l-1) times).  ``method='auto'`` therefore returns the *same* schema
the materialize-everything portfolio would have chosen (or a cheaper one:
unit-strategy selection is weighted here, while the seed selected by
unweighted copy counts), at the cost of building exactly one schema.

Registries are extension points: ``register_unit_strategy`` /
``register_a2a_strategy`` add new constructions that ``plan_a2a``,
``plan_unit`` and ``plan_some_pairs`` pick up automatically.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.obs import EVENTS as _OBS_EVENTS
from repro_torch.obs import REGISTRY as _OBS_REGISTRY

from . import unit_schemas as us
from .binpack import pack
from .primes import is_prime, prev_prime
from .schema import MappingSchema

__all__ = [
    "UnitStrategy",
    "A2AStrategy",
    "UNIT_REGISTRY",
    "A2A_REGISTRY",
    "register_unit_strategy",
    "register_a2a_strategy",
    "best_unit",
    "unit_estimates",
    "A2AProfile",
    "PlanCache",
    "PLAN_CACHE",
]


# ===========================================================================
# plan cache
# ===========================================================================
class PlanCache:
    """LRU cache keyed by the (sorted-weights, q, method) profile.

    Plans depend only on the weight *multiset*: the planner computes the
    schema in canonical (descending-weight) order and the cache stores that
    canonical schema, so permutations of the same weights hit the same entry
    and are remapped to the caller's input order in O(m).
    """

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    @staticmethod
    def key(sorted_w: np.ndarray, q: float, method: str) -> tuple:
        return (sorted_w.tobytes(), float(q), method)

    def get(self, key: tuple):
        if key in self._store:
            self.hits += 1
            _OBS_REGISTRY.counter("cache.hits", cache="plan").inc()
            self._store.move_to_end(key)
            return self._store[key]
        self.misses += 1
        _OBS_REGISTRY.counter("cache.misses", cache="plan").inc()
        return None

    def put(self, key: tuple, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
            self.evictions += 1
            _OBS_REGISTRY.counter("cache.evictions", cache="plan").inc()
            _OBS_EVENTS.emit("cache_eviction", cache="plan")

    def invalidate(self, key: tuple) -> bool:
        """Drop one entry (the streaming gap-drift re-plan path: a serving
        stream that re-plans has permanently moved off its previous weight
        profile, so that profile's entry is dead weight in the LRU and would
        otherwise push live request-serving profiles out).  Returns whether
        the key was present.  Not counted as an eviction — ``evictions``
        tracks capacity pressure only."""
        if self._store.pop(key, None) is None:
            return False
        self.invalidations += 1
        _OBS_REGISTRY.counter("cache.invalidations", cache="plan").inc()
        return True

    def stats(self) -> dict:
        """Counter snapshot: hits / misses / capacity evictions / explicit
        invalidations, plus current size and cap."""
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "size": len(self._store), "maxsize": self.maxsize}

    def clear(self) -> None:
        self._store.clear()
        self.hits = self.misses = 0
        self.evictions = self.invalidations = 0

    def __len__(self) -> int:
        return len(self._store)


PLAN_CACHE = PlanCache()


# ===========================================================================
# unit-size strategies (items are bins; integer capacity k items per reducer)
# ===========================================================================
@dataclass(frozen=True)
class UnitStrategy:
    """A unit-size construction: n abstract items, capacity k per reducer.

    ``estimate(bw, k)`` must equal the weighted communication cost of the
    schema ``build(len(bw), k)`` produces, for every applicable (n, k) —
    this invariant is what lets the planner skip materialization, and it is
    enforced by tests/test_planner_registry.py.
    """

    name: str
    applicable: Callable[[int, int], bool]          # (n, k) -> bool
    estimate: Callable[[np.ndarray, int], float]    # (bin_weights, k) -> cost
    build: Callable[[int, int], list[list[int]]]    # (n, k) -> reducers


def _filter(reducers: list[list[int]], n: int) -> list[list[int]]:
    out = [[i for i in red if i < n] for red in reducers]
    return [r for r in out if len(r) >= 1]


# ------------------------------------------------------------- closed forms
def _even_layout(n: int, k: int) -> int:
    """Padded group count u_p of Algorithm 2; every item replicates u_p - 1
    times (each group meets every other group exactly once, empty padding
    groups included — a group paired with an empty one still ships)."""
    g = k // 2
    u = math.ceil(n / g)
    return u + (u % 2)


def _even_cost(bw: np.ndarray, k: int) -> float:
    n = len(bw)
    if n == 0:
        return 0.0
    if n <= k:
        return float(bw.sum())
    return float(bw.sum()) * (_even_layout(n, k) - 1)


def _odd_layout(n: int, k: int) -> tuple[int, int]:
    """(u_p, n_a) of Algorithm 1: set A = first n_a items in groups of
    (k-1)/2, set B = the rest, one B item broadcast per team."""
    g = (k - 1) // 2
    u = max(2, math.ceil((n + 1) / (g + 1)))
    while u * g + (u + (u % 2)) - 1 < n:
        u += 1
    u_p = u + (u % 2)
    return u_p, min(n, u * g)


def _odd_cost(bw: np.ndarray, k: int) -> float:
    n = len(bw)
    if n == 0:
        return 0.0
    if n <= k:
        return float(bw.sum())
    u_p, n_a = _odd_layout(n, k)
    # A items: once per team = u_p - 1; B item t: every pair of team t =
    # u_p / 2; plus the recursion that covers B x B.
    cost = float(bw[:n_a].sum()) * (u_p - 1)
    b = bw[n_a:]
    cost += float(b.sum()) * (u_p // 2)
    return cost + _odd_cost(b, k)


def _au_square_cost(bw: np.ndarray, k: int) -> float:
    # one appearance per team, k + 1 teams
    return float(bw.sum()) * (k + 1)


def _au_projective_cost(bw: np.ndarray, k: int) -> float:
    # p = k - 1: base items once per team (p + 1 = k); extension item t is in
    # the p reducers of team t plus the all-new reducer, also k total.
    return float(bw.sum()) * k


def _alg3_prime(n: int, k: int) -> Optional[int]:
    """The prime p <= k that us.alg3 selects for (n, k), or None."""
    cand = k
    while cand >= 2:
        cand = prev_prime(cand)
        l = k - cand
        if n <= cand * cand + l * (cand + 1):
            return cand
        cand -= 1
    return None


def _alg3_cost(bw: np.ndarray, k: int) -> float:
    n = len(bw)
    if n == 0:
        return 0.0
    p = _alg3_prime(n, k)
    assert p is not None, "estimate called on inapplicable alg3"
    n_a = min(n, p * p)
    cost = float(bw[:n_a].sum()) * (p + 1)      # AU square appearances
    b = bw[n_a:]
    cost += float(b.sum()) * p                  # broadcast to one team (p red)
    if len(b) > 1:                              # B x B recursion
        cost += _odd_cost(b, k) if k % 2 else _even_cost(b, k)
    return cost


def _alg4_level(n: int, k: int) -> int:
    return round(math.log(n, k)) if n > 1 else 0


def _alg4_cost(bw: np.ndarray, k: int) -> float:
    # every item replicates exactly (k+1)^(l-1) times in the assignment tree
    l = _alg4_level(len(bw), k)
    return float(bw.sum()) * (k + 1) ** (l - 1)


def _alg4_applicable(n: int, k: int) -> bool:
    if not is_prime(k):
        return False
    l = _alg4_level(n, k)
    return l >= 2 and k ** l == n and (k * (k + 1)) ** (l - 1) <= 200_000


def _single_build(n: int, k: int) -> list[list[int]]:
    return [list(range(n))]


UNIT_REGISTRY: list[UnitStrategy] = []


def register_unit_strategy(strategy: UnitStrategy) -> UnitStrategy:
    UNIT_REGISTRY.append(strategy)
    PLAN_CACHE.clear()      # cached plans predate the new strategy
    return strategy


# Registration order is the tie-break order (argmin is stable), mirroring the
# candidate order of the seed planner.
register_unit_strategy(UnitStrategy(
    "single",
    applicable=lambda n, k: n <= k,
    estimate=lambda bw, k: float(bw.sum()),
    build=_single_build,
))
register_unit_strategy(UnitStrategy(
    "alg_even",
    applicable=lambda n, k: k % 2 == 0,
    estimate=_even_cost,
    build=lambda n, k: us.alg_even(n, k),
))
register_unit_strategy(UnitStrategy(
    "alg_odd",
    applicable=lambda n, k: k % 2 == 1 and k >= 3,
    estimate=_odd_cost,
    build=lambda n, k: us.alg_odd(n, k),
))
register_unit_strategy(UnitStrategy(
    "au_square",
    applicable=lambda n, k: is_prime(k) and n <= k * k,
    estimate=_au_square_cost,
    build=lambda n, k: _filter(us.au_square(k, with_teams=True)[0], n),
))
register_unit_strategy(UnitStrategy(
    "au_projective",
    applicable=lambda n, k: is_prime(k - 1) and n <= (k - 1) ** 2 + k,
    estimate=_au_projective_cost,
    build=lambda n, k: _filter(us.au_projective(k - 1), n),
))
register_unit_strategy(UnitStrategy(
    "alg3",
    applicable=lambda n, k: _alg3_prime(n, k) is not None,
    estimate=_alg3_cost,
    build=lambda n, k: us.alg3(n, k),
))
register_unit_strategy(UnitStrategy(
    "alg4",
    applicable=_alg4_applicable,
    estimate=_alg4_cost,
    build=lambda n, k: us.alg4(n, k),
))


def unit_estimates(bw: np.ndarray, k: int,
                   method: str = "auto") -> list[tuple[UnitStrategy, float]]:
    """(strategy, exact cost) for every applicable unit strategy.

    The 'single' strategy short-circuits: when everything fits in one
    reducer nothing can beat shipping each item once.
    """
    bw = np.asarray(bw, dtype=np.float64)
    n = len(bw)
    assert k >= 2
    if n <= k:
        single = UNIT_REGISTRY[0]
        return [(single, single.estimate(bw, k))]
    out = []
    for strat in UNIT_REGISTRY:
        if strat.name == "single":
            continue
        if method not in ("auto", strat.name):
            continue
        if strat.applicable(n, k):
            out.append((strat, strat.estimate(bw, k)))
    if not out:
        # always-applicable parity fallback (mirrors the seed planner)
        name = "alg_even" if k % 2 == 0 else "alg_odd"
        strat = next(s for s in UNIT_REGISTRY if s.name == name)
        out.append((strat, strat.estimate(bw, k)))
    return out


def argmin_estimate(cands):
    """First candidate within float tolerance of the minimum estimate.

    Closed-form estimates of equal-cost schemas can differ in the last few
    ulps (different summation orders), so a plain ``min`` would break ties
    by noise; registration/k order is the intended tie-break.
    """
    best = min(c[1] for c in cands)
    tol = 1e-9 * max(1.0, abs(best))
    return next(c for c in cands if c[1] <= best + tol)


def best_unit(bw: np.ndarray, k: int,
              method: str = "auto") -> tuple[UnitStrategy, float]:
    """Argmin by estimated (= exact) weighted cost; stable on ties."""
    return argmin_estimate(unit_estimates(bw, k, method))


# ===========================================================================
# A2A strategies over different-sized inputs
# ===========================================================================
class A2AProfile:
    """Instance profile: weights + capacity, with memoized per-bin-size
    packings so estimate and build share one pack per candidate."""

    def __init__(self, weights: np.ndarray, q: float):
        self.w = np.asarray(weights, dtype=np.float64)
        self.q = float(q)
        self.m = len(self.w)
        self.s = float(np.sum(self.w))
        self.wmax = float(np.max(self.w)) if self.m else 0.0
        self._packs: dict[int, tuple[list[list[int]], np.ndarray]] = {}
        self._hybrid: Optional[tuple] = None

    @property
    def kmax(self) -> int:
        return max(2, min(int(self.q / max(self.wmax, 1e-12)), 64))

    def pack_k(self, k: int) -> tuple[list[list[int]], np.ndarray]:
        """FFD/BFD-best bins of size q/k and their weight vector."""
        if k not in self._packs:
            bins = pack(self.w, self.q / k, method="best")
            bw = np.array([float(np.sum(self.w[np.asarray(b)]))
                           for b in bins])
            self._packs[k] = (bins, bw)
        return self._packs[k]

    def hybrid_packs(self):
        """(big_bins, big_bw, med_bins, med_bw, small_bins, small_bw) of
        Algorithm 5: (q/3, q/2] inputs into q/2 bins; <= q/3 inputs into
        both q/2 and q/3 bins."""
        if self._hybrid is None:
            w, q = self.w, self.q
            a_ids = np.flatnonzero((w > q / 3 + 1e-12) & (w <= q / 2 + 1e-12))
            b_ids = np.flatnonzero(w <= q / 3 + 1e-12)

            def sub(ids, size):
                bins = [[int(ids[i]) for i in bn]
                        for bn in pack(w[ids], size, "best")]
                bw = np.array([float(np.sum(w[np.asarray(b)])) for b in bins])
                return bins, bw

            big = sub(a_ids, q / 2) if len(a_ids) else ([], np.empty(0))
            med = sub(b_ids, q / 2) if len(b_ids) else ([], np.empty(0))
            sml = sub(b_ids, q / 3) if len(b_ids) else ([], np.empty(0))
            self._hybrid = (a_ids, b_ids, *big, *med, *sml)
        return self._hybrid


class A2AStrategy:
    """Base: an entry in the A2A portfolio."""

    name: str = "abstract"

    def applicable(self, prof: A2AProfile) -> bool:  # pragma: no cover
        raise NotImplementedError

    def estimate(self, prof: A2AProfile) -> float:   # pragma: no cover
        raise NotImplementedError

    def build(self, prof: A2AProfile) -> MappingSchema:  # pragma: no cover
        raise NotImplementedError


class BinpackStrategy(A2AStrategy):
    """Sections 4.1 / 6 / 7: bins of size q/k, then the best unit scheduler
    (weighted argmin over the unit registry)."""

    def __init__(self, k: int, unit_method: str = "auto"):
        self.k = k
        self.unit_method = unit_method
        self.name = f"binpack-k{k}"

    def applicable(self, prof: A2AProfile) -> bool:
        return prof.wmax <= prof.q / self.k + 1e-12

    def estimate(self, prof: A2AProfile) -> float:
        _, bw = prof.pack_k(self.k)
        _, cost = best_unit(bw, self.k, self.unit_method)
        return cost

    def build(self, prof: A2AProfile) -> MappingSchema:
        bins, bw = prof.pack_k(self.k)
        strat, cost = best_unit(bw, self.k, self.unit_method)
        reducers = strat.build(len(bins), self.k)
        return MappingSchema(
            weights=prof.w, q=prof.q, bins=bins, reducers=reducers,
            algorithm=f"binpack-k{self.k}+{strat.name}",
            meta={"k": self.k, "bin_size": prof.q / self.k,
                  "num_bins": len(bins), "estimated_cost": cost},
        )


class HybridStrategy(A2AStrategy):
    """Algorithm 5 (Section 8): mixed big (q/3, q/2] and small (<= q/3)
    inputs; small inputs are packed twice (overlapping bins)."""

    name = "hybrid-alg5"

    def applicable(self, prof: A2AProfile) -> bool:
        w, q = prof.w, prof.q
        if prof.wmax > q / 2 + 1e-12:
            return False
        n_big = int(np.sum(w > q / 3 + 1e-12))
        return 0 < n_big < prof.m

    def estimate(self, prof: A2AProfile) -> float:
        (_, _, big_bins, big_bw, med_bins, med_bw,
         small_bins, small_bw) = prof.hybrid_packs()
        nb, nm = len(big_bins), len(med_bins)
        # step 2: big-bin pairs (lone big bin gets a solo reducer);
        # step 3: big x medium; step 4: unit scheduler on small bins.
        cost = float(big_bw.sum()) * (nb - 1 + nm)
        if nb == 1:
            cost += float(big_bw[0])
        cost += float(med_bw.sum()) * nb
        _, small_cost = best_unit(small_bw, 3)
        return cost + small_cost

    def build(self, prof: A2AProfile) -> MappingSchema:
        (_, _, big_bins, big_bw, med_bins, med_bw,
         small_bins, small_bw) = prof.hybrid_packs()
        bins = big_bins + med_bins + small_bins
        nb, nm = len(big_bins), len(med_bins)
        reducers: list[list[int]] = []
        for i in range(nb):
            for j in range(i + 1, nb):
                reducers.append([i, j])
        if nb == 1:
            reducers.append([0])
        for i in range(nb):
            for j in range(nm):
                reducers.append([i, nb + j])
        strat, _ = best_unit(small_bw, 3)
        off = nb + nm
        for red in strat.build(len(small_bins), 3):
            reducers.append([off + i for i in red])
        return MappingSchema(
            weights=prof.w, q=prof.q, bins=bins, reducers=reducers,
            algorithm="hybrid-alg5",
            meta={"bins_overlap": True, "big_bins": nb, "med_bins": nm,
                  "small_bins": len(small_bins)},
        )


A2A_REGISTRY: list[Callable[[A2AProfile], list[A2AStrategy]]] = []


def register_a2a_strategy(
        factory: Callable[[A2AProfile], list[A2AStrategy]]):
    """Register a factory: profile -> strategy instances to consider."""
    A2A_REGISTRY.append(factory)
    PLAN_CACHE.clear()      # cached plans predate the new strategy
    return factory


register_a2a_strategy(
    lambda prof: [BinpackStrategy(k) for k in range(2, prof.kmax + 1)])
register_a2a_strategy(lambda prof: [HybridStrategy()])


def a2a_portfolio(prof: A2AProfile) -> list[tuple[A2AStrategy, float]]:
    """(strategy, exact estimated cost) for every applicable strategy."""
    out = []
    for factory in A2A_REGISTRY:
        for strat in factory(prof):
            if strat.applicable(prof):
                out.append((strat, strat.estimate(prof)))
    return out
