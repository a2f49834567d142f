"""Exact optimal mapping schemas for tiny instances (exhaustive search).

Used by tests/benchmarks to measure the planner's true approximation factor
on instances where the optimum is computable (m <= ~7).  Searches over the
number of reducers z = 1, 2, ...; for each z, assigns inputs to subsets via
depth-first search with capacity pruning, minimizing communication cost.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from .schema import MappingSchema

__all__ = ["optimal_a2a_bruteforce"]


def optimal_a2a_bruteforce(weights, q: float,
                           max_reducers: int = 8) -> Optional[MappingSchema]:
    """Minimum-communication A2A schema by exhaustive subset search.

    Enumerates candidate reducers (subsets fitting in q), then searches for
    the cheapest cover of all pairs.  Exponential — tiny m only.
    """
    w = np.asarray(weights, dtype=np.float64)
    m = len(w)
    assert m <= 8, "brute force is exponential; use the planner"
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]

    # candidate reducers: maximal feasible subsets (non-maximal subsets are
    # never better: adding an input to a feasible reducer only covers more
    # pairs at equal reducer count; cost ties are broken by the search)
    feasible = []
    for r in range(2, m + 1):
        for sub in itertools.combinations(range(m), r):
            if sum(w[i] for i in sub) <= q + 1e-12:
                feasible.append(frozenset(sub))
    maximal = [s for s in feasible
               if not any(s < t for t in feasible)]
    if not maximal:
        return None
    cost = {s: float(sum(w[i] for i in s)) for s in maximal}
    cover = {s: {p for p in pairs if p[0] in s and p[1] in s}
             for s in maximal}
    need = set(pairs)

    best: list[Optional[tuple]] = [None]

    def dfs(remaining, chosen, total):
        if best[0] is not None and total >= best[0][0] - 1e-12:
            return
        if not remaining:
            best[0] = (total, list(chosen))
            return
        # branch on an uncovered pair; try all reducers covering it
        p = min(remaining,
                key=lambda pp: sum(1 for s in maximal if pp in cover[s]))
        for s in maximal:
            if p in cover[s]:
                dfs(remaining - cover[s], chosen + [s], total + cost[s])

    dfs(need, [], 0.0)
    if best[0] is None:
        return None
    _, chosen = best[0]
    return MappingSchema(
        weights=w, q=q,
        bins=[[i] for i in range(m)],
        reducers=[sorted(s) for s in chosen],
        algorithm="bruteforce-optimal")
