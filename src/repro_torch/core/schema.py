"""Mapping-schema representation for the A2A / X2Y / some-pairs problems.

A *mapping schema* (Afrati, Dolev, Korach, Sharma, Ullman 2015) assigns a set
of inputs — each with a size ``w_i`` — to reducers of identical capacity ``q``
such that

  * the sum of input sizes at any reducer is at most ``q``;
  * every *required pair* of inputs meets at >= 1 reducer.

For the A2A problem the required pairs are all ``(i, j), i != j``.  For the
X2Y problem they are all ``(x, y), x in X, y in Y``.  For the some-pairs
problem (Ullman & Ullman, "Some Pairs Problems") they are an explicit subset.

The schema produced by the planners in this package is a two-level object:

  bins      — optional grouping step (bin packing).  ``bins[b]`` is the list
              of original input ids packed into bin ``b``.  When the planner
              works directly on inputs, bins are singletons.
  reducers  — ``reducers[r]`` is the list of *bin* ids assigned to reducer r.

``expand()`` flattens a schema to reducer -> original-input-ids, which is what
the JAX execution engine consumes and what ``validate()`` checks.

Every schema produced by the planners carries the paper's replication-rate
communication lower bound for its instance (``lower_bound``), so a plan
self-reports its optimality gap: ``optimality_gap()`` is measured
communication over the lower bound (1.0 = provably optimal).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "MappingSchema",
    "InfeasibleError",
    "communication_cost",
    "replication_vector",
]


class InfeasibleError(ValueError):
    """No mapping schema exists for the given instance (e.g. two inputs with
    ``w_i + w_j > q`` in A2A, or an input larger than ``q``)."""


@dataclass
class MappingSchema:
    """A concrete assignment of inputs to capacity-``q`` reducers."""

    weights: np.ndarray                  # (m,) float64 — original input sizes
    q: float                             # reducer capacity
    bins: list[list[int]]                # bin id -> original input ids
    reducers: list[list[int]]            # reducer id -> bin ids
    algorithm: str = "unknown"           # provenance tag for reporting
    meta: dict = field(default_factory=dict)
    lower_bound: Optional[float] = None  # paper's comm lower bound (Thm 8/25)

    # ---------------------------------------------------------------- helpers
    @property
    def m(self) -> int:
        return int(len(self.weights))

    @property
    def num_reducers(self) -> int:
        return len(self.reducers)

    def bin_weight(self, b: int) -> float:
        return float(sum(self.weights[i] for i in self.bins[b]))

    def expand(self) -> list[list[int]]:
        """reducer id -> sorted list of original input ids (deduplicated)."""
        out = []
        for red in self.reducers:
            ids: set[int] = set()
            for b in red:
                ids.update(self.bins[b])
            out.append(sorted(ids))
        return out

    # ------------------------------------------------------------------ costs
    def reducer_load(self, r: int) -> float:
        """Sum of original input sizes at reducer ``r`` (deduplicated)."""
        ids: set[int] = set()
        for b in self.reducers[r]:
            ids.update(self.bins[b])
        return float(sum(self.weights[i] for i in ids))

    def _bin_weights(self) -> np.ndarray:
        w = np.asarray(self.weights, dtype=np.float64)
        return np.array([float(np.sum(w[np.asarray(b, dtype=np.int64)]))
                         if len(b) else 0.0 for b in self.bins])

    def communication_cost(self) -> float:
        """Total bytes shipped map->reduce: sum of loads over reducers.

        Disjoint-bin schemas (the common case) are summed with one vectorized
        pass over the flattened reducer lists; overlapping-bin schemas
        (hybrid / big-input paths) deduplicate input ids per reducer.
        """
        if not self.reducers:
            return 0.0
        if not self.meta.get("bins_overlap", False):
            bw = self._bin_weights()
            flat = np.fromiter(
                itertools.chain.from_iterable(self.reducers),
                dtype=np.int64,
                count=sum(len(r) for r in self.reducers))
            return float(np.sum(bw[flat]))
        return float(sum(self.reducer_load(r)
                         for r in range(self.num_reducers)))

    def optimality_gap(self) -> Optional[float]:
        """communication_cost / lower_bound (>= 1.0); None when no bound
        was attached or the bound is degenerate."""
        if self.lower_bound is None or self.lower_bound <= 0.0:
            return None
        return self.communication_cost() / self.lower_bound

    def replication(self) -> np.ndarray:
        """(m,) number of reducers each original input is sent to."""
        rep = np.zeros(self.m, dtype=np.int64)
        for red in self.expand():
            for i in red:
                rep[i] += 1
        return rep

    def max_load(self) -> float:
        if not self.reducers:
            return 0.0
        return max(self.reducer_load(r) for r in range(self.num_reducers))

    # -------------------------------------------------------------- validation
    def validate(
        self,
        pairs: str = "a2a",
        x_ids: Optional[Sequence[int]] = None,
        y_ids: Optional[Sequence[int]] = None,
        required_pairs: Optional[Sequence[tuple[int, int]]] = None,
        strict_capacity: bool = True,
    ) -> None:
        """Raise AssertionError if the schema is not a valid mapping schema.

        pairs='a2a'   — every unordered pair of distinct inputs must meet.
        pairs='x2y'   — every (x, y) with x in x_ids, y in y_ids must meet.
        pairs='some'  — every pair in ``required_pairs`` must meet
                        (Ullman & Ullman's some-pairs problem).
        """
        m = self.m
        expanded = self.expand()
        # capacity
        if strict_capacity:
            for r in range(self.num_reducers):
                load = self.reducer_load(r)
                assert load <= self.q + 1e-9, (
                    f"reducer {r} overflows: load={load} > q={self.q} "
                    f"(algorithm={self.algorithm})"
                )
        # every input placed in >= 1 bin; duplicates only when the algorithm
        # declares overlapping packings (hybrid Alg 5, big-input path).  The
        # some-pairs planner may legitimately leave pair-free inputs unplaced
        # (meta['partial_cover']=True).
        seen = sorted(itertools.chain.from_iterable(self.bins))
        if not self.meta.get("bins_overlap", False):
            assert seen == sorted(set(seen)), "an input appears in two bins"
        if not self.meta.get("partial_cover", False):
            assert set(seen) == set(range(m)), (
                f"bins cover {len(set(seen))} of {m} inputs"
            )
        # pair coverage via boolean matrix (m is moderate in tests)
        met = np.zeros((m, m), dtype=bool)
        for ids in expanded:
            idx = np.asarray(ids, dtype=np.int64)
            met[np.ix_(idx, idx)] = True
        if pairs == "a2a":
            want = ~np.eye(m, dtype=bool)
            missing = np.argwhere(want & ~met)
            assert missing.size == 0, (
                f"{len(missing)} uncovered pairs, e.g. {missing[:5].tolist()} "
                f"(algorithm={self.algorithm}, m={m}, q={self.q})"
            )
        elif pairs == "x2y":
            assert x_ids is not None and y_ids is not None
            xs = np.asarray(list(x_ids), dtype=np.int64)
            ys = np.asarray(list(y_ids), dtype=np.int64)
            sub = met[np.ix_(xs, ys)]
            missing = np.argwhere(~sub)
            assert missing.size == 0, (
                f"{len(missing)} uncovered X2Y pairs "
                f"(algorithm={self.algorithm})"
            )
        elif pairs == "some":
            assert required_pairs is not None, \
                "pairs='some' needs required_pairs"
            bad = [(int(i), int(j)) for i, j in required_pairs
                   if not met[int(i), int(j)]]
            assert not bad, (
                f"{len(bad)} uncovered required pairs, e.g. {bad[:5]} "
                f"(algorithm={self.algorithm})"
            )
        else:  # pragma: no cover
            raise ValueError(pairs)

    # ------------------------------------------------------------ composition
    @staticmethod
    def concat(a: "MappingSchema", b: "MappingSchema") -> "MappingSchema":
        """Union of two schemas over the *same* input universe."""
        assert a.m == b.m and a.q == b.q
        nb = len(a.bins)
        bins = a.bins + b.bins
        reducers = a.reducers + [[x + nb for x in red] for red in b.reducers]
        return MappingSchema(
            weights=a.weights, q=a.q, bins=bins, reducers=reducers,
            algorithm=f"{a.algorithm}+{b.algorithm}",
            lower_bound=a.lower_bound,
        )


def communication_cost(schema: MappingSchema) -> float:
    return schema.communication_cost()


def replication_vector(schema: MappingSchema) -> np.ndarray:
    return schema.replication()
