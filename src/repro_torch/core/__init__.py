"""Core: mapping schemas for different-sized inputs in MapReduce.

The port's own copy of the numpy planner in ``repro.core`` (Afrati et al.,
"Assignment Problems of Different-Sized Inputs in MapReduce", 2015):
``primes``, ``schema``, ``bounds``, ``binpack``, ``unit_schemas``,
``strategies`` and ``planner`` are copied whole, with imports rewritten to
this package.  The hierarchical and exact planners come with the
block-serving slice.

``plan_a2a(weights, q, method='auto')`` plans an all-pairs mapping schema
through the strategy-registry portfolio and memoizes it in ``PLAN_CACHE``
by weight profile; ``compute_buckets`` groups reducers into power-of-two
capacity buckets for the bucketed and fused executors.
"""

from .planner import compute_buckets, plan_a2a
from .schema import InfeasibleError, MappingSchema
from .strategies import PLAN_CACHE

__all__ = [
    "plan_a2a", "PLAN_CACHE", "MappingSchema", "InfeasibleError",
    "compute_buckets",
]
