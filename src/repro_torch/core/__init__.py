"""Core: mapping schemas for different-sized inputs in MapReduce.

The port's own copy of the numpy planner in ``repro.core`` (Afrati et al.,
"Assignment Problems of Different-Sized Inputs in MapReduce", 2015):
``primes``, ``schema``, ``bounds``, ``binpack``, ``unit_schemas``,
``strategies``, ``planner``, ``hierarchy`` and ``exact`` are copied whole,
with imports rewritten to this package, and this module exports what the
reference's ``repro.core`` exports.

``plan_a2a(weights, q, method='auto')`` plans an all-pairs mapping schema
through the strategy-registry portfolio and memoizes it in ``PLAN_CACHE``
by weight profile; ``plan_x2y(wx, wy, q)`` plans the bipartite (X2Y)
schema of Section 10; ``plan_a2a_hierarchical`` composes the packing twice
for million-input tables (block serving); ``compute_buckets`` /
``compute_rect_buckets`` group reducers into power-of-two capacity buckets
for the bucketed and fused executors.
"""

from .binpack import bfd, ffd, pack, pack_prefix, prefix_bins
from .bounds import (
    a2a_algk_comm_upper_bound,
    a2a_binpack_comm_lower_bound,
    a2a_comm_lower_bound,
    a2a_k2_comm_upper_bound,
    a2a_reducers_lower_bound,
    a2a_unit_comm_lower_bound,
    a2a_unit_reducers_lower_bound,
    big_input_comm_upper_bound,
    some_pairs_comm_lower_bound,
    x2y_comm_lower_bound,
    x2y_comm_upper_bound,
    x2y_reducers_lower_bound,
)
from .hierarchy import (
    choose_grouping_factor,
    plan_a2a_hierarchical,
    sampled_pair_coverage,
)
from .planner import (
    PlanPartition,
    bucket_summary,
    compute_buckets,
    compute_rect_buckets,
    estimate_a2a,
    estimate_x2y,
    naive_pairs,
    partition_plan,
    plan_a2a,
    plan_a2a_materialized,
    plan_some_pairs,
    plan_unit,
    plan_x2y,
    reducer_work,
)
from .primes import is_prime, next_prime, prev_prime
from .schema import InfeasibleError, MappingSchema
from .strategies import (
    A2A_REGISTRY,
    PLAN_CACHE,
    PlanCache,
    UNIT_REGISTRY,
    register_a2a_strategy,
    register_unit_strategy,
)
from . import unit_schemas

__all__ = [
    "MappingSchema", "InfeasibleError",
    "plan_a2a", "plan_a2a_materialized", "plan_x2y", "plan_unit",
    "plan_some_pairs", "estimate_a2a", "estimate_x2y", "naive_pairs",
    "compute_buckets", "compute_rect_buckets", "bucket_summary",
    "PlanPartition", "partition_plan", "reducer_work",
    "PLAN_CACHE", "PlanCache",
    "UNIT_REGISTRY", "A2A_REGISTRY",
    "register_unit_strategy", "register_a2a_strategy",
    "ffd", "bfd", "pack", "pack_prefix", "prefix_bins",
    "plan_a2a_hierarchical", "choose_grouping_factor",
    "sampled_pair_coverage",
    "is_prime", "prev_prime", "next_prime",
    "unit_schemas",
    "a2a_comm_lower_bound", "a2a_reducers_lower_bound",
    "a2a_binpack_comm_lower_bound", "a2a_unit_comm_lower_bound",
    "a2a_unit_reducers_lower_bound", "a2a_k2_comm_upper_bound",
    "a2a_algk_comm_upper_bound", "big_input_comm_upper_bound",
    "x2y_comm_lower_bound", "x2y_comm_upper_bound",
    "x2y_reducers_lower_bound", "some_pairs_comm_lower_bound",
]
