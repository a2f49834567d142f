"""PyTorch execution engine for mapping schemas (port of
``repro.mapreduce``).

``build_plan(schema)`` flattens a :class:`repro_torch.core.MappingSchema`
into a :class:`ReducerPlan` (``build_x2y_plan`` a rectangular X2Y one,
``build_sparse_plan`` / ``block_subplan`` the CSR plan of block serving);
``run_reducers`` / ``run_reducers_bucketed`` and their ``_x2y`` twins
execute a generic reducer over it; the executor registry (``dense``,
``bucketed``, ``fused``, ``sharded``, ``coded``) is the single dispatch
point of ``pairwise_similarity``, ``some_pairs_similarity``,
``x2y_similarity``, ``pairwise_similarity_block`` and ``skew_join``;
``get_executor("streaming")`` registers the streaming executor of
``repro_torch.stream`` on first lookup.  The ``sharded`` and ``coded``
executors run a plan over a ``torch.distributed`` process group
(``mesh=``; see ``repro_torch.compat``).
"""

from .allpairs import (
    block_similarity,
    block_similarity_x2y,
    pairwise_similarity,
    pairwise_similarity_block,
    some_pairs_similarity,
    x2y_similarity,
)
from .assembly import (
    assemble_pair_matrix,
    assemble_pair_matrix_bucketed,
    assemble_x2y_matrix_bucketed,
)
from .engine import (
    FUSED_STATS,
    ReducerBucket,
    ReducerPlan,
    SparsePlan,
    block_cache_stats,
    block_subplan,
    build_plan,
    build_sparse_plan,
    build_x2y_plan,
    build_x2y_plan_arrays,
    configure_block_cache,
    configure_jit_cache,
    fused_stats,
    jit_cache_stats,
    plan_from_arrays,
    reset_fused_stats,
    run_reducers,
    run_reducers_bucketed,
    run_reducers_fused,
    run_reducers_sharded,
    run_reducers_x2y,
    run_reducers_x2y_bucketed,
    table_signatures,
)
from .executors import (
    BucketedExecutor,
    CodedExecutor,
    DenseExecutor,
    Executor,
    FusedExecutor,
    ShardedExecutor,
    choose_replication,
    coded_assembly_model,
    get_executor,
    list_executors,
    make_executor,
    register_executor,
)
from .skewjoin import join, skew_join

__all__ = [
    "ReducerBucket", "ReducerPlan", "SparsePlan", "build_plan",
    "build_sparse_plan", "block_subplan", "build_x2y_plan",
    "build_x2y_plan_arrays", "plan_from_arrays",
    "run_reducers", "run_reducers_bucketed", "run_reducers_x2y",
    "run_reducers_x2y_bucketed", "run_reducers_fused",
    "run_reducers_sharded", "jit_cache_stats",
    "configure_jit_cache", "table_signatures", "FUSED_STATS",
    "fused_stats", "reset_fused_stats",
    "block_cache_stats", "configure_block_cache",
    "Executor", "DenseExecutor", "BucketedExecutor", "FusedExecutor",
    "ShardedExecutor", "CodedExecutor", "coded_assembly_model",
    "choose_replication",
    "register_executor", "get_executor", "make_executor", "list_executors",
    "pairwise_similarity", "pairwise_similarity_block",
    "some_pairs_similarity", "x2y_similarity",
    "assemble_pair_matrix", "assemble_pair_matrix_bucketed",
    "assemble_x2y_matrix_bucketed", "block_similarity",
    "block_similarity_x2y", "skew_join", "join",
]
