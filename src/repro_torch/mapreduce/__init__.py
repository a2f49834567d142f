"""PyTorch execution engine for mapping schemas (port of
``repro.mapreduce``, square all-pairs slice).

``build_plan(schema)`` flattens a :class:`repro_torch.core.MappingSchema`
into a :class:`ReducerPlan`; ``run_reducers`` / ``run_reducers_bucketed``
execute a generic reducer over it; the executor registry (``dense``,
``bucketed``, ``fused``) is the single dispatch point of
``pairwise_similarity``.
"""

from .allpairs import (
    assemble_pair_matrix,
    assemble_pair_matrix_bucketed,
    block_similarity,
    pairwise_similarity,
)
from .engine import (
    ReducerBucket,
    ReducerPlan,
    build_plan,
    jit_cache_stats,
    plan_from_arrays,
    run_reducers,
    run_reducers_bucketed,
)
from .executors import (
    BucketedExecutor,
    DenseExecutor,
    Executor,
    FusedExecutor,
    get_executor,
    list_executors,
    make_executor,
    register_executor,
)

__all__ = [
    "ReducerBucket", "ReducerPlan", "build_plan", "plan_from_arrays",
    "run_reducers", "run_reducers_bucketed", "jit_cache_stats",
    "Executor", "DenseExecutor", "BucketedExecutor", "FusedExecutor",
    "register_executor", "get_executor", "make_executor", "list_executors",
    "pairwise_similarity", "assemble_pair_matrix",
    "assemble_pair_matrix_bucketed", "block_similarity",
]
