"""Distribution substrate (port of ``repro.parallel``): logical-axis
sharding rules over a ``torch.distributed`` ``DeviceMesh`` and GPipe
pipeline parallelism over a process group."""

from .pipeline import bubble_fraction, pipeline_apply
from .sharding import (
    LOGICAL_RULES_BASE,
    ShardingRules,
    logical_to_spec,
    named_sharding,
    placements,
    shard_constraint,
)

__all__ = [
    "ShardingRules", "LOGICAL_RULES_BASE", "logical_to_spec",
    "shard_constraint", "named_sharding", "placements",
    "pipeline_apply", "bubble_fraction",
]
