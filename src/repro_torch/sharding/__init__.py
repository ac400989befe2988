"""Logical-axis sharding rules for the port's device meshes."""
from repro_torch.sharding.rules import (
    ShardingRules,
    DEFAULT_RULES,
    logical_to_spec,
    shard_params,
    constrain,
)
