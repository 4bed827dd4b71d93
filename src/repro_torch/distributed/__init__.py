"""Distribution: sharding rule engine + collective sizing (port of
``repro.distributed``)."""
from .sharding import (PartitionSpec, ShardingPolicy, batch_shardings,
                       cache_shardings, opt_state_shardings,
                       param_shardings, shard_factor_fn, spec_for_path,
                       to_placements)

__all__ = ["PartitionSpec", "ShardingPolicy", "batch_shardings",
           "cache_shardings", "opt_state_shardings", "param_shardings",
           "shard_factor_fn", "spec_for_path", "to_placements"]
