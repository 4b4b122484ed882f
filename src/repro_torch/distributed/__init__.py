"""Distribution on ``torch.distributed`` (a port of ``repro.distributed``):
the partition rules and the sharding context that names the mesh the CPM
collectives and the mesh backend run on."""

from .sharding import (P, PartitionSpec, ShardingCtx, act_spec,
                       compute_spec, current_ctx, make_ctx, param_spec,
                       param_specs, placements, set_sharding_ctx,
                       use_sharding)

__all__ = ["ShardingCtx", "set_sharding_ctx", "use_sharding", "current_ctx",
           "make_ctx", "act_spec", "param_spec", "param_specs",
           "compute_spec", "placements", "PartitionSpec", "P"]
