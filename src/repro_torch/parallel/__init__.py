"""repro_torch.parallel -- sharding rules on DeviceMesh/DTensor and
compressed collectives.  Twin of ``repro.parallel``."""
from .sharding import (LOGICAL_RULES, ShardingCtx, constrain, current_ctx,
                       logical_sharding, logical_spec, set_rules,
                       use_sharding)

__all__ = [
    "LOGICAL_RULES", "ShardingCtx", "constrain", "current_ctx",
    "logical_sharding", "logical_spec", "set_rules", "use_sharding",
]
