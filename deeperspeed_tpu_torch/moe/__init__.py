from .layer import (DISPATCH_MODES, MoELayer, expert_shard, moe_ffn_dense,
                    moe_ffn_expert_parallel)

__all__ = ["DISPATCH_MODES", "MoELayer", "expert_shard", "moe_ffn_dense",
           "moe_ffn_expert_parallel"]
