from .layer import (DISPATCH_MODES, MoELayer, moe_ffn_dense,
                    moe_ffn_expert_parallel)

__all__ = ["DISPATCH_MODES", "MoELayer", "moe_ffn_dense",
           "moe_ffn_expert_parallel"]
