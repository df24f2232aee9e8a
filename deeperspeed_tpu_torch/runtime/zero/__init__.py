from .config import DeepSpeedZeroConfig
from .partition_parameters import (GatheredParameters, Init,
                                   PartitionedParameter, ZeroShardingRules,
                                   current_init_context,
                                   register_external_parameter,
                                   unregister_external_parameter)
from .stage1 import FP16_DeepSpeedZeroOptimizer_Stage1
from .stage2 import (FP16_DeepSpeedZeroOptimizer,
                     FP16_DeepSpeedZeroOptimizer_Stage2)
from .stage3 import FP16_DeepSpeedZeroOptimizer_Stage3
from .tiling import TiledLinear, memory_efficient_linear

__all__ = ["DeepSpeedZeroConfig", "FP16_DeepSpeedZeroOptimizer",
           "FP16_DeepSpeedZeroOptimizer_Stage1",
           "FP16_DeepSpeedZeroOptimizer_Stage2",
           "FP16_DeepSpeedZeroOptimizer_Stage3", "GatheredParameters",
           "Init", "PartitionedParameter", "TiledLinear",
           "ZeroShardingRules", "current_init_context",
           "memory_efficient_linear", "register_external_parameter",
           "unregister_external_parameter"]
