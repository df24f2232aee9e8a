"""ZeRO config-schema keys: the part of
`deeperspeed_tpu/runtime/zero/constants.py` the port parses. The values
are the same, so one JSON config means the same thing to both packages.
"""

ZERO_OPTIMIZATION = "zero_optimization"

ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS

ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = ZERO_OPTIMIZATION_DISABLED

ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT = 500_000_000

# size knobs the JAX parser rejects when negative
SIZE_KEYS = ("reduce_bucket_size", "allgather_bucket_size",
             "stage3_prefetch_bucket_size", "stage3_max_live_parameters",
             "stage3_max_reuse_distance",
             "stage3_param_persistence_threshold")

# refused ("not ported"): the offload sub-blocks, their deprecated
# boolean spellings, and the explicit collective schedule
OFFLOAD_PARAM = "offload_param"
OFFLOAD_OPTIMIZER = "offload_optimizer"
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS = "cpu_offload_params"
ZERO_OPTIMIZATION_SCHEDULE = "schedule"
