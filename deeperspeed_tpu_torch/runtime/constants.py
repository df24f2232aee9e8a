"""Config keys and defaults of the blocks the port parses.

A subset of `deeperspeed_tpu/runtime/constants.py`: the training keys
`DeepSpeedConfig` reads (batch triple, precision, optimizer, scheduler,
clipping), the top-level blocks it refuses until their slices land, the
"moe" block the model reads, the "inference" block the serving engine
reads, the precision spellings its ``kv_cache_dtype`` resolves through,
and the "quantization" block. The values are the same, so one JSON
config means the same thing to both packages.
"""

# ---------------------------------------------------------------------------
# Training (runtime/config.py DeepSpeedConfig, runtime/engine.py)
# ---------------------------------------------------------------------------
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
# optimizer "type" spellings (lower-cased), as the JAX engine reads them
ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER]

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

# "fp16" carries fp16 and bf16 alike (the fork's "type" key)
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_TYPE = "type"
FP16_TYPE_DEFAULT = "fp16"
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MIN_SCALE_PATIENCE = "min_scale_patience"
FP16_MIN_SCALE_PATIENCE_DEFAULT = 0
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"

# Fork additions: gradient storage for debugging (`engine.backward`)
STORE_GRADIENTS = "store_gradients"
STORE_GRADIENTS_DEFAULT = False
STORE_GRADIENTS_CPU = "store_gradients_cpu"
STORE_GRADIENTS_CPU_DEFAULT = True

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

# Top-level blocks of the JAX config that the port does not carry yet:
# block → the slice that brings it (ROADMAP.md queue A). A block that is
# set (present, and not null / false / {} / {"enabled": false}) raises
# DeepSpeedConfigError "not ported".
NOT_PORTED_BLOCKS = {
    "sequence_parallel": "ranks (sequence parallelism)",
    "pipeline": "scale-out (pipeline)",
    "multislice": "scale-out",
    "elasticity": "elasticity",
    "aio": "offload",
    "planner": "schedule planner",
}

# ---------------------------------------------------------------------------
# Observability: wall-clock timers, tensorboard, the monitor's export
# backends (runtime/exporters.py) and the telemetry block
# (runtime/telemetry.py); the JAX package's keys and defaults
# ---------------------------------------------------------------------------
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

MONITOR = "monitor"
MONITOR_EXPORT = "export"
MONITOR_PROMETHEUS_PORT = "prometheus_port"     # None = off, 0 = ephemeral
MONITOR_PROMETHEUS_PORT_DEFAULT = None
MONITOR_PROMETHEUS_HOST = "prometheus_host"     # 0.0.0.0 = off-box scrape
MONITOR_PROMETHEUS_HOST_DEFAULT = "127.0.0.1"
MONITOR_JSONL = "jsonl"
MONITOR_JSONL_DEFAULT = False
MONITOR_ROTATE_MAX_MB = "rotate_max_mb"         # 0 disables rotation
MONITOR_ROTATE_MAX_MB_DEFAULT = 64
MONITOR_ROTATE_KEEP = "rotate_keep"
MONITOR_ROTATE_KEEP_DEFAULT = 5

TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False
TELEMETRY_GOODPUT = "goodput"
TELEMETRY_GOODPUT_DEFAULT = True
TELEMETRY_MFU = "mfu"
TELEMETRY_MFU_DEFAULT = True
TELEMETRY_SPANS = "spans"
TELEMETRY_SPANS_DEFAULT = True
TELEMETRY_TRACE_DIR = "trace_dir"
TELEMETRY_TRACE_DIR_DEFAULT = None
TELEMETRY_CAPTURE = "capture"             # {"start_step": N, "num_steps": M}
TELEMETRY_CAPTURE_START_STEP = "start_step"
TELEMETRY_CAPTURE_NUM_STEPS = "num_steps"
TELEMETRY_CAPTURE_NUM_STEPS_DEFAULT = 1
TELEMETRY_MEMORY_WATERMARK_INTERVAL = "memory_watermark_interval_steps"
TELEMETRY_MEMORY_WATERMARK_INTERVAL_DEFAULT = 0
TELEMETRY_CAPTURE_ON_ANOMALY = "capture_on_anomaly"
TELEMETRY_CAPTURE_ON_ANOMALY_DEFAULT = False
TELEMETRY_ANOMALY_CAPTURE_STEPS = "anomaly_capture_steps"
TELEMETRY_ANOMALY_CAPTURE_STEPS_DEFAULT = 1
# the cross-host sub-block (the JAX package's runtime/fleet.py): refused
TELEMETRY_FLEET = "fleet"

# AMP (API-compat: parsed as the JAX package parses it, and read by nothing
# else, as there)
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

# ---------------------------------------------------------------------------
# Progressive layer drop
# ---------------------------------------------------------------------------
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

# ---------------------------------------------------------------------------
# Batch-size warmup schedule (fork addition, bs_schedules.py)
# ---------------------------------------------------------------------------
BATCH_SIZE_SCHEDULE = "batch_size_schedule"
BS_SCHEDULE_ENABLED = "enabled"
BS_SCHEDULE_ENABLED_DEFAULT = False
BS_SCHEDULE_PARAMS = "params"

# ---------------------------------------------------------------------------
# Training-health sentinel block (runtime/sentinel.py)
# ---------------------------------------------------------------------------
TRAINING_HEALTH = "training_health"
TRAINING_HEALTH_ENABLED = "enabled"
TRAINING_HEALTH_ENABLED_DEFAULT = False
TRAINING_HEALTH_POLICY = "policy"
TRAINING_HEALTH_POLICY_DEFAULT = "warn"
TRAINING_HEALTH_LOSS_ZSCORE = "loss_zscore"
TRAINING_HEALTH_LOSS_ZSCORE_DEFAULT = 6.0
TRAINING_HEALTH_GRAD_NORM_ZSCORE = "grad_norm_zscore"
TRAINING_HEALTH_GRAD_NORM_ZSCORE_DEFAULT = 6.0
TRAINING_HEALTH_EMA_BETA = "ema_beta"
TRAINING_HEALTH_EMA_BETA_DEFAULT = 0.98
TRAINING_HEALTH_WARMUP_STEPS = "warmup_steps"
TRAINING_HEALTH_WARMUP_STEPS_DEFAULT = 20
TRAINING_HEALTH_ROLLBACK_AFTER = "rollback_after"
TRAINING_HEALTH_ROLLBACK_AFTER_DEFAULT = 2
TRAINING_HEALTH_ABORT_AFTER = "abort_after"
TRAINING_HEALTH_ABORT_AFTER_DEFAULT = 5
TRAINING_HEALTH_MAX_ROLLBACKS = "max_rollbacks"
TRAINING_HEALTH_MAX_ROLLBACKS_DEFAULT = 2
TRAINING_HEALTH_HANG_TIMEOUT = "hang_timeout_seconds"
TRAINING_HEALTH_HANG_TIMEOUT_DEFAULT = 0.0
TRAINING_HEALTH_FAULT_INJECTION = "fault_injection"

# ---------------------------------------------------------------------------
# Packing block (document-packed ragged batches; runtime/packing.py)
# ---------------------------------------------------------------------------
PACKING = "packing"
PACKING_ENABLED = "enabled"
PACKING_ENABLED_DEFAULT = False
# token id written on pad positions (segment id 0 marks them for the
# kernels' masks and the effective-token accounting)
PACKING_PAD_ID = "pad_id"
PACKING_PAD_ID_DEFAULT = 0
# drop rows under 50% occupancy (bench hygiene for tail rows)
PACKING_DROP_TAIL = "drop_tail"
PACKING_DROP_TAIL_DEFAULT = False

# ---------------------------------------------------------------------------
# Checkpoint block (`config._parse_checkpoint_block`, read by the engine's
# `checkpoint.AsyncCheckpointManager`)
# ---------------------------------------------------------------------------
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_SAVE_DIR = "save_dir"
CHECKPOINT_SAVE_DIR_DEFAULT = None
CHECKPOINT_ASYNC_SAVE = "async_save"
CHECKPOINT_ASYNC_SAVE_DEFAULT = True
CHECKPOINT_SAVE_INTERVAL = "save_interval_steps"
CHECKPOINT_SAVE_INTERVAL_DEFAULT = 0
CHECKPOINT_KEEP_LAST_N = "keep_last_n"
CHECKPOINT_KEEP_LAST_N_DEFAULT = 0
CHECKPOINT_KEEP_EVERY_N_STEPS = "keep_every_n_steps"
CHECKPOINT_KEEP_EVERY_N_STEPS_DEFAULT = 0
CHECKPOINT_SAVE_ON_PREEMPTION = "save_on_preemption"
CHECKPOINT_SAVE_ON_PREEMPTION_DEFAULT = False


class ValidationMode:
    WARN = "WARN"
    IGNORE = "IGNORE"
    FAIL = "FAIL"


CHECKPOINT_TAG_VALIDATION_DEFAULT = ValidationMode.WARN
CHECKPOINT_TAG_VALIDATION_MODES = [
    ValidationMode.WARN,
    ValidationMode.IGNORE,
    ValidationMode.FAIL,
]

# ---------------------------------------------------------------------------
# MoE block (`config._parse_moe_block`, read by `GPTNeoX.apply_ds_config`)
# ---------------------------------------------------------------------------
MOE = "moe"
MOE_ENABLED = "enabled"
MOE_NUM_EXPERTS = "num_experts"
MOE_TOP_K = "top_k"
MOE_TOP_K_DEFAULT = 1
MOE_TOP_K_CHOICES = (1, 2)
MOE_CAPACITY_FACTOR = "capacity_factor"
MOE_CAPACITY_FACTOR_DEFAULT = 1.25
MOE_JITTER_EPS = "jitter_eps"
MOE_JITTER_EPS_DEFAULT = 0.0
MOE_AUX_LOSS_COEF = "aux_loss_coef"
MOE_AUX_LOSS_COEF_DEFAULT = 0.01
# 1 = global capacity (reference numerics); 0 opts in to auto-sized groups
MOE_NUM_GROUPS = "num_groups"
MOE_NUM_GROUPS_DEFAULT = 1
# dispatch engine: "einsum" = the one-hot [T, E, C] einsum pair;
# "sort" = sorted token permutation + the grouped-matmul kernels
MOE_DISPATCH = "dispatch"
MOE_DISPATCH_DEFAULT = "einsum"
MOE_DISPATCH_MODES = ("einsum", "sort")
# expert-parallel all_to_all/compute pipeline depth (no effect on one card)
MOE_A2A_OVERLAP_CHUNKS = "a2a_overlap_chunks"
MOE_A2A_OVERLAP_CHUNKS_DEFAULT = 1
# renormalize top-2 combine weights over capacity-surviving choices
MOE_RENORM_KEPT_CHOICES = "renorm_kept_choices"
MOE_RENORM_KEPT_CHOICES_DEFAULT = False
# routing statistics (validated; not ported: no monitor drains them)
MOE_OBSERVABILITY = "observability"
MOE_OBSERVABILITY_DEFAULT = False

# Accepted precision spellings → canonical dtype names (torch dtypes are
# resolved in precision.py; kept as strings here so this module stays
# import-light).
PRECISION_TYPES = {
    "fp32": "float32",
    "float32": "float32",
    "float": "float32",
    "fp16": "float16",
    "float16": "float16",
    "half": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
}


# ---------------------------------------------------------------------------
# Inference block (serving engine; deeperspeed_tpu_torch/inference)
# ---------------------------------------------------------------------------
INFERENCE = "inference"
INFERENCE_ENABLED = "enabled"
INFERENCE_ENABLED_DEFAULT = False
# KV-cache page geometry: slots per page
# and pool pages per layer (page 0 is the reserved trash page)
INFERENCE_PAGE_SIZE = "page_size"
INFERENCE_PAGE_SIZE_DEFAULT = 128
INFERENCE_NUM_PAGES = "num_pages"
INFERENCE_NUM_PAGES_DEFAULT = 1024
# serving window; None = the model's max_seq_len
INFERENCE_MAX_SEQ_LEN = "max_seq_len"
INFERENCE_MAX_SEQ_LEN_DEFAULT = None
# in-flight decode sequences (the continuous batch)
INFERENCE_MAX_BATCH_SIZE = "max_batch_size"
INFERENCE_MAX_BATCH_SIZE_DEFAULT = 8
# per-step admission budget: a prefill costs its padded bucket length,
# a decode costs 1 (scheduler.py)
INFERENCE_TOKEN_BUDGET = "token_budget"
INFERENCE_TOKEN_BUDGET_DEFAULT = 4096
# compiled-shape bucket ladders (None = derived defaults)
INFERENCE_PREFILL_LENGTHS = "prefill_lengths"
INFERENCE_PREFILL_BATCH_SIZES = "prefill_batch_sizes"
INFERENCE_DECODE_BATCH_SIZES = "decode_batch_sizes"
# sampling: 0.0 = greedy argmax (deterministic)
INFERENCE_TEMPERATURE = "temperature"
INFERENCE_TEMPERATURE_DEFAULT = 0.0
INFERENCE_SEED = "seed"
INFERENCE_SEED_DEFAULT = 0
# decode-attention backend: "auto" and "pallas" launch the hand-written
# kernel on CUDA tensors (the plain version on CPU tensors); "xla" always
# takes the plain version. The spellings are the JAX package's.
INFERENCE_KERNEL = "kernel"
INFERENCE_KERNEL_DEFAULT = "auto"
INFERENCE_KERNEL_CHOICES = ("auto", "pallas", "xla")
# KV-cache storage dtype: null = the params' compute dtype. Validated
# at parse time against the POOL dtypes the cache actually implements —
# any other resolve_precision spelling used to slip through and surface
# as a late kernel error far from the config.
INFERENCE_KV_DTYPE = "kv_cache_dtype"
INFERENCE_KV_DTYPE_DEFAULT = None
INFERENCE_KV_DTYPE_CHOICES = ("bfloat16", "bf16", "float16", "fp16",
                              "half", "float32", "fp32", "float", "int8")

# Graceful drain (SIGTERM): stop admissions, finish in-flight sequences
# for at most this many seconds, flush Serve/* telemetry, exit 0.
INFERENCE_DRAIN_DEADLINE = "drain_deadline_s"
INFERENCE_DRAIN_DEADLINE_DEFAULT = 30.0

# -- serving robustness (inference/admission.py; docs/inference.md
#    "Serving under failure") ------------------------------------------------

# priority class a submit() without an explicit `priority` gets
INFERENCE_DEFAULT_PRIORITY = "default_priority"
INFERENCE_DEFAULT_PRIORITY_DEFAULT = "interactive"

# hang watchdog around the serving step: 0 = off
INFERENCE_HANG_TIMEOUT = "hang_timeout_s"
INFERENCE_HANG_TIMEOUT_DEFAULT = 0.0

# admission control / load shedding sub-block (absent => no shedding,
# the pre-robustness unbounded-queue behavior)
INFERENCE_ADMISSION = "admission"
INFERENCE_ADMISSION_ENABLED = "enabled"
INFERENCE_ADMISSION_ENABLED_DEFAULT = True
INFERENCE_ADMISSION_MAX_QUEUE_DEPTH = "max_queue_depth"
INFERENCE_ADMISSION_MAX_QUEUE_DEPTH_DEFAULT = 256
INFERENCE_ADMISSION_SHED_POOL_UTIL = "shed_page_pool_util"
INFERENCE_ADMISSION_SHED_POOL_UTIL_DEFAULT = 0.95
INFERENCE_ADMISSION_SHED_TTFT_EMA = "shed_ttft_ema_ms"
INFERENCE_ADMISSION_SHED_TTFT_EMA_DEFAULT = None
INFERENCE_ADMISSION_TTFT_EMA_BETA = "ttft_ema_beta"
INFERENCE_ADMISSION_TTFT_EMA_BETA_DEFAULT = 0.9
INFERENCE_ADMISSION_RETRY_AFTER_CAP = "retry_after_cap_s"
INFERENCE_ADMISSION_RETRY_AFTER_CAP_DEFAULT = 60.0

# step-failure retry/poison sub-block (always active; the defaults
# apply when the block is absent)
INFERENCE_RETRY = "retry"
INFERENCE_RETRY_MAX_ATTEMPTS = "max_attempts"
INFERENCE_RETRY_MAX_ATTEMPTS_DEFAULT = 3
INFERENCE_RETRY_BACKOFF_BASE = "backoff_base_ms"
INFERENCE_RETRY_BACKOFF_BASE_DEFAULT = 50.0
INFERENCE_RETRY_BACKOFF_CAP = "backoff_cap_ms"
INFERENCE_RETRY_BACKOFF_CAP_DEFAULT = 2000.0
INFERENCE_RETRY_JITTER = "jitter"
INFERENCE_RETRY_JITTER_DEFAULT = 0.25

# serving fault injection (runtime/fault_injection.py serving kinds);
# same schema as training_health.fault_injection
INFERENCE_FAULT_INJECTION = "fault_injection"

# prefix/radix KV-cache reuse sub-block (inference/kv_cache.PrefixCache):
# shared-prompt prefills attach registered page chains by refcount
INFERENCE_PREFIX_CACHE = "prefix_cache"
INFERENCE_PREFIX_CACHE_ENABLED = "enabled"
INFERENCE_PREFIX_CACHE_ENABLED_DEFAULT = False
# registry size cap in pages (null = bounded only by pool pressure:
# allocation shortfalls reclaim LRU unshared registry pages)
INFERENCE_PREFIX_CACHE_MAX_PAGES = "max_pages"
INFERENCE_PREFIX_CACHE_MAX_PAGES_DEFAULT = None

# speculative decoding sub-block: a draft model proposes
# num_draft_tokens per decode step; the target verifies the window in
# one batched forward (engine arg `draft_model` supplies the drafter)
INFERENCE_SPECULATIVE = "speculative"
INFERENCE_SPECULATIVE_ENABLED = "enabled"
INFERENCE_SPECULATIVE_ENABLED_DEFAULT = False
INFERENCE_SPECULATIVE_NUM_DRAFT = "num_draft_tokens"
INFERENCE_SPECULATIVE_NUM_DRAFT_DEFAULT = 4
# int8 weight-only quantization for the DRAFT params (the draft step is
# weight-bandwidth bound too); null = the target's compute dtype
INFERENCE_SPECULATIVE_DRAFT_WEIGHT_QUANT = "draft_weight_quant"
INFERENCE_SPECULATIVE_DRAFT_WEIGHT_QUANT_DEFAULT = None

# disaggregated prefill/decode serving sub-block (docs/inference.md
# "Disaggregated prefill/decode"): an engine's pool role — a prefill
# pool runs admission + prefill and hands completed requests' KV pages
# to a decode pool over the coordination-service transport; "unified"
# (the default) is the single-engine behavior
INFERENCE_DISAGGREGATION = "disaggregation"
INFERENCE_DISAGG_ROLE = "role"
INFERENCE_DISAGG_ROLE_DEFAULT = "unified"
INFERENCE_DISAGG_ROLE_CHOICES = ("unified", "prefill", "decode")
# pool identity: the handoff transport key namespace AND the
# role/host labels on the Serve/* Prometheus families (null = derived
# from the role, e.g. "prefill-0")
INFERENCE_DISAGG_POOL_ID = "pool_id"
INFERENCE_DISAGG_POOL_ID_DEFAULT = None
# an offer the decode side has not acked within this window is treated
# as rejected: pages return to the prefill pool's free list and the
# request requeues for a fresh prefill + re-offer
INFERENCE_DISAGG_HANDOFF_TIMEOUT = "handoff_timeout_s"
INFERENCE_DISAGG_HANDOFF_TIMEOUT_DEFAULT = 30.0

# front-end SLO router sub-block (inference/router.py): weighted
# least-load admission across pools on the queue-depth / page-pool /
# TTFT-EMA gauges the admission controller already maintains
INFERENCE_ROUTER = "router"
INFERENCE_ROUTER_QUEUE_DEPTH_WEIGHT = "queue_depth_weight"
INFERENCE_ROUTER_QUEUE_DEPTH_WEIGHT_DEFAULT = 1.0
INFERENCE_ROUTER_POOL_UTIL_WEIGHT = "pool_util_weight"
INFERENCE_ROUTER_POOL_UTIL_WEIGHT_DEFAULT = 32.0
INFERENCE_ROUTER_TTFT_WEIGHT = "ttft_weight"
INFERENCE_ROUTER_TTFT_WEIGHT_DEFAULT = 0.01
# advisory autoscaling threshold: when every routable pool's page-pool
# utilization sits above this, Serve/router/advise_scale_up goes to 1
INFERENCE_ROUTER_SCALE_UP_UTIL = "scale_up_util"
INFERENCE_ROUTER_SCALE_UP_UTIL_DEFAULT = 0.85

# "quantization" block (`config.parse_quantization_block`): the serving
# engine reads ``weights``, the training engine ``ffn``; the training
# ``DeepSpeedConfig`` refuses an enabled ``gradient_compression``
QUANTIZATION = "quantization"
QUANTIZATION_ENABLED = "enabled"
QUANTIZATION_ENABLED_DEFAULT = True
# serving weight-only quantization (module_inject.prepare_inference_params)
QUANTIZATION_WEIGHTS = "weights"
QUANTIZATION_WEIGHTS_DEFAULT = None
QUANTIZATION_WEIGHTS_CHOICES = ("int8",)
# delayed-scaling quantized FFN (training; ops/hopper/quant_matmul)
QUANTIZATION_FFN = "ffn"
QUANTIZATION_FFN_RECIPE = "recipe"
QUANTIZATION_FFN_RECIPE_CHOICES = ("int8", "fp8")
QUANTIZATION_FFN_HISTORY = "amax_history_len"
QUANTIZATION_FFN_HISTORY_DEFAULT = 16
QUANTIZATION_FFN_MARGIN = "margin"
QUANTIZATION_FFN_MARGIN_DEFAULT = 1.0
# error-feedback compressed gradients (training; not ported: it
# needs the explicit ZeRO-3 schedule and a data-parallel world)
QUANTIZATION_GRAD_COMPRESSION = "gradient_compression"
QUANTIZATION_GRAD_COMPRESSION_ENABLED = "enabled"
QUANTIZATION_GRAD_COMPRESSION_ENABLED_DEFAULT = True
QUANTIZATION_GRAD_COMPRESSION_PACKED = "packed_wire"
QUANTIZATION_GRAD_COMPRESSION_PACKED_DEFAULT = False

# ---------------------------------------------------------------------------
# Sparse attention block (`config._parse_sparse_attention`, read by
# `GPTNeoX.apply_ds_config`)
# ---------------------------------------------------------------------------
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = SPARSE_FIXED_MODE
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

# ---------------------------------------------------------------------------
# Online RL: the co-located train+serve driver (deeperspeed_tpu_torch/rl):
# rollouts from the serving engine, PPO-clip / DPO losses on the training
# engine, train→serve weights by in-process hot-swap; the JAX package's
# keys and defaults
# ---------------------------------------------------------------------------
RL = "rl"
RL_ENABLED = "enabled"
RL_ENABLED_DEFAULT = False
RL_LOSS = "loss"
RL_LOSS_DEFAULT = "ppo_clip"
RL_LOSS_CHOICES = ("ppo_clip", "dpo")
# total rollouts generated per driver iteration (must be a multiple of
# group_size; PPO updates on all of them, DPO on one pair per group)
RL_ROLLOUTS_PER_ITERATION = "rollouts_per_iteration"
RL_ROLLOUTS_PER_ITERATION_DEFAULT = 8
# rollouts sampled per prompt: the advantage baseline group (PPO) /
# the chosen-vs-rejected candidate pool (DPO, needs >= 2)
RL_GROUP_SIZE = "group_size"
RL_GROUP_SIZE_DEFAULT = 1
RL_MAX_NEW_TOKENS = "max_new_tokens"
RL_MAX_NEW_TOKENS_DEFAULT = 16
# fixed padded rollout width (the one train/logprob shape of the run);
# null = max prompt length + max_new_tokens, rounded up to 8
RL_SEQUENCE_LENGTH = "sequence_length"
RL_SEQUENCE_LENGTH_DEFAULT = None
# PPO-clip knobs
RL_CLIP_RATIO = "clip_ratio"
RL_CLIP_RATIO_DEFAULT = 0.2
RL_KL_COEF = "kl_coef"
RL_KL_COEF_DEFAULT = 0.05
# DPO preference temperature
RL_BETA = "beta"
RL_BETA_DEFAULT = 0.1
# driver iterations between committed checkpoints (the deterministic-
# resume granularity: a kill replays at most this many iterations)
RL_CHECKPOINT_INTERVAL = "checkpoint_interval"
RL_CHECKPOINT_INTERVAL_DEFAULT = 1
