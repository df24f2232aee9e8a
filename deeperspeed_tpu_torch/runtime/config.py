"""DeepSpeed JSON configs: the training `DeepSpeedConfig`, the
"inference" block and the "quantization" block the serving engine reads.

The port's counterpart of `deeperspeed_tpu/runtime/config.py`: the same
keys, defaults and `DeepSpeedConfigError` messages for what it parses,
so a config written for the JAX package means the same here. The
training parser reads what the port's engine runs (the batch triple,
precision and loss scaling, optimizer, LR scheduler, clipping, ZeRO
stages 0-2), the "checkpoint" block the engine's checkpoint manager
reads, the "training_health", "progressive_layer_drop" and
"batch_size_schedule" blocks and ``fp16.min_scale_patience`` its step
boundary reads, the "moe", "sparse_attention", "packing" and
"activation_checkpointing" blocks the model reads
(`GPTNeoX.apply_ds_config`), the "quantization" block (its "ffn"
object arms the delayed-scaling FFN; "gradient_compression" raises "not
ported"), and the observability blocks: "telemetry" (a set ``fleet``
sub-block raises "not ported"), "monitor", "tensorboard",
"flops_profiler", ``wall_clock_breakdown`` and ``memory_breakdown``;
the "rl" block (`parse_rl_block`; the engine installs its loss, and
`rl.RLDriver` reads its rollout geometry); every other top-level block
of the JAX config that is set raises "not ported"
(`constants.NOT_PORTED_BLOCKS`).
"""

from . import constants as c
from .activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig)
from .config_utils import (DeepSpeedConfigError, as_int, get_scalar_param,
                           load_config_json)
from ..profiling.config import DeepSpeedFlopsProfilerConfig
from .precision import resolve_precision
from .zero import constants as zc
from .zero.config import DeepSpeedZeroConfig


def _is_set(block):
    """A top-level block counts as set unless it is absent, null, false,
    empty, or a dict with "enabled": false."""
    if block is None or block is False or block == {}:
        return False
    if isinstance(block, dict) and block.get("enabled", True) is False:
        return False
    return True


def _parse_sparse_attention(param_dict):
    """Parse the "sparse_attention" block into a plain dict of knobs
    (reference `config.py:213-383`)."""
    sparsity = param_dict.get(c.SPARSE_ATTENTION)
    if sparsity is None:
        return None
    mode = get_scalar_param(sparsity, c.SPARSE_MODE, c.SPARSE_MODE_DEFAULT)

    common = {
        c.SPARSE_MODE: mode,
        c.SPARSE_BLOCK: get_scalar_param(sparsity, c.SPARSE_BLOCK,
                                         c.SPARSE_BLOCK_DEFAULT),
        c.SPARSE_DIFFERENT_LAYOUT_PER_HEAD: get_scalar_param(
            sparsity, c.SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
            c.SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT),
    }
    if mode == c.SPARSE_DENSE_MODE:
        return common
    if mode == c.SPARSE_FIXED_MODE:
        extra = {
            c.SPARSE_NUM_LOCAL_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_LOCAL_BLOCKS,
                c.SPARSE_NUM_LOCAL_BLOCKS_DEFAULT),
            c.SPARSE_NUM_GLOBAL_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_GLOBAL_BLOCKS,
                c.SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
            # unset stays None: the consumer picks its default —
            # the SparsityConfig constructors keep the reference's
            # bidirectional, the causal-LM sparse engine (gpt_neox.
            # make_sparse_attention) needs unidirectional and must be
            # able to tell "user asked for bidirectional" apart
            c.SPARSE_ATTENTION_TYPE: get_scalar_param(
                sparsity, c.SPARSE_ATTENTION_TYPE, None),
            c.SPARSE_HORIZONTAL_GLOBAL_ATTENTION: get_scalar_param(
                sparsity, c.SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
                c.SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT),
            c.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS: get_scalar_param(
                sparsity, c.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
                c.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT),
        }
    elif mode == c.SPARSE_VARIABLE_MODE:
        extra = {
            c.SPARSE_NUM_RANDOM_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_RANDOM_BLOCKS,
                c.SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
            c.SPARSE_LOCAL_WINDOW_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_LOCAL_WINDOW_BLOCKS,
                c.SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT),
            c.SPARSE_GLOBAL_BLOCK_INDICES: get_scalar_param(
                sparsity, c.SPARSE_GLOBAL_BLOCK_INDICES,
                c.SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT),
            c.SPARSE_GLOBAL_BLOCK_END_INDICES: get_scalar_param(
                sparsity, c.SPARSE_GLOBAL_BLOCK_END_INDICES,
                c.SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT),
            # unset stays None: the consumer picks its default —
            # the SparsityConfig constructors keep the reference's
            # bidirectional, the causal-LM sparse engine (gpt_neox.
            # make_sparse_attention) needs unidirectional and must be
            # able to tell "user asked for bidirectional" apart
            c.SPARSE_ATTENTION_TYPE: get_scalar_param(
                sparsity, c.SPARSE_ATTENTION_TYPE, None),
            c.SPARSE_HORIZONTAL_GLOBAL_ATTENTION: get_scalar_param(
                sparsity, c.SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
                c.SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT),
        }
    elif mode == c.SPARSE_BIGBIRD_MODE:
        extra = {
            c.SPARSE_NUM_RANDOM_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_RANDOM_BLOCKS,
                c.SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
            c.SPARSE_NUM_SLIDING_WINDOW_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
                c.SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT),
            c.SPARSE_NUM_GLOBAL_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_GLOBAL_BLOCKS,
                c.SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
        }
    elif mode == c.SPARSE_BSLONGFORMER_MODE:
        extra = {
            c.SPARSE_NUM_SLIDING_WINDOW_BLOCKS: get_scalar_param(
                sparsity, c.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
                c.SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT),
            c.SPARSE_GLOBAL_BLOCK_INDICES: get_scalar_param(
                sparsity, c.SPARSE_GLOBAL_BLOCK_INDICES,
                c.SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT),
            c.SPARSE_GLOBAL_BLOCK_END_INDICES: get_scalar_param(
                sparsity, c.SPARSE_GLOBAL_BLOCK_END_INDICES,
                c.SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT),
        }
    else:
        raise DeepSpeedConfigError(
            f"Invalid sparse_attention mode {mode!r}")
    common.update(extra)
    return common


def _default_dp_world_size():
    """The data-parallel world when none is given: the process group's
    size (one rank a card), 1 without a process group."""
    from ..utils.distributed import get_world_size
    return get_world_size()


class DeepSpeedConfig:
    """Parsed, validated training config (the JAX `DeepSpeedConfig` for
    the keys the port's engine runs). ``world_size`` is the
    data-parallel world the batch triple resolves against: by default
    the `torch.distributed` world, 1 without a process group (the JAX
    config's default is its device count)."""

    def __init__(self, json_file_or_dict, param_dict=None, world_size=None):
        if param_dict is not None:
            self._param_dict = dict(param_dict)
        elif isinstance(json_file_or_dict, dict):
            self._param_dict = dict(json_file_or_dict)
        else:
            self._param_dict = load_config_json(json_file_or_dict)
        self.world_size = int(world_size) if world_size is not None \
            else _default_dp_world_size()
        self._reject_unported(self._param_dict)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_error_check()

    @staticmethod
    def _reject_unported(d):
        for key, slice_name in c.NOT_PORTED_BLOCKS.items():
            if _is_set(d.get(key)):
                raise DeepSpeedConfigError(
                    f"the '{key}' config block is not ported yet (it comes "
                    f"with the {slice_name} slice; see ROADMAP.md)")

    @staticmethod
    def _check_lean_state(zero_block):
        """The JAX engine's refusals of ``fp16_master_weights_and_grads``,
        with its messages and in its order: with a ZeRO stage (which
        shards the fp32 master layout), then with the host-offload tier.
        Checked before the zero block is parsed, so an offload block gets
        this message and not its own "not ported"."""
        if zero_block is True:
            zero_block = {zc.ZERO_OPTIMIZATION_STAGE: 1}
        if not isinstance(zero_block, dict):
            return
        stage = as_int(zero_block.get(zc.ZERO_OPTIMIZATION_STAGE,
                                      zc.ZERO_OPTIMIZATION_STAGE_DEFAULT),
                       zc.ZERO_OPTIMIZATION_STAGE)
        if stage > zc.ZERO_OPTIMIZATION_DISABLED:
            raise DeepSpeedConfigError(
                "fp16_master_weights_and_grads with ZeRO stages is not "
                "supported: ZeRO shards the fp32 master layout; use "
                "stage 0, or drop the flag")
        if zero_block.get(zc.OFFLOAD_OPTIMIZER) is not None or \
                zero_block.get(zc.ZERO_OPTIMIZATION_CPU_OFFLOAD):
            raise DeepSpeedConfigError(
                "fp16_master_weights_and_grads is a device-state knob; "
                "the host-offload tier keeps fp32 masters in DRAM by "
                "design (drop the flag or the offload block)")

    def _initialize_params(self, d):
        self.train_batch_size = d.get(c.TRAIN_BATCH_SIZE,
                                      c.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = d.get(
            c.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            c.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = d.get(
            c.GRADIENT_ACCUMULATION_STEPS,
            c.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = as_int(
            d.get(c.STEPS_PER_PRINT, c.STEPS_PER_PRINT_DEFAULT),
            c.STEPS_PER_PRINT)
        self.gradient_predivide_factor = float(
            d.get(c.GRADIENT_PREDIVIDE_FACTOR,
                  c.GRADIENT_PREDIVIDE_FACTOR_DEFAULT))

        # Later-DeepSpeed key (the JAX engine's lean state): no separate
        # fp32 master copy; the compute-dtype parameters are the masters
        # and the gradients stay in the compute dtype.
        self.fp16_master_weights_and_grads = bool(
            (d.get(c.FP16) or {}).get(c.FP16_MASTER_WEIGHTS_AND_GRADS,
                                      False))
        if self.fp16_master_weights_and_grads:
            self._check_lean_state(d.get(zc.ZERO_OPTIMIZATION))
        self.zero_config = DeepSpeedZeroConfig.from_dict(d)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_config.enabled

        # Parse validates knob types and the remat-policy name against
        # the registry (unknown names raise with the valid choices);
        # `number_checkpoints <= num_layers` is enforced model-side where
        # the layer count is known (models.gpt_neox.
        # apply_activation_checkpointing_config).
        self.activation_checkpointing_config = (
            DeepSpeedActivationCheckpointingConfig.from_dict(d))
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig.from_dict(d)

        # Mixed precision. "fp16" block carries both fp16 and bf16 (fork).
        fp16 = d.get(c.FP16) or {}
        self.fp16_enabled = bool(
            fp16.get(c.FP16_ENABLED, c.FP16_ENABLED_DEFAULT))
        self.precision = (resolve_precision(
            fp16.get(c.FP16_TYPE, c.FP16_TYPE_DEFAULT))
            if self.fp16_enabled else resolve_precision("float32"))
        self.bfloat16_enabled = self.precision == resolve_precision("bf16")
        self.loss_scale = fp16.get(c.FP16_LOSS_SCALE,
                                   c.FP16_LOSS_SCALE_DEFAULT)
        self.initial_dynamic_scale = 2 ** as_int(
            fp16.get(c.FP16_INITIAL_SCALE_POWER,
                     c.FP16_INITIAL_SCALE_POWER_DEFAULT),
            c.FP16_INITIAL_SCALE_POWER)
        self.dynamic_loss_scale_args = {
            c.FP16_INITIAL_SCALE_POWER: as_int(
                fp16.get(c.FP16_INITIAL_SCALE_POWER,
                         c.FP16_INITIAL_SCALE_POWER_DEFAULT),
                c.FP16_INITIAL_SCALE_POWER),
            c.FP16_LOSS_SCALE_WINDOW: as_int(
                fp16.get(c.FP16_LOSS_SCALE_WINDOW,
                         c.FP16_LOSS_SCALE_WINDOW_DEFAULT),
                c.FP16_LOSS_SCALE_WINDOW),
            c.FP16_HYSTERESIS: as_int(
                fp16.get(c.FP16_HYSTERESIS, c.FP16_HYSTERESIS_DEFAULT),
                c.FP16_HYSTERESIS),
            c.FP16_MIN_LOSS_SCALE: fp16.get(c.FP16_MIN_LOSS_SCALE,
                                            c.FP16_MIN_LOSS_SCALE_DEFAULT),
        } if self.fp16_enabled else None
        # bf16/fp32 never need loss scaling even when configured.
        self.loss_scaling_enabled = (
            self.fp16_enabled and
            self.precision == resolve_precision("fp16"))
        # Consecutive overflow-skipped steps tolerated at the
        # min_loss_scale floor before a loud error (0 = warn-only; see
        # fp16/loss_scaler.ScaleFloorWatch).
        self.min_scale_patience = as_int(
            fp16.get(c.FP16_MIN_SCALE_PATIENCE,
                     c.FP16_MIN_SCALE_PATIENCE_DEFAULT),
            f"fp16.{c.FP16_MIN_SCALE_PATIENCE}")
        if self.min_scale_patience < 0:
            raise DeepSpeedConfigError(
                f"fp16.{c.FP16_MIN_SCALE_PATIENCE} must be >= 0 "
                f"(0 = warn-only), got {self.min_scale_patience}")

        # the "amp" block: parsed as the JAX package parses it (nothing
        # there reads it beyond the two attributes)
        amp = d.get(c.AMP) or {}
        self.amp_enabled = bool(amp.get(c.AMP_ENABLED, c.AMP_ENABLED_DEFAULT))
        self.amp_params = {k: v for k, v in amp.items()
                           if k != c.AMP_ENABLED}

        self.gradient_clipping = float(
            d.get(c.GRADIENT_CLIPPING, c.GRADIENT_CLIPPING_DEFAULT))
        self.prescale_gradients = bool(
            d.get(c.PRESCALE_GRADIENTS, c.PRESCALE_GRADIENTS_DEFAULT))
        # bf16 gradients default to fp32-upcast reductions (the fork's
        # rule, as the JAX config)
        self.fp32_allreduce = bool(d.get(
            c.FP32_ALLREDUCE, c.FP32_ALLREDUCE_DEFAULT_BF16
            if self.bfloat16_enabled else c.FP32_ALLREDUCE_DEFAULT))
        self.sparse_gradients_enabled = bool(
            d.get(c.SPARSE_GRADIENTS, c.SPARSE_GRADIENTS_DEFAULT))

        optimizer = d.get(c.OPTIMIZER)
        if optimizer is not None:
            self.optimizer_name = str(optimizer.get(c.TYPE, "")).lower() or None
            self.optimizer_params = dict(optimizer.get(c.OPTIMIZER_PARAMS, {}))
        else:
            self.optimizer_name = c.OPTIMIZER_TYPE_DEFAULT
            self.optimizer_params = None
        self.zero_allow_untested_optimizer = bool(
            d.get(c.ZERO_ALLOW_UNTESTED_OPTIMIZER,
                  c.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT))

        scheduler = d.get(c.SCHEDULER)
        if scheduler is not None:
            self.scheduler_name = scheduler.get(c.TYPE)
            self.scheduler_params = dict(scheduler.get(c.SCHEDULER_PARAMS, {}))
        else:
            self.scheduler_name = c.SCHEDULER_TYPE_DEFAULT
            self.scheduler_params = None

        self.wall_clock_breakdown = bool(
            d.get(c.WALL_CLOCK_BREAKDOWN, c.WALL_CLOCK_BREAKDOWN_DEFAULT))
        self.memory_breakdown = bool(
            d.get(c.MEMORY_BREAKDOWN, c.MEMORY_BREAKDOWN_DEFAULT))

        tb = d.get(c.TENSORBOARD) or {}
        self.tensorboard_enabled = bool(
            tb.get(c.TENSORBOARD_ENABLED, c.TENSORBOARD_ENABLED_DEFAULT))
        self.tensorboard_output_path = tb.get(
            c.TENSORBOARD_OUTPUT_PATH, c.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.tensorboard_job_name = tb.get(c.TENSORBOARD_JOB_NAME,
                                           c.TENSORBOARD_JOB_NAME_DEFAULT)
        self._parse_monitor_block(d)

        # Fork additions: gradient storage for debugging.
        self.store_gradients = bool(
            d.get(c.STORE_GRADIENTS, c.STORE_GRADIENTS_DEFAULT))
        self.store_gradients_cpu = bool(
            d.get(c.STORE_GRADIENTS_CPU, c.STORE_GRADIENTS_CPU_DEFAULT))

        self.inference_params = parse_inference_block(d)
        # Online-RL driver (deeperspeed_tpu_torch/rl); module-level parse
        # so RLDriver validates raw dicts identically.
        self.rl_params = parse_rl_block(d)
        self.rl_enabled = bool(self.rl_params)
        self.sparse_attention = _parse_sparse_attention(d)
        self._parse_packing_block(d)
        self._parse_moe_block(d)

        pld = d.get(c.PROGRESSIVE_LAYER_DROP) or {}
        self.pld_enabled = bool(pld.get(c.PLD_ENABLED, c.PLD_ENABLED_DEFAULT))
        self.pld_params = {
            c.PLD_THETA: pld.get(c.PLD_THETA, c.PLD_THETA_DEFAULT),
            c.PLD_GAMMA: pld.get(c.PLD_GAMMA, c.PLD_GAMMA_DEFAULT),
        } if self.pld_enabled else False

        bs_sched = d.get(c.BATCH_SIZE_SCHEDULE) or {}
        self.batch_size_schedule_enabled = bool(
            bs_sched.get(c.BS_SCHEDULE_ENABLED, c.BS_SCHEDULE_ENABLED_DEFAULT))
        self.batch_size_schedule_params = dict(
            bs_sched.get(c.BS_SCHEDULE_PARAMS, {}))

        self._parse_checkpoint_block(d)
        self._parse_training_health_block(d)
        self._parse_telemetry_block(d)

        # the low-precision paths (the module-level parse, shared with the
        # serving engine): the engine arms "ffn"; "weights" is parsed and
        # read by nothing in training, as in the JAX engine
        self.quantization_config = parse_quantization_block(d) or None
        if self.quantization_config and \
                self.quantization_config["gradient_compression"]:
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_GRAD_COMPRESSION} is "
                f"not ported yet (it comes with the scale-out (A.7) slice: "
                f"it needs the explicit ZeRO-3 schedule and a "
                f"data-parallel world; see ROADMAP.md)")

    def _parse_packing_block(self, d):
        """Parse + validate the "packing" block (`runtime/packing.py`:
        document-packed ragged batches with segment ids) with the JAX
        package's keys, defaults and messages: a typo'd knob fails at
        start-up, not by training with cross-document attention. The
        block makes the model REQUIRE (tokens, labels, segment_ids)
        batches."""
        pk = d.get(c.PACKING) or {}
        known = {c.PACKING_ENABLED, c.PACKING_PAD_ID, c.PACKING_DROP_TAIL}
        unknown = sorted(set(pk) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown 'packing' key(s) {unknown}; valid keys: "
                f"{sorted(known)}")

        enabled = pk.get(c.PACKING_ENABLED, c.PACKING_ENABLED_DEFAULT)
        if not isinstance(enabled, bool):
            raise DeepSpeedConfigError(
                f"packing.{c.PACKING_ENABLED} must be a boolean, got "
                f"{enabled!r}")
        self.packing_enabled = enabled
        if not enabled:
            self.packing_params = False
            return

        pad_id = as_int(pk.get(c.PACKING_PAD_ID, c.PACKING_PAD_ID_DEFAULT),
                        f"packing.{c.PACKING_PAD_ID}")
        if pad_id < 0:
            raise DeepSpeedConfigError(
                f"packing.{c.PACKING_PAD_ID} must be >= 0, got {pad_id}")
        drop_tail = pk.get(c.PACKING_DROP_TAIL,
                           c.PACKING_DROP_TAIL_DEFAULT)
        if not isinstance(drop_tail, bool):
            raise DeepSpeedConfigError(
                f"packing.{c.PACKING_DROP_TAIL} must be a boolean, got "
                f"{drop_tail!r}")
        if self.sparse_attention:
            # the block-sparse kernels carry no segment gate: a packed
            # batch through them would silently attend across documents
            raise DeepSpeedConfigError(
                "packing cannot be combined with sparse_attention: the "
                "sparse kernels are not segment-aware (use the dense "
                "segmented flash engine for packed batches)")
        self.packing_params = {
            "pad_id": pad_id,
            "drop_tail": drop_tail,
        }

    def _parse_checkpoint_block(self, d):
        """Parse + validate the "checkpoint" block with the JAX package's
        keys, defaults and messages: tag validation plus the async-save
        knobs (`checkpoint/async_manager.py`). A mistyped retention knob
        fails at start-up, not at the first save."""
        ckpt = d.get(c.CHECKPOINT) or {}
        known = {c.CHECKPOINT_TAG_VALIDATION, c.CHECKPOINT_SAVE_DIR,
                 c.CHECKPOINT_ASYNC_SAVE, c.CHECKPOINT_SAVE_INTERVAL,
                 c.CHECKPOINT_KEEP_LAST_N, c.CHECKPOINT_KEEP_EVERY_N_STEPS,
                 c.CHECKPOINT_SAVE_ON_PREEMPTION}
        unknown = sorted(set(ckpt) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown 'checkpoint' key(s) {unknown}; valid keys: "
                f"{sorted(known)}")

        self.checkpoint_tag_validation_mode = str(
            ckpt.get(c.CHECKPOINT_TAG_VALIDATION,
                     c.CHECKPOINT_TAG_VALIDATION_DEFAULT)).upper()
        if self.checkpoint_tag_validation_mode not in \
                c.CHECKPOINT_TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError(
                f"checkpoint.{c.CHECKPOINT_TAG_VALIDATION} must be one of "
                f"{c.CHECKPOINT_TAG_VALIDATION_MODES}, got "
                f"{self.checkpoint_tag_validation_mode!r}")
        self.checkpoint_tag_validation_enabled = (
            self.checkpoint_tag_validation_mode != c.ValidationMode.IGNORE)
        self.checkpoint_tag_validation_fail = (
            self.checkpoint_tag_validation_mode == c.ValidationMode.FAIL)

        save_dir = ckpt.get(c.CHECKPOINT_SAVE_DIR,
                            c.CHECKPOINT_SAVE_DIR_DEFAULT)
        if save_dir is not None and not isinstance(save_dir, str):
            raise DeepSpeedConfigError(
                f"checkpoint.{c.CHECKPOINT_SAVE_DIR} must be a string "
                f"path, got {save_dir!r}")
        for key, default in ((c.CHECKPOINT_ASYNC_SAVE,
                              c.CHECKPOINT_ASYNC_SAVE_DEFAULT),
                             (c.CHECKPOINT_SAVE_ON_PREEMPTION,
                              c.CHECKPOINT_SAVE_ON_PREEMPTION_DEFAULT)):
            if not isinstance(ckpt.get(key, default), bool):
                raise DeepSpeedConfigError(
                    f"checkpoint.{key} must be a boolean, got "
                    f"{ckpt.get(key)!r}")
        ints = {}
        for key, default in ((c.CHECKPOINT_SAVE_INTERVAL,
                              c.CHECKPOINT_SAVE_INTERVAL_DEFAULT),
                             (c.CHECKPOINT_KEEP_LAST_N,
                              c.CHECKPOINT_KEEP_LAST_N_DEFAULT),
                             (c.CHECKPOINT_KEEP_EVERY_N_STEPS,
                              c.CHECKPOINT_KEEP_EVERY_N_STEPS_DEFAULT)):
            value = as_int(ckpt.get(key, default), f"checkpoint.{key}")
            if value < 0:
                raise DeepSpeedConfigError(
                    f"checkpoint.{key} must be >= 0 (0 disables), got "
                    f"{value}")
            ints[key] = value
        save_on_preemption = ckpt.get(c.CHECKPOINT_SAVE_ON_PREEMPTION,
                                      c.CHECKPOINT_SAVE_ON_PREEMPTION_DEFAULT)
        if save_dir is None and (ints[c.CHECKPOINT_SAVE_INTERVAL]
                                 or save_on_preemption):
            raise DeepSpeedConfigError(
                f"checkpoint.{c.CHECKPOINT_SAVE_DIR} is required when "
                f"{c.CHECKPOINT_SAVE_INTERVAL} or "
                f"{c.CHECKPOINT_SAVE_ON_PREEMPTION} is set (auto/emergency "
                "saves need somewhere to write)")
        self.checkpoint_config = {
            "save_dir": save_dir,
            "async_save": ckpt.get(c.CHECKPOINT_ASYNC_SAVE,
                                   c.CHECKPOINT_ASYNC_SAVE_DEFAULT),
            "save_interval_steps": ints[c.CHECKPOINT_SAVE_INTERVAL],
            "keep_last_n": ints[c.CHECKPOINT_KEEP_LAST_N],
            "keep_every_n_steps": ints[c.CHECKPOINT_KEEP_EVERY_N_STEPS],
            "save_on_preemption": save_on_preemption,
        }

    def _parse_training_health_block(self, d):
        """Parse + validate the "training_health" block (runtime/
        sentinel.py + runtime/fault_injection.py) with the JAX package's
        keys, defaults, bounds and messages. Same parse-time strictness
        as the "checkpoint" block: a mistyped threshold or policy must
        fail at startup, not at the first (hours-away) anomaly. Runs
        AFTER _parse_checkpoint_block: the rollback policy
        cross-validates against checkpoint.save_dir."""
        th = d.get(c.TRAINING_HEALTH) or {}
        known = {c.TRAINING_HEALTH_ENABLED, c.TRAINING_HEALTH_POLICY,
                 c.TRAINING_HEALTH_LOSS_ZSCORE,
                 c.TRAINING_HEALTH_GRAD_NORM_ZSCORE,
                 c.TRAINING_HEALTH_EMA_BETA,
                 c.TRAINING_HEALTH_WARMUP_STEPS,
                 c.TRAINING_HEALTH_ROLLBACK_AFTER,
                 c.TRAINING_HEALTH_ABORT_AFTER,
                 c.TRAINING_HEALTH_MAX_ROLLBACKS,
                 c.TRAINING_HEALTH_HANG_TIMEOUT,
                 c.TRAINING_HEALTH_FAULT_INJECTION}
        unknown = sorted(set(th) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown 'training_health' key(s) {unknown}; valid "
                f"keys: {sorted(known)}")

        enabled = th.get(c.TRAINING_HEALTH_ENABLED,
                         c.TRAINING_HEALTH_ENABLED_DEFAULT)
        if not isinstance(enabled, bool):
            raise DeepSpeedConfigError(
                f"training_health.{c.TRAINING_HEALTH_ENABLED} must be a "
                f"boolean, got {enabled!r}")

        from .sentinel import POLICIES
        policy = th.get(c.TRAINING_HEALTH_POLICY,
                        c.TRAINING_HEALTH_POLICY_DEFAULT)
        if policy not in POLICIES:
            raise DeepSpeedConfigError(
                f"training_health.{c.TRAINING_HEALTH_POLICY} must be one "
                f"of {list(POLICIES)}, got {policy!r}")

        floats = {}
        for key, default, lo, hi in (
                (c.TRAINING_HEALTH_LOSS_ZSCORE,
                 c.TRAINING_HEALTH_LOSS_ZSCORE_DEFAULT, 0.0, None),
                (c.TRAINING_HEALTH_GRAD_NORM_ZSCORE,
                 c.TRAINING_HEALTH_GRAD_NORM_ZSCORE_DEFAULT, 0.0, None),
                (c.TRAINING_HEALTH_EMA_BETA,
                 c.TRAINING_HEALTH_EMA_BETA_DEFAULT, 0.0, 1.0),
                (c.TRAINING_HEALTH_HANG_TIMEOUT,
                 c.TRAINING_HEALTH_HANG_TIMEOUT_DEFAULT, 0.0, None)):
            value = th.get(key, default)
            if not isinstance(value, (int, float)) or \
                    isinstance(value, bool):
                raise DeepSpeedConfigError(
                    f"training_health.{key} must be a number, got "
                    f"{value!r}")
            value = float(value)
            if value < lo or (hi is not None and value >= hi):
                bound = f">= {lo}" if hi is None else f"in [{lo}, {hi})"
                raise DeepSpeedConfigError(
                    f"training_health.{key} must be {bound}, got {value}")
            floats[key] = value

        ints = {}
        for key, default, lo in (
                (c.TRAINING_HEALTH_WARMUP_STEPS,
                 c.TRAINING_HEALTH_WARMUP_STEPS_DEFAULT, 0),
                (c.TRAINING_HEALTH_ROLLBACK_AFTER,
                 c.TRAINING_HEALTH_ROLLBACK_AFTER_DEFAULT, 1),
                (c.TRAINING_HEALTH_ABORT_AFTER,
                 c.TRAINING_HEALTH_ABORT_AFTER_DEFAULT, 1),
                (c.TRAINING_HEALTH_MAX_ROLLBACKS,
                 c.TRAINING_HEALTH_MAX_ROLLBACKS_DEFAULT, 0)):
            value = as_int(th.get(key, default), f"training_health.{key}")
            if value < lo:
                raise DeepSpeedConfigError(
                    f"training_health.{key} must be >= {lo}, got {value}")
            ints[key] = value

        if enabled and policy == "rollback" and \
                self.checkpoint_config["save_dir"] is None:
            raise DeepSpeedConfigError(
                "training_health.policy 'rollback' requires "
                "checkpoint.save_dir: recovery restores the last "
                "committed checkpoint from there")

        fault_spec = th.get(c.TRAINING_HEALTH_FAULT_INJECTION)
        if fault_spec is not None:
            from .fault_injection import validate_fault_spec
            validate_fault_spec(fault_spec)   # parse-time strictness

        self.training_health_enabled = enabled
        self.training_health_config = {
            "enabled": enabled,
            "policy": policy,
            "loss_zscore": floats[c.TRAINING_HEALTH_LOSS_ZSCORE],
            "grad_norm_zscore":
                floats[c.TRAINING_HEALTH_GRAD_NORM_ZSCORE],
            "ema_beta": floats[c.TRAINING_HEALTH_EMA_BETA],
            "warmup_steps": ints[c.TRAINING_HEALTH_WARMUP_STEPS],
            "rollback_after": ints[c.TRAINING_HEALTH_ROLLBACK_AFTER],
            "abort_after": ints[c.TRAINING_HEALTH_ABORT_AFTER],
            "max_rollbacks": ints[c.TRAINING_HEALTH_MAX_ROLLBACKS],
            "hang_timeout_seconds": floats[c.TRAINING_HEALTH_HANG_TIMEOUT],
            "fault_injection": fault_spec,
        }

    def _parse_telemetry_block(self, d):
        """Parse + validate the "telemetry" block (runtime/telemetry.py:
        span tracing, goodput + MFU accounting, trigger-driven profiler
        capture) with the JAX package's keys, defaults and messages: a
        mistyped capture window must fail at startup, not silently never
        trace. A set ``fleet`` sub-block (the cross-host layer) raises
        "not ported". A static method's body: the serving engine runs it
        with a bare namespace as ``self``."""
        tel = d.get(c.TELEMETRY) or {}
        known = {c.TELEMETRY_ENABLED, c.TELEMETRY_GOODPUT, c.TELEMETRY_MFU,
                 c.TELEMETRY_SPANS, c.TELEMETRY_TRACE_DIR,
                 c.TELEMETRY_CAPTURE, c.TELEMETRY_MEMORY_WATERMARK_INTERVAL,
                 c.TELEMETRY_CAPTURE_ON_ANOMALY,
                 c.TELEMETRY_ANOMALY_CAPTURE_STEPS, c.TELEMETRY_FLEET}
        unknown = sorted(set(tel) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown 'telemetry' key(s) {unknown}; valid keys: "
                f"{sorted(known)}")

        bools = {}
        for key, default in (
                (c.TELEMETRY_ENABLED, c.TELEMETRY_ENABLED_DEFAULT),
                (c.TELEMETRY_GOODPUT, c.TELEMETRY_GOODPUT_DEFAULT),
                (c.TELEMETRY_MFU, c.TELEMETRY_MFU_DEFAULT),
                (c.TELEMETRY_SPANS, c.TELEMETRY_SPANS_DEFAULT),
                (c.TELEMETRY_CAPTURE_ON_ANOMALY,
                 c.TELEMETRY_CAPTURE_ON_ANOMALY_DEFAULT)):
            value = tel.get(key, default)
            if not isinstance(value, bool):
                raise DeepSpeedConfigError(
                    f"telemetry.{key} must be a boolean, got {value!r}")
            bools[key] = value

        trace_dir = tel.get(c.TELEMETRY_TRACE_DIR,
                            c.TELEMETRY_TRACE_DIR_DEFAULT)
        if trace_dir is not None and not isinstance(trace_dir, str):
            raise DeepSpeedConfigError(
                f"telemetry.{c.TELEMETRY_TRACE_DIR} must be a string "
                f"path, got {trace_dir!r}")

        capture = tel.get(c.TELEMETRY_CAPTURE)
        if capture is not None:
            if not isinstance(capture, dict):
                raise DeepSpeedConfigError(
                    f"telemetry.{c.TELEMETRY_CAPTURE} must be an object "
                    "{start_step, num_steps}, got "
                    f"{type(capture).__name__}")
            cap_known = {c.TELEMETRY_CAPTURE_START_STEP,
                         c.TELEMETRY_CAPTURE_NUM_STEPS}
            cap_unknown = sorted(set(capture) - cap_known)
            if cap_unknown:
                raise DeepSpeedConfigError(
                    f"Unknown telemetry.{c.TELEMETRY_CAPTURE} key(s) "
                    f"{cap_unknown}; valid keys: {sorted(cap_known)}")
            if c.TELEMETRY_CAPTURE_START_STEP not in capture:
                raise DeepSpeedConfigError(
                    f"telemetry.{c.TELEMETRY_CAPTURE} requires "
                    f"{c.TELEMETRY_CAPTURE_START_STEP}")
            start = as_int(capture[c.TELEMETRY_CAPTURE_START_STEP],
                           f"telemetry.capture."
                           f"{c.TELEMETRY_CAPTURE_START_STEP}")
            num = as_int(capture.get(c.TELEMETRY_CAPTURE_NUM_STEPS,
                                     c.TELEMETRY_CAPTURE_NUM_STEPS_DEFAULT),
                         f"telemetry.capture."
                         f"{c.TELEMETRY_CAPTURE_NUM_STEPS}")
            if start < 0:
                raise DeepSpeedConfigError(
                    f"telemetry.capture.{c.TELEMETRY_CAPTURE_START_STEP} "
                    f"must be >= 0, got {start}")
            if num < 1:
                raise DeepSpeedConfigError(
                    f"telemetry.capture.{c.TELEMETRY_CAPTURE_NUM_STEPS} "
                    f"must be >= 1, got {num}")
            capture = {c.TELEMETRY_CAPTURE_START_STEP: start,
                       c.TELEMETRY_CAPTURE_NUM_STEPS: num}

        watermark = as_int(
            tel.get(c.TELEMETRY_MEMORY_WATERMARK_INTERVAL,
                    c.TELEMETRY_MEMORY_WATERMARK_INTERVAL_DEFAULT),
            f"telemetry.{c.TELEMETRY_MEMORY_WATERMARK_INTERVAL}")
        if watermark < 0:
            raise DeepSpeedConfigError(
                f"telemetry.{c.TELEMETRY_MEMORY_WATERMARK_INTERVAL} must "
                f"be >= 0 (0 disables), got {watermark}")
        anomaly_steps = as_int(
            tel.get(c.TELEMETRY_ANOMALY_CAPTURE_STEPS,
                    c.TELEMETRY_ANOMALY_CAPTURE_STEPS_DEFAULT),
            f"telemetry.{c.TELEMETRY_ANOMALY_CAPTURE_STEPS}")
        if anomaly_steps < 1:
            raise DeepSpeedConfigError(
                f"telemetry.{c.TELEMETRY_ANOMALY_CAPTURE_STEPS} must be "
                f">= 1, got {anomaly_steps}")

        fleet = tel.get(c.TELEMETRY_FLEET)
        if fleet is not None and not isinstance(fleet, dict):
            raise DeepSpeedConfigError(
                f"telemetry.{c.TELEMETRY_FLEET} must be an object, got "
                f"{type(fleet).__name__}")
        if fleet is not None and fleet.get("enabled", False) is not False:
            raise DeepSpeedConfigError(
                f"telemetry.{c.TELEMETRY_FLEET} is not ported yet (it comes "
                f"with the fleet (A.8.3) slice: the cross-host aggregation "
                f"needs more than one rank; see ROADMAP.md)")

        needs_dir = capture is not None or \
            bools[c.TELEMETRY_CAPTURE_ON_ANOMALY]
        if bools[c.TELEMETRY_ENABLED] and needs_dir and trace_dir is None:
            raise DeepSpeedConfigError(
                f"telemetry.{c.TELEMETRY_TRACE_DIR} is required when "
                f"'{c.TELEMETRY_CAPTURE}' or "
                f"'{c.TELEMETRY_CAPTURE_ON_ANOMALY}' is set (captures "
                "need somewhere to write)")

        self.telemetry_enabled = bools[c.TELEMETRY_ENABLED]
        self.telemetry_config = {
            "enabled": bools[c.TELEMETRY_ENABLED],
            "goodput": bools[c.TELEMETRY_GOODPUT],
            "mfu": bools[c.TELEMETRY_MFU],
            "spans": bools[c.TELEMETRY_SPANS],
            "trace_dir": trace_dir,
            "capture": capture,
            "memory_watermark_interval_steps": watermark,
            "capture_on_anomaly": bools[c.TELEMETRY_CAPTURE_ON_ANOMALY],
            "anomaly_capture_steps": anomaly_steps,
        }

    def _parse_monitor_block(self, d):
        """Parse + validate the ``monitor`` block (runtime/exporters.py:
        the Prometheus endpoint, the JSONL event stream, and event-file
        rotation). Same parse-time strictness as the telemetry block —
        a mistyped port must fail at startup, not silently never serve
        a scrape."""
        mon = d.get(c.MONITOR) or {}
        known = {c.MONITOR_EXPORT}
        unknown = sorted(set(mon) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown 'monitor' key(s) {unknown}; valid keys: "
                f"{sorted(known)}")
        exp = mon.get(c.MONITOR_EXPORT) or {}
        if not isinstance(exp, dict):
            raise DeepSpeedConfigError(
                f"monitor.{c.MONITOR_EXPORT} must be an object, got "
                f"{type(exp).__name__}")
        exp_known = {c.MONITOR_PROMETHEUS_PORT, c.MONITOR_PROMETHEUS_HOST,
                     c.MONITOR_JSONL, c.MONITOR_ROTATE_MAX_MB,
                     c.MONITOR_ROTATE_KEEP}
        exp_unknown = sorted(set(exp) - exp_known)
        if exp_unknown:
            raise DeepSpeedConfigError(
                f"Unknown monitor.{c.MONITOR_EXPORT} key(s) "
                f"{exp_unknown}; valid keys: {sorted(exp_known)}")
        port = exp.get(c.MONITOR_PROMETHEUS_PORT,
                       c.MONITOR_PROMETHEUS_PORT_DEFAULT)
        if port is not None:
            port = as_int(port,
                          f"monitor.export.{c.MONITOR_PROMETHEUS_PORT}")
            if not 0 <= port <= 65535:
                raise DeepSpeedConfigError(
                    f"monitor.export.{c.MONITOR_PROMETHEUS_PORT} must be "
                    f"in [0, 65535] (0 = ephemeral), got {port}")
        jsonl = exp.get(c.MONITOR_JSONL, c.MONITOR_JSONL_DEFAULT)
        if not isinstance(jsonl, bool):
            raise DeepSpeedConfigError(
                f"monitor.export.{c.MONITOR_JSONL} must be a boolean, "
                f"got {jsonl!r}")
        try:
            rotate_mb = float(exp.get(c.MONITOR_ROTATE_MAX_MB,
                                      c.MONITOR_ROTATE_MAX_MB_DEFAULT))
        except (TypeError, ValueError):
            raise DeepSpeedConfigError(
                f"monitor.export.{c.MONITOR_ROTATE_MAX_MB} must be a "
                f"number (MB; 0 disables rotation), got "
                f"{exp.get(c.MONITOR_ROTATE_MAX_MB)!r}")
        if rotate_mb < 0:
            raise DeepSpeedConfigError(
                f"monitor.export.{c.MONITOR_ROTATE_MAX_MB} must be >= 0, "
                f"got {rotate_mb}")
        keep = as_int(exp.get(c.MONITOR_ROTATE_KEEP,
                              c.MONITOR_ROTATE_KEEP_DEFAULT),
                      f"monitor.export.{c.MONITOR_ROTATE_KEEP}")
        if keep < 1:
            raise DeepSpeedConfigError(
                f"monitor.export.{c.MONITOR_ROTATE_KEEP} must be >= 1, "
                f"got {keep}")
        host = exp.get(c.MONITOR_PROMETHEUS_HOST,
                       c.MONITOR_PROMETHEUS_HOST_DEFAULT)
        if not isinstance(host, str) or not host:
            raise DeepSpeedConfigError(
                f"monitor.export.{c.MONITOR_PROMETHEUS_HOST} must be a "
                f"non-empty bind address string (default 127.0.0.1; "
                f"0.0.0.0 exposes the scrape off-box), got {host!r}")
        self.monitor_export_config = {
            "prometheus_port": port,
            "prometheus_host": host,
            "jsonl": jsonl,
            "rotate_max_mb": rotate_mb,
            "rotate_keep": keep,
        }
        # an armed export backend means the user wants the monitor even
        # without a tensorboard block — the engine constructs it either
        # way (the parser's contract: a configured exporter must serve,
        # not silently depend on an unrelated block)
        self.monitor_export_active = port is not None or jsonl

    def _parse_moe_block(self, d):
        """Parse + validate the "moe" block with the JAX package's keys,
        defaults and messages. ``observability: true`` (sort dispatch
        only) makes the sort engine emit its routing statistics, which the
        engine drains into the ``Train/MoE/*`` scalars."""
        moe = d.get(c.MOE) or {}
        known = {c.MOE_ENABLED, c.MOE_NUM_EXPERTS, c.MOE_TOP_K,
                 c.MOE_CAPACITY_FACTOR, c.MOE_JITTER_EPS,
                 c.MOE_AUX_LOSS_COEF, c.MOE_NUM_GROUPS, c.MOE_DISPATCH,
                 c.MOE_A2A_OVERLAP_CHUNKS, c.MOE_RENORM_KEPT_CHOICES,
                 c.MOE_OBSERVABILITY}
        unknown = sorted(set(moe) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown 'moe' key(s) {unknown}; valid keys: "
                f"{sorted(known)}")

        self.moe_enabled = bool(moe.get(c.MOE_ENABLED,
                                        moe.get(c.MOE_NUM_EXPERTS, 0)))
        if not self.moe_enabled:
            self.moe_params = False
            return

        num_experts = as_int(moe.get(c.MOE_NUM_EXPERTS, 0),
                             f"moe.{c.MOE_NUM_EXPERTS}")
        if num_experts <= 0:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_NUM_EXPERTS} must be a positive int, got "
                f"{moe.get(c.MOE_NUM_EXPERTS)!r}")
        top_k = as_int(moe.get(c.MOE_TOP_K, c.MOE_TOP_K_DEFAULT),
                       f"moe.{c.MOE_TOP_K}")
        if top_k not in c.MOE_TOP_K_CHOICES:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_TOP_K} must be one of "
                f"{list(c.MOE_TOP_K_CHOICES)} (1 = Switch, 2 = GShard), "
                f"got {top_k}")

        def as_float(key, default):
            try:
                return float(moe.get(key, default))
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"moe.{key} must be a number, got {moe.get(key)!r}")

        capacity_factor = as_float(c.MOE_CAPACITY_FACTOR,
                                   c.MOE_CAPACITY_FACTOR_DEFAULT)
        if not capacity_factor > 0:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_CAPACITY_FACTOR} must be > 0, got "
                f"{capacity_factor}")
        jitter_eps = as_float(c.MOE_JITTER_EPS, c.MOE_JITTER_EPS_DEFAULT)
        if jitter_eps < 0:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_JITTER_EPS} must be >= 0, got {jitter_eps}")
        aux_loss_coef = as_float(c.MOE_AUX_LOSS_COEF,
                                 c.MOE_AUX_LOSS_COEF_DEFAULT)
        if aux_loss_coef < 0:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_AUX_LOSS_COEF} must be >= 0 (a negative "
                f"coefficient actively unbalances experts), got "
                f"{aux_loss_coef}")
        num_groups = as_int(moe.get(c.MOE_NUM_GROUPS,
                                    c.MOE_NUM_GROUPS_DEFAULT),
                            f"moe.{c.MOE_NUM_GROUPS}")
        if num_groups < 0:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_NUM_GROUPS} must be >= 0 (0 = auto), got "
                f"{num_groups}")
        dispatch = str(moe.get(c.MOE_DISPATCH, c.MOE_DISPATCH_DEFAULT))
        if dispatch not in c.MOE_DISPATCH_MODES:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_DISPATCH} must be one of "
                f"{list(c.MOE_DISPATCH_MODES)}, got {dispatch!r}")
        a2a_chunks = as_int(moe.get(c.MOE_A2A_OVERLAP_CHUNKS,
                                    c.MOE_A2A_OVERLAP_CHUNKS_DEFAULT),
                            f"moe.{c.MOE_A2A_OVERLAP_CHUNKS}")
        if a2a_chunks < 1:
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_A2A_OVERLAP_CHUNKS} must be >= 1, got "
                f"{a2a_chunks}")
        renorm = moe.get(c.MOE_RENORM_KEPT_CHOICES,
                         c.MOE_RENORM_KEPT_CHOICES_DEFAULT)
        if not isinstance(renorm, bool):
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_RENORM_KEPT_CHOICES} must be a boolean, "
                f"got {renorm!r}")
        observability = moe.get(c.MOE_OBSERVABILITY,
                                c.MOE_OBSERVABILITY_DEFAULT)
        if not isinstance(observability, bool):
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_OBSERVABILITY} must be a boolean, got "
                f"{observability!r}")
        if observability and dispatch != "sort":
            raise DeepSpeedConfigError(
                f"moe.{c.MOE_OBSERVABILITY} requires moe.dispatch="
                f"\"sort\": the expert-load / capacity-drop statistics "
                f"come from the sort engine's position-in-expert "
                f"bookkeeping (got dispatch={dispatch!r})")

        self.moe_params = {
            "num_experts": num_experts,
            "top_k": top_k,
            "capacity_factor": capacity_factor,
            "jitter_eps": jitter_eps,
            "aux_loss_coef": aux_loss_coef,
            "num_groups": num_groups,
            "dispatch": dispatch,
            "a2a_overlap_chunks": a2a_chunks,
            "renorm_kept_choices": renorm,
            "observability": observability,
        }

    def _configure_train_batch_size(self):
        """Resolve train_batch = micro_batch * grad_acc * dp_world
        (reference `config.py:681-756`)."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        world = self.world_size

        if all(v is not None for v in (train, micro, gas)):
            pass  # verified below
        elif train is not None and micro is not None:
            if train % (micro * world) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} is not divisible by "
                    f"micro_batch * world = {micro} * {world}")
            gas = train // (micro * world)
        elif train is not None and gas is not None:
            if train % (gas * world) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} is not divisible by "
                    f"grad_acc * world = {gas} * {world}")
            micro = train // (gas * world)
        elif micro is not None:
            gas = gas if gas is not None else 1
            train = micro * gas * world
        elif train is not None:
            micro = train // world
            gas = 1
        elif gas is not None:
            raise DeepSpeedConfigError(
                "gradient_accumulation_steps alone cannot determine batch "
                "sizes; also provide train_batch_size or "
                "train_micro_batch_size_per_gpu")
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size or "
                "train_micro_batch_size_per_gpu must be configured")

        self.train_batch_size = as_int(train, c.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = as_int(
            micro, c.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = as_int(
            gas, c.GRADIENT_ACCUMULATION_STEPS)

    def _do_error_check(self):
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        for name, value in ((c.TRAIN_BATCH_SIZE, train),
                            (c.TRAIN_MICRO_BATCH_SIZE_PER_GPU, micro),
                            (c.GRADIENT_ACCUMULATION_STEPS, gas)):
            if value <= 0:
                raise DeepSpeedConfigError(f"{name} must be > 0, got {value}")
        if train != micro * gas * self.world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. "
                f"train_batch_size ({train}) is not equal to "
                f"micro_batch_per_gpu ({micro}) * grad_acc ({gas}) * "
                f"world_size ({self.world_size})")

    @property
    def param_dict(self):
        return self._param_dict


def parse_inference_block(d):
    """Parse + validate the "inference" block (the serving engine,
    `deeperspeed_tpu_torch/inference`). A mistyped bucket ladder must
    fail at engine init, not under live traffic.

    Returns the validated params dict, or False when absent/disabled."""
    inf = d.get(c.INFERENCE) or {}
    known = {c.INFERENCE_ENABLED, c.INFERENCE_PAGE_SIZE,
             c.INFERENCE_NUM_PAGES, c.INFERENCE_MAX_SEQ_LEN,
             c.INFERENCE_MAX_BATCH_SIZE, c.INFERENCE_TOKEN_BUDGET,
             c.INFERENCE_PREFILL_LENGTHS, c.INFERENCE_PREFILL_BATCH_SIZES,
             c.INFERENCE_DECODE_BATCH_SIZES, c.INFERENCE_TEMPERATURE,
             c.INFERENCE_SEED, c.INFERENCE_KERNEL, c.INFERENCE_KV_DTYPE,
             c.INFERENCE_DRAIN_DEADLINE, c.INFERENCE_DEFAULT_PRIORITY,
             c.INFERENCE_HANG_TIMEOUT, c.INFERENCE_ADMISSION,
             c.INFERENCE_RETRY, c.INFERENCE_FAULT_INJECTION,
             c.INFERENCE_PREFIX_CACHE, c.INFERENCE_SPECULATIVE,
             c.INFERENCE_DISAGGREGATION, c.INFERENCE_ROUTER}
    unknown = sorted(set(inf) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference' key(s) {unknown}; valid keys: "
            f"{sorted(known)}")

    enabled = inf.get(c.INFERENCE_ENABLED, c.INFERENCE_ENABLED_DEFAULT)
    if not isinstance(enabled, bool):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_ENABLED} must be a boolean, got "
            f"{enabled!r}")
    if not enabled:
        return False

    ints = {}
    for key, default, lo in (
            (c.INFERENCE_PAGE_SIZE, c.INFERENCE_PAGE_SIZE_DEFAULT, 8),
            (c.INFERENCE_NUM_PAGES, c.INFERENCE_NUM_PAGES_DEFAULT, 2),
            (c.INFERENCE_MAX_BATCH_SIZE,
             c.INFERENCE_MAX_BATCH_SIZE_DEFAULT, 1),
            (c.INFERENCE_TOKEN_BUDGET,
             c.INFERENCE_TOKEN_BUDGET_DEFAULT, 1),
            (c.INFERENCE_SEED, c.INFERENCE_SEED_DEFAULT, 0)):
        value = as_int(inf.get(key, default), f"inference.{key}")
        if value < lo:
            raise DeepSpeedConfigError(
                f"inference.{key} must be >= {lo}, got {value}")
        ints[key] = value
    if ints[c.INFERENCE_PAGE_SIZE] % 8:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_PAGE_SIZE} must be a multiple of 8 "
            f"(the decode kernel reads keys 8 at a time), got "
            f"{ints[c.INFERENCE_PAGE_SIZE]}")

    max_seq_len = inf.get(c.INFERENCE_MAX_SEQ_LEN,
                          c.INFERENCE_MAX_SEQ_LEN_DEFAULT)
    if max_seq_len is not None:
        max_seq_len = as_int(max_seq_len,
                             f"inference.{c.INFERENCE_MAX_SEQ_LEN}")
        if max_seq_len < 1:
            raise DeepSpeedConfigError(
                f"inference.{c.INFERENCE_MAX_SEQ_LEN} must be >= 1, got "
                f"{max_seq_len}")

    def bucket_list(key, minimum=1):
        raw = inf.get(key)
        if raw is None:
            return None
        if not isinstance(raw, (list, tuple)) or not raw:
            raise DeepSpeedConfigError(
                f"inference.{key} must be a non-empty list of ints, got "
                f"{raw!r}")
        vals = [as_int(v, f"inference.{key}") for v in raw]
        if any(v < minimum for v in vals):
            raise DeepSpeedConfigError(
                f"inference.{key} entries must be >= {minimum}, got "
                f"{vals}")
        if sorted(vals) != vals or len(set(vals)) != len(vals):
            raise DeepSpeedConfigError(
                f"inference.{key} must be strictly increasing, got "
                f"{vals}")
        return vals

    prefill_lengths = bucket_list(c.INFERENCE_PREFILL_LENGTHS)
    if prefill_lengths is not None:
        bad = [v for v in prefill_lengths
               if v % ints[c.INFERENCE_PAGE_SIZE]]
        if bad:
            raise DeepSpeedConfigError(
                f"inference.{c.INFERENCE_PREFILL_LENGTHS} entries must "
                f"be multiples of page_size "
                f"{ints[c.INFERENCE_PAGE_SIZE]} (the prefill scatter "
                f"writes whole pages), got {bad}")
    prefill_batch_sizes = bucket_list(c.INFERENCE_PREFILL_BATCH_SIZES)
    decode_batch_sizes = bucket_list(c.INFERENCE_DECODE_BATCH_SIZES)
    if decode_batch_sizes is not None and \
            decode_batch_sizes[-1] < ints[c.INFERENCE_MAX_BATCH_SIZE]:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_DECODE_BATCH_SIZES} tops out at "
            f"{decode_batch_sizes[-1]} but max_batch_size is "
            f"{ints[c.INFERENCE_MAX_BATCH_SIZE]}: a full continuous "
            f"batch would have no compiled shape")

    temperature = inf.get(c.INFERENCE_TEMPERATURE,
                          c.INFERENCE_TEMPERATURE_DEFAULT)
    if not isinstance(temperature, (int, float)) or \
            isinstance(temperature, bool) or temperature < 0:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_TEMPERATURE} must be a number >= 0 "
            f"(0 = greedy), got {temperature!r}")

    kernel = inf.get(c.INFERENCE_KERNEL, c.INFERENCE_KERNEL_DEFAULT)
    if kernel not in c.INFERENCE_KERNEL_CHOICES:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_KERNEL} must be one of "
            f"{list(c.INFERENCE_KERNEL_CHOICES)}, got {kernel!r}")

    kv_dtype = inf.get(c.INFERENCE_KV_DTYPE, c.INFERENCE_KV_DTYPE_DEFAULT)
    if kv_dtype is not None:
        # validated against the POOL dtypes the paged cache implements,
        # not resolve_precision's full spelling table: an unsupported
        # pool dtype must fail here with the choices listed, not as a
        # late kernel error far from the config
        if not isinstance(kv_dtype, str) or \
                kv_dtype.lower() not in c.INFERENCE_KV_DTYPE_CHOICES:
            raise DeepSpeedConfigError(
                f"inference.{c.INFERENCE_KV_DTYPE} must be null (the "
                f"params' compute dtype) or a supported pool precision "
                f"{sorted(c.INFERENCE_KV_DTYPE_CHOICES)}, got "
                f"{kv_dtype!r}")
        kv_dtype = kv_dtype.lower()
        if kv_dtype == "int8" and kernel == "pallas" and \
                ints[c.INFERENCE_PAGE_SIZE] % 32:
            # the JAX package's schema error (its int8 TPU kernel needs
            # the int8 sublane tile); the CUDA kernel has no such rule,
            # but a config must fail the same way in both packages
            raise DeepSpeedConfigError(
                f"inference.kernel \"pallas\" with kv_cache_dtype "
                f"\"int8\" needs page_size % 32 == 0 (the int8 sublane "
                f"tile), got {ints[c.INFERENCE_PAGE_SIZE]}")

    drain_deadline = inf.get(c.INFERENCE_DRAIN_DEADLINE,
                             c.INFERENCE_DRAIN_DEADLINE_DEFAULT)
    if not isinstance(drain_deadline, (int, float)) or \
            isinstance(drain_deadline, bool) or drain_deadline < 0:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_DRAIN_DEADLINE} must be a number "
            f">= 0 (seconds; 0 = stop immediately after the current "
            f"step), got {drain_deadline!r}")

    # -- serving robustness (inference/admission.py) -------------------

    from ..inference.admission import PRIORITIES
    default_priority = inf.get(c.INFERENCE_DEFAULT_PRIORITY,
                               c.INFERENCE_DEFAULT_PRIORITY_DEFAULT)
    if default_priority not in PRIORITIES:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_DEFAULT_PRIORITY} must be one of "
            f"{list(PRIORITIES)}, got {default_priority!r}")

    hang_timeout = inf.get(c.INFERENCE_HANG_TIMEOUT,
                           c.INFERENCE_HANG_TIMEOUT_DEFAULT)
    if not isinstance(hang_timeout, (int, float)) or \
            isinstance(hang_timeout, bool) or hang_timeout < 0:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_HANG_TIMEOUT} must be a number "
            f">= 0 (seconds; 0 = watchdog off), got {hang_timeout!r}")

    admission = _parse_inference_admission(
        inf.get(c.INFERENCE_ADMISSION))
    retry = _parse_inference_retry(inf.get(c.INFERENCE_RETRY))
    prefix_cache = _parse_inference_prefix_cache(
        inf.get(c.INFERENCE_PREFIX_CACHE))
    speculative = _parse_inference_speculative(
        inf.get(c.INFERENCE_SPECULATIVE))
    disaggregation = _parse_inference_disaggregation(
        inf.get(c.INFERENCE_DISAGGREGATION))
    router = _parse_inference_router(inf.get(c.INFERENCE_ROUTER))
    if disaggregation["role"] != "unified" and speculative is not None:
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_DISAGGREGATION} role "
            f"{disaggregation['role']!r} cannot combine with "
            f"inference.{c.INFERENCE_SPECULATIVE}: the draft model's "
            f"shadow KV pools cannot be reconstructed from a page "
            f"handoff yet — run speculation on unified pools")

    fault_spec = inf.get(c.INFERENCE_FAULT_INJECTION)
    if fault_spec is not None:
        from .fault_injection import validate_fault_spec
        validate_fault_spec(fault_spec,
                            where=f"inference.{c.INFERENCE_FAULT_INJECTION}")

    return {
        "page_size": ints[c.INFERENCE_PAGE_SIZE],
        "num_pages": ints[c.INFERENCE_NUM_PAGES],
        "max_seq_len": max_seq_len,
        "max_batch_size": ints[c.INFERENCE_MAX_BATCH_SIZE],
        "token_budget": ints[c.INFERENCE_TOKEN_BUDGET],
        "prefill_lengths": prefill_lengths,
        "prefill_batch_sizes": prefill_batch_sizes,
        "decode_batch_sizes": decode_batch_sizes,
        "temperature": float(temperature),
        "seed": ints[c.INFERENCE_SEED],
        "kernel": kernel,
        "kv_cache_dtype": kv_dtype,
        "drain_deadline_s": float(drain_deadline),
        "default_priority": default_priority,
        "hang_timeout_s": float(hang_timeout),
        "admission": admission,
        "retry": retry,
        "fault_injection": fault_spec,
        "prefix_cache": prefix_cache,
        "speculative": speculative,
        "disaggregation": disaggregation,
        "router": router,
    }


def _parse_inference_admission(block):
    """Validate the ``inference.admission`` sub-block -> params dict,
    or None when absent/disabled (no admission control: the
    pre-robustness unbounded-queue behavior)."""
    if block is None:
        return None
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_ADMISSION} must be an object, got "
            f"{type(block).__name__}")
    known = {c.INFERENCE_ADMISSION_ENABLED,
             c.INFERENCE_ADMISSION_MAX_QUEUE_DEPTH,
             c.INFERENCE_ADMISSION_SHED_POOL_UTIL,
             c.INFERENCE_ADMISSION_SHED_TTFT_EMA,
             c.INFERENCE_ADMISSION_TTFT_EMA_BETA,
             c.INFERENCE_ADMISSION_RETRY_AFTER_CAP}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference.{c.INFERENCE_ADMISSION}' key(s) "
            f"{unknown}; valid keys: {sorted(known)}")
    enabled = block.get(c.INFERENCE_ADMISSION_ENABLED,
                        c.INFERENCE_ADMISSION_ENABLED_DEFAULT)
    if not isinstance(enabled, bool):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_ADMISSION}."
            f"{c.INFERENCE_ADMISSION_ENABLED} must be a boolean, got "
            f"{enabled!r}")
    if not enabled:
        return None

    where = f"inference.{c.INFERENCE_ADMISSION}"
    depth = as_int(block.get(c.INFERENCE_ADMISSION_MAX_QUEUE_DEPTH,
                             c.INFERENCE_ADMISSION_MAX_QUEUE_DEPTH_DEFAULT),
                   f"{where}.{c.INFERENCE_ADMISSION_MAX_QUEUE_DEPTH}")
    if depth < 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_ADMISSION_MAX_QUEUE_DEPTH} must be "
            f">= 1, got {depth}")

    pool_util = block.get(c.INFERENCE_ADMISSION_SHED_POOL_UTIL,
                          c.INFERENCE_ADMISSION_SHED_POOL_UTIL_DEFAULT)
    if not isinstance(pool_util, (int, float)) or \
            isinstance(pool_util, bool) or not 0 < pool_util <= 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_ADMISSION_SHED_POOL_UTIL} must be a "
            f"number in (0, 1], got {pool_util!r}")

    ttft_ms = block.get(c.INFERENCE_ADMISSION_SHED_TTFT_EMA,
                        c.INFERENCE_ADMISSION_SHED_TTFT_EMA_DEFAULT)
    if ttft_ms is not None and (
            not isinstance(ttft_ms, (int, float)) or
            isinstance(ttft_ms, bool) or ttft_ms <= 0):
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_ADMISSION_SHED_TTFT_EMA} must be a "
            f"number > 0 (milliseconds) or null (signal off), got "
            f"{ttft_ms!r}")

    beta = block.get(c.INFERENCE_ADMISSION_TTFT_EMA_BETA,
                     c.INFERENCE_ADMISSION_TTFT_EMA_BETA_DEFAULT)
    if not isinstance(beta, (int, float)) or isinstance(beta, bool) or \
            not 0 < beta < 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_ADMISSION_TTFT_EMA_BETA} must be a "
            f"number in (0, 1), got {beta!r}")

    cap = block.get(c.INFERENCE_ADMISSION_RETRY_AFTER_CAP,
                    c.INFERENCE_ADMISSION_RETRY_AFTER_CAP_DEFAULT)
    if not isinstance(cap, (int, float)) or isinstance(cap, bool) or \
            cap <= 0:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_ADMISSION_RETRY_AFTER_CAP} must be a "
            f"number > 0 (seconds), got {cap!r}")

    return {"max_queue_depth": depth,
            "shed_page_pool_util": float(pool_util),
            "shed_ttft_ema_ms": (None if ttft_ms is None
                                 else float(ttft_ms)),
            "ttft_ema_beta": float(beta),
            "retry_after_cap_s": float(cap)}


def _parse_inference_retry(block):
    """Validate the ``inference.retry`` sub-block -> params dict. The
    retry/poison machinery is always on (a step failure must never kill
    the server), so an absent block yields the defaults."""
    if block is None:
        block = {}
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_RETRY} must be an object, got "
            f"{type(block).__name__}")
    known = {c.INFERENCE_RETRY_MAX_ATTEMPTS,
             c.INFERENCE_RETRY_BACKOFF_BASE,
             c.INFERENCE_RETRY_BACKOFF_CAP, c.INFERENCE_RETRY_JITTER}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference.{c.INFERENCE_RETRY}' key(s) {unknown}; "
            f"valid keys: {sorted(known)}")
    where = f"inference.{c.INFERENCE_RETRY}"

    attempts = as_int(block.get(c.INFERENCE_RETRY_MAX_ATTEMPTS,
                                c.INFERENCE_RETRY_MAX_ATTEMPTS_DEFAULT),
                      f"{where}.{c.INFERENCE_RETRY_MAX_ATTEMPTS}")
    if attempts < 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_RETRY_MAX_ATTEMPTS} must be >= 1 "
            f"(the first attempt counts), got {attempts}")

    base = block.get(c.INFERENCE_RETRY_BACKOFF_BASE,
                     c.INFERENCE_RETRY_BACKOFF_BASE_DEFAULT)
    cap = block.get(c.INFERENCE_RETRY_BACKOFF_CAP,
                    c.INFERENCE_RETRY_BACKOFF_CAP_DEFAULT)
    for key, value in ((c.INFERENCE_RETRY_BACKOFF_BASE, base),
                       (c.INFERENCE_RETRY_BACKOFF_CAP, cap)):
        if not isinstance(value, (int, float)) or \
                isinstance(value, bool) or value <= 0:
            raise DeepSpeedConfigError(
                f"{where}.{key} must be a number > 0 (milliseconds), "
                f"got {value!r}")
    if cap < base:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_RETRY_BACKOFF_CAP} ({cap}) must be "
            f">= {c.INFERENCE_RETRY_BACKOFF_BASE} ({base})")

    jitter = block.get(c.INFERENCE_RETRY_JITTER,
                       c.INFERENCE_RETRY_JITTER_DEFAULT)
    if not isinstance(jitter, (int, float)) or \
            isinstance(jitter, bool) or not 0 <= jitter < 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_RETRY_JITTER} must be a number in "
            f"[0, 1), got {jitter!r}")

    return {"max_attempts": attempts, "backoff_base_ms": float(base),
            "backoff_cap_ms": float(cap), "jitter": float(jitter)}


def _parse_inference_prefix_cache(block):
    """Validate the ``inference.prefix_cache`` sub-block -> params dict,
    or None when absent/disabled (no cross-request KV reuse: the
    pre-prefix-cache behavior)."""
    if block is None:
        return None
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_PREFIX_CACHE} must be an object, "
            f"got {type(block).__name__}")
    known = {c.INFERENCE_PREFIX_CACHE_ENABLED,
             c.INFERENCE_PREFIX_CACHE_MAX_PAGES}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference.{c.INFERENCE_PREFIX_CACHE}' key(s) "
            f"{unknown}; valid keys: {sorted(known)}")
    enabled = block.get(c.INFERENCE_PREFIX_CACHE_ENABLED,
                        c.INFERENCE_PREFIX_CACHE_ENABLED_DEFAULT)
    if not isinstance(enabled, bool):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_PREFIX_CACHE}."
            f"{c.INFERENCE_PREFIX_CACHE_ENABLED} must be a boolean, got "
            f"{enabled!r}")
    if not enabled:
        return None

    where = f"inference.{c.INFERENCE_PREFIX_CACHE}"
    max_pages = block.get(c.INFERENCE_PREFIX_CACHE_MAX_PAGES,
                          c.INFERENCE_PREFIX_CACHE_MAX_PAGES_DEFAULT)
    if max_pages is not None:
        max_pages = as_int(
            max_pages, f"{where}.{c.INFERENCE_PREFIX_CACHE_MAX_PAGES}")
        if max_pages < 1:
            raise DeepSpeedConfigError(
                f"{where}.{c.INFERENCE_PREFIX_CACHE_MAX_PAGES} must be "
                f">= 1 or null (registry bounded only by the pool), got "
                f"{max_pages}")

    return {"max_pages": max_pages}


def _parse_inference_speculative(block):
    """Validate the ``inference.speculative`` sub-block -> params dict,
    or None when absent/disabled (plain one-token-per-step decode)."""
    if block is None:
        return None
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_SPECULATIVE} must be an object, "
            f"got {type(block).__name__}")
    known = {c.INFERENCE_SPECULATIVE_ENABLED,
             c.INFERENCE_SPECULATIVE_NUM_DRAFT,
             c.INFERENCE_SPECULATIVE_DRAFT_WEIGHT_QUANT}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference.{c.INFERENCE_SPECULATIVE}' key(s) "
            f"{unknown}; valid keys: {sorted(known)}")
    enabled = block.get(c.INFERENCE_SPECULATIVE_ENABLED,
                        c.INFERENCE_SPECULATIVE_ENABLED_DEFAULT)
    if not isinstance(enabled, bool):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_SPECULATIVE}."
            f"{c.INFERENCE_SPECULATIVE_ENABLED} must be a boolean, got "
            f"{enabled!r}")
    if not enabled:
        return None

    where = f"inference.{c.INFERENCE_SPECULATIVE}"
    k = as_int(block.get(c.INFERENCE_SPECULATIVE_NUM_DRAFT,
                         c.INFERENCE_SPECULATIVE_NUM_DRAFT_DEFAULT),
               f"{where}.{c.INFERENCE_SPECULATIVE_NUM_DRAFT}")
    if k < 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_SPECULATIVE_NUM_DRAFT} must be >= 1, "
            f"got {k}")

    quant = block.get(c.INFERENCE_SPECULATIVE_DRAFT_WEIGHT_QUANT,
                      c.INFERENCE_SPECULATIVE_DRAFT_WEIGHT_QUANT_DEFAULT)
    if quant is not None and quant not in c.QUANTIZATION_WEIGHTS_CHOICES:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_SPECULATIVE_DRAFT_WEIGHT_QUANT} must "
            f"be null or one of {list(c.QUANTIZATION_WEIGHTS_CHOICES)}, "
            f"got {quant!r}")

    return {"num_draft_tokens": k, "draft_weight_quant": quant}


def _parse_inference_disaggregation(block):
    """Validate the ``inference.disaggregation`` sub-block -> params
    dict. ALWAYS returns a dict (role "unified" when absent — today's
    single-engine behavior), so the engine reads one shape."""
    if block is None:
        block = {}
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_DISAGGREGATION} must be an object, "
            f"got {type(block).__name__}")
    known = {c.INFERENCE_DISAGG_ROLE, c.INFERENCE_DISAGG_POOL_ID,
             c.INFERENCE_DISAGG_HANDOFF_TIMEOUT}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference.{c.INFERENCE_DISAGGREGATION}' key(s) "
            f"{unknown}; valid keys: {sorted(known)}")
    where = f"inference.{c.INFERENCE_DISAGGREGATION}"

    role = block.get(c.INFERENCE_DISAGG_ROLE,
                     c.INFERENCE_DISAGG_ROLE_DEFAULT)
    if role not in c.INFERENCE_DISAGG_ROLE_CHOICES:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_DISAGG_ROLE} must be one of "
            f"{list(c.INFERENCE_DISAGG_ROLE_CHOICES)}, got {role!r}")

    pool_id = block.get(c.INFERENCE_DISAGG_POOL_ID,
                        c.INFERENCE_DISAGG_POOL_ID_DEFAULT)
    if pool_id is None:
        pool_id = f"{role}-0"
    if not isinstance(pool_id, str) or not pool_id or \
            any(ch in pool_id for ch in "/:"):
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_DISAGG_POOL_ID} must be a non-empty "
            f"string without '/' or ':' (it namespaces transport "
            f"keys), got {pool_id!r}")

    timeout = block.get(c.INFERENCE_DISAGG_HANDOFF_TIMEOUT,
                        c.INFERENCE_DISAGG_HANDOFF_TIMEOUT_DEFAULT)
    if not isinstance(timeout, (int, float)) or \
            isinstance(timeout, bool) or timeout <= 0:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_DISAGG_HANDOFF_TIMEOUT} must be a "
            f"number > 0 (seconds), got {timeout!r}")

    return {"role": role, "pool_id": pool_id,
            "handoff_timeout_s": float(timeout)}


def _parse_inference_router(block):
    """Validate the ``inference.router`` sub-block -> params dict, or
    None when absent (`ServeRouter` then runs on defaults)."""
    if block is None:
        return None
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"inference.{c.INFERENCE_ROUTER} must be an object, got "
            f"{type(block).__name__}")
    known = {c.INFERENCE_ROUTER_QUEUE_DEPTH_WEIGHT,
             c.INFERENCE_ROUTER_POOL_UTIL_WEIGHT,
             c.INFERENCE_ROUTER_TTFT_WEIGHT,
             c.INFERENCE_ROUTER_SCALE_UP_UTIL}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'inference.{c.INFERENCE_ROUTER}' key(s) "
            f"{unknown}; valid keys: {sorted(known)}")
    where = f"inference.{c.INFERENCE_ROUTER}"

    out = {}
    for key, default in (
            (c.INFERENCE_ROUTER_QUEUE_DEPTH_WEIGHT,
             c.INFERENCE_ROUTER_QUEUE_DEPTH_WEIGHT_DEFAULT),
            (c.INFERENCE_ROUTER_POOL_UTIL_WEIGHT,
             c.INFERENCE_ROUTER_POOL_UTIL_WEIGHT_DEFAULT),
            (c.INFERENCE_ROUTER_TTFT_WEIGHT,
             c.INFERENCE_ROUTER_TTFT_WEIGHT_DEFAULT)):
        value = block.get(key, default)
        if not isinstance(value, (int, float)) or \
                isinstance(value, bool) or value < 0:
            raise DeepSpeedConfigError(
                f"{where}.{key} must be a number >= 0, got {value!r}")
        out[key] = float(value)

    util = block.get(c.INFERENCE_ROUTER_SCALE_UP_UTIL,
                     c.INFERENCE_ROUTER_SCALE_UP_UTIL_DEFAULT)
    if not isinstance(util, (int, float)) or isinstance(util, bool) or \
            not 0 < util <= 1:
        raise DeepSpeedConfigError(
            f"{where}.{c.INFERENCE_ROUTER_SCALE_UP_UTIL} must be a "
            f"number in (0, 1], got {util!r}")
    out[c.INFERENCE_ROUTER_SCALE_UP_UTIL] = float(util)
    return out


def parse_rl_block(d):
    """Parse + validate the "rl" block (the online-RL driver,
    `deeperspeed_tpu_torch/rl`) with the JAX package's keys, defaults
    and errors. Module-level so `RLDriver` can validate raw dicts
    identically; `DeepSpeedConfig` delegates here. A mistyped rollout
    geometry fails at driver construction, not as a shape mismatch three
    iterations into a run.

    Returns the validated params dict, or False when absent/disabled."""
    block = d.get(c.RL) or {}
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(
            f"'{c.RL}' must be a dict, got {block!r}")
    known = {c.RL_ENABLED, c.RL_LOSS, c.RL_ROLLOUTS_PER_ITERATION,
             c.RL_GROUP_SIZE, c.RL_MAX_NEW_TOKENS, c.RL_SEQUENCE_LENGTH,
             c.RL_CLIP_RATIO, c.RL_KL_COEF, c.RL_BETA,
             c.RL_CHECKPOINT_INTERVAL}
    unknown = sorted(set(block) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown '{c.RL}' key(s) {unknown}; valid keys: "
            f"{sorted(known)}")

    enabled = block.get(c.RL_ENABLED, c.RL_ENABLED_DEFAULT)
    if not isinstance(enabled, bool):
        raise DeepSpeedConfigError(
            f"{c.RL}.{c.RL_ENABLED} must be a boolean, got {enabled!r}")
    if not enabled:
        return False

    loss = block.get(c.RL_LOSS, c.RL_LOSS_DEFAULT)
    if loss not in c.RL_LOSS_CHOICES:
        raise DeepSpeedConfigError(
            f"{c.RL}.{c.RL_LOSS} must be one of "
            f"{list(c.RL_LOSS_CHOICES)}, got {loss!r}")

    ints = {}
    for key, default, lo in (
            (c.RL_ROLLOUTS_PER_ITERATION,
             c.RL_ROLLOUTS_PER_ITERATION_DEFAULT, 1),
            (c.RL_GROUP_SIZE, c.RL_GROUP_SIZE_DEFAULT, 1),
            (c.RL_MAX_NEW_TOKENS, c.RL_MAX_NEW_TOKENS_DEFAULT, 1),
            (c.RL_CHECKPOINT_INTERVAL,
             c.RL_CHECKPOINT_INTERVAL_DEFAULT, 1)):
        value = as_int(block.get(key, default), f"{c.RL}.{key}")
        if value < lo:
            raise DeepSpeedConfigError(
                f"{c.RL}.{key} must be >= {lo}, got {value}")
        ints[key] = value
    if ints[c.RL_ROLLOUTS_PER_ITERATION] % ints[c.RL_GROUP_SIZE]:
        raise DeepSpeedConfigError(
            f"{c.RL}.{c.RL_ROLLOUTS_PER_ITERATION} "
            f"({ints[c.RL_ROLLOUTS_PER_ITERATION]}) must be a multiple "
            f"of {c.RL_GROUP_SIZE} ({ints[c.RL_GROUP_SIZE]}): each "
            f"iteration samples whole prompt groups")
    if loss == "dpo" and ints[c.RL_GROUP_SIZE] < 2:
        raise DeepSpeedConfigError(
            f"{c.RL}.{c.RL_LOSS} \"dpo\" needs {c.RL_GROUP_SIZE} >= 2: "
            f"the chosen/rejected pair is picked within a prompt group")

    seq_len = block.get(c.RL_SEQUENCE_LENGTH, c.RL_SEQUENCE_LENGTH_DEFAULT)
    if seq_len is not None:
        seq_len = as_int(seq_len, f"{c.RL}.{c.RL_SEQUENCE_LENGTH}")
        if seq_len < 2:
            raise DeepSpeedConfigError(
                f"{c.RL}.{c.RL_SEQUENCE_LENGTH} must be >= 2 (next-token "
                f"logprobs need at least one transition), got {seq_len}")

    floats = {}
    for key, default, lo_open in (
            (c.RL_CLIP_RATIO, c.RL_CLIP_RATIO_DEFAULT, True),
            (c.RL_KL_COEF, c.RL_KL_COEF_DEFAULT, False),
            (c.RL_BETA, c.RL_BETA_DEFAULT, True)):
        value = block.get(key, default)
        if not isinstance(value, (int, float)) or \
                isinstance(value, bool) or \
                (value <= 0 if lo_open else value < 0):
            bound = "> 0" if lo_open else ">= 0"
            raise DeepSpeedConfigError(
                f"{c.RL}.{key} must be a number {bound}, got {value!r}")
        floats[key] = float(value)

    return {
        c.RL_ENABLED: True,
        c.RL_LOSS: loss,
        c.RL_ROLLOUTS_PER_ITERATION: ints[c.RL_ROLLOUTS_PER_ITERATION],
        c.RL_GROUP_SIZE: ints[c.RL_GROUP_SIZE],
        c.RL_MAX_NEW_TOKENS: ints[c.RL_MAX_NEW_TOKENS],
        c.RL_SEQUENCE_LENGTH: seq_len,
        c.RL_CLIP_RATIO: floats[c.RL_CLIP_RATIO],
        c.RL_KL_COEF: floats[c.RL_KL_COEF],
        c.RL_BETA: floats[c.RL_BETA],
        c.RL_CHECKPOINT_INTERVAL: ints[c.RL_CHECKPOINT_INTERVAL],
    }


def parse_quantization_block(d):
    """Parse + validate the "quantization" block with the JAX package's
    keys and errors. The serving engine consumes ``weights``, the
    training engine ``ffn``; the training `DeepSpeedConfig` refuses an
    enabled ``gradient_compression`` as not ported.

    Returns {"weights": str|None, "ffn": dict|None,
    "gradient_compression": bool, "gradient_compression_packed": bool}
    or False when absent/disabled."""
    qz = d.get(c.QUANTIZATION)
    if qz is None:
        return False
    if not isinstance(qz, dict):
        raise DeepSpeedConfigError(
            f"'{c.QUANTIZATION}' must be an object, got "
            f"{type(qz).__name__}")
    known = {c.QUANTIZATION_ENABLED, c.QUANTIZATION_WEIGHTS,
             c.QUANTIZATION_FFN, c.QUANTIZATION_GRAD_COMPRESSION}
    unknown = sorted(set(qz) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown '{c.QUANTIZATION}' key(s) {unknown}; valid keys: "
            f"{sorted(known)}")
    enabled = qz.get(c.QUANTIZATION_ENABLED,
                     c.QUANTIZATION_ENABLED_DEFAULT)
    if not isinstance(enabled, bool):
        raise DeepSpeedConfigError(
            f"{c.QUANTIZATION}.{c.QUANTIZATION_ENABLED} must be a "
            f"boolean, got {enabled!r}")
    if not enabled:
        return False

    weights = qz.get(c.QUANTIZATION_WEIGHTS,
                     c.QUANTIZATION_WEIGHTS_DEFAULT)
    if weights is not None and \
            weights not in c.QUANTIZATION_WEIGHTS_CHOICES:
        raise DeepSpeedConfigError(
            f"{c.QUANTIZATION}.{c.QUANTIZATION_WEIGHTS} must be null or "
            f"one of {list(c.QUANTIZATION_WEIGHTS_CHOICES)}, got "
            f"{weights!r}")

    ffn = qz.get(c.QUANTIZATION_FFN)
    if ffn is not None:
        if not isinstance(ffn, dict):
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_FFN} must be an "
                f"object, got {type(ffn).__name__}")
        fknown = {c.QUANTIZATION_FFN_RECIPE, c.QUANTIZATION_FFN_HISTORY,
                  c.QUANTIZATION_FFN_MARGIN}
        funknown = sorted(set(ffn) - fknown)
        if funknown:
            raise DeepSpeedConfigError(
                f"Unknown '{c.QUANTIZATION}.{c.QUANTIZATION_FFN}' "
                f"key(s) {funknown}; valid keys: {sorted(fknown)}")
        recipe = ffn.get(c.QUANTIZATION_FFN_RECIPE)
        if recipe not in c.QUANTIZATION_FFN_RECIPE_CHOICES:
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_FFN}."
                f"{c.QUANTIZATION_FFN_RECIPE} is required and must be "
                f"one of {list(c.QUANTIZATION_FFN_RECIPE_CHOICES)}, got "
                f"{recipe!r}")
        hist = as_int(ffn.get(c.QUANTIZATION_FFN_HISTORY,
                              c.QUANTIZATION_FFN_HISTORY_DEFAULT),
                      f"{c.QUANTIZATION}.{c.QUANTIZATION_FFN}."
                      f"{c.QUANTIZATION_FFN_HISTORY}")
        if hist < 1:
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_FFN}."
                f"{c.QUANTIZATION_FFN_HISTORY} must be >= 1, got {hist}")
        margin = ffn.get(c.QUANTIZATION_FFN_MARGIN,
                         c.QUANTIZATION_FFN_MARGIN_DEFAULT)
        if not isinstance(margin, (int, float)) or \
                isinstance(margin, bool) or margin <= 0:
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_FFN}."
                f"{c.QUANTIZATION_FFN_MARGIN} must be a number > 0, got "
                f"{margin!r}")
        ffn = {"recipe": recipe, "amax_history_len": hist,
               "margin": float(margin)}

    gc = qz.get(c.QUANTIZATION_GRAD_COMPRESSION)
    grad_compression = False
    grad_compression_packed = False
    if gc is not None:
        if not isinstance(gc, dict):
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_GRAD_COMPRESSION} "
                f"must be an object, got {type(gc).__name__}")
        gknown = {c.QUANTIZATION_GRAD_COMPRESSION_ENABLED,
                  c.QUANTIZATION_GRAD_COMPRESSION_PACKED}
        gunknown = sorted(set(gc) - gknown)
        if gunknown:
            raise DeepSpeedConfigError(
                f"Unknown '{c.QUANTIZATION}."
                f"{c.QUANTIZATION_GRAD_COMPRESSION}' key(s) {gunknown}; "
                f"valid keys: {sorted(gknown)}")
        grad_compression = gc.get(
            c.QUANTIZATION_GRAD_COMPRESSION_ENABLED,
            c.QUANTIZATION_GRAD_COMPRESSION_ENABLED_DEFAULT)
        if not isinstance(grad_compression, bool):
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_GRAD_COMPRESSION}."
                f"{c.QUANTIZATION_GRAD_COMPRESSION_ENABLED} must be a "
                f"boolean, got {grad_compression!r}")
        packed = gc.get(c.QUANTIZATION_GRAD_COMPRESSION_PACKED,
                        c.QUANTIZATION_GRAD_COMPRESSION_PACKED_DEFAULT)
        if not isinstance(packed, bool):
            raise DeepSpeedConfigError(
                f"{c.QUANTIZATION}.{c.QUANTIZATION_GRAD_COMPRESSION}."
                f"{c.QUANTIZATION_GRAD_COMPRESSION_PACKED} must be a "
                f"boolean, got {packed!r}")
        grad_compression_packed = grad_compression and packed

    return {"weights": weights, "ffn": ffn,
            "gradient_compression": grad_compression,
            "gradient_compression_packed": grad_compression_packed}
