"""The training engine: `DeepSpeedEngine`, on one card or across
data-parallel `torch.distributed` ranks (MoE experts also sharded over
an "expert" mesh).

The port of the training step of `deeperspeed_tpu/runtime/engine.py`
(`_init_state`, `_loss_and_grads`, `_train_step_body`, `_apply_update`,
`train_batch`, `eval_batch`, and the legacy `forward` / `backward` /
`step` loop): bf16, fp16 or fp32 compute with fp32 masters or the lean
state, Adam(W), the LR schedules, gradient clipping and ZeRO stages
0-3.

State layout. The JAX engine keeps pytrees and lets XLA fuse each
leaf's update; eager PyTorch fuses nothing, so the port keeps the
masters, both Adam moments and the gradient accumulator as one flat
buffer each, as the reference's ZeRO 1/2 partitions do. The model's
parameters become views into one flat compute-dtype buffer, and their
``.grad`` views into one flat compute-dtype gradient buffer that
autograd adds into; with fp32 compute the parameters are the masters and
the gradient buffer is the accumulator. An optimizer step is then one
launch of the flat Adam kernel, which also writes the compute-dtype
copy of the new masters (the recast).

The lean state (``fp16.fp16_master_weights_and_grads``, the JAX
engine's ``keep_master`` False under a 16-bit compute dtype): the flat
compute-dtype buffer is the master, and no fp32 copy of the model is
made; the Adam moments rest in the optimizer's ``state_dtype``. As in
the JAX step, one micro-batch's gradients reach the optimizer in the
compute dtype, and several are summed in an fp32 accumulator (the JAX
scan's fp32 carry) and divided by their count; unscaling, the
prescale divide and clipping run on an fp32 copy. The kernel then
updates the bf16 parameters in place from its fp32 math.

Data parallel (a `torch.distributed` process group, which
`utils.distributed.init_distributed` forms; one rank a card, NCCL on
the card, gloo on the CPU, or none: stage 3 then runs at world 1 with
its collectives as copies). Each rank takes its own micro-batches
[gas, micro, ...] (the JAX engine's global batch split over its data
axis), and the gradients are reduced across the ranks as the JAX
engine's shardings have XLA reduce them:

- stage 0: every rank keeps all the state; the fp32 accumulator (the
  gradient buffer in fp32 compute) is all-reduced at the accumulation
  boundary;
- stage 1: the flat buffers are padded to a multiple of world ×
  `zero.stage1.PARTITION_ALIGNMENT` and each rank keeps the fp32
  masters and the moments of one contiguous partition
  (`zero.stage1.flat_partition`); the whole fp32 accumulator is
  reduce-scattered once at the boundary;
- stage 2: each micro-batch's gradient is reduce-scattered as it is
  made into an fp32 accumulator of the rank's partition, so no rank
  holds a whole fp32 gradient;
- stage 3 (`zero/stage3.py`; GPT-NeoX): the compute-dtype parameters
  are partitioned too, by rows of layers: each rank holds its shard of
  every row (and the leaves under the persistence threshold whole), the
  model gathers each layer's row just before the layer runs (and again
  in the backward's recompute) and each row's gradient is
  reduce-scattered into the fp32 partition accumulator as soon as that
  layer's backward ends; the step is one flat Adam launch over the
  partition, which writes the compute shard. There is no flat
  gradient buffer and the module's parameters hold no data (the
  persisted leaves are views of the whole persisted row):
  `gathered_parameters` and `params_to_natural` gather them.

The sum is divided by the world (with the accumulation steps), in fp32
where ``allreduce_always_fp32()`` holds (bf16 by default). The global
norm sums each rank's squares over the group, an fp16 overflow on any
rank skips the step on all (`fp16.loss_scaler.grads_finite`), each rank
launches the flat Adam kernel on its partition (which writes the compute
copy of the partition), and the compute partitions are all-gathered
into the flat parameter buffer. The mean loss is all-reduced. Where
``sparse_gradients`` is set (stage 0), the token embeddings' gradient
rows are all-gathered as a `csr_tensor.CSRTensor` instead. Scalars go to
the monitor from rank 0 only, as the JAX package writes from process 0.
At world 1 every collective is a copy and the step is the single-rank
one bit for bit.

Step (`train_batch`), as in the JAX engine: for each micro-batch the
loss (times the loss scale, fp16 only) is differentiated, and the
micro-batch gradient is added in fp32 into the accumulator; the sum is
divided by the accumulation steps; then unscale (fp16) → finite check
(fp16) → global norm and clip → Adam on the masters → recast. On an
fp16 overflow nothing changes but the loss scale and ``skipped_steps``.
The LR is read before the step and the scheduler steps after each step
taken. The legacy loop (`forward` returns the loss with its graph,
`backward` runs autograd into the flat gradient views, `step` applies
the update at the accumulation boundary) runs the same micro-step and
the same update, so it takes the same steps bit for bit. The fork's
debugging features ride on it: `backward` feeds the gradient-noise-scale
estimator and stores each micro-batch's gradients (``store_gradients``);
`set_layers_to_hook` captures layer outputs on the next batch.

MoE: a "moe" config block is handed to the model's `apply_ds_config`
(as are a "sparse_attention" block, which swaps the attention core, a
"packing" block, which makes the loss segment-aware, and an
"activation_checkpointing" block, which sets the remat spans) before
the flat state is built, so the flat buffers hold the expert
weights and autograd adds their dW into the flat gradient views like any
other leaf. The gate jitter and BERT's dropout seeds draw from one
`torch.Generator` on the training device, re-seeded before every
micro-step from (1234, ``micro_steps``), as the JAX engine folds
``micro_steps`` into ``PRNGKey(1234)``: a run resumed from a checkpoint
(which restores ``micro_steps``) draws the numbers of the run that was
never stopped.

MoE across ranks: under a process group the model's MoE blocks route
the global micro-batch of the data-parallel group, as the JAX engine's
loss sees it (`models.gpt_neox.MoEComm`, `moe.layer._route_plan`). A 1-D
`DeviceMesh` named "expert" (``mesh=``, the JAX engine's ``mesh``; its
axis is the data axis too) shards the experts: each rank keeps E/world
of them (`GPTNeoX.shard_experts`), the blocks send the sort engine's
buffer to the experts' owners and back by two all-to-alls, and the flat
buffers hold the expert leaves last, one range (``_expert_range``) that
stage 0 leaves out of the all-reduce; every leaf takes the same 1 /
(gas · world) scale, the norm counts each expert once, and checkpoints
hold every expert leaf whole (gathered at save, sliced at load). ZeRO
stages 1-3, the einsum engine, quantization.ffn, sparse_gradients and
the flops count are refused there (`_configure_moe_ranks`).

Checkpoints (`save_checkpoint`, `save_checkpoint_async`,
`load_checkpoint`; `checkpoint/`) are the JAX package's files: either
engine resumes the other's run. The "checkpoint" config block drives
`checkpoint_manager` (auto-saves, retention, the preemption save), which
`train_batch` and `step` call at the end of every step.

Training under failure (the "training_health" block; `sentinel.py`,
`fault_injection.py`): `train_batch` plans each step with the fault
injector (an injected NaN gradient or loss spike corrupts the step's
mean loss and accumulated gradient; a stall sleeps with the watchdog
armed, which it is once a step of the same kind has run), the probe in
`_apply_update` reads the global norm and the mean loss, and
`_after_step` turns its flags into a verdict: "quarantined" and
"overflow" steps advance no schedule, a "rollback" restores the last
checkpoint and skips the step boundary. The step boundary
(`_advance_host_schedules`) steps the LR and batch-size schedules,
progressive layer drop, the loss-scale floor watch
(``fp16.min_scale_patience``) and the checkpoint manager.

Quantized training (the "quantization" block's "ffn" object;
`_configure_quantization`): `apply_ds_config` makes the model's FFN
matmuls run the delayed-scaling fp8/int8 recipe, and the engine keeps
the per-layer amax history ``quant.amax`` [L, 4, H] (`QuantState`).
`train_batch` hands it to each micro-step's ``loss_fn(...,
ffn_amax=)`` and the next micro-step reads what the last one returned;
`_apply_update` keeps the step's new history only when the step is
taken, so an fp16 overflow skip or a sentinel quarantine leaves it as
it was (the JAX step selects the old state branchlessly; the port
decides on the host, where it decides the skip). `eval_batch` runs full
precision. The history rides the checkpoint's ``quantization_state``.

Observability (the "tensorboard", "monitor", "telemetry",
"flops_profiler" blocks and ``wall_clock_breakdown``; built as the JAX
engine builds them: the flops profiler and the monitor, then the
checkpoint manager, then the telemetry): `train_batch` opens and closes
the telemetry's step window (`on_step_start` / `on_step_end`, with the
step's verdict and, for packed batches, its effective tokens) around the
spans ``data_fetch``, ``h2d`` and ``train_dispatch``; the sentinel's
escalation runs in the span ``sentinel``, a rollback's load in
``rollback_restore`` and an async save's snapshot in ``ckpt_snapshot``.
The in-engine MFU divides the step variant's flops, counted once at its
first step by the flops profiler on the plain path over fake tensors
(`profiling.flops_profiler.count_train_flops`; no device memory, and
outside the step window), by the step window.
`_record_step_metrics` queues the JAX engine's scalar tags on the
monitor keyed by ``global_samples``: host floats, and the grad norm and
MoE routing statistics as 0-d device tensors that the monitor reads at
its flush. The legacy loop gets the ``forward`` / ``backward`` /
``step`` timers and a telemetry step window from the first forward of
an accumulation window to `step`.

Online RL (the "rl" block; `rl/`): `_apply_rl_loss_override` installs
the registered PPO-clip or DPO loss as the engine's `loss_fn` before
the optimizer is built, and every loss call (`train_batch`, the legacy
`forward`, `eval_batch`, the flops count) goes through it; its batch is
a dict (``tokens``, ``mask``, the logprobs, ``advantages``).
`params_to_natural` hands out copies of the compute-dtype parameters
for the co-resident serving engine and the frozen reference, which must
not follow the flat buffer's in-place updates.

Batches: bare tokens, a tuple of arrays (GPT-NeoX's and GPT-2's
(tokens, labels)) or a dict (BERT's, an RL batch), each leaf moved to
the device with its kind kept (integer ids as long, a float mask as it
is) and handed to ``loss_fn`` one micro-batch at a time, as the JAX
engine splits its batch pytree; each model's ``loss_fn`` unpacks its
own micro-batch.
"""

import inspect
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..checkpoint import checkpointing
from ..checkpoint.async_manager import AsyncCheckpointManager
from ..models.convert import state_dict_from_jax
from ..ops.adam.fused_adam import FusedAdam
from ..ops.lamb.fused_lamb import FusedLamb
from ..utils.logging import log_dist, logger
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from . import constants as c
from .config import DeepSpeedConfig
from .config_utils import DeepSpeedConfigError
from .bs_schedules import BatchSizeScheduler
from .dataloader import DeepSpeedDataLoader
from .fault_injection import (HOST_FAULT_KINDS, SERVING_FAULT_KINDS,
                              FaultInjector, apply_fault)
from .fp16.loss_scaler import (DynamicLossScaler, ScaleFloorWatch,
                               create_loss_scaler, grads_finite,
                               init_loss_scale_state, update_loss_scale)
from .lr_schedules import get_scheduler_class
from .progressive_layer_drop import ProgressiveLayerDrop
from .sentinel import (TrainingHealthSentinel, grad_anomaly,
                       init_health_state, probe_update)
from .utils import GradientNoiseScale, clip_grad_norm_, global_norm
from .zero.partition_parameters import ZeroShardingRules
from .zero.stage1 import (all_gather_, flat_partition, gather_full,
                          reduce_scatter_)
from .zero.stage3 import Zero3Layout, Zero3Runtime


# the base seed of the per-micro-step generator (the JAX engine's
# PRNGKey(1234))
RNG_BASE_SEED = 1234


def micro_step_seed(micro_steps):
    """The generator seed of micro-step ``micro_steps``: (1234,
    micro_steps) packed into one 64-bit seed."""
    return (RNG_BASE_SEED << 32) | int(micro_steps)


class QuantState(NamedTuple):
    """The quantization state (the JAX engine's ``EngineState.quant``):
    ``amax`` is the delayed-scaling FFN's per-layer amax history
    [L, 4, H] fp32 on the training device (None when quantization.ffn is
    off); ``ef``, the compressed-gradient error feedback, is always None
    here (gradient_compression is not ported). Checkpointed in
    model_states for bit-exact resume."""
    amax: Any = None
    ef: Any = None


# what a client optimizer object must have (the JAX engine's protocol)
CLIENT_OPTIMIZER_PROTOCOL = ("param_groups", "init_state", "update")


def is_client_optimizer(optimizer):
    """True for an optimizer the engine steps through the client protocol
    (`update` returns ``(new_master, new_state)``, as in the JAX engine);
    the port's `FusedAdam` and `FusedLamb` update the flat masters in
    place and write the compute copy themselves."""
    return not isinstance(optimizer, (FusedAdam, FusedLamb))


def _not_ported(what, slice_name):
    return DeepSpeedConfigError(
        f"{what} is not ported yet (it comes with the {slice_name} slice; "
        f"see ROADMAP.md)")


# the token embeddings (GPT-NeoX's and GPT-2's, BERT's): the leaves whose
# gradient rows `sparse_gradients` reduces as a CSRTensor
CSR_EMBEDDING_LEAVES = ("embed.wte", "embeddings.word")


class DeepSpeedEngine:
    """Training engine with the DeepSpeed training API, on one card or
    on each rank of a `torch.distributed` process group (one card a
    rank; data parallel with ZeRO stages 0-3).

    ``model`` is a `models.gpt_neox.GPTNeoX`, a `models.gpt2.GPT2` or
    a `models.bert` model (any `torch.nn.Module` with ``loss_fn(params,
    batch, rng=None)`` and ``params_tree()``, and
    ``apply_ds_config(config)`` where the config has a "moe",
    "sparse_attention", "packing" or "activation_checkpointing" block);
    it trains on the device its parameters are on. ``model_parameters``
    (optional) is the JAX package's natural params pytree (numpy or
    tensor leaves), loaded into the model (`convert.state_dict_from_jax`)
    before the flat state is built. ``config`` (a JSON path) or
    ``config_params`` (a dict) is the DeepSpeed config.
    """

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config=None, config_params=None,
                 mesh=None):
        if model is None:
            raise DeepSpeedConfigError("deepspeed.initialize requires a model")
        if not (isinstance(model, torch.nn.Module) and
                hasattr(model, "loss_fn") and hasattr(model, "params_tree")):
            raise DeepSpeedConfigError(
                "model must be a torch.nn.Module exposing loss_fn(params, "
                "batch) and params_tree() (models.gpt_neox.GPTNeoX)")
        if mpu is not None:
            raise _not_ported("a model-parallel unit (mpu)",
                              "tensor / sequence parallel (A.6)")
        config_arg = config if config is not None else \
            getattr(args, "deepspeed_config", None)
        if config_arg is None and config_params is None:
            raise DeepSpeedConfigError(
                "DeepSpeed requires --deepspeed_config or config_params")
        self._config = DeepSpeedConfig(config_arg, param_dict=config_params)

        self.module = model
        self.collate_fn = collate_fn
        self.device = next(model.parameters()).device
        self.compute_dtype = self._config.precision
        self._configure_data_parallel(mesh)

        # config-drivable model features, applied before the flat state
        # is built: the model builds expert weights, its attention core,
        # its segment-aware loss and its remat spans from the JSON alone
        act_ckpt = self._config.activation_checkpointing_config
        quant_ffn = bool((self._config.quantization_config or {}).get("ffn"))
        if self._config.moe_enabled or self._config.sparse_attention or \
                self._config.packing_params or quant_ffn:
            if not hasattr(model, "apply_ds_config"):
                raise DeepSpeedConfigError(
                    "config enables moe/packing/sparse_attention/"
                    "quantization.ffn but the model does not implement "
                    "apply_ds_config(config) (models.gpt_neox.GPTNeoX "
                    "does)")
            model.apply_ds_config(self._config)
        elif act_ckpt.active and hasattr(model, "apply_ds_config"):
            model.apply_ds_config(self._config)
        if act_ckpt.active:
            # keep the module-level Megatron API in sync for models that
            # call activation_checkpointing.checkpoint() directly
            from .activation_checkpointing import checkpointing as _ckpt
            _ckpt.configure(deepspeed_config=self._config)
        if model_parameters is not None:
            # the weights the JAX engine would train: loaded in place,
            # after apply_ds_config has given the model its final shapes
            with torch.no_grad():
                model.load_state_dict(state_dict_from_jax(model_parameters))
        self._configure_moe_ranks()
        # the loss the engine trains (`loss_fn`): the model's own, or the
        # RL loss the "rl" block installs, before anything reads it
        self._loss_override = None
        if self._config.rl_params:
            self._apply_rl_loss_override()
        self._check_zero3()
        # the generator of the gate jitter and the dropout seeds, re-seeded
        # from (1234, micro_steps) before every micro-step
        self._rng = torch.Generator(device=self.device)

        self.optimizer = self._configure_optimizer(optimizer)
        self._check_partitioned_optimizer()
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.batch_size_scheduler = None
        if self._config.batch_size_schedule_enabled:
            self.batch_size_scheduler = BatchSizeScheduler(
                final_batch_size=self.train_micro_batch_size_per_gpu(),
                **self._config.batch_size_schedule_params)
        self.progressive_layer_drop = None
        self._pld_in_loss = False
        if self._config.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                self._config.pld_params["theta"],
                self._config.pld_params["gamma"])
            # theta(t) reaches the model only if the installed loss_fn
            # declares the argument (the reference injects it as a forward
            # kwarg)
            try:
                self._pld_in_loss = "pld_theta" in \
                    inspect.signature(self.loss_fn).parameters
            except (TypeError, ValueError):
                self._pld_in_loss = False
        # fp32 masters apart from the parameters in the JAX engine, so a
        # checkpoint holds a zero file (ZeRO on, or a 16-bit compute
        # dtype), unless the lean state makes the parameters the masters
        self.keep_master = ((self.compute_dtype != torch.float32
                             or self.zero_optimization())
                            and not self._config.fp16_master_weights_and_grads)
        self._init_state()

        # the delayed-scaling FFN's amax history (after the flat state, as
        # the JAX engine seats EngineState.quant after _init_state)
        self.quant = None
        self._quant_step_active = False
        qz = self._config.quantization_config
        if qz and qz.get("ffn"):
            self._configure_quantization(qz)

        self.loss_scaler = create_loss_scaler(self._config)
        self.scale_state = init_loss_scale_state(
            init_scale=self.loss_scaler.cur_scale,
            delayed_shift=getattr(self.loss_scaler, "delayed_shift", 1),
            static=not self.dynamic_loss_scale())
        self._scale_floor = None
        if self.dynamic_loss_scale():
            self._scale_floor = ScaleFloorWatch(
                min_scale=self.loss_scaler.min_scale,
                patience=self._config.min_scale_patience)

        # the training-health sentinel and the fault-injection harness
        # (runtime/sentinel.py, runtime/fault_injection.py; the
        # "training_health" block)
        th_cfg = self._config.training_health_config
        self._fault_injector = FaultInjector.from_config_env(
            th_cfg.get("fault_injection"))
        if self._fault_injector is not None:
            elastic = sorted({f["kind"] for f in self._fault_injector.faults
                              if f["kind"] in HOST_FAULT_KINDS and
                              f["kind"] not in SERVING_FAULT_KINDS})
            if elastic:
                raise _not_ported(
                    f"the training fault kind(s) {elastic} (they act on "
                    f"the peer-health monitor and the slices)",
                    "scale-out (A.7) and fleet (A.8.3)")
        self.sentinel = None
        self.health = None
        if th_cfg.get("enabled"):
            self.sentinel = TrainingHealthSentinel(
                self, **{k: v for k, v in th_cfg.items()
                         if k not in ("enabled", "fault_injection")})
            self.health = init_health_state(self.device)
        # the (gas, injector present) kinds of step this engine has run:
        # the watchdog arms only for those (the first one builds the
        # kernels and sets up cuBLAS, which is not a hang)
        self._steps_run = set()

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        # the legacy loop's micro-batches since the last step, and their
        # loss sum; the last forward's loss (what backward() runs when
        # it is given none)
        self._accum_count = 0
        self._accum_loss = None
        self._cached_loss = None
        self._legacy_window_open = False
        # the fork's debugging features (backward() feeds them)
        self.gradient_noise_scale = None
        self._gns_warned = False
        self.store_gradients = self._config.store_gradients
        self.stored_gradients = None
        self._layers_to_hook = []
        self.hooked_activations = {}
        self._configure_observability_pre()
        self.checkpoint_manager = AsyncCheckpointManager(
            self, **self._config.checkpoint_config)
        self._configure_telemetry()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            steps_per_output=self._config.steps_per_print)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)

    @property
    def loss_fn(self):
        """The loss the engine trains and evaluates, ``loss_fn(params,
        batch, rng=None, ...)``: the RL loss the "rl" block installed
        (`_apply_rl_loss_override`), else the model's own ``loss_fn``
        (read from the model at each call)."""
        if self._loss_override is not None:
            return self._loss_override
        return self.module.loss_fn

    def _apply_rl_loss_override(self):
        """Install the configured RL loss (`rl.losses` registry) as
        `loss_fn`, rejecting the engine modes whose loss is tied to the
        LM objective, with the JAX engine's messages: the explicit ZeRO-3
        schedule (its own LM loss program), ``quantization.ffn`` (the
        delayed-scaling FFN threads an amax history through the model's
        own loss_fn) and a model without ``apply`` / ``loss_and_logits``.
        The pipeline and ``offload_param``, which it also rejects here,
        the port's config refuses as not ported. ZeRO stages 0-2
        compose: they differentiate `loss_fn` like the LM loss; stage 3
        under "gspmd" is not ported (the RL losses run the model's
        ``apply`` over a whole parameter tree)."""
        p = self._config.rl_params
        if self._config.zero_config.schedule.mode == "explicit":
            raise DeepSpeedConfigError(
                "the \"rl\" block cannot ride "
                "zero_optimization.schedule.mode \"explicit\": the "
                "explicit ZeRO-3 schedule compiles its own fused LM "
                "loss-and-grad program and bypasses loss_fn — use GSPMD "
                "ZeRO (stage 0-3) for the policy engine")
        if (self._config.quantization_config or {}).get("ffn"):
            raise DeepSpeedConfigError(
                "the \"rl\" block cannot ride quantization.ffn: the "
                "delayed-scaling FFN path calls the model's own loss_fn "
                "with an amax history the RL losses do not thread")
        model = self.module
        if not (hasattr(model, "apply") and
                hasattr(model, "loss_and_logits")):
            raise DeepSpeedConfigError(
                "the \"rl\" block needs a model exposing apply(params, "
                "tokens) and loss_and_logits(params, batch) "
                "(models.gpt_neox.GPTNeoX does); a bare loss_fn "
                "callable has no logits to score rollouts with")
        if self._zero3_on:
            raise _not_ported("the \"rl\" block with ZeRO stage 3",
                              "ZeRO-3 (A.6)")
        from ..rl.losses import get_rl_loss
        self._loss_override = get_rl_loss(p[c.RL_LOSS])(model, p)
        log_dist(f"rl: loss_fn override -> {p[c.RL_LOSS]}", ranks=[0])

    # ------------------------------------------------------------------
    # config accessors (the JAX engine's, for what the port parses)
    # ------------------------------------------------------------------

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def sparse_attention_config(self):
        """The parsed "sparse_attention" block (reference engine
        accessor); build the pattern object with
        `ops.sparse_attention.sparsity_config_from_dict`."""
        return self._config.sparse_attention

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def dynamic_loss_scale(self):
        return isinstance(self.loss_scaler, DynamicLossScaler)

    @property
    def loss_scale(self):
        return self.scale_state.cur_scale

    def get_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def get_mom(self):
        return [g.get("betas") for g in self.optimizer.param_groups]

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def _configure_optimizer(self, client_optimizer):
        if client_optimizer is not None:
            # the JAX engine's protocol: any object with param_groups,
            # init_state and update (`is_client_optimizer`)
            missing = [a for a in CLIENT_OPTIMIZER_PROTOCOL
                       if not hasattr(client_optimizer, a)]
            if missing:
                raise DeepSpeedConfigError(
                    f"a client optimizer needs param_groups, "
                    f"init_state(master) and update(grads, state, master, "
                    f"lr=); {type(client_optimizer).__name__} has no "
                    f"{', '.join(missing)}")
            log_dist("Using client optimizer", ranks=[0])
            return client_optimizer
        name = self._config.optimizer_name
        params = dict(self._config.optimizer_params or {})
        if name is None:
            raise DeepSpeedConfigError(
                "No optimizer supplied and none configured; add an "
                "'optimizer' block or pass optimizer=")
        if name not in c.DEEPSPEED_OPTIMIZERS and \
                not self._config.zero_allow_untested_optimizer and \
                self.zero_optimization():
            raise DeepSpeedConfigError(
                f"optimizer {name!r} is untested with ZeRO; set "
                "'zero_allow_untested_optimizer': true to force")
        params.pop("torch_adam", None)
        if name == c.ADAM_OPTIMIZER:
            return FusedAdam(**params)
        if name == c.LAMB_OPTIMIZER:
            return FusedLamb(**params)
        if name in (c.ONEBIT_ADAM_OPTIMIZER, c.ONEBIT_LAMB_OPTIMIZER):
            raise _not_ported(f"the {name!r} optimizer",
                              "compressed comm (A.7)")
        raise DeepSpeedConfigError(f"Unknown optimizer {name!r}")

    def _check_partitioned_optimizer(self):
        """Across ranks at stages 1-2, and at stage 3 on any world, each
        rank steps its partition of the flat state: the flat Adam does;
        Lamb's per-parameter trust ratio and a client's update over the
        whole flat masters do not run on a partition yet."""
        if not (self._partitioned or self._zero3_on) or \
                isinstance(self.optimizer, FusedAdam):
            return
        raise _not_ported(
            f"{type(self.optimizer).__name__} on a ZeRO stage "
            f"{self.zero_optimization_stage()} partition across "
            f"{self.dp_world_size} ranks (Adam partitions; use ZeRO "
            f"stage 0 for Lamb or a client optimizer)", "ranks (A.6)")

    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            if callable(client_scheduler) and not hasattr(
                    client_scheduler, "step"):
                return client_scheduler(self.optimizer)
            return client_scheduler
        if self._config.scheduler_name is None:
            return None
        cls = get_scheduler_class(self._config.scheduler_name)
        sched = cls(self.optimizer, **(self._config.scheduler_params or {}))
        log_dist(f"Using configured LR scheduler "
                 f"{self._config.scheduler_name}", ranks=[0])
        return sched

    def _configure_data_parallel(self, mesh=None):
        """The data-parallel world: the `torch.distributed` default
        group when one exists (at any world size, 1 included), else one
        rank and no collectives. Stages 1-2 partition the flat state
        (``_part``, this rank's range, set by `_init_state`).

        ``mesh``: a 1-D `DeviceMesh` over the default group's ranks,
        named "expert" or "data" (the JAX engine's ``mesh``). Its axis is
        the data axis, so ``dp_world_size`` is the world either way, as
        in JAX; an "expert" axis also shards the MoE blocks' experts
        (``ep``, `_configure_moe_ranks`)."""
        from ..utils import distributed as ds_dist
        self.mp_world_size = 1
        self.dp_world_size = ds_dist.get_world_size()
        self.dp_rank = ds_dist.get_rank()
        self.dp_group = None
        self._part = None
        self.mesh = mesh
        self.ep = 1
        self.expert_mesh = False
        if mesh is not None:
            names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
            if getattr(mesh, "ndim", len(names)) != 1:
                raise _not_ported(
                    f"a {getattr(mesh, 'ndim', len(names))}-D mesh "
                    f"{names} (the data axis beside an \"expert\" or a "
                    f"model axis)", "tensor / sequence parallel (A.6)")
            if names and names[0] not in ("expert", "data"):
                raise _not_ported(f"a mesh axis named {names[0]!r}",
                                  "tensor / sequence parallel (A.6)")
            if not ds_dist.is_initialized() or \
                    mesh.size() != ds_dist.get_world_size():
                raise DeepSpeedConfigError(
                    f"the mesh spans {mesh.size()} ranks; it must span "
                    f"the default process group's "
                    f"{ds_dist.get_world_size()} (init_distributed first)")
            if names and names[0] == "expert":
                self.expert_mesh = True
                self.ep = mesh.size()
        if not ds_dist.is_initialized():
            return
        import torch.distributed as dist
        if dist.get_backend() == "nccl" and self.device.type != "cuda":
            raise DeepSpeedConfigError(
                f"the process group's backend is nccl but the model is on "
                f"{self.device}: build the model on the rank's card, or "
                f"init_distributed(dist_backend=\"gloo\") for the CPU")
        self.dp_group = dist.group.WORLD

    def _configure_moe_ranks(self):
        """MoE under a process group: the model's blocks route the global
        micro-batch of the data-parallel group (`models.gpt_neox.
        MoEComm`), and on an "expert" mesh the model keeps this rank's
        E/world experts (`shard_experts`), which the blocks reach through
        two all-to-alls. What the expert mesh does not carry raises:
        ZeRO stages 1-3 (the JAX engine maps "expert" twice there and
        raises DuplicateSpecError), the einsum engine, quantization.ffn,
        sparse_gradients and the flops count of the telemetry and the
        flops profiler (A.6). At world 1 (as in JAX, whose specs shard
        nothing over a 1-device axis) nothing is refused and the
        exchange is a copy."""
        cfg = self._config
        # the model's own config says whether it is MoE (the JSON block
        # or a config built with experts), as the JAX model's specs read
        moe = bool(getattr(getattr(self.module, "config", None),
                           "moe_num_experts", 0))
        if self.ep > 1 and moe:
            def refuse(what):
                return _not_ported(f"{what} on an \"expert\" mesh",
                                   "ranks (A.6)")
            if self.zero_optimization_stage() >= 1:
                raise DeepSpeedConfigError(
                    f"ZeRO stage {self.zero_optimization_stage()} on an "
                    f"\"expert\" mesh is unsupported: the JAX engine "
                    f"shards the expert leaves and the ZeRO state both "
                    f"over that one axis and raises DuplicateSpecError "
                    f"(PartitionSpec('expert', 'expert')); train the "
                    f"experts at stage 0")
            if self.module.config.moe_dispatch != "sort":
                raise refuse("moe.dispatch \"einsum\" (the exchange runs "
                             "the sort engine's grouped matmul)")
            if (cfg.quantization_config or {}).get("ffn"):
                raise refuse("quantization.ffn (its amax over the whole "
                             "buffer needs a max over the owners)")
            if self.sparse_gradients_enabled():
                raise refuse("sparse_gradients")
            if cfg.flops_profiler_config.enabled or \
                    cfg.telemetry_config.get("enabled"):
                raise refuse("the flops count (flops_profiler, "
                             "telemetry)")
            self.module.shard_experts(self.dp_rank, self.ep)
        elif not moe:
            # no experts to shard: data parallel
            self.ep, self.expert_mesh = 1, False
        if moe and self.dp_group is not None and \
                hasattr(self.module, "moe_comm"):
            from ..models.gpt_neox import MoEComm
            self.module.moe_comm = MoEComm(self.dp_group, self.expert_mesh)

    @property
    def _zero3_on(self):
        return self.zero_optimization_stage() == 3

    def _check_zero3(self):
        """What stage 3 does not carry in this port raises "not ported"
        (A.6), rather than training without it: a model without
        `build_zero3_loss` (GPT-2, BERT, client modules), MoE and sparse
        attention under "gspmd" (under "explicit" the model raises the
        JAX schedule's own errors), ``quantization.ffn`` under "gspmd"
        (`_configure_quantization` raises the JAX error under
        "explicit"), ``sparse_gradients``, the fork features that read a
        whole gradient (``store_gradients``) and the flops profiler,
        whose timed step runs the model's parameters in place. The
        explicit schedule with progressive layer drop raises the JAX
        engine's error."""
        if not self._zero3_on:
            return
        cfg = self._config
        explicit = cfg.zero_config.schedule.mode == "explicit"

        def refuse(what):
            return _not_ported(f"{what} with ZeRO stage 3", "ZeRO-3 (A.6)")
        if explicit and cfg.pld_enabled:
            raise DeepSpeedConfigError(
                "explicit schedule + progressive_layer_drop is "
                "unsupported (theta is not threaded through the "
                "scheduled block scan)")
        if not hasattr(self.module, "build_zero3_loss"):
            raise refuse(f"{type(self.module).__name__} (the port "
                         f"partitions GPT-NeoX's layers)")
        if not explicit:
            if cfg.moe_enabled:
                raise refuse("the \"moe\" block")
            if cfg.sparse_attention:
                raise refuse("the \"sparse_attention\" block")
            if (cfg.quantization_config or {}).get("ffn"):
                raise refuse("quantization.ffn")
        if self.sparse_gradients_enabled():
            raise refuse("sparse_gradients")
        if cfg.store_gradients:
            raise refuse("store_gradients")
        if cfg.flops_profiler_config.enabled:
            raise refuse("the \"flops_profiler\" block")

    @property
    def _partitioned(self):
        """Stages 1-2 under a process group: each rank keeps the fp32
        masters and moments (stage 2: the accumulator too) of one
        contiguous, 16-byte aligned range of the flat buffers."""
        return self.dp_group is not None and \
            self.zero_optimization_stage() >= 1

    def _init_state(self):
        """The flat state from the model's parameters: fp32 masters (in
        the lean state the flat compute-dtype buffer is the master, and
        no fp32 copy is made); the parameters become views into the flat
        compute-dtype buffer and their grads views into the flat
        gradient buffer. A separate fp32 accumulator exists where the
        compute dtype is 16-bit, except in the lean state with one
        micro-batch a step, whose gradients reach Adam as they are.

        Partitioned across ranks (stages 1-2): the flat compute and
        gradient buffers are whole (padded to ``_part.padded``); the
        masters and the moments are this rank's partition (with fp32
        compute, a view of the parameters' partition); stage 1 keeps a
        whole fp32 accumulator and a partition it is reduce-scattered
        into (``_grad_part``), stage 2 an fp32 accumulator of the
        partition only.

        On an "expert" mesh (``ep`` > 1, stage 0) the buffers hold this
        rank's experts, and their leaves come last, one contiguous range
        (``_expert_range``) that the step does not all-reduce;
        ``natural_slices`` is the whole model's natural layout
        (`_natural_flat` gathers a buffer into it).

        Stage 3: `_init_zero3_state`."""
        self._z3 = self._z3_loss = None
        self._expert_range = None
        if self._zero3_on:
            self._init_zero3_state()
            self.natural_slices = self.param_slices
            return
        named = list(self.module.named_parameters())
        if self.ep > 1:
            from ..models.gpt_neox import is_expert_leaf
            whole = [(n, (p.shape[0] * self.ep,) + tuple(p.shape[1:])
                      if is_expert_leaf(n) else tuple(p.shape))
                     for n, p in named]
            named = [leaf for leaf in named if not is_expert_leaf(leaf[0])] \
                + [leaf for leaf in named if is_expert_leaf(leaf[0])]
        self.param_names = [n for n, _ in named]
        sizes = [p.numel() for _, p in named]
        self.num_params = int(sum(sizes))
        dev, cdt = self.device, self.compute_dtype
        offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        # (name, lo, hi, shape) of every leaf in the flat buffers
        self.param_slices = [(n, lo, hi, tuple(p.shape)) for (n, p), lo, hi
                             in zip(named, offsets[:-1], offsets[1:])]
        self.natural_slices = self.param_slices
        if self.ep > 1:
            n_exp = sum(p.numel() for n, p in named if is_expert_leaf(n))
            self._expert_range = (self.num_params - n_exp, self.num_params)
            wsz = [int(np.prod(shape)) for _, shape in whole]
            woff = np.concatenate([[0], np.cumsum(wsz)]).tolist()
            self.natural_slices = [(n, lo, hi, shape) for (n, shape), lo, hi
                                   in zip(whole, woff[:-1], woff[1:])]
        lean = not self.keep_master and cdt != torch.float32
        part = self._part = flat_partition(
            self.num_params, self.dp_world_size, self.dp_rank) \
            if self._partitioned else None
        flat_n = part.padded if part is not None else self.num_params
        full = torch.zeros(flat_n, dtype=cdt if lean else torch.float32,
                           device=dev)
        with torch.no_grad():
            for (_, p), lo, hi in zip(named, offsets[:-1], offsets[1:]):
                full[lo:hi].copy_(p.detach().reshape(-1))
        self._params_flat = full if full.dtype == cdt else full.to(cdt)
        self._grads_flat = torch.zeros(flat_n, dtype=cdt, device=dev)
        one_micro_lean = lean and self.gradient_accumulation_steps() == 1
        self._grad_part = None
        if part is None:
            self._master = full
            self._grad_acc = self._grads_flat \
                if cdt == torch.float32 or one_micro_lean else \
                torch.zeros(flat_n, dtype=torch.float32, device=dev)
        else:
            self._master = self._params_flat[part.lo:part.hi] \
                if cdt == torch.float32 else full[part.lo:part.hi].clone()
            if self.zero_optimization_stage() >= 2:
                self._grad_acc = self._grad_part = torch.zeros(
                    part.size, dtype=torch.float32, device=dev)
            else:
                self._grad_acc = self._grads_flat \
                    if cdt == torch.float32 else \
                    torch.zeros(flat_n, dtype=torch.float32, device=dev)
                self._grad_part = torch.zeros(part.size,
                                              dtype=torch.float32,
                                              device=dev)
        del full
        self._grad_ptrs = []
        for (_, p), lo, hi in zip(named, offsets[:-1], offsets[1:]):
            p.data = self._params_flat[lo:hi].view(p.shape)
            p.requires_grad_(True)
            p.grad = self._grads_flat[lo:hi].view(p.shape)
            self._grad_ptrs.append(p.grad.data_ptr())
        self._grads_checked = False
        if isinstance(self.optimizer, FusedLamb):
            # the trust ratio is per parameter: each leaf's span of the
            # flat buffers
            self.opt_state = self.optimizer.init_state(
                self._master, segments=[(lo, hi) for _, lo, hi, _ in
                                        self.param_slices])
        else:
            self.opt_state = self.optimizer.init_state(self._master)

    def _init_zero3_state(self):
        """Stage 3's state (`zero/stage3.py`): the natural fp32 flat
        buffer of the model's parameters is cut into this rank's
        partition of the row layout (fp32 masters; the compute shard, the
        masters themselves in fp32 compute; the moments and the fp32
        accumulator alike) and the whole persisted row; the module's
        parameters then hold no data but the persisted leaves (views of
        the persisted row), and the model's `build_zero3_loss` sets the
        schedule. ``param_slices`` keep the natural flat order of stage
        0, which the checkpoints and the whole-model readers use."""
        named = list(self.module.named_parameters())
        self.param_names = [n for n, _ in named]
        sizes = [p.numel() for _, p in named]
        self.num_params = int(sum(sizes))
        dev, cdt = self.device, self.compute_dtype
        offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        self.param_slices = [(n, lo, hi, tuple(p.shape)) for (n, p), lo, hi
                             in zip(named, offsets[:-1], offsets[1:])]
        zconf = self._config.zero_config
        sched = zconf.schedule
        rules = ZeroShardingRules(
            3, self.dp_world_size,
            param_persistence_threshold=zconf.param_persistence_threshold)
        itemsize = torch.empty(0, dtype=cdt).element_size()
        layout = Zero3Layout(
            self.param_slices, self.dp_world_size, rules,
            bucket_bytes=sched.bucket_bytes if sched.mode == "explicit"
            else 0, itemsize=itemsize)
        natural = torch.empty(self.num_params, dtype=torch.float32,
                              device=dev)
        with torch.no_grad():
            for (_, p), lo, hi in zip(named, offsets[:-1], offsets[1:]):
                natural[lo:hi].copy_(p.detach().reshape(-1))
        self._master = layout.to_partition(natural, self.dp_rank)
        self._params_flat = self._master if cdt == torch.float32 else \
            self._master.to(cdt)
        persist = layout.persisted_whole(natural).to(cdt) \
            if layout.persisted is not None else \
            torch.empty(0, dtype=cdt, device=dev)
        del natural
        self._grads_flat = None
        self._grad_acc = self._grad_part = torch.zeros(
            layout.part_size, dtype=torch.float32, device=dev)
        by_name = {leaf.name: leaf for leaf in layout.persisted.leaves} \
            if layout.persisted is not None else {}
        for name, p in named:
            leaf = by_name.get(name)
            p.requires_grad_(False)
            p.grad = None
            p.data = persist[leaf.offset:leaf.offset + leaf.numel].view(
                p.shape) if leaf is not None else \
                torch.empty(0, dtype=cdt, device=dev)
        self._grad_ptrs = []
        self._grads_checked = True
        reduce_dtype = torch.float32 if self.allreduce_always_fp32() \
            else cdt
        self._z3 = Zero3Runtime(layout, self.dp_rank, self.dp_group,
                                self._params_flat, self._grad_acc, persist,
                                reduce_dtype,
                                self.module.config.num_layers)
        self._z3_loss = self.module.build_zero3_loss(self._z3, sched)
        self.opt_state = self.optimizer.init_state(self._master)

    def _configure_observability_pre(self):
        """The flops profiler and the monitor, before the checkpoint
        manager (the JAX engine's order; the telemetry follows the
        manager, `_configure_telemetry`).

        The flops profiler (reference `engine.py:966-1019`) counts and
        times the train step once, at ``flops_profiler.profile_step``.
        The monitor (reference `engine.py:163-164,1222-1275`) is the
        tensorboard event stream of loss / lr / scale / grad-norm /
        step-time keyed by global sample count; an armed
        ``monitor.export`` backend builds it without a tensorboard block,
        as in JAX. ``wall_clock_breakdown`` arms the synchronized timer
        group (a device sync at each phase edge, by design)."""
        self.timers = SynchronizedWallClockTimer()
        self.flops_profiler = None
        self._flops_profiled = False
        if self._config.flops_profiler_config.enabled:
            from ..profiling.flops_profiler.profiler import FlopsProfiler
            self.flops_profiler = FlopsProfiler(engine=self)
        self.monitor = None
        self._last_step_stamp = None
        self._last_used_lr = None
        self._step_metrics = {}
        # rank 0 writes the event stream (the JAX package's process 0)
        if (self._config.tensorboard_enabled or
                self._config.monitor_export_active) and self.dp_rank == 0:
            from .monitor import TensorBoardMonitor
            self.monitor = TensorBoardMonitor(
                output_path=self._config.tensorboard_output_path,
                job_name=self._config.tensorboard_job_name,
                export=self._config.monitor_export_config)
        # MoE routing observability (moe.observability): the sort engine
        # queues its statistics as device tensors, drained into
        # Train/MoE/* scalars at each step record
        moe_cfg = self._config.moe_params
        self._moe_observe = bool(moe_cfg and moe_cfg.get("observability"))

    def _configure_telemetry(self):
        """The "telemetry" block (runtime/telemetry.py): spans mirrored
        into `torch.profiler.record_function`, goodput buckets, in-engine
        MFU from the flops profiler's count, trigger-driven capture.
        `NULL_TELEMETRY` (every hook a no-op) when the block is absent,
        and on every rank but 0."""
        from .telemetry import build_telemetry
        # rank 0 measures and writes, as the JAX package's process 0
        self.telemetry = build_telemetry(
            self._config.telemetry_config if self.dp_rank == 0 else None,
            monitor=self.monitor, devices=[self.device])
        self._step_flops = {}   # step-variant key (gas) -> flops a step

    @property
    def _monitor_wants_grad_norm(self):
        """The global gradient norm costs a read pass over the flat
        gradient: compute it only when something reports it."""
        return (self._config.tensorboard_enabled
                or self.gradient_noise_scale is not None
                or self.sentinel is not None)

    def _configure_quantization(self, qz):
        """Arm the delayed-scaling FFN (``quantization.ffn``; the model's
        FFN already runs the recipe, `apply_ds_config` wired it) and seat
        its zero amax history in ``quant``. The JAX engine's refusals
        with its messages: progressive layer drop, and a model without
        ``init_ffn_amax``. The offload tiers and ZeRO-3, which it also
        refuses here, the port's config refuses as not ported, as it
        does ``gradient_compression``."""
        if self._config.pld_enabled:
            raise DeepSpeedConfigError(
                "quantization + progressive_layer_drop is unsupported "
                "(theta and the amax state cannot both thread through "
                "the block scan yet)")
        if self._z3 is not None and \
                self._config.zero_config.schedule.mode == "explicit":
            raise DeepSpeedConfigError(
                "quantization.ffn with the explicit ZeRO-3 schedule "
                "is unsupported (the scheduled block scan does not "
                "thread amax state); use schedule.mode \"gspmd\", "
                "or drop quantization.ffn and keep "
                "gradient_compression")
        if not hasattr(self.module, "init_ffn_amax"):
            raise DeepSpeedConfigError(
                "quantization.ffn needs a model exposing "
                "init_ffn_amax()/loss_fn(ffn_amax=...) "
                "(models.gpt_neox.GPTNeoX implements it)")
        amax = self.module.init_ffn_amax()
        if amax is None:
            raise DeepSpeedConfigError(
                "quantization.ffn is configured but the model has "
                "no ffn_quant recipe — apply_ds_config did not "
                "reach it (pass the config to deepspeed.initialize)")
        self.quant = QuantState(amax=amax.to(self.device))
        self._quant_step_active = True
        log_dist(f"quantization armed: ffn={qz['ffn']['recipe']}, "
                 f"gradient_compression=False", ranks=[0])

    def _quant_state_dict(self):
        """Host snapshot of ``quant`` for model_states: {"amax": fp32
        ndarray, "ef": None}, or None when no quantization path is
        armed (the JAX engine's layout)."""
        if self.quant is None:
            return None
        return {"amax": self.quant.amax.detach().to("cpu").numpy(),
                "ef": None}

    def _restore_quant_state(self, payload):
        """Re-seat checkpointed quantization state with the JAX engine's
        rules: armed and a payload with a matching amax shape: restore
        it; armed and no payload (a checkpoint from before the block was
        on): keep the zero history, with a warning; a mismatched shape:
        keep the zeros, with a warning; not armed: ignore a payload, with
        a warning."""
        if self.quant is None:
            if payload and (payload.get("amax") is not None or
                            payload.get("ef") is not None):
                logger.warning(
                    "checkpoint carries quantization state but this "
                    "engine has no quantization block — ignoring it "
                    "(the run continues as configured)")
            return
        if not payload:
            logger.warning(
                "quantization is armed but the checkpoint has no "
                "quantization state (saved before the block was "
                "enabled?) — amax history / error feedback restart "
                "from zeros")
            return
        if payload.get("amax") is None:
            return
        saved = torch.as_tensor(np.asarray(payload["amax"], np.float32))
        amax = self.quant.amax
        if tuple(saved.shape) == tuple(amax.shape):
            self.quant = self.quant._replace(amax=saved.to(self.device))
        else:
            logger.warning(
                f"saved amax history {tuple(saved.shape)} does not match "
                f"the configured {tuple(amax.shape)} "
                f"(amax_history_len/layer change?) — restarting "
                f"from zeros")

    def _check_grad_views(self):
        """After the first backward: autograd added into the flat
        gradient buffer's views and replaced none of them."""
        params = dict(self.module.named_parameters())
        for name, ptr in zip(self.param_names, self._grad_ptrs):
            p = params[name]
            if p.grad is None or p.grad.data_ptr() != ptr:
                raise RuntimeError(
                    f"autograd replaced the gradient view of {name}: the "
                    f"flat gradient buffer no longer holds it")
        self._grads_checked = True

    def pack_dataset(self, docs, seq_len=None):
        """Pack a ragged document list into a `PackedDataset` using the
        validated "packing" block's `pad_id`/`drop_tail`: the config is
        the one source of those knobs (a hand-built `PackedDataset` with
        other values would desync pad detection from the model's segment
        masking). `seq_len` defaults to the model's `config.max_seq_len`.
        Feed the result to `deepspeed_io` or iterate it directly into
        `train_batch`."""
        params = getattr(self._config, "packing_params", None)
        if not params:
            raise DeepSpeedConfigError(
                "pack_dataset requires the 'packing' config block with "
                "\"enabled\": true")
        if seq_len is None:
            seq_len = getattr(getattr(self.module, "config", None),
                              "max_seq_len", None)
            if seq_len is None:
                raise DeepSpeedConfigError(
                    "pack_dataset could not infer the packing window "
                    "from model.config.max_seq_len; pass seq_len "
                    "explicitly")
        from .packing import PackedDataset
        return PackedDataset(docs, seq_len, **params)

    def deepspeed_io(self, dataset, batch_size=None, route="train",
                     data_sampler=None, collate_fn=None):
        """A `DeepSpeedDataLoader` of micro-batches over ``dataset``."""
        return DeepSpeedDataLoader(
            dataset=dataset,
            batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn or self.collate_fn,
            data_sampler=data_sampler,
            tput_timer=self.tput_timer if route == "train" else None)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _to_device(self, x):
        """One batch leaf on the training device with its kind kept:
        integers as long, floats as they are."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        return t.to(device=self.device,
                    dtype=None if t.is_floating_point() else torch.long)

    @staticmethod
    def _map(batch, fn):
        """``fn`` on every leaf of a dict, a tuple or a bare batch (a
        leaf of None stays None)."""
        if isinstance(batch, dict):
            return {k: None if v is None else fn(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return tuple(None if v is None else fn(v) for v in batch)
        return fn(batch)

    def _device_batch(self, batch):
        """The batch on the device, every leaf with its kind kept; each
        model's ``loss_fn`` unpacks its own micro-batch."""
        return self._map(batch, self._to_device)

    @staticmethod
    def _input_ids(batch):
        """The token ids of a batch (``input_ids``, an RL batch's
        ``tokens``, or the first leaf)."""
        if isinstance(batch, dict):
            for key in ("input_ids", "tokens"):
                if key in batch:
                    return batch[key]
            return next(iter(batch.values()))
        return batch[0] if isinstance(batch, tuple) else batch

    def _current_lr(self):
        return float(self.optimizer.param_groups[0]["lr"])

    def train_batch(self, data_iter=None, batch=None, layers_to_hook=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches: ``batch`` = (tokens, labels) (or bare tokens, or
        a packed (tokens, labels, segment_ids) triple) shaped
        [gas, micro, S] for GPT-NeoX and GPT-2, a dict or tuple of
        [gas, micro, ...] arrays for BERT, numpy or tensors; or
        ``data_iter`` yielding one micro-batch per ``next``.
        ``layers_to_hook`` captures those layers' outputs on the first
        micro-batch (`set_layers_to_hook`). Returns the mean loss."""
        if layers_to_hook is not None:
            self.set_layers_to_hook(layers_to_hook)
        tel = self.telemetry
        tel.on_step_start(self.global_steps)
        gas = self.gradient_accumulation_steps()
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            # the host input pipeline: the goodput data_wait bucket is fed
            # by this span
            with tel.span("data_fetch"):
                micro = [next(data_iter) for _ in range(gas)]
                if isinstance(micro[0], dict):
                    batch = {k: np.stack([np.asarray(m[k]) for m in micro])
                             for k in micro[0]}
                elif isinstance(micro[0], (tuple, list)):
                    batch = tuple(np.stack([np.asarray(m[i]) for m in micro])
                                  for i in range(len(micro[0])))
                else:
                    batch = np.stack([np.asarray(m) for m in micro])
        self._warn_gns_not_fed("train_batch")
        if self._accum_count:
            raise RuntimeError(
                f"train_batch with {self._accum_count} micro-batch(es) of "
                f"the forward/backward/step loop not yet stepped")

        fault = None
        stall_s = 0.0
        if self._fault_injector is not None:
            mode, factor, stall_s = self._fault_injector.plan_next_step()
            # the serving kinds do nothing in training (the elastic ones
            # are refused at construction)
            self._fault_injector.take_host_faults()
            fault = (mode, factor)
        # hang watchdog: this step must complete (through the sentinel's
        # flags read in _after_step) before the deadline. Armed only
        # once this kind of step has run: the first one builds the
        # kernels and sets up cuBLAS, which is not a hang.
        key = (gas, fault is not None)
        if self.sentinel is not None and key in self._steps_run:
            self.sentinel.watchdog_arm()
        self._steps_run.add(key)
        if stall_s > 0:
            time.sleep(stall_s)   # deterministic hung-step fault
        try:
            return self._train_batch_execute(batch, gas, fault)
        except BaseException:
            # the step DIED rather than hung: disarm, or the deadline
            # would later fire a spurious stack dump and preemption
            # request while the caller handles the exception
            if self.sentinel is not None:
                self.sentinel.watchdog_feed()
            raise

    def _train_batch_execute(self, batch, gas, fault):
        tel = self.telemetry
        token_stats = None
        if tel.enabled:
            # packed batches: effective (non-pad, non-cross-document) vs
            # possible targets, counted on the host (one read of the
            # segment ids where they are device tensors; None unpacked)
            from .packing import packed_batch_token_stats
            token_stats = packed_batch_token_stats(self._map(
                batch, lambda v: v.cpu() if isinstance(v, torch.Tensor)
                else v) if isinstance(batch, tuple) and len(batch) == 3
                else batch)
        with tel.outside_window():
            self._maybe_profile_flops(batch)
        if self.wall_clock_breakdown():
            self.timers("comms").start()
        with tel.span("h2d"):
            batch = self._device_batch(batch)
        if self.wall_clock_breakdown():
            self.timers("comms").stop()
        tokens = self._input_ids(batch)
        # token ids [gas, micro, S], or a client module's floating
        # features [gas, micro, S, width] (as the JAX engine, any
        # [gas, micro, ...] leaves)
        features = tokens.is_floating_point() and tokens.dim() == 4
        if not (tokens.dim() == 3 or features) or tokens.shape[0] != gas:
            raise ValueError(f"train_batch expects [gas={gas}, micro, S] "
                             f"batches, got {tuple(tokens.shape)}")
        if tel.wants_flops and gas not in self._step_flops:
            # the step variant's flops, counted once over fake tensors
            # and outside the step window (the JAX engine harvests them
            # once from its compiled step)
            from ..profiling.flops_profiler.profiler import \
                count_train_flops
            with tel.outside_window():
                micro_flops = count_train_flops(
                    self, self._map(batch, lambda v: v[0]),
                    rng_seed=micro_step_seed(self.micro_steps))
            self._step_flops[gas] = micro_flops * gas
            tel.register_compiled(gas, self._step_flops[gas])
        self.tput_timer.start()
        if self._layers_to_hook:
            self._capture_activations(self._map(batch, lambda v: v[0]))
        # the amax history in micro-step order: each micro-step reads what
        # the one before it wrote; the step's update keeps the last
        amax = self.quant.amax if self._quant_step_active else None
        with tel.span("train_dispatch"), \
                tel.step_annotation(self.global_steps):
            for i in range(gas):
                self._rng.manual_seed(micro_step_seed(self.micro_steps))
                kw = self._pld_kwargs()
                if amax is not None:
                    kw["ffn_amax"] = amax
                loss = self._loss(self._map(batch, lambda v: v[i]),
                                  self._rng, **kw)
                if amax is not None:
                    loss, amax = loss
                    if self.dp_world_size > 1:
                        # the JAX history is the global micro-batch's:
                        # the max over the ranks' own
                        import torch.distributed as dist
                        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                                        group=self.dp_group)
                self._micro_backward(loss)
            quant = None if amax is None else self.quant._replace(amax=amax)
            mean_loss, overflow = self._update_accumulated(
                fault=fault, probe_loss=True, quant=quant)
        verdict = self._after_step(overflow)
        self.tput_timer.stop(tokens=tokens.shape[:3].numel())
        tel.on_step_end(self, verdict=verdict,
                        flops=self._step_flops.get(gas), tokens=token_stats)
        return mean_loss

    def _loss(self, batch, rng, **kw):
        """The installed loss of one micro-batch: over the module's
        parameter tree, or at stage 3 through the model's fetch hook
        (`GPTNeoX.build_zero3_loss`), which gathers the parameters."""
        if self._z3_loss is not None:
            return self._z3_loss(batch, rng=rng, **kw)
        return self.loss_fn(self.module.params_tree(), batch, rng=rng, **kw)

    def _pld_kwargs(self):
        """``pld_theta`` for a model whose ``loss_fn`` declares it:
        theta(t) = (1 - p)·e^{-γt} + p at t = ``global_steps``, in fp32 as
        the JAX step computes it from its step counter."""
        if not self._pld_in_loss:
            return {}
        p = self._config.pld_params["theta"]
        gamma = self._config.pld_params["gamma"]
        t = np.float32(self.global_steps)
        theta = np.float32(1.0 - p) * np.exp(np.float32(-gamma) * t) + \
            np.float32(p)
        return {"pld_theta": float(np.float32(theta))}

    def _micro_backward(self, loss, per_micro=None):
        """One micro-batch's backward (the loss times the loss scale,
        fp16 only) into the flat gradient views, then into the
        accumulator; the loss joins the step's sum. ``per_micro`` (the
        legacy loop's debugging features) sees this micro-batch's
        gradients alone, scaled, in the compute dtype: where the
        gradient buffer is the accumulator, the earlier micro-batches'
        sum is set aside while autograd runs and added back after, which
        gives the same sum bit for bit (one IEEE add, commutative)."""
        if self._z3 is not None:
            # stage 3: each row's backward reduce-scatters into the fp32
            # partition accumulator (`zero.stage3._FetchRow`)
            (loss * self.scale_state.cur_scale
             if self._config.loss_scaling_enabled else loss).backward()
            self._count_micro(loss)
            return
        stash = None
        if per_micro is not None and self._grad_acc is self._grads_flat \
                and self._accum_count:
            stash = self._grads_flat.clone()
            self._grads_flat.zero_()
        (loss * self.scale_state.cur_scale
         if self._config.loss_scaling_enabled else loss).backward()
        if not self._grads_checked:
            self._check_grad_views()
        if per_micro is not None:
            per_micro(self._grads_flat)
        if stash is not None:
            self._grads_flat.add_(stash)
        elif self._grad_acc is self._grad_part:
            # stage 2: the micro-batch's sum over the ranks into this
            # rank's fp32 partition accumulator
            reduce_scatter_(
                self._grad_acc, self._grads_flat, self._part, self.dp_group,
                dtype=self._reduce_dtype(self._grads_flat),
                bucket=self._config.zero_config.reduce_bucket_size,
                accumulate=True)
            self._grads_flat.zero_()
        elif self._grad_acc is not self._grads_flat:
            self._grad_acc.add_(self._grads_flat)
            self._grads_flat.zero_()
        self._count_micro(loss)

    def _count_micro(self, loss):
        """The micro-batch's loss into the step's sum, and the counts."""
        loss = loss.detach().float()
        self._accum_loss = loss if self._accum_loss is None else \
            self._accum_loss + loss
        self._accum_count += 1
        self.micro_steps += 1

    def _step_update(self, fault=None, probe_loss=False, quant=None):
        """The step over the accumulated micro-batches
        (`_update_accumulated`), then the step boundary (`_after_step`).
        Returns (the mean loss, the step's verdict)."""
        mean_loss, overflow = self._update_accumulated(
            fault=fault, probe_loss=probe_loss, quant=quant)
        return mean_loss, self._after_step(overflow)

    def _update_accumulated(self, fault=None, probe_loss=False, quant=None):
        """The update over the accumulated micro-batches: the mean
        gradient (corrupted by ``fault``, an injected ``(mode, factor)``,
        where given) through `_apply_update`. The probe sees the mean
        loss where ``probe_loss`` (`train_batch`); the legacy loop's
        update has no loss, as in JAX. ``quant`` is the step's new
        `QuantState`, kept if the step is taken. Returns (the mean loss,
        the overflow flag)."""
        n = self._accum_count
        lr = self._current_lr()
        self._last_used_lr = lr   # what THIS step runs with (monitor)
        grads = self._reduced_grads()
        if n * self.dp_world_size > 1:
            grads.div_(n * self.dp_world_size)
        loss = self._accum_loss / n
        if self.dp_group is not None:
            import torch.distributed as dist
            dist.all_reduce(loss, group=self.dp_group)
            if self.dp_world_size > 1:
                loss = loss / self.dp_world_size
        if fault is not None:
            loss, grads = apply_fault(loss, grads, fault)
        overflow = self._apply_update(grads, lr,
                                      loss=loss if probe_loss else None,
                                      quant=quant)
        self._grad_acc.zero_()
        mean_loss = float(loss)
        self._step_metrics["loss"] = mean_loss
        self._accum_count, self._accum_loss = 0, None
        return mean_loss, overflow

    def _reduce_dtype(self, grads):
        """The dtype the ranks sum gradients in: fp32 where
        ``allreduce_always_fp32()`` holds or they are fp32, else their
        own (fp16 reduces in fp16, as the reference does)."""
        if self.allreduce_always_fp32():
            return torch.float32
        return grads.dtype

    def _reduced_grads(self):
        """The accumulated gradients summed over the ranks: the
        accumulator itself with no process group; all-reduced at stage 0
        (the token embeddings' rows gathered as a CSRTensor where
        ``sparse_gradients`` is set); reduce-scattered into this rank's
        fp32 partition at stage 1; stage 2's partition accumulator,
        reduced micro-batch by micro-batch."""
        acc = self._grad_acc
        if self.dp_group is None or acc is self._grad_part:
            return acc
        if self._part is not None:
            reduce_scatter_(self._grad_part, acc, self._part, self.dp_group,
                            dtype=torch.float32)
            return self._grad_part
        import torch.distributed as dist
        red = acc if acc.dtype == self._reduce_dtype(acc) else \
            acc.to(self._reduce_dtype(acc))
        sparse = [(lo, hi, shape) for name, lo, hi, shape in
                  self.param_slices if name in CSR_EMBEDDING_LEAVES] \
            if self.sparse_gradients_enabled() else []
        # this rank's experts (an "expert" mesh) are its own: their
        # gradients stay as they are, scaled like every other leaf
        skip = sorted([(lo, hi) for lo, hi, _ in sparse] +
                      ([self._expert_range] if self._expert_range else []))
        edges = [0] + [b for lo, hi in skip for b in (lo, hi)] + \
            [red.numel()]
        for lo, hi in zip(edges[::2], edges[1::2]):
            if hi > lo:
                dist.all_reduce(red[lo:hi], group=self.dp_group)
        if sparse:
            from .csr_tensor import CSRTensor, csr_allgather
            for lo, hi, shape in sparse:
                dense = red[lo:hi].view(shape)
                dense.copy_(csr_allgather(CSRTensor(dense),
                                          self.dp_group).to_dense())
        return red

    def allreduce_always_fp32(self):
        """bf16 runs reduce in fp32 by default (the fork's rule,
        ``fp32_allreduce``)."""
        return self._config.fp32_allreduce

    def sparse_gradients_enabled(self):
        return self._config.sparse_gradients_enabled

    def allreduce_gradients(self, bucket_size=None):
        """A no-op, as in the JAX engine: the gradients are reduced in
        the step (stages 0-1) or in each micro-batch's backward
        (stage 2)."""

    def _apply_update(self, grads, lr, loss=None, quant=None):
        """Unscale, check, clip, update the masters and recast; on an
        fp16 overflow skip the update. Returns the overflow flag. The
        step's new `QuantState` ``quant`` replaces ``self.quant`` only
        when the update is taken: a skipped step (overflow or
        quarantine) would carry an anomalous step's amax forward. A
        16-bit gradient (the lean state's one micro-batch) goes to Adam
        as it is, or through an fp32 copy where it is unscaled, divided
        or clipped first (the JAX `_apply_update`).

        With the sentinel on, the global norm (after unscale and the
        predivide, before clipping; the clip reuses it) and ``loss`` go
        through the probe, and under policy `skip_batch` or higher a
        hard anomaly skips the update: its flag is read on the host once,
        before the Adam launch, where the JAX step selects the old state
        branchlessly. The loss-scale state advances either way."""
        cfg = self._config
        if grads.dtype != torch.float32 and (
                cfg.loss_scaling_enabled or cfg.prescale_gradients or
                cfg.gradient_clipping > 0):
            grads = grads.float()
        if cfg.loss_scaling_enabled:
            grads.div_(self.scale_state.cur_scale)
        if cfg.prescale_gradients and cfg.gradient_predivide_factor != 1.0:
            grads.div_(cfg.gradient_predivide_factor)
        # a partition's flag and norm are agreed over the ranks; stage
        # 0's gradients are whole and alike on every rank, but for the
        # experts of an "expert" mesh
        group = self.dp_group if self._part is not None or \
            self._z3 is not None or self._expert_range is not None \
            else None
        overflow = cfg.loss_scaling_enabled and \
            not bool(grads_finite(grads, group))
        skip = overflow
        # the global norm (after unscale and the predivide, before
        # clipping; the clip reuses it) where the probe or the monitor
        # reads it: a 0-d device tensor, read at the monitor's flush
        grad_norm = self._grad_norm(grads, group) if \
            self._monitor_wants_grad_norm or (
                (group is not None or self._z3 is not None) and
                cfg.gradient_clipping > 0) else None
        self._step_metrics["grad_norm"] = grad_norm
        # the scale this step ran with (the JAX step's metrics.loss_scale)
        self._step_metrics["loss_scale"] = self.scale_state.cur_scale
        if self.sentinel is not None:
            self.health, hard = probe_update(
                self.health, loss, grad_norm,
                grad_anomaly(self, self.scale_state, grad_norm, overflow),
                self.sentinel.probe_config)
            if self.sentinel.probe_config.quarantine and not overflow:
                skip = bool(hard)
        if not skip:
            if quant is not None:
                self.quant = quant
            if cfg.gradient_clipping > 0:
                self._step_metrics["grad_norm"] = clip_grad_norm_(
                    grads, cfg.gradient_clipping, norm=grad_norm)
            compute_out = self._compute_out()
            if is_client_optimizer(self.optimizer):
                self._client_update(grads, lr, compute_out)
            else:
                self.opt_state = self.optimizer.update(
                    grads, self.opt_state, self._master, lr=lr,
                    compute_out=compute_out,
                    use_kernel=getattr(self.module, "use_kernels", True))
            if self._part is not None:
                # every rank's new compute partition into every rank's
                # flat parameter buffer
                all_gather_(self._params_flat, self._part, self.dp_group)
            if self._z3 is not None:
                self._z3.refresh_persisted()
        if self.dynamic_loss_scale():
            scaler = self.loss_scaler
            self.scale_state = update_loss_scale(
                self.scale_state, overflow,
                scale_factor=scaler.scale_factor,
                scale_window=scaler.scale_window,
                min_scale=scaler.min_scale,
                delayed_shift=scaler.delayed_shift,
                consecutive_hysteresis=scaler.consecutive_hysteresis)
        else:
            self.scale_state = self.scale_state._replace(
                cur_iter=self.scale_state.cur_iter + 1)
        return overflow

    def _grad_norm(self, grads, group):
        """The global norm of the (partitioned) gradient. At stage 3 on
        one rank the partition holds every row in the row layout's
        order; the norm is taken over the natural order, stage 0's flat
        layout, so a reduction over the same elements in the same order
        gives stage 0's norm, and the clip its scale, bit for bit. On an
        "expert" mesh it is ‖dense‖² + Σ_r ‖experts_r‖²: the dense part,
        alike on every rank after the all-reduce, counted once, each
        rank's experts summed over the ranks, so every expert counts
        once, as in JAX."""
        if self._z3 is not None and self.dp_world_size == 1:
            return global_norm(self._z3.layout.to_natural(grads))
        if self._expert_range is not None:
            elo, ehi = self._expert_range
            dense = torch.linalg.vector_norm(grads[:elo].float()).square()
            experts = global_norm(grads[elo:ehi], group).square()
            return (dense + experts).sqrt()
        return global_norm(grads, group)

    def _compute_out(self):
        """Where the optimizer writes the new compute-dtype parameters:
        nothing where the masters are the parameters (or a view of their
        partition), else the flat compute buffer (this rank's
        partition of it across ranks)."""
        if self._master.dtype == self.compute_dtype:
            return None
        if self._part is not None:
            return self._params_flat[self._part.lo:self._part.hi]
        return self._params_flat

    def _client_update(self, grads, lr, compute_out):
        """One step of a client optimizer over the flat masters: its
        ``update(grads, state, master, lr=)`` returns ``(new_master,
        new_state)`` (the JAX protocol); new masters it did not write in
        place are copied into the flat master, and the compute copy is
        written here unless its ``update`` takes ``compute_out`` and
        wrote it itself."""
        kw = {"lr": lr}
        takes_out = compute_out is not None and "compute_out" in \
            inspect.signature(self.optimizer.update).parameters
        if takes_out:
            kw["compute_out"] = compute_out
        new_master, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self._master, **kw)
        with torch.no_grad():
            if new_master is not self._master:
                self._master.copy_(new_master)
            if compute_out is not None and not takes_out:
                compute_out.copy_(self._master)

    def _after_step(self, overflow):
        """Post-step host bookkeeping. Returns the step's verdict: one
        of "ok", "warned", "quarantined", "rollback", "overflow".
        "quarantined" and "overflow" advance no schedule; after a
        "rollback" the state and the counters are the checkpoint's, and
        the step boundary is not run."""
        verdict = "ok"
        if self.sentinel is not None:
            try:
                # sentinel escalation is a bounded phase too: its flag
                # read syncs the device, and warn/rollback work is host
                # time a trace should attribute
                with self.telemetry.span("sentinel"):
                    verdict = self.sentinel.after_step(self)
            finally:
                self.sentinel.watchdog_feed()
            if verdict == "rollback":
                # the state and the counters are the checkpoint's; the
                # poisoned step gives the schedules and the monitor
                # nothing
                return verdict
        if overflow:
            if verdict == "ok":
                verdict = "overflow"   # scale-search skip
            self.skipped_steps += 1
            log_dist(f"OVERFLOW! Skipping step; loss scale now "
                     f"{self.scale_state.cur_scale}", ranks=[0])
            if self._scale_floor is not None and \
                    self._scale_floor.on_skip(self.scale_state.cur_scale) \
                    and self.monitor is not None:
                self.monitor.record(self.global_samples, {
                    "Train/Samples/loss_scale_floor_skips":
                        self._scale_floor.consecutive})
            self._advance_host_schedules(taken=0)
        else:
            if self._scale_floor is not None:
                self._scale_floor.on_step_taken()
            # a quarantined anomaly skipped its update: the schedules do
            # not advance either
            self._advance_host_schedules(
                taken=0 if verdict == "quarantined" else 1)
        if self.monitor is not None:
            self._record_step_metrics()
        return verdict

    def _record_step_metrics(self, sample_count=None):
        """Queue one step's scalars on the monitor (the JAX engine's
        tags). The loss, lr and loss scale are host floats; the grad norm
        and the MoE routing statistics stay 0-d device tensors until the
        monitor's flush reads them in one copy."""
        # lr: the value the step ran with (_last_used_lr), not get_lr():
        # the scheduler has already advanced past this step
        lr = self._last_used_lr
        metrics = self._step_metrics
        scalars = {"Train/Samples/train_loss": metrics.get("loss"),
                   "Train/Samples/lr": lr if lr is not None
                   else self.get_lr()[0]}
        if scalars["Train/Samples/train_loss"] is None:
            del scalars["Train/Samples/train_loss"]
        if self._config.loss_scaling_enabled:
            scalars["Train/Samples/loss_scale"] = metrics.get(
                "loss_scale", self.scale_state.cur_scale)
        if (self._monitor_wants_grad_norm or
                self._config.gradient_clipping > 0) and \
                metrics.get("grad_norm") is not None:
            scalars["Train/Samples/grad_norm"] = metrics["grad_norm"]
        now = time.monotonic()
        if self._last_step_stamp is not None:
            scalars["Train/Samples/step_time_ms"] = \
                (now - self._last_step_stamp) * 1e3
        self._last_step_stamp = now
        if self._moe_observe:
            # the sort engine's expert-load / capacity-drop statistics of
            # this step's forwards (device tensors, averaged here)
            from ..moe.layer import ROUTING_STATS
            moe_stats = ROUTING_STATS.drain()
            if moe_stats:
                scalars.update(moe_stats)
        # wall_clock_breakdown timers land in the event stream too (the
        # reference only printed them): Train/Timers/<name>_ms keyed by
        # the same sample count; elapsed(reset) makes them per step
        if self.wall_clock_breakdown():
            for name, timer in self.timers.timers.items():
                if timer.started_:
                    continue   # mid-phase (the legacy loop): next step
                ms = timer.elapsed(reset=True) * 1e3
                if ms > 0:
                    scalars[f"Train/Timers/{name}_ms"] = ms
        self.monitor.record(
            self.global_samples if sample_count is None else sample_count,
            scalars)

    def _maybe_profile_flops(self, batch, accum_steps=None, stacked=True):
        """Run the flops profiler at `profile_step` (reference
        `engine.py:966-1019`), exactly once: `>=` plus the flag keeps it
        from firing every batch when the step at profile_step is skipped
        by an fp16 overflow (global_steps does not advance on skipped
        steps)."""
        if self.flops_profiler is None or self._flops_profiled:
            return
        fp_cfg = self._config.flops_profiler_config
        if self.global_steps < fp_cfg.profile_step:
            return
        self._flops_profiled = True
        if not stacked:
            batch = self._map(batch, lambda v: v[None])
        self.flops_profiler.profile_train_step(batch,
                                               accum_steps=accum_steps)
        self.flops_profiler.print_model_profile(
            profile_step=fp_cfg.profile_step,
            module_depth=fp_cfg.module_depth,
            top_modules=fp_cfg.top_modules,
            detailed=fp_cfg.detailed)

    def _advance_host_schedules(self, taken):
        """Advance the host-side per-step machinery after ``taken``
        steps, then the checkpoint manager's step boundary."""
        self.global_steps += taken
        self.global_samples += self.train_batch_size() * taken
        for _ in range(taken):
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
            if self.batch_size_scheduler is not None:
                self.batch_size_scheduler.step()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.global_steps and \
                self.global_steps % self.steps_per_print() == 0:
            msg = (f"step={self.global_steps}, skipped={self.skipped_steps}"
                   f", lr={self.get_lr()}, loss_scale={self.loss_scale}")
            if self.sentinel is not None:
                s = self.sentinel
                msg += (f", anomalies={s.anomalies}, quarantined="
                        f"{s.quarantined}, rollbacks={s.rollbacks}")
            log_dist(msg, ranks=[0])
        # step boundary: drain finished saves, honor a preemption request,
        # fire the auto-save interval (no-ops when unconfigured)
        self.checkpoint_manager.on_step_boundary(self)

    # ------------------------------------------------------------------
    # the legacy training loop (Megatron's engine(batch) /
    # engine.backward(loss) / engine.step())
    # ------------------------------------------------------------------

    def forward(self, batch, rng=None):
        """The loss of one micro-batch ((tokens, labels) [micro, S] for
        GPT-NeoX and GPT-2, BERT's dict or tuple), with its autograd
        graph: `backward` differentiates it. The gate jitter and BERT's
        dropout draw from ``rng`` (a `torch.Generator`) or, by default,
        from the engine's generator re-seeded from (1234,
        ``micro_steps``), as `train_batch` seeds each micro-step. Armed
        layers (`set_layers_to_hook`) are captured first. With the
        quantized FFN armed it raises, as in JAX: the loop does not
        thread the amax history.

        The first forward of an accumulation window opens the telemetry's
        step window, which `step` closes at the boundary (the JAX
        engine's legacy loop has no telemetry; the port gives it the
        goodput buckets and the MFU of `train_batch`'s count, where one
        was made). The flops profiler fires here at its profile step on
        this micro-batch."""
        if self._quant_step_active:
            raise RuntimeError(
                "the manual forward()/backward()/step() API does not "
                "thread the quantization state (amax history / "
                "error-feedback buffers would silently go stale); use "
                "train_batch()/train_steps()")
        if self.wall_clock_breakdown():
            self.timers("forward").start()
        if self._accum_count == 0 and not self._legacy_window_open:
            self._legacy_window_open = True
            self.telemetry.on_step_start(self.global_steps)
        with self.telemetry.outside_window():
            self._maybe_profile_flops(batch, accum_steps=1, stacked=False)
        batch = self._device_batch(batch)
        if self._layers_to_hook:
            self._capture_activations(batch)
        if rng is None:
            rng = self._rng.manual_seed(micro_step_seed(self.micro_steps))
        loss = self._loss(batch, rng, **self._pld_kwargs())
        self._cached_loss = loss
        if self.wall_clock_breakdown():
            self.timers("forward").stop()
        return loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """Differentiate ``loss`` (the last `forward`'s when None; times
        the loss scale under fp16) into the flat gradient views and add
        it into the accumulator. Feeds the gradient-noise-scale
        estimator the micro-batch's unscaled gradients, and keeps them,
        scaled, in ``stored_gradients`` when ``store_gradients`` is on
        (on the host with ``store_gradients_cpu``). Returns ``loss``."""
        if loss is None:
            loss = self._cached_loss
        if loss is None:
            raise RuntimeError("backward() called before forward()")
        self._cached_loss = None
        if self.wall_clock_breakdown():
            self.timers("backward").start()
        want = self.gradient_noise_scale is not None or self.store_gradients
        self._micro_backward(loss, self._per_micro_grads if want else None)
        if self.wall_clock_breakdown():
            self.timers("backward").stop()
        return loss

    def _per_micro_grads(self, flat):
        if self.gradient_noise_scale is not None:
            # unscaled: the flat gradients carry the loss scale
            scale = float(self.scale_state.cur_scale) \
                if self._config.loss_scaling_enabled else 1.0
            self.gradient_noise_scale.update(flat.float() / scale)
        if self.store_gradients:
            self.stored_gradients = self._natural_tree(
                flat.detach().to("cpu", torch.float32, copy=True).numpy()
                if self._config.store_gradients_cpu else flat.clone())

    def _natural_tree(self, flat):
        """One flat buffer (tensor or numpy) → the natural tree of the
        parameters (nested dicts, lists for the layer levels), one view
        a leaf."""
        from ..models.gpt_neox import unflatten
        return unflatten({name: flat[lo:hi].reshape(shape)
                          for name, lo, hi, shape in self.param_slices})

    def params_to_natural(self):
        """The compute-dtype parameters as ``{dotted name: tensor}``
        (what `InferenceEngine` takes as ``params=`` and
        `hot_swap_weights`), COPIES: one device copy of the flat compute
        buffer, one view a leaf into it. The flat buffer's own views
        (`_natural_tree`) would move with every update, which the serving
        engine and the RL reference must not. At stage 3 the copy is
        the gathered rows (`Zero3Runtime.gather_natural`)."""
        if self._z3 is not None:
            with torch.no_grad():
                flat = self._z3.gather_natural(self._params_flat)
            return {name: flat[lo:hi].view(shape)
                    for name, lo, hi, shape in self.param_slices}
        flat = self._params_flat.detach().clone()
        return {name: flat[lo:hi].view(shape)
                for name, lo, hi, shape in self.param_slices}

    def is_gradient_accumulation_boundary(self):
        return self._accum_count >= self.gradient_accumulation_steps()

    def step(self):
        """At the accumulation boundary, the optimizer update over the
        accumulated micro-batches (`train_batch`'s update); returns the
        mean micro-batch loss. Before it, returns None."""
        if not self.is_gradient_accumulation_boundary():
            return None
        if self.wall_clock_breakdown():
            self.timers("step").start()
        mean_loss, verdict = self._step_update()
        if self.wall_clock_breakdown():
            self.timers("step").stop()
        if self._legacy_window_open:
            self._legacy_window_open = False
            self.telemetry.on_step_end(
                self, verdict=verdict,
                flops=self._step_flops.get(self.gradient_accumulation_steps()))
        return mean_loss

    # ------------------------------------------------------------------
    # the fork's debugging features
    # ------------------------------------------------------------------

    def set_layers_to_hook(self, layers_to_hook):
        """Capture the listed layer outputs (indices, or case-insensitive
        regexes matched against the model's `layer_names()`) on the next
        batch; the capture then disarms."""
        self._layers_to_hook = list(layers_to_hook or [])
        self.hooked_activations = {}

    def get_hooked_activations(self):
        return self.hooked_activations

    def _capture_activations(self, batch):
        """The armed layers' outputs of one micro-batch, by index into
        `layer_names()`, from the model's `hidden_states` (one forward
        without gradients or remat, so no layer is captured twice), with
        the micro-step's generator seed. One shot: disarms after."""
        hs_fn = getattr(self.module, "hidden_states", None)
        if hs_fn is None:
            return
        import re
        rng = torch.Generator(device=self.device).manual_seed(
            micro_step_seed(self.micro_steps))
        outs = hs_fn(None, batch, rng, zero3=self._z3) \
            if self._z3 is not None else \
            hs_fn(self.module.params_tree(), batch, rng)
        names = list(getattr(self.module, "layer_names", lambda: [])()) or \
            [str(i) for i in range(len(outs))]
        wanted = set()
        for item in self._layers_to_hook:
            if isinstance(item, int):
                wanted.add(item)
            else:
                pat = re.compile(str(item).lower())
                wanted.update(i for i, n in enumerate(names)
                              if pat.search(n.lower()))
        self.hooked_activations = {i: outs[i].detach() for i in sorted(wanted)
                                   if 0 <= i < len(outs)}
        self._layers_to_hook = []

    def enable_gradient_noise_scale(self, n_batches=10, beta=0.99):
        """The gradient-noise-scale estimator (`runtime.utils.
        GradientNoiseScale`) at the micro batch size; `backward` feeds
        it each micro-batch's gradients (`train_batch` does not, and
        warns once). Not ported at stage 3, where no rank holds a whole
        gradient."""
        if self._z3 is not None:
            raise _not_ported("the gradient-noise scale with ZeRO stage 3",
                              "ZeRO-3 (A.6)")
        self.gradient_noise_scale = GradientNoiseScale(
            batch_size_small=self.train_micro_batch_size_per_gpu(),
            n_batches=n_batches, beta=beta)
        self._gns_warned = False
        return self.gradient_noise_scale

    def _warn_gns_not_fed(self, path):
        if self.gradient_noise_scale is None or self._gns_warned:
            return
        self._gns_warned = True
        logger.warning(
            f"{path}: GradientNoiseScale is enabled but this fused path "
            "keeps per-micro-batch gradients on device; the estimator "
            "only updates under the forward()/backward()/step() loop")

    @torch.no_grad()
    def eval_batch(self, batch, rng=None, return_logits=False):
        """Loss of one batch [B, ...] (GPT-NeoX and GPT-2: (tokens,
        labels) or bare tokens; BERT: a dict or tuple), without touching
        the training state; with ``return_logits`` (loss, [B, S, V] fp32
        logits) from one forward (the model's `loss_and_logits`). The
        gate jitter and BERT's dropout, where on, draw from ``rng`` or a
        fresh generator seeded 0: the JAX engine's eval key is
        ``PRNGKey(0)``, and a BERT loss given a key runs dropout, so its
        eval loss includes dropout."""
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        batch = self._device_batch(batch)
        if return_logits:
            fn = getattr(self.module, "loss_and_logits", None)
            if fn is None:
                raise RuntimeError(
                    "eval_batch(return_logits=True) needs a model exposing "
                    "loss_and_logits(params, batch, rng) (models.gpt_neox."
                    "GPTNeoX / models.gpt2.GPT2 do)")
            loss, logits = fn(None, batch, rng, zero3=self._z3) \
                if self._z3 is not None else \
                fn(self.module.params_tree(), batch, rng)
            return float(loss), logits
        return float(self._loss(batch, rng))

    # ------------------------------------------------------------------
    # whole-model access to the (partitioned) state
    # ------------------------------------------------------------------

    def _natural_flat(self, part):
        """One buffer of the flat state (the masters, or the compute
        parameters) whole, in the natural flat order: gathered over the
        ranks where each holds a partition."""
        if self._z3 is not None:
            return self._z3.gather_natural(part)
        if self._part is not None and part.numel() == self._part.size:
            return gather_full(part, self._part,
                               self.dp_group)[:self.num_params]
        if self._expert_range is not None:
            return self._ep_whole(part[:self.num_params])
        return part[:self.num_params]

    def _ep_whole(self, flat):
        """A flat buffer of this rank's layout on an "expert" mesh → the
        whole model's natural flat (``natural_slices``): every rank's
        expert range all-gathered, each expert leaf's ranks' rows
        concatenated."""
        from ..utils import distributed as ds_dist
        elo, ehi = self._expert_range
        parts = ds_dist.all_gather(flat[elo:ehi].detach(), self.dp_group)
        local = {n: (lo, hi) for n, lo, hi, _ in self.param_slices}
        out = []
        for name, _, _, _ in self.natural_slices:
            lo, hi = local[name]
            if lo >= elo:
                out.extend(p[lo - elo:hi - elo] for p in parts)
            else:
                out.append(flat[lo:hi])
        return torch.cat(out)

    def _ep_local(self, natural):
        """The inverse of `_ep_whole`: this rank's layout (its rows of
        each expert leaf) out of a whole natural flat."""
        out = torch.empty(self.num_params, dtype=natural.dtype,
                          device=natural.device)
        whole = {n: (lo, hi) for n, lo, hi, _ in self.natural_slices}
        elo = self._expert_range[0]
        for name, lo, hi, _ in self.param_slices:
            wlo, whi = whole[name]
            if lo >= elo:
                n = hi - lo
                wlo += self.dp_rank * n
                whi = wlo + n
            out[lo:hi] = natural[wlo:whi]
        return out

    def _load_natural(self, natural):
        """A natural flat fp32 buffer of the whole model into the masters
        and the compute parameters (this rank's partition of each where
        it holds one)."""
        with torch.no_grad():
            if self._z3 is not None:
                self._z3.layout.to_partition(natural, self.dp_rank,
                                             out=self._master)
                self._z3.load_natural(natural)
                return
            if self._part is not None:
                full = natural.new_zeros(self._part.padded)
                full[:self.num_params] = natural
                if self._master.untyped_storage().data_ptr() != \
                        self._params_flat.untyped_storage().data_ptr():
                    self._master.copy_(full[self._part.lo:self._part.hi])
                self._params_flat.copy_(full)
                return
            if self._expert_range is not None:
                natural = self._ep_local(natural)
            self._params_flat[:self.num_params].copy_(natural)
            if self._master is not self._params_flat:
                self._master.copy_(natural)

    def gathered_parameters(self, modifier_rank=0, select=None):
        """`zero.GatheredParameters` over the LIVE training state: whole,
        mutable fp32 host copies of the masters (of the parameters in the
        lean state) as the natural tree; on exit the mutations (rank
        ``modifier_rank``'s) go back into the state, the masters AND the
        compute parameters (at stage 3 this rank's shard and the
        persisted row), so training continues from the edited weights.
        The optimizer moments are left as they are, as in the reference.
        ``select`` (a predicate over "a/b/c" tree paths, or a list of
        path prefixes) hands out and writes back only that sub-tree; the
        other leaves are yielded as they are."""
        from ..models.gpt_neox import unflatten
        from .zero.partition_parameters import GatheredParameters
        if isinstance(select, (list, tuple, set)):
            prefixes = tuple(select)
            select = lambda path: any(  # noqa: E731
                path.startswith(p) for p in prefixes)
        with torch.no_grad():
            natural = self._natural_flat(self._master).float().cpu()
        tree = unflatten({name: natural[lo:hi].view(shape)
                          for name, lo, hi, shape in self.natural_slices})

        def write_back(view):
            from .zero.partition_parameters import _tree_map_path
            new = natural.clone()
            slots = {name.replace(".", "/"): (lo, hi)
                     for name, lo, hi, _ in self.natural_slices}

            def put(path, v):
                key = "/".join(str(k) for k in path)
                if isinstance(v, np.ndarray) and key in slots:
                    lo, hi = slots[key]
                    new[lo:hi] = torch.from_numpy(
                        np.ascontiguousarray(v, np.float32)).reshape(-1)
                return v
            _tree_map_path(put, view)
            self._load_natural(new.to(self.device))

        return GatheredParameters(tree, modifier_rank=modifier_rank,
                                  on_exit=write_back, select=select,
                                  group=self.dp_group)

    def _zero3_consolidated_fp16_state_dict(self):
        """The ZeRO-3 compute parameters gathered into one host natural
        tree in the compute dtype (the reference's consolidated fp16
        save; the JAX engine's `_zero3_consolidated_fp16_state_dict`)."""
        if self.zero_optimization_stage() != 3:
            raise ValueError(
                "this function only works for ZeRO-3; use "
                "engine.state.params / module_state_dict otherwise")
        from ..models.gpt_neox import unflatten
        from .zero.stage3 import consolidate_params
        return consolidate_params(unflatten(self.params_to_natural()),
                                  dtype=self.compute_dtype)

    # ------------------------------------------------------------------
    # checkpointing (the JAX package's layout; see checkpoint/)
    # ------------------------------------------------------------------

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        # back-pressure against the async path: commits stay totally
        # ordered even when sync and async saves interleave
        self.checkpoint_manager.wait()
        return checkpointing.save_checkpoint(
            self, save_dir, tag=tag, client_state=client_state,
            save_latest=save_latest)

    def save_checkpoint_async(self, save_dir, tag=None, client_state=None,
                              save_latest=True):
        """Snapshot the train state now (the only stall: one
        device-to-host copy of each flat buffer, complete on return) and
        commit in a background writer thread. At most one save is in
        flight; a second call waits out the first. Returns the tag;
        `checkpoint_manager.wait()` blocks until the checkpoint is
        durable."""
        return self.checkpoint_manager.save_async(
            save_dir, tag=tag, client_state=client_state,
            save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None,
                        load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_dataloader_states=True,
                        module_only=False):
        """Restore in place (the flat buffers keep their storage).
        ``tag=None`` resumes from `latest`, falling back to the newest
        other committed checkpoint when its manifest fails; a named tag
        that fails raises. `module_only=True` restores only the
        parameters. Returns (path, client_state), or (None, {}) when
        there is nothing to load."""
        path, client_state = checkpointing.load_checkpoint(
            self, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_lr_scheduler_states=load_lr_scheduler_states,
            load_dataloader_states=load_dataloader_states,
            module_only=module_only)
        if path is not None and not module_only:
            self.checkpoint_manager.on_checkpoint_loaded(self)
        return path, client_state
