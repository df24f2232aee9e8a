"""DeeperSpeed on PyTorch and CUDA: the port of `deeperspeed_tpu` to an
NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It serves GPT-NeoX and GPT-2 (the
continuous-batching `InferenceEngine` over a paged KV cache, with int8
block weights and int8 KV pages as options) and trains GPT-NeoX, GPT-2
and BERT on one card or data-parallel across `torch.distributed` ranks
(`init_distributed`: NCCL on the card, gloo on the CPU; ZeRO stages 1-2
partition the fp32 masters, the moments and, at stage 2, the gradient
accumulator; stage 3 partitions GPT-NeoX's parameters too, gathered a
layer at a time: `zero.Init`, `zero.GatheredParameters`):
`initialize()` returns a `DeepSpeedEngine` whose
`train_batch` (or the legacy `forward` / `backward` / `step` loop) runs
bf16 (or fp32) compute with fp32 masters, or the lean state
(``fp16_master_weights_and_grads``: the bf16 parameters are the
masters, with bf16 Adam moments), Adam(W), the LR schedules, gradient
clipping and ZeRO stages 0-3. GPT-NeoX takes a
dense or an MoE FFN (`moe`, driven by the JSON "moe" block) and dense
or block-sparse attention (`ops/sparse_attention`, driven by the JSON
"sparse_attention" block); BERT (`BertForPreTraining`,
`BertForQuestionAnswering`) stacks the fused `DeepSpeedTransformerLayer`.
Hand-written CUDA kernels (`ops/hopper`, sources in `csrc`) carry the
flash attention forward and backward (with an optional block-layout
mask, key bias and dropout), the block-sparse attention forward and
backward, the paged decode over bf16/fp32 and int8 pages, the
weight-only int8 matmul, the grouped expert matmul (forward and dW) and
the flat Adam step. Online RL (`rl.RLDriver`, the "rl" block) runs
both engines in one process: rollouts from the serving engine, a
PPO-clip or DPO update through `train_batch`, the weights hot-swapped
back. The port never imports JAX or `deeperspeed_tpu`.
"""

import argparse

from . import moe
from .inference import InferenceEngine
from .models.bert import (BertConfig, BertForPreTraining,
                          BertForQuestionAnswering, BertModel)
from .models.gpt2 import GPT2, GPT2Config
from .models.gpt_neox import GPTNeoX, GPTNeoXConfig
from .moe import MoELayer
from .ops.transformer import (DeepSpeedTransformerConfig,
                              DeepSpeedTransformerLayer)
from .runtime.config import DeepSpeedConfig
from .runtime.config_utils import DeepSpeedConfigError
from .runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from .runtime import zero  # noqa: F401  (zero.Init, GatheredParameters)
from .runtime.engine import DeepSpeedEngine
from .runtime.sentinel import TrainingHealthError
from .utils.distributed import init_distributed
from .utils.logging import log_dist, logger
from .version import __version__


def _add_core_arguments(parser):
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse.SUPPRESS)  # deprecated spelling
    group.add_argument("--deepscale_config", default=None, type=str,
                       help=argparse.SUPPRESS)
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Discover rank/world from MPI")
    return parser


def add_config_arguments(parser):
    """Add DeepSpeed's argparse flags (the JAX package's
    `add_config_arguments`: the same flags, defaults and help)."""
    return _add_core_arguments(parser)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, mesh=None):
    """Initialize the training engine (the JAX package's `initialize`).

    ``model`` is a `GPTNeoX`, a `GPT2`, a `BertForPreTraining` or a
    `BertForQuestionAnswering` whose parameters are initialized or
    loaded, or are loaded from ``model_parameters`` (the JAX package's
    natural params pytree, numpy or tensor leaves); it trains on their
    device (build it with ``device="cpu"`` to train on the CPU).
    ``config`` is a JSON path, ``config_params`` a dict.

    Under a `torch.distributed` process group (`init_distributed`) each
    rank builds its model on its own card and trains data parallel with
    ZeRO stages 0-3 (stage 3: GPT-NeoX), each taking its own
    micro-batches; the MoE blocks route the global micro-batch. ``mesh``
    (a 1-D `torch.distributed.device_mesh.DeviceMesh` over the group's
    ranks, named "expert" or "data": the JAX ``initialize``'s mesh) with
    an "expert" axis shards the MoE experts over the ranks (ZeRO stage
    0, the sort engine): each rank keeps E/world experts and the blocks
    exchange the tokens with their owners by all-to-alls.

    Returns ``(engine, engine.optimizer, engine.training_dataloader,
    engine.lr_scheduler)``. A pipeline model, an ``mpu`` and a 2-D mesh
    are not ported yet and raise `DeepSpeedConfigError`.
    """
    log_dist(f"DeeperSpeed-torch info: version={__version__}", ranks=[0])
    if type(model).__name__ == "PipelineModule":
        raise DeepSpeedConfigError(
            "a PipelineModule is not ported yet (it comes with the "
            "scale-out slice, A.7; see ROADMAP.md)")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=config,
                             config_params=config_params, mesh=mesh)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


__all__ = ["initialize", "init_distributed", "DeepSpeedEngine", "DeepSpeedConfig",
           "DeepSpeedConfigError", "DeepSpeedDataLoader", "RepeatingLoader",
           "TrainingHealthError", "InferenceEngine", "GPT2", "GPT2Config",
           "GPTNeoX",
           "GPTNeoXConfig", "MoELayer", "moe", "add_config_arguments",
           "BertConfig", "BertModel", "BertForPreTraining",
           "BertForQuestionAnswering", "DeepSpeedTransformerConfig",
           "DeepSpeedTransformerLayer", "log_dist", "logger",
           "__version__"]
