"""ZeRO stage 2, gradient and optimizer-state partitioning across
`torch.distributed` ranks: the port of
`deeperspeed_tpu/runtime/zero/stage2.py`.

Stage 1 keeps a whole fp32 gradient accumulator on every rank and
reduce-scatters it once a step; stage 2 reduce-scatters each
micro-batch's gradient as it is made into an fp32 accumulator of the
rank's partition (`reduce_gradients`), so no rank holds a whole fp32
gradient. The training engine does the same over its flat buffers
(`runtime/engine.py`); the rest (the sub-partition math, the partitioned
step, the elastic state dict) is stage 1's.
"""

import torch

from .stage1 import (FP16_DeepSpeedZeroOptimizer_Stage1, StepInfo,
                     ZeroOptimizerState, flat_sub_partitions,
                     get_group_alignment_padding, reduce_scatter_,
                     sub_partition_bounds, sub_partition_sizes)

__all__ = [
    "FP16_DeepSpeedZeroOptimizer",
    "FP16_DeepSpeedZeroOptimizer_Stage2",
    "ZeroOptimizerState",
    "StepInfo",
    "flat_sub_partitions",
    "get_group_alignment_padding",
    "sub_partition_bounds",
    "sub_partition_sizes",
]


class FP16_DeepSpeedZeroOptimizer_Stage2(FP16_DeepSpeedZeroOptimizer_Stage1):
    """Stage 1 with the gradient partitioned: `reduce_gradients` sums one
    micro-batch's gradients over the ranks into this rank's fp32
    partition accumulator, which `step` takes in place of whole
    gradients."""

    stage = 2

    def reduce_gradients(self, grads, acc=None):
        """Add the sum over ranks of one micro-batch's local gradients
        (the flat compute buffer, or one tensor a parameter) into ``acc``
        (this rank's fp32 partition; a new zero one when None) and return
        it."""
        flat = grads if torch.is_tensor(grads) else self._flat(
            list(grads), torch.float32)
        if acc is None:
            acc = torch.zeros(self.part.size, dtype=torch.float32,
                              device=flat.device)
        reduce_scatter_(acc, flat, self.part, self.group,
                        dtype=torch.float32, accumulate=True)
        return acc


# The reference names its stage-2 class plain `FP16_DeepSpeedZeroOptimizer`.
FP16_DeepSpeedZeroOptimizer = FP16_DeepSpeedZeroOptimizer_Stage2
