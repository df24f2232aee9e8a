"""ZeRO's per-leaf layout rules for stages 0-2: the part of
`deeperspeed_tpu/runtime/zero/partition_parameters.py` the port needs.

The port trains from flat buffers and partitions them by contiguous
ranges (`stage1.flat_partition`); the JAX engine shards each leaf of its
pytrees over the data axis instead. Checkpoints are written in the JAX
layout, so the port keeps the JAX rules that decide a leaf's layout at a
data-parallel world: `_shardable_dim` (the largest dimension the world
divides), `ZeroShardingRules.master_spec` (that dimension carries the
data axis from stage 1 on) and `master_pad_info` (a leaf no dimension of
which the world divides is stored flat and padded: `FlatPad`). A spec is
a tuple with the axis name where the leaf is sharded and None elsewhere,
as a `PartitionSpec` reads.

`Init`, `GatheredParameters` and the stage-3 rules come with ZeRO-3.
"""

import numpy as np

from ..config_utils import DeepSpeedConfigError

DATA_AXIS = "data"


def _shardable_dim(shape, world, threshold_numel=0):
    """The dimension to shard over the data axis: the largest one that
    ``world`` divides; None for scalars, leaves under the threshold or
    smaller than the world, and shapes no dimension of which the world
    divides (those take `FlatPad`)."""
    numel = int(np.prod(shape)) if shape else 1
    if not shape or numel < max(threshold_numel, world):
        return None
    divisible = [d for d in range(len(shape)) if shape[d] % world == 0]
    if divisible:
        return max(divisible, key=lambda d: shape[d])
    return None


class FlatPad:
    """A leaf stored flat and padded: ``shape`` its natural shape,
    ``numel`` its size, ``padded`` the world-divisible length of the
    stored 1-D buffer."""

    __slots__ = ("shape", "numel", "padded")

    def __init__(self, shape, numel, padded):
        self.shape = tuple(shape)
        self.numel = numel
        self.padded = padded

    def __repr__(self):
        return (f"FlatPad(shape={self.shape}, numel={self.numel}, "
                f"padded={self.padded})")


def flat_pad(arr, info):
    """Natural-shaped array or tensor → its padded flat buffer (a zero
    tail)."""
    if isinstance(arr, np.ndarray):
        return np.pad(np.ravel(arr), (0, info.padded - info.numel))
    import torch
    flat = arr.reshape(-1)
    return torch.cat([flat, flat.new_zeros(info.padded - info.numel)])


def flat_unpad(flat, info):
    """Padded flat buffer → the natural-shaped array."""
    return flat[:info.numel].reshape(info.shape)


class ZeroShardingRules:
    """The JAX engine's per-leaf data-axis layout at a stage and a
    data-parallel ``world``."""

    def __init__(self, stage, world, data_axis=DATA_AXIS):
        if not 0 <= stage <= 3:
            raise DeepSpeedConfigError(f"invalid ZeRO stage {stage}")
        self.stage = stage
        self.world = int(world)
        self.data_axis = data_axis

    def _spec(self, shape):
        spec = [None] * len(shape)
        if self.world == 1:
            return tuple(spec)
        dim = _shardable_dim(tuple(shape), self.world)
        if dim is not None:
            spec[dim] = self.data_axis
        return tuple(spec)

    def master_spec(self, shape):
        """fp32 masters and optimizer moments: sharded from stage 1."""
        if self.stage >= 1:
            return self._spec(shape)
        return ()

    def master_pad_info(self, shape):
        """`FlatPad` for a leaf whose masters and moments are stored flat
        and padded to be sharded at all (stage >= 1, world > 1, at least
        world elements, no dimension the world divides); None where a
        dimension shards or the leaf is replicated."""
        if self.stage < 1 or self.world == 1:
            return None
        numel = int(np.prod(shape)) if shape else 1
        if not shape or numel < self.world:
            return None
        if self.data_axis in self._spec(shape):
            return None
        padded = -(-numel // self.world) * self.world
        return FlatPad(tuple(shape), numel, padded)


def sharded_dim(spec):
    """The dimension a spec shards, or None."""
    for i, axis in enumerate(spec):
        if axis is not None:
            return i
    return None
