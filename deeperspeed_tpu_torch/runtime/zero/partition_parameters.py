"""ZeRO's per-leaf layout rules and the ``zero.Init`` /
``GatheredParameters`` API: the port of
`deeperspeed_tpu/runtime/zero/partition_parameters.py`.

The port trains from flat buffers and partitions them by contiguous
ranges (`stage1.flat_partition`) or, at stage 3, by rows of layers
(`stage3.Zero3Layout`); the JAX engine shards each leaf of its pytrees
over the data axis instead. Checkpoints are written in the JAX layout,
so the port keeps the JAX rules that decide a leaf's layout at a
data-parallel world: `_shardable_dim` (the largest dimension the world
divides), `ZeroShardingRules.master_spec` (that dimension carries the
data axis from stage 1 on), `master_pad_info` (a leaf no dimension of
which the world divides is stored flat and padded: `FlatPad`) and, at
stage 3, `param_spec` / `param_pad_info` with the persistence
threshold (a leaf smaller than ``stage3_param_persistence_threshold``
stays whole on every rank and is never gathered). A spec is a tuple
with the axis name where the leaf is sharded and None elsewhere, as a
`PartitionSpec` reads.

`Init` partitions the leaves an init function makes across the ranks of
a process group (`PartitionedParameter`: persisted leaves whole, the
others flat and padded, rank r holding slice r), `GatheredParameters`
hands out whole, mutable host copies of such leaves (or of tensors) and
writes them back under ``modifier_rank``, and the external-parameter
registry is kept for API compatibility, as in the JAX package.
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

    def __init__(self, stage, world, data_axis=DATA_AXIS,
                 param_persistence_threshold=100_000):
        if not 0 <= stage <= 3:
            raise DeepSpeedConfigError(f"invalid ZeRO stage {stage}")
        self.stage = stage
        self.world = int(world)
        self.data_axis = data_axis
        self.param_persistence_threshold = param_persistence_threshold

    def _spec(self, shape, threshold=0):
        spec = [None] * len(shape)
        if self.world == 1:
            return tuple(spec)
        dim = _shardable_dim(tuple(shape), self.world, threshold)
        if dim is not None:
            spec[dim] = self.data_axis
        return tuple(spec)

    def param_spec(self, shape):
        """Compute-dtype parameters: sharded at rest at stage 3 only,
        leaves under the persistence threshold kept whole."""
        if self.stage >= 3:
            return self._spec(shape, self.param_persistence_threshold)
        return ()

    def param_pad_info(self, shape):
        """`FlatPad` for a compute parameter stored flat and padded at
        rest at stage 3 (a ragged leaf at or above the persistence
        threshold); None otherwise."""
        if self.stage < 3:
            return None
        numel = int(np.prod(shape)) if shape else 1
        if numel < self.param_persistence_threshold:
            return None
        return self.master_pad_info(shape)

    def param_persisted(self, shape):
        """True for a compute parameter that stays whole on every rank at
        stage 3 (under the persistence threshold, or smaller than the
        world): it is never gathered, and its gradient is reduced whole
        (the JAX engine's replicated placement at any world)."""
        numel = int(np.prod(shape)) if shape else 1
        return numel < max(self.param_persistence_threshold, self.world)


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


# ---------------------------------------------------------------------------
# zero.Init / GatheredParameters
# ---------------------------------------------------------------------------

def _group_world_rank(group):
    from ...utils import distributed as ds_dist
    return ds_dist.get_world_size(group), ds_dist.get_rank(group)


class PartitionedParameter:
    """One leaf at rest on this rank under stage 3 (`Init.materialize`):
    a persisted leaf whole in ``local``; any other leaf raveled, padded
    to a multiple of the world and cut into ``world`` equal slices, of
    which ``local`` is this rank's. `full` gathers it back."""

    __slots__ = ("local", "shape", "numel", "padded", "world", "rank",
                 "group", "persisted")

    def __init__(self, local, shape, numel, padded, world, rank, group,
                 persisted):
        self.local = local
        self.shape = tuple(shape)
        self.numel = int(numel)
        self.padded = int(padded)
        self.world = int(world)
        self.rank = int(rank)
        self.group = group
        self.persisted = bool(persisted)

    @classmethod
    def partition(cls, tensor, rules, rank, group=None):
        """Keep this rank's part of ``tensor`` (whole when persisted)."""
        import torch
        t = torch.as_tensor(tensor)
        shape, world = tuple(t.shape), rules.world
        numel = t.numel()
        if rules.stage < 3 or rules.param_persisted(shape):
            return cls(t.clone(), shape, numel, numel, world, rank, group,
                       True)
        padded = -(-numel // world) * world
        size = padded // world
        flat = torch.zeros(padded, dtype=t.dtype, device=t.device)
        flat[:numel] = t.reshape(-1)
        return cls(flat[rank * size:(rank + 1) * size].clone(), shape,
                   numel, padded, world, rank, group, False)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def full(self):
        """The whole natural-shaped leaf (an all-gather of the slices)."""
        if self.persisted:
            return self.local.clone()
        import torch
        out = torch.empty(self.padded, dtype=self.local.dtype,
                          device=self.local.device)
        if self.world == 1:
            out.copy_(self.local)
        else:
            import torch.distributed as dist
            dist.all_gather_into_tensor(out, self.local.contiguous(),
                                        group=self.group)
        return out[:self.numel].reshape(self.shape)

    def replaced(self, value):
        """A `PartitionedParameter` of the same layout holding the whole
        ``value``."""
        import torch
        v = torch.as_tensor(np.asarray(value)).to(self.local.dtype)
        if self.persisted:
            return PartitionedParameter(
                v.reshape(self.shape).to(self.local.device), self.shape,
                self.numel, self.padded, self.world, self.rank, self.group,
                True)
        size = self.padded // self.world
        flat = torch.zeros(self.padded, dtype=self.local.dtype)
        flat[:self.numel] = v.reshape(-1)
        local = flat[self.rank * size:(self.rank + 1) * size].clone()
        return PartitionedParameter(
            local.to(self.local.device), self.shape, self.numel,
            self.padded, self.world, self.rank, self.group, False)

    def __repr__(self):
        return (f"PartitionedParameter(shape={self.shape}, "
                f"local={tuple(self.local.shape)}, "
                f"persisted={self.persisted})")


_CURRENT_INIT = None


class Init:
    """Context manager for building a model's parameters partitioned
    across the ranks of ``data_parallel_group`` (the default group, or
    one rank without one): the reference's ``zero.Init``.

        with zero.Init(config=ds_config) as ctx:
            params = ctx.materialize(init_fn, generator)

    `materialize` runs ``init_fn(*args)`` (a tree of tensors) and keeps
    this rank's part of each leaf (`PartitionedParameter`): at stage 3
    every leaf at or above ``param_persistence_threshold`` elements as
    one slice of its padded flat buffer, the smaller ones whole. The
    whole tree exists until `materialize` returns; the JAX package's
    jitted initializer with sharded outputs never holds it. With
    ``enabled=False`` (or a stage below 3) the leaves stay whole."""

    def __init__(self, module=None, data_parallel_group=None,
                 mem_efficient_linear=True, remote_device=None,
                 pin_memory=False, config=None, enabled=True, stage=3,
                 param_persistence_threshold=100_000):
        if config is not None:
            zero_config = getattr(config, "zero_config", None)
            if zero_config is None and isinstance(config, dict):
                from .config import DeepSpeedZeroConfig
                zero_config = DeepSpeedZeroConfig.from_dict(config)
            if zero_config is not None:
                stage = zero_config.stage
                param_persistence_threshold = \
                    zero_config.param_persistence_threshold
        self.enabled = enabled
        self.group = data_parallel_group
        world, self.rank = _group_world_rank(data_parallel_group)
        self.rules = ZeroShardingRules(
            stage=stage if enabled else 0, world=world,
            param_persistence_threshold=param_persistence_threshold)

    def __enter__(self):
        global _CURRENT_INIT
        self._prev = _CURRENT_INIT
        _CURRENT_INIT = self
        return self

    def __exit__(self, *exc):
        global _CURRENT_INIT
        _CURRENT_INIT = self._prev
        return False

    def materialize(self, init_fn, *args):
        """``init_fn(*args)`` → the same tree with every leaf a
        `PartitionedParameter`."""
        return _tree_map_path(
            lambda path, t: PartitionedParameter.partition(
                t, self.rules, self.rank, self.group),
            init_fn(*args))


def current_init_context():
    return _CURRENT_INIT


def _is_leaf(x):
    return not isinstance(x, (dict, list, tuple))


def _tree_map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _tree_map2(fn, a, b, path=()):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k], path + (k,)) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map2(fn, x, y, path + (i,))
                       for i, (x, y) in enumerate(zip(a, b)))
    return fn(path, a, b)


def path_string(path):
    """A tree path as the JAX package's "a/b/c" select string."""
    return "/".join(str(p) for p in path)


def _host_copy(leaf):
    """A whole, mutable host numpy copy of a leaf (bf16 widened to
    fp32: numpy has no bfloat16)."""
    import torch
    if isinstance(leaf, PartitionedParameter):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf)


class GatheredParameters:
    """Context manager yielding whole, MUTABLE host (numpy) copies of
    possibly partitioned parameters, with write-back on exit (the
    reference's ``GatheredParameters``).

    Under ``modifier_rank=r`` the code inside the context mutates the
    gathered copies, and on exit rank r's values (broadcast over the
    group) replace the leaves: ``.updated`` is the tree re-placed with
    each leaf's layout, dtype and device (a `PartitionedParameter` keeps
    its partition), or ``on_exit(view)`` takes the write-back (the
    engine's `gathered_parameters`). With ``modifier_rank=None`` (a
    read-only gather, the reference default) mutations are dropped.
    ``select`` (a predicate over "a/b/c" tree paths) gathers a sub-tree:
    the other leaves are yielded as they are."""

    def __init__(self, params, modifier_rank=None, fwd_module=None,
                 enabled=True, on_exit=None, select=None, group=None):
        self.params = params
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self.updated = None
        self.group = group
        self._on_exit = on_exit
        self._view = None
        self._select = select

    def _selected(self, path):
        return self._select is None or self._select(path_string(path))

    def __enter__(self):
        if not self.enabled:
            self._view = self.params
            return self.params
        self._view = _tree_map_path(
            lambda path, p: _host_copy(p) if self._selected(path) else p,
            self.params)
        return self._view

    def _broadcast(self, view):
        """Rank ``modifier_rank``'s copies on every rank of the group."""
        world, _ = _group_world_rank(self.group)
        if world == 1:
            return view
        import torch
        import torch.distributed as dist

        def bcast(path, v):
            if not self._selected(path) or not isinstance(v, np.ndarray):
                return v
            t = torch.from_numpy(np.ascontiguousarray(v))
            if dist.get_backend(self.group) == "nccl":
                t = t.cuda()
            dist.broadcast(t, src=self.modifier_rank, group=self.group)
            return t.cpu().numpy()
        return _tree_map_path(bcast, view)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None or not self.enabled:
            return False
        if self.modifier_rank is None:
            return False
        view = self._broadcast(self._view)
        if self._on_exit is not None:
            self._on_exit(view)
            return False
        import torch

        def place(path, v, p):
            if not self._selected(path):
                return p
            if isinstance(p, PartitionedParameter):
                return p.replaced(v)
            if isinstance(p, torch.Tensor):
                return torch.as_tensor(np.asarray(v)).to(
                    dtype=p.dtype, device=p.device)
            return np.asarray(v, dtype=np.asarray(p).dtype)
        self.updated = _tree_map2(place, view, self.params)
        return False


# the external-parameter registry (the reference's
# `partition_parameters.py:56`): a module that uses another module's
# parameter registers it so the reference's hooks gather it; the port
# gathers rows of layers, so the registry is kept for API compatibility
_EXTERNAL_PARAMS = {}


def register_external_parameter(module, parameter):
    _EXTERNAL_PARAMS.setdefault(id(module), []).append(parameter)


def unregister_external_parameter(module, parameter):
    params = _EXTERNAL_PARAMS.get(id(module), [])
    if parameter in params:
        params.remove(parameter)
