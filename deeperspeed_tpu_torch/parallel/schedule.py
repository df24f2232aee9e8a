"""The ZeRO-3 collective schedule's numbers: the port of the ZeRO-3 part
of `deeperspeed_tpu/parallel/schedule.py`.

The JAX package has two stage-3 schedules: "gspmd" (XLA places the
all-gathers the data-axis shardings imply) and "explicit" (a
``shard_map`` scan that issues bucketed all-gathers ``prefetch_depth``
layers ahead of compute, in remat groups of ``group_layers`` layers).
The port issues its collectives itself (`runtime/zero/stage3.py`); this
module keeps the parts of the JAX one that hold numbers only:

- `ScheduleConfig`, the parsed ``zero_optimization.schedule`` block;
- `LeafPlacement` / `leaf_placement`: how one leaf rests on the data
  axis (replicated under the persistence threshold, one dimension
  sharded, or flat and padded);
- `LayerPlan`: one layer's leaves in the JAX flatten order (sorted dict
  keys), which of them are gathered, the per-rank row of their shards,
  its buckets (`plan_buckets`) and the rebuild of the natural tree from
  a gathered [world, S] row (`_reassemble`);
- `_segment_sizes`, the remat groups of a layer stack.

Trees are nested dicts and lists of numpy arrays or tensors; a spec is
a tuple holding the data axis's name where the leaf is sharded and None
elsewhere (the port's `PartitionSpec`). The error-feedback gather
(`make_ef_gather`), the offload row layout (`offload_layer_plan`,
`pack_plan_rows`) and the 1F1B schedule wait for the offload tiers and
compressed communication (ROADMAP.md A.7).
"""

from dataclasses import dataclass

import numpy as np

from ..runtime.config_utils import DeepSpeedConfigError

SCHEDULE_MODES = ("gspmd", "explicit")


@dataclass(frozen=True)
class ScheduleConfig:
    """Knobs of the stage-3 collective schedule (the
    ``zero_optimization.schedule`` block)."""
    mode: str = "gspmd"          # "gspmd" | "explicit"
    prefetch_depth: int = 1      # layers gathered ahead of compute
    bucket_mb: float = 32.0      # max MB per all-gather bucket
    group_layers: int = 4        # layers per remat/prefetch group
    # True: the backward gathers each group's parameters again; False
    # keeps the gathered rows as backward residuals
    remat: bool = True

    @property
    def bucket_bytes(self):
        return int(self.bucket_mb * 1024 * 1024)


# ---------------------------------------------------------------------------
# per-leaf placement
# ---------------------------------------------------------------------------

REPLICATED, DIM_SHARDED, FLAT_SHARDED = "replicated", "dim", "flat"


def _itemsize(dtype):
    """Bytes an element of a numpy or torch dtype."""
    size = getattr(dtype, "itemsize", None)
    return size if size is not None else np.dtype(dtype).itemsize


class LeafPlacement:
    """How one leaf rests on the data axis: ``replicated`` (under the
    persistence threshold), ``dim`` (one natural dimension carries the
    data axis) or ``flat`` (stored as a padded 1-D buffer sharded over
    the data axis: `runtime.zero.partition_parameters.FlatPad`)."""

    __slots__ = ("kind", "dim", "pad", "shape", "dtype", "local_shape",
                 "size")

    def __init__(self, kind, shape, dtype, world, dim=None, pad=None):
        self.kind = kind
        self.dim = dim
        self.pad = pad
        self.shape = tuple(shape)
        self.dtype = dtype
        if kind == DIM_SHARDED:
            local = list(shape)
            if local[dim] % world:
                raise ValueError(
                    f"dim {dim} of {tuple(shape)} does not divide the dp "
                    f"world {world}")
            local[dim] //= world
            self.local_shape = tuple(local)
        elif kind == FLAT_SHARDED:
            if pad.padded % world:
                raise ValueError(
                    f"flat-padded length {pad.padded} does not divide "
                    f"the dp world {world}")
            self.local_shape = (pad.padded // world,)
        else:
            self.local_shape = tuple(shape)
        self.size = int(np.prod(self.local_shape)) if self.local_shape \
            else 1

    @property
    def gathered(self):
        return self.kind != REPLICATED

    def __repr__(self):
        return (f"LeafPlacement({self.kind}, shape={self.shape}, "
                f"dim={self.dim})")


def _spec_str(spec):
    """A spec tuple as a `PartitionSpec` prints."""
    return f"PartitionSpec({', '.join(repr(a) for a in spec)})"


def leaf_placement(shape, dtype, spec, pad, axis_name, world):
    """Classify one leaf from its spec and pad info. Only the data axis
    may appear in ``spec``."""
    if pad:
        return LeafPlacement(FLAT_SHARDED, pad.shape, dtype, world,
                             pad=pad)
    dims = []
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        for a in axes:
            if a != axis_name:
                raise DeepSpeedConfigError(
                    f"explicit schedule supports pure data-parallel "
                    f"placements; leaf spec {_spec_str(spec)} uses mesh "
                    f"axis {a!r}")
        dims.append(d)
    if not dims:
        return LeafPlacement(REPLICATED, shape, dtype, world)
    if len(dims) > 1:
        raise DeepSpeedConfigError(
            f"leaf spec {_spec_str(spec)} shards more than one dim over "
            f"the data axis; the explicit schedule expects at most one")
    return LeafPlacement(DIM_SHARDED, shape, dtype, world, dim=dims[0])


def _moveaxis(x, src, dst):
    if isinstance(x, np.ndarray):
        return np.moveaxis(x, src, dst)
    return x.movedim(src, dst)


def _reassemble(pieces, placement, world):
    """[world, size] rank-major pieces → the whole natural-shaped
    leaf."""
    if placement.kind == FLAT_SHARDED:
        flat = pieces.reshape(-1)[:placement.pad.numel]
        return flat.reshape(placement.shape)
    k = placement.dim
    stacked = pieces.reshape((world,) + placement.local_shape)
    # rank-major concatenation along dim k: the shard order of the data
    # axis
    return _moveaxis(stacked, 0, k).reshape(placement.shape)


# ---------------------------------------------------------------------------
# trees in the JAX flatten order
# ---------------------------------------------------------------------------

def tree_paths(tree, prefix=()):
    """[(path tuple, leaf)] of a nested dict / list tree in the JAX
    flatten order: dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_paths(tree[key], prefix + (key,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += tree_paths(item, prefix + (i,))
        return out
    return [(prefix, tree)]


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` in the flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(item) for item in node]
        return next(it)
    return build(template)


def _cat(parts):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    import torch
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# one layer's gather plan
# ---------------------------------------------------------------------------

class LayerPlan:
    """The gather plan of one transformer layer's parameter tree.

    The sharded leaves' local shards concatenate (raveled, in the
    flatten order) into one [S] row a rank; `buckets` split that row
    into chunks of at most ``bucket_bytes``, each gathered as its own
    collective (the last takes the ragged tail). `rebuild` reassembles a
    gathered [world, S] row and the replicated leaves into the natural
    tree."""

    def __init__(self, template, specs, pads, axis_name, world,
                 bucket_bytes):
        paths = tree_paths(template)
        self.template = template
        self.paths = [p for p, _ in paths]
        leaves = [l for _, l in paths]
        spec_leaves = [s for _, s in _spec_paths(specs)]
        pad_leaves = [p for _, p in tree_paths(pads)]
        if not (len(leaves) == len(spec_leaves) == len(pad_leaves)):
            raise ValueError(
                f"template/specs/pads disagree: {len(leaves)} vs "
                f"{len(spec_leaves)} vs {len(pad_leaves)} leaves")
        self.axis_name = axis_name
        self.world = int(world)
        self.placements = [
            leaf_placement(tuple(l.shape), l.dtype, s, p or None,
                           axis_name, self.world)
            for l, s, p in zip(leaves, spec_leaves, pad_leaves)]
        self.offsets = []
        off = 0
        dtypes = set()
        for pl in self.placements:
            if pl.gathered:
                self.offsets.append(off)
                off += pl.size
                dtypes.add(str(pl.dtype))
            else:
                self.offsets.append(None)
        self.shard_size = off            # S: a rank's elements a layer
        if len(dtypes) > 1:
            raise ValueError(
                f"gathered leaves of one layer must share a dtype for "
                f"bucketed gathers; got {sorted(dtypes)}")
        gathered = [pl for pl in self.placements if pl.gathered]
        self.dtype = gathered[0].dtype if gathered else np.float32
        self.buckets = plan_buckets(self.shard_size,
                                    _itemsize(self.dtype), bucket_bytes)

    @property
    def n_replicated(self):
        return sum(1 for pl in self.placements if not pl.gathered)

    def split_leaves(self, leaves):
        """Flatten-order leaves → (gathered shards, replicated leaves)."""
        gath = [l for l, pl in zip(leaves, self.placements) if pl.gathered]
        rep = [l for l, pl in zip(leaves, self.placements)
               if not pl.gathered]
        return gath, rep

    def concat_shards(self, leaves):
        """This layer's flatten-order local leaves → one [S] row of the
        gathered leaves' raveled shards (None if all replicated)."""
        parts, _ = self.split_leaves(leaves)
        parts = [l.reshape(-1) for l in parts]
        if not parts:
            return None
        return _cat(parts) if len(parts) > 1 else parts[0]

    def rebuild(self, gathered, rep_leaves):
        """A gathered [world, S] row and this layer's replicated leaves
        (in the flatten order of the replicated subset) → the natural
        tree."""
        out = []
        rep_iter = iter(rep_leaves)
        for pl, off in zip(self.placements, self.offsets):
            if not pl.gathered:
                out.append(next(rep_iter))
                continue
            piece = gathered[:, off:off + pl.size]
            out.append(_reassemble(piece, pl, self.world))
        return tree_unflatten(self.template, out)


def _spec_paths(specs):
    """[(path, spec)] of a tree of spec tuples (a spec is a leaf, not a
    container)."""
    if isinstance(specs, dict):
        out = []
        for key in sorted(specs):
            out += [((key,) + p, s) for p, s in _spec_paths(specs[key])]
        return out
    if isinstance(specs, list):
        out = []
        for i, item in enumerate(specs):
            out += [((i,) + p, s) for p, s in _spec_paths(item)]
        return out
    return [((), specs)]


def plan_buckets(shard_size, itemsize, bucket_bytes):
    """[(start, size)] chunks of a [shard_size] row, each at most
    ``bucket_bytes`` big; the final bucket takes the ragged tail. A
    non-positive bucket size is one whole-row bucket."""
    if shard_size <= 0:
        return []
    elems = max(1, int(bucket_bytes) // max(1, int(itemsize)))
    if bucket_bytes <= 0 or elems >= shard_size:
        return [(0, shard_size)]
    out = []
    start = 0
    while start < shard_size:
        size = min(elems, shard_size - start)
        out.append((start, size))
        start += size
    return out


def _segment_sizes(n_layers, n_groups):
    """As-equal-as-possible group sizes (earlier groups take the
    remainder), as `models.gpt_neox.segment_sizes`."""
    n = max(1, min(int(n_groups), n_layers))
    return [n_layers // n + (1 if i < n_layers % n else 0)
            for i in range(n)]
