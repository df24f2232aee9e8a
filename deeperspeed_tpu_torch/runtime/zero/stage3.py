"""ZeRO stage 3 across `torch.distributed` ranks: the compute-dtype
parameters partitioned at rest, gathered a layer at a time ahead of
compute, and each layer's gradient reduce-scattered to its owners as
soon as that layer's backward ends. The port of
`deeperspeed_tpu/runtime/zero/stage3.py` and of the JAX engine's two
stage-3 schedules (GSPMD's data-axis shardings, and the explicit
``shard_map`` scan of `parallel/schedule.py`), whose collectives the
port issues itself.

The row layout (`Zero3Layout`). A model's leaves, in the JAX flatten
order (sorted dict keys, `LayerPlan`'s order), fall into rows: one a
layer (``blocks.{i}``) and one for the outer leaves (``embed``,
``final_ln``, ``embed_out``), each the concatenation of its leaves'
raveled elements, padded to a multiple of world ×
`stage1.PARTITION_ALIGNMENT`; leaves under
``stage3_param_persistence_threshold`` elements go into one more row,
the persisted row, which is never gathered: every rank keeps those
leaves whole (the JAX engine's replicated placement). A row is cut into
chunks (the explicit schedule's ``bucket_mb`` buckets, `plan_buckets`;
one chunk otherwise): chunk ``(start, size)`` covers the row's elements
[world·start, world·(start + size)), and rank r holds
[world·start + r·size, world·start + (r + 1)·size) of it, so a chunk's
all-gather lands contiguously in the row and its reduce-scatter reads
contiguously from the row's gradient. A rank's partition is its slices
of every row, one after the other: the fp32 masters, both Adam moments,
the fp32 gradient accumulator and the compute-dtype shard are each one
flat buffer of the partition's size, so a step stays one launch of the
flat Adam kernel a rank, which writes the compute shard in the same
pass. `Zero3Layout.segments` maps a rank's partition onto the natural
flat order (the engine's ``param_slices``, stage 0's flat buffer), for
checkpoints and the whole-model readers.

The schedule (`Zero3Runtime`). One forward gathers the outer row once
(`tree`) and runs the layers in groups; inside a group the gather of
layer i + ``depth`` is issued before layer i runs (nothing is gathered
across a group boundary), on a side stream on the card: the gathered
buffer is recorded on the compute stream, which waits on the gather's
event, so the allocator reuses no buffer a kernel still reads. A
gathered row enters autograd through `_FetchRow`, whose backward
reduce-scatters the row's gradient (in fp32 where the engine reduces in
fp32) into the rank's fp32 partition accumulator; a group run as a
recompute span (`models.gpt_neox.block_stack`) gathers again in the
backward. The outer and persisted rows' backwards run after the last
gradient that reaches them (the embedding lookup's, at the end of the
backward). Under ``torch.no_grad`` nothing is reduced. With no process
group every collective is a copy and one rank takes stage 0's steps.
The port has no partitioner, so both modes run this schedule: "gspmd"
at depth 1, one layer a group, a recompute span a layer; "explicit"
with the block's depth, buckets, groups and remat (the model decides,
`GPTNeoX.build_zero3_loss`).

`FP16_DeepSpeedZeroOptimizer_Stage3`, `consolidate_params` and
`estimate_state_bytes` are the JAX module's standalone surface.
"""

import torch

from ...parallel.schedule import plan_buckets
from .partition_parameters import ZeroShardingRules
from .stage1 import PARTITION_ALIGNMENT, StepInfo, ZeroOptimizerState
from .stage2 import FP16_DeepSpeedZeroOptimizer_Stage2

__all__ = ["FP16_DeepSpeedZeroOptimizer_Stage3", "ZeroOptimizerState",
           "StepInfo", "Zero3Layout", "Zero3Runtime", "consolidate_params",
           "estimate_state_bytes"]

OUTER, LAYER, PERSISTED = "outer", "layer", "persisted"


def name_path(name):
    """A dotted parameter name as its JAX tree path (list indices as
    ints): the key of the JAX flatten order."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


class Leaf:
    """One leaf of a row: ``name``, its natural ``shape`` and ``numel``,
    its offset in the row and its offset in the natural flat order."""

    __slots__ = ("name", "shape", "numel", "offset", "natural")

    def __init__(self, name, shape, numel, offset, natural):
        self.name, self.shape, self.numel = name, tuple(shape), int(numel)
        self.offset, self.natural = int(offset), int(natural)


class Row:
    """One row: its ``kind`` (outer, layer or persisted), ``layer``
    index, ``leaves``, its elements, padded length, a rank's ``shard``
    length, its ``chunks`` [(start, size)] of the shard and the shard's
    offset in the partition (``part_lo``)."""

    __slots__ = ("kind", "layer", "leaves", "numel", "padded", "shard",
                 "chunks", "part_lo")

    def __init__(self, kind, layer, entries, world, bucket_bytes, itemsize,
                 part_lo):
        self.kind, self.layer = kind, layer
        self.leaves, off = [], 0
        for name, lo, hi, shape in entries:
            self.leaves.append(Leaf(name, shape, hi - lo, off, lo))
            off += hi - lo
        self.numel = off
        chunk = world * PARTITION_ALIGNMENT
        self.padded = -(-off // chunk) * chunk
        self.shard = self.padded // world
        self.chunks = plan_buckets(self.shard, itemsize, bucket_bytes) \
            if bucket_bytes > 0 else ([(0, self.shard)] if self.shard else [])
        self.part_lo = part_lo

    def views(self, buf):
        """The leaves as views of a row-shaped buffer."""
        return tuple(buf[l.offset:l.offset + l.numel].view(l.shape)
                     for l in self.leaves)


class Zero3Layout:
    """The stage-3 row layout of a model's leaves at a data-parallel
    ``world`` (see the module docstring). ``param_slices`` is the
    engine's [(name, lo, hi, shape)] in the natural flat order;
    ``bucket_bytes`` > 0 cuts the layer rows into the explicit
    schedule's buckets of ``itemsize``-byte elements."""

    def __init__(self, param_slices, world, rules, bucket_bytes=0,
                 itemsize=2, block_key="blocks"):
        self.world = int(world)
        self.num_params = max((hi for _, _, hi, _ in param_slices),
                              default=0)
        ordered = sorted(param_slices, key=lambda e: name_path(e[0]))
        outer, layers, persisted = [], {}, []
        for entry in ordered:
            path = name_path(entry[0])
            if rules.param_persisted(entry[3]):
                persisted.append(entry)
            elif len(path) > 2 and path[0] == block_key and \
                    isinstance(path[1], int):
                layers.setdefault(path[1], []).append(entry)
            else:
                outer.append(entry)
        self.rows, part_lo = [], 0

        def add(kind, layer, entries, buckets):
            nonlocal part_lo
            row = Row(kind, layer, entries, self.world, buckets, itemsize,
                      part_lo)
            part_lo += row.shard
            self.rows.append(row)
            return row
        self.outer = add(OUTER, None, outer, 0) if outer else None
        self.layers = {i: add(LAYER, i, layers[i], bucket_bytes)
                       for i in sorted(layers)}
        self.persisted = add(PERSISTED, None, persisted, 0) \
            if persisted else None
        self.part_size = part_lo

    @property
    def persisted_numel(self):
        return self.persisted.numel if self.persisted else 0

    @property
    def persisted_padded(self):
        return self.persisted.padded if self.persisted else 0

    def segments(self, rank):
        """[(natural offset, partition offset, length)]: every element
        rank ``rank`` holds, as runs of the natural flat order."""
        out = []
        w = self.world
        for row in self.rows:
            for start, size in row.chunks:
                a = w * start + rank * size
                b = a + size
                for leaf in row.leaves:
                    lo, hi = max(a, leaf.offset), \
                        min(b, leaf.offset + leaf.numel)
                    if lo < hi:
                        out.append((leaf.natural + lo - leaf.offset,
                                    row.part_lo + start + lo - a, hi - lo))
        return out

    def to_partition(self, natural, rank, out=None):
        """Rank ``rank``'s partition of a natural flat buffer (tensor),
        pads zero."""
        if out is None:
            out = natural.new_zeros(self.part_size)
        else:
            out.zero_()
        for nat, loc, n in self.segments(rank):
            out[loc:loc + n].copy_(natural[nat:nat + n])
        return out

    def to_natural(self, partitions, out=None):
        """Every rank's partition (a [world, part_size] buffer, rank
        major) → the natural flat buffer of ``num_params``."""
        parts = partitions.view(self.world, self.part_size)
        if out is None:
            out = parts.new_empty(self.num_params)
        for rank in range(self.world):
            src = parts[rank]
            for nat, loc, n in self.segments(rank):
                out[nat:nat + n].copy_(src[loc:loc + n])
        return out

    def persisted_whole(self, natural, out=None):
        """The persisted row, whole and padded, from a natural flat
        buffer."""
        row = self.persisted
        if out is None:
            out = natural.new_zeros(row.padded)
        for leaf in row.leaves:
            out[leaf.offset:leaf.offset + leaf.numel].copy_(
                natural[leaf.natural:leaf.natural + leaf.numel])
        return out


class _Pending:
    """An issued gather: the row, its buffer and the event the compute
    stream waits on (None off the card, or for a buffer not gathered)."""

    __slots__ = ("row", "buf", "event")

    def __init__(self, row, buf, event=None):
        self.row, self.buf, self.event = row, buf, event


class _FetchRow(torch.autograd.Function):
    """A gathered row into autograd: the forward hands out the row's
    leaves as views of the gathered buffer; the backward reduce-scatters
    the row's gradient into the rank's fp32 partition accumulator and
    returns no gradient (``anchor`` is a tensor that requires grad, so
    the views do)."""

    @staticmethod
    def forward(ctx, anchor, rt, pending):
        ctx.rt, ctx.row = rt, pending.row
        ctx.set_materialize_grads(False)
        return pending.row.views(rt.take(pending))

    @staticmethod
    def backward(ctx, *grads):
        ctx.rt.reduce_row(ctx.row, grads)
        return None, None, None


def _merge(into, path, value):
    """Set ``value`` at ``path`` of a tree of dicts (and the ``blocks``
    list), making the dicts on the way."""
    node = into
    for key in path[:-1]:
        node = node[key] if isinstance(node, list) else \
            node.setdefault(key, {})
    node[path[-1]] = value


class Zero3Runtime:
    """The partitioned parameters of one engine and their schedule.

    ``shard`` is this rank's compute-dtype partition, ``acc`` its fp32
    gradient accumulator, ``persist`` the whole persisted row (compute
    dtype); ``group`` the process group (None: one rank, collectives as
    copies), ``reduce_dtype`` the dtype the ranks sum gradients in. The
    model sets the schedule's geometry (`configure`): ``groups`` (lists
    of layer indices), ``depth``, ``remat`` and the recompute
    ``policy``."""

    def __init__(self, layout, rank, group, shard, acc, persist,
                 reduce_dtype, num_layers):
        self.layout = layout
        self.rank = rank
        self.group = group
        self.shard = shard
        self.acc = acc
        self.persist = persist
        self.reduce_dtype = reduce_dtype
        self.num_layers = num_layers
        self.device = shard.device
        self.dtype = shard.dtype
        self.anchor = torch.empty(0, device=self.device, requires_grad=True)
        self.groups = [[i] for i in range(num_layers)]
        self.depth = 1
        self.remat = True
        self.policy = None
        # collectives issued (the tests' and chip_smoke's counts)
        self.gathers = 0
        self.reduce_scatters = 0
        self._side = None

    def configure(self, groups, depth, remat, policy):
        self.groups = [list(g) for g in groups]
        self.depth = max(1, int(depth))
        self.remat = bool(remat)
        self.policy = policy

    # -- collectives --------------------------------------------------------

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def gather_chunks(self, buf, row):
        """Every rank's shard of ``row`` into the row buffer ``buf``,
        chunk by chunk (a copy with no process group)."""
        shard = self.shard[row.part_lo:row.part_lo + row.shard]
        w = self.layout.world
        for start, size in row.chunks:
            out = buf[w * start:w * (start + size)]
            src = shard[start:start + size]
            if self.group is None:
                out.copy_(src)
            else:
                import torch.distributed as dist
                dist.all_gather_into_tensor(out, src, group=self.group)
        self.gathers += 1

    def scatter_chunks(self, out, grad, row):
        """Sum every rank's row gradient ``grad`` (padded) into this
        rank's shard of it, ``out`` (a copy with no process group)."""
        w = self.layout.world
        for start, size in row.chunks:
            src = grad[w * start:w * (start + size)]
            dst = out[start:start + size]
            if self.group is None:
                dst.copy_(src)
            else:
                import torch.distributed as dist
                dist.reduce_scatter_tensor(dst, src, group=self.group)
        self.reduce_scatters += 1

    def issue(self, row):
        """Start the all-gather of ``row``'s compute parameters into a
        new row buffer; on the card on the side stream, after the work
        queued so far on the compute stream (the last step's Adam)."""
        if self.device.type != "cuda":
            buf = torch.empty(row.padded, dtype=self.dtype,
                              device=self.device)
            self.gather_chunks(buf, row)
            return _Pending(row, buf)
        compute = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            buf = torch.empty(row.padded, dtype=self.dtype,
                              device=self.device)
            self.gather_chunks(buf, row)
            event = torch.cuda.Event()
            event.record(side)
        return _Pending(row, buf, event)

    def take(self, pending):
        """The gathered buffer, ready for the compute stream."""
        if pending.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(pending.event)
            pending.buf.record_stream(compute)
        return pending.buf

    def reduce_row(self, row, grads):
        """The backward of one row: its leaves' gradients (None: zeros)
        into one padded row buffer in the reduce dtype, reduce-scattered
        chunk by chunk into this rank's shard of it and added into the
        fp32 partition accumulator."""
        g = torch.empty(row.padded, dtype=self.reduce_dtype,
                        device=self.device)
        for leaf, grad in zip(row.leaves, grads):
            dst = g[leaf.offset:leaf.offset + leaf.numel]
            if grad is None:
                dst.zero_()
            else:
                dst.copy_(grad.reshape(-1))
        g[row.numel:].zero_()
        red = torch.empty(row.shard, dtype=self.reduce_dtype,
                          device=self.device)
        self.scatter_chunks(red, g, row)
        self.acc[row.part_lo:row.part_lo + row.shard].add_(red)

    def refresh_persisted(self):
        """After a step: every rank's new shard of the persisted row into
        the whole persisted buffer."""
        row = self.layout.persisted
        if row is None:
            return
        shard = self.shard[row.part_lo:row.part_lo + row.shard]
        w = self.layout.world
        for start, size in row.chunks:
            out = self.persist[w * start:w * (start + size)]
            src = shard[start:start + size]
            if self.group is None:
                out.copy_(src)
            else:
                import torch.distributed as dist
                dist.all_gather_into_tensor(out, src, group=self.group)

    # -- the forward's parameter trees ------------------------------------

    def fetch(self, pending):
        """A gathered row's leaves, through `_FetchRow`."""
        return _FetchRow.apply(self.anchor, self, pending)

    def tree(self):
        """The parameter tree of one forward: the outer leaves (one
        gather of the outer row), the persisted leaves (views of the
        whole persisted buffer) and ``blocks``, a list holding each
        layer's persisted leaves only (`layer_tree` adds the gathered
        ones)."""
        tree = {"blocks": [{} for _ in range(self.num_layers)]}
        lay = self.layout
        for row in (lay.outer, lay.persisted):
            if row is None:
                continue
            pending = self.issue(row) if row.kind == OUTER else \
                _Pending(row, self.persist)
            for leaf, value in zip(row.leaves, self.fetch(pending)):
                _merge(tree, name_path(leaf.name), value)
        self._blocks = tree["blocks"]
        return tree

    def issue_layer(self, layer):
        row = self.layout.layers.get(layer)
        return None if row is None else self.issue(row)

    def layer_tree(self, layer, pending):
        """Layer ``layer``'s parameter tree: its persisted leaves and its
        gathered row's (``pending`` from `issue_layer`)."""
        tree = _copy_tree(self._blocks[layer])
        if pending is not None:
            for leaf, value in zip(pending.row.leaves, self.fetch(pending)):
                _merge(tree, name_path(leaf.name)[2:], value)
        return tree

    def group_trees(self, layers):
        """Each layer's tree of one group in order, the gather of layer
        i + depth issued before layer i's tree is handed out, never past
        the group's end."""
        d = min(self.depth, len(layers))
        pending = {j: self.issue_layer(layers[j]) for j in range(d)}
        for i, layer in enumerate(layers):
            if i + d < len(layers):
                pending[i + d] = self.issue_layer(layers[i + d])
            yield self.layer_tree(layer, pending.pop(i))

    # -- whole-model readers ----------------------------------------------

    def gather_partitions(self, part):
        """Every rank's ``part`` (a partition-sized buffer), rank major
        ([world · part_size]; a copy with no process group)."""
        out = torch.empty(self.layout.world * self.layout.part_size,
                          dtype=part.dtype, device=part.device)
        if self.group is None:
            out.copy_(part)
        else:
            import torch.distributed as dist
            dist.all_gather_into_tensor(out, part.contiguous(),
                                        group=self.group)
        return out

    def gather_natural(self, part):
        """A partition-sized buffer of every rank → the natural flat
        buffer (the engine's ``param_slices`` order)."""
        return self.layout.to_natural(self.gather_partitions(part))

    def load_natural(self, natural):
        """This rank's partition of a natural flat buffer into the
        compute shard, and the persisted buffer from it."""
        self.layout.to_partition(natural.to(self.dtype), self.rank,
                                 out=self.shard)
        if self.layout.persisted is not None:
            self.layout.persisted_whole(natural.to(self.dtype),
                                        out=self.persist)


def _copy_tree(node):
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    return node


# ---------------------------------------------------------------------------
# the JAX module's standalone surface
# ---------------------------------------------------------------------------

def consolidate_params(params, dtype=None):
    """Whole host tensors of a tree of (possibly partitioned) parameters,
    cast to ``dtype`` where given: the one consolidation path of the
    standalone stage-3 optimizer and the engine's
    `_zero3_consolidated_fp16_state_dict`."""
    from .partition_parameters import PartitionedParameter, _tree_map_path

    def pull(path, p):
        if isinstance(p, PartitionedParameter):
            p = p.full()
        t = torch.as_tensor(p).detach()
        if dtype is not None:
            t = t.to(dtype)
        return t.cpu()
    return _tree_map_path(pull, params)


def estimate_state_bytes(num_params, world, itemsize=2, persisted=0):
    """A rank's training-state bytes at stage 3 (the reference's
    ``estimate_zero3_model_states_mem_needs``): the compute shard, the
    fp32 master shard and two fp32 moment shards, 1/world of each, plus
    the persisted leaves whole in the compute dtype."""
    world = max(int(world), 1)
    return int(num_params) * (itemsize + 4 + 8) // world + \
        int(persisted) * itemsize


class FP16_DeepSpeedZeroOptimizer_Stage3(FP16_DeepSpeedZeroOptimizer_Stage2):
    """Full partitioning as a standalone optimizer over a list of
    tensors: stage 2's partitioned step (`init_state`, `step`,
    `reduce_gradients`, `state_dict`), plus the stage-3 knobs, the
    consolidated state dict and the state estimate. The three fetch
    knobs are kept for config parity (the training engine's schedule is
    `Zero3Runtime`'s)."""

    stage = 3

    def __init__(self, *args, max_live_parameters=1_000_000_000,
                 max_reuse_distance=1_000_000_000,
                 prefetch_bucket_size=50_000_000,
                 param_persistence_threshold=100_000, **kwargs):
        self.max_live_parameters = max_live_parameters
        self.max_reuse_distance = max_reuse_distance
        self.prefetch_bucket_size = prefetch_bucket_size
        self.param_persistence_threshold = param_persistence_threshold
        super().__init__(*args, **kwargs)

    def consolidated_fp16_state_dict(self, state, dtype=None):
        """The whole compute parameters as host tensors, one a parameter
        in `init_state`'s order (``dtype`` casts)."""
        return consolidate_params(self.unflatten(state.params), dtype=dtype)

    def estimate_state_bytes(self, params):
        """A rank's bytes for the compute, master and moment shards."""
        total = sum(int(torch.as_tensor(p).numel()) for p in params)
        itemsize = torch.empty(0, dtype=self.precision).element_size()
        return estimate_state_bytes(total, self.dp_world, itemsize)

