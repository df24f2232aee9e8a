"""ZeRO stage 1, optimizer-state partitioning across `torch.distributed`
ranks: the port of `deeperspeed_tpu/runtime/zero/stage1.py`.

Each data-parallel rank keeps the fp32 masters and the optimizer moments
of one contiguous partition of the flat parameter buffer; gradients are
reduce-scattered to their owners, each rank steps its partition with the
flat Adam kernel (which writes the compute-dtype copy of its partition
in the same pass), and the compute partitions are all-gathered back into
the flat parameter buffer. The JAX package expresses the same ownership
as data-axis shardings that XLA turns into these collectives; the port
issues them itself.

The flat buffer is padded to a multiple of ``world × alignment``
(`get_group_alignment_padding`). `PARTITION_ALIGNMENT` elements keep
every partition's start 16-byte aligned in every buffer the Adam kernel
reads (fp32 masters and moments, a 2-byte gradient and compute copy), so
it takes its packed path on every rank.

The sub-partition arithmetic (`sub_partition_sizes`,
`sub_partition_bounds`, `flat_sub_partitions`,
`get_group_alignment_padding`) is the JAX package's, bit for bit: the
optimizer's `state_dict` lays the masters out in its rank-major
sub-partitions, so either package merges the other's.

`FP16_DeepSpeedZeroOptimizer_Stage1` packages the partitioned step as a
standalone optimizer over a list of tensors (the JAX class's
`init_state` / `step` / `state_dict` / `load_state_dict`); the training
engine runs the same collectives over its own flat buffers
(`runtime/engine.py`).
"""

from typing import Any, NamedTuple

import torch

from ..fp16.loss_scaler import (LossScaleState, grads_finite,
                                init_loss_scale_state, update_loss_scale)
from ..utils import clip_grad_norm_, global_norm

# partition sizes are multiples of this many elements: 16 bytes of a
# bf16 or fp16 buffer, 32 of an fp32 one
PARTITION_ALIGNMENT = 8


# ---------------------------------------------------------------------------
# flat sub-partition math (the JAX package's, bit for bit)
# ---------------------------------------------------------------------------

def sub_partition_sizes(numel, world, sub_partition_count=1):
    """Split `numel` into world*sub_partition_count aligned pieces; the last
    piece absorbs the remainder, as the reference pads the final
    sub-partition (`stage1.py:360`)."""
    parts = world * sub_partition_count
    base = numel // parts
    sizes = [base] * parts
    sizes[-1] += numel - base * parts
    return sizes


def sub_partition_bounds(numel, world, sub_partition_count=1):
    """[(start, end)] for each sub-partition, rank-major order: rank r owns
    pieces [r, r+world, r+2*world, ...] (the reference's round-robin
    comm-interleaved layout, `stage1.py:417-440`)."""
    sizes = sub_partition_sizes(numel, world, sub_partition_count)
    bounds, off = [], 0
    for s in sizes:
        bounds.append((off, off + s))
        off += s
    return bounds


def flat_sub_partitions(flat, world, sub_partition_count=1):
    """Slice a flat array into per-rank lists of sub-partition views."""
    numel = flat.shape[0]
    bounds = sub_partition_bounds(numel, world, sub_partition_count)
    per_rank = [[] for _ in range(world)]
    for i, (lo, hi) in enumerate(bounds):
        per_rank[i % world].append(flat[lo:hi])
    return per_rank


def get_group_alignment_padding(numel, world, alignment=1):
    """Padding needed so `numel` splits evenly into world pieces of
    `alignment`-multiple size (reference `stage1.py:343`)."""
    chunk = world * alignment
    return (chunk - numel % chunk) % chunk


# ---------------------------------------------------------------------------
# a rank's partition of the flat buffers, and the collectives over it
# ---------------------------------------------------------------------------

class FlatPartition(NamedTuple):
    """Rank ``rank``'s contiguous range [lo, hi) of a flat buffer of
    ``numel`` elements padded to ``padded`` (= world · size)."""
    numel: int
    padded: int
    world: int
    rank: int

    @property
    def size(self):
        return self.padded // self.world

    @property
    def lo(self):
        return self.rank * self.size

    @property
    def hi(self):
        return self.lo + self.size


def flat_partition(numel, world, rank, alignment=PARTITION_ALIGNMENT):
    """The partition layout of a flat buffer of ``numel`` elements."""
    padded = numel + get_group_alignment_padding(numel, world, alignment)
    return FlatPartition(int(numel), int(padded), int(world), int(rank))


def reduce_scatter_(out, flat, part, group=None, dtype=None, bucket=0,
                    accumulate=False):
    """Sum every rank's ``flat`` (``part.padded`` elements) into this
    rank's partition ``out`` (``part.size``), in ``dtype`` (the flat
    buffer's by default), ``bucket`` elements of each partition at a time
    (0: all at once). ``accumulate`` adds the sum into ``out`` instead of
    writing it."""
    import torch.distributed as dist
    dtype = dtype or flat.dtype
    rows = flat.view(part.world, part.size)
    step = min(bucket, part.size) if bucket else part.size
    for o in range(0, part.size, step):
        n = min(step, part.size - o)
        src = rows if n == part.size else rows[:, o:o + n]
        src = src.to(dtype).contiguous().view(-1)
        dst = out[o:o + n]
        direct = not accumulate and out.dtype == dtype
        red = dst if direct else torch.empty(n, dtype=dtype,
                                             device=flat.device)
        dist.reduce_scatter_tensor(red, src, group=group)
        if accumulate:
            dst.add_(red)
        elif not direct:
            dst.copy_(red)


def all_gather_(flat, part, group=None):
    """Every rank's partition of ``flat`` into every rank's ``flat``, in
    place (each rank's input is its own slice of the output)."""
    import torch.distributed as dist
    dist.all_gather_into_tensor(flat, flat[part.lo:part.hi], group=group)


def gather_full(src, part, group=None):
    """A new flat buffer of ``part.padded`` elements holding every
    rank's partition ``src`` (``part.size``) in rank order."""
    import torch.distributed as dist
    out = torch.empty(part.padded, dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# the standalone stage-1 optimizer
# ---------------------------------------------------------------------------

class ZeroOptimizerState(NamedTuple):
    params: Any               # flat compute dtype, whole on every rank
    master: Any               # fp32, this rank's partition
    opt_state: Any            # moments of this rank's partition
    scale: LossScaleState


class StepInfo(NamedTuple):
    overflow: Any
    grad_norm: Any
    loss_scale: float


class FP16_DeepSpeedZeroOptimizer_Stage1:
    """Optimizer-state partitioning over the ranks of ``group`` (the
    default group).

    ``init_optimizer`` is a `ops.adam.fused_adam.FusedAdam`: its flat
    update runs on this rank's partition. ``precision`` is the compute
    dtype of the parameters (the fork's bf16 support: gradients are
    reduced in fp32).
    """

    stage = 1

    def __init__(self, init_optimizer, group=None, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 clip_grad=0.0, precision=torch.float16,
                 alignment=PARTITION_ALIGNMENT, verbose=False):
        import torch.distributed as dist
        self.optimizer = init_optimizer
        self.group = group if group is not None else dist.group.WORLD
        self.clip_grad = clip_grad
        self.precision = precision
        self.dynamic = dynamic_loss_scale
        args = dynamic_loss_args or {}
        self._init_scale = (args.get("init_scale", 2 ** 32)
                            if dynamic_loss_scale else static_loss_scale)
        self.scale_window = args.get("scale_window", 1000)
        self.min_scale = args.get("min_scale", 1)
        self.delayed_shift = args.get("delayed_shift", 1)
        self.alignment = alignment
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.part = None
        self._shapes = None

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def loss_scale(self):
        return self._init_scale

    def get_loss_scale(self, state):
        return float(state.scale.cur_scale)

    @property
    def dp_world(self):
        return self.world

    def _flat(self, leaves, dtype):
        flat = torch.zeros(self.part.padded, dtype=dtype,
                           device=leaves[0].device)
        off = 0
        for leaf in leaves:
            n = leaf.numel()
            flat[off:off + n] = leaf.reshape(-1)
            off += n
        return flat

    def unflatten(self, flat):
        """The flat buffer → one view a parameter, in `init_state`'s
        order and shapes."""
        out, off = [], 0
        for shape in self._shapes:
            n = int(torch.Size(shape).numel())
            out.append(flat[off:off + n].view(shape))
            off += n
        return out

    def init_state(self, params):
        """``params``: the parameter tensors, in a fixed order. Returns
        the flat compute parameters, this rank's fp32 master partition,
        its moments and the loss-scale state."""
        params = list(params)
        self._shapes = [tuple(p.shape) for p in params]
        numel = sum(p.numel() for p in params)
        self.part = flat_partition(numel, self.world, self.rank,
                                   self.alignment)
        full = self._flat([p.detach().float() for p in params],
                          torch.float32)
        master = full[self.part.lo:self.part.hi].clone()
        compute = full.to(self.precision)
        scale = init_loss_scale_state(init_scale=self._init_scale,
                                      delayed_shift=self.delayed_shift,
                                      static=not self.dynamic)
        return ZeroOptimizerState(params=compute, master=master,
                                  opt_state=self.optimizer.init_state(
                                      master), scale=scale)

    def scale_loss(self, loss, state):
        return loss * state.scale.cur_scale

    def _reduce(self, grads):
        """This rank's partition of the mean over ranks of the local
        gradients (fp32). A tensor of the partition's size is a sum over
        the ranks already (stage 2's `reduce_gradients`)."""
        if torch.is_tensor(grads) and grads.numel() == self.part.size:
            out = grads.float()
        else:
            flat = grads if torch.is_tensor(grads) else self._flat(
                list(grads), torch.float32)
            out = torch.empty(self.part.size, dtype=torch.float32,
                              device=flat.device)
            reduce_scatter_(out, flat, self.part, self.group,
                            dtype=torch.float32)
        if self.world > 1:
            out.div_(self.world)
        return out

    def step(self, state, grads, lr=None):
        """``grads``: this rank's gradients of the scaled loss (the flat
        compute buffer, or one tensor a parameter). Reduce-scatter → unscale
        → the finite check agreed over the ranks → the global norm and
        clip → Adam on this rank's partition → all-gather of the compute
        parameters; an overflow on any rank skips the step on all."""
        g = self._reduce(grads)
        g.div_(float(state.scale.cur_scale))
        overflow = not bool(grads_finite(g, self.group))
        grad_norm = global_norm(g, group=self.group)
        if not overflow:
            if self.clip_grad > 0:
                clip_grad_norm_(g, self.clip_grad, norm=grad_norm)
            lo, hi = self.part.lo, self.part.hi
            out = state.params[lo:hi]
            fp32 = out.dtype == torch.float32
            opt_state = self.optimizer.update(
                g, state.opt_state, state.master, lr=lr,
                compute_out=None if fp32 else out)
            if fp32:
                out.copy_(state.master)
            all_gather_(state.params, self.part, self.group)
            state = state._replace(opt_state=opt_state)
        if self.dynamic:
            scale = update_loss_scale(
                state.scale, overflow, scale_window=self.scale_window,
                min_scale=self.min_scale, delayed_shift=self.delayed_shift)
        else:
            scale = state.scale._replace(cur_iter=state.scale.cur_iter + 1)
        return (state._replace(scale=scale),
                StepInfo(overflow=overflow, grad_norm=grad_norm,
                         loss_scale=float(state.scale.cur_scale)))

    def _full(self, src):
        return gather_full(src, self.part, self.group)[:self.part.numel]

    def state_dict(self, state):
        """The JAX class's layout, the same on every rank: the masters in
        per-rank lists of sub-partitions (rank-major round robin), so a
        restart at another world size merges and re-slices; the moments
        whole."""
        flat_master = self._full(state.master).cpu()
        sd = self.optimizer.state_dict(state.opt_state)
        for key in ("exp_avg", "exp_avg_sq"):
            sd[key] = self._full(sd[key]).cpu()
        return {
            "zero_stage": self.stage,
            "partition_count": self.world,
            "cur_scale": float(state.scale.cur_scale),
            "cur_iter": int(state.scale.cur_iter),
            "local_sub_partitions_of_fp32_groups":
                [[p.clone() for p in parts] for parts in
                 flat_sub_partitions(flat_master, self.world)],
            "optimizer_state_dict": sd,
        }

    def load_state_dict(self, state, sd, load_optimizer_states=True):
        """Restore ``sd`` (saved at any world size) into ``state``, in
        place: this rank's partition of the merged masters and moments,
        the compute parameters from the masters."""
        parts = sd["local_sub_partitions_of_fp32_groups"]
        world = sd["partition_count"]
        n_pieces = sum(len(p) for p in parts)
        ordered = [None] * n_pieces
        for rank, plist in enumerate(parts):
            for j, piece in enumerate(plist):
                ordered[rank + j * world] = torch.as_tensor(piece).reshape(-1)
        lo, hi = self.part.lo, self.part.hi
        dev = state.master.device

        def padded(flat):
            full = torch.zeros(self.part.padded, dtype=torch.float32)
            full[:flat.numel()] = flat.float()
            return full

        full = padded(torch.cat(ordered))
        with torch.no_grad():
            state.master.copy_(full[lo:hi].to(dev))
            state.params.copy_(full.to(state.params.dtype).to(dev))
        opt_state = state.opt_state
        if load_optimizer_states and "optimizer_state_dict" in sd:
            osd = dict(sd["optimizer_state_dict"])
            for key in ("exp_avg", "exp_avg_sq"):
                osd[key] = padded(torch.as_tensor(osd[key]))[lo:hi]
            opt_state = self.optimizer.load_state_dict(osd, device=dev)
        scale = state.scale._replace(cur_scale=float(sd["cur_scale"]),
                                     cur_iter=int(sd["cur_iter"]))
        return state._replace(opt_state=opt_state, scale=scale)
