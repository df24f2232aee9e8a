"""Mixture-of-Experts FFN, on one card or across ranks.

The port of `deeperspeed_tpu/moe/layer.py`: GShard/Switch routing with
capacity (top-1 or top-2, position-ordered queues, second choices after
all first choices, overflow copies dropped to an exact-zero output),
token groups (``groups``: 1, an explicit count, or 0 for auto), the
load-balancing aux loss and the optional top-2 renormalization over the
choices that survived capacity. Two dispatch engines route identically:

- ``"einsum"`` (the default): the dense [g, T, E, C] one-hot dispatch and
  combine tensors and a batched expert FFN, in plain PyTorch;
- ``"sort"``: a stable sort of the routed copies by (virtual) expert,
  a gather into per-expert spans of ``span`` rows, the expert FFN as two
  grouped matmuls over the packed buffer (`ops/hopper/grouped_matmul`:
  the CUDA kernels on CUDA tensors, the plain version on CPU tensors or
  with ``use_kernels=False``), and a gather-and-weight combine.

Gate jitter (``jitter_eps > 0`` with an ``rng``) draws its multiplicative
noise from a `torch.Generator` at one point that both engines share, so
they route identically under noise; the numbers are not the JAX
package's. The sort engine runs the delayed-scaling quantized FFN
(``ffn_quant``, the "quantization.ffn" block) on its two grouped
products. With ``observe`` (``moe.observability``) it also emits its
routing statistics into `ROUTING_STATS`, as device tensors that the
engine drains into ``Train/MoE/*`` scalars.

Across ranks there are the JAX package's two semantics:

- the engine's (GSPMD: one device over the global batch).
  `moe_ffn_dense(..., group=)` routes the global micro-batch of
  ``group``'s ranks, rank-major (rank r's token t is global token
  r·T_local + t, as JAX splits the batch dimension): the groups and the
  capacity are those of the global token count. A rank holding whole
  routing groups routes them alone (exact); a group spanning whole ranks
  takes one all-gather of the ranks' first- and second-choice counts,
  whose prefix gives each copy's place in the global GShard queue, and
  the aux loss's means come through a differentiable all-gather
  (`_GroupSync`). With ``expert_parallel`` (an "expert" mesh) the
  parameters hold this rank's E/world experts and the sort engine's
  buffer goes to the experts' owners and back by two all-to-alls
  (`_exchange_ffn`);
- `moe_ffn_expert_parallel` (`shard_map`): each rank routes its own shard
  with per-rank capacity, the same exchange, the aux loss averaged over
  the group; `MoELayer(mesh=)` runs it.

The exchange is `utils.distributed.all_to_all`, a collective (as
`jax.lax.all_to_all`), whose backward is the reverse exchange.
"""

import contextlib
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.hopper.grouped_matmul import (grouped_matmul,
                                         grouped_matmul_reference, pick_span)
from ..ops.hopper.quant_matmul import grouped_scaled_operands
from ..runtime.config_utils import DeepSpeedConfigError
from ..utils import distributed as ds_dist
from ..utils.device import resolve_device

# auto-grouping target: the largest per-group token count
_AUTO_GROUP_TOKENS = 1024

DISPATCH_MODES = ("einsum", "sort")


@functools.lru_cache(maxsize=None)
def _resolve_groups(groups, tokens):
    """0/'auto' → the divisor of `tokens` whose group size is nearest
    `_AUTO_GROUP_TOKENS` (never below 128); otherwise validate the
    explicit count."""
    if groups in (0, None, "auto"):
        best_g, best_cost = 1, abs(tokens - _AUTO_GROUP_TOKENS)
        d = 1
        while d * d <= tokens:
            if tokens % d == 0:
                for g in (d, tokens // d):
                    size = tokens // g
                    if size < 128:
                        continue
                    cost = abs(size - _AUTO_GROUP_TOKENS)
                    if cost < best_cost or (cost == best_cost
                                            and g > best_g):
                        best_g, best_cost = g, cost
            d += 1
        return best_g
    groups = int(groups)
    if groups < 1 or tokens % groups:
        raise ValueError(f"groups={groups} must be ≥1 and divide the "
                         f"token count {tokens}")
    return groups


class _RoutingStatsCollector:
    """Sink of the sort engine's routing statistics (``moe.observability``):
    per-expert load fractions and the capacity-drop fraction, one entry
    per MoE layer forward. The JAX package lands them on the host through
    `jax.debug.callback`; here they stay device tensors (no host read in
    the step), and `drain` averages them on the device at the engine's
    step record into the four ``Train/MoE/*`` scalars, which the
    monitor reads at its flush.

    Samples are AVERAGED across everything that accumulated since the
    last drain: one entry per MoE layer per forward, plus duplicates when
    rematerialization re-runs a layer's forward in the backward pass;
    duplicate values are identical, so the averages are unbiased."""

    # un-drained cap: with no monitor attached nothing ever drains; keep
    # the most recent window instead of growing forever
    MAX_PENDING = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._load = []          # [E] load fraction per emission
        self._drop = []          # capacity-drop fraction per emission
        self._suspended = 0

    @contextlib.contextmanager
    def suspended(self):
        """Record nothing inside the block (the flops profiler's extra
        forward of a step's batch)."""
        with self._lock:
            self._suspended += 1
        try:
            yield
        finally:
            with self._lock:
                self._suspended -= 1

    def _record(self, load, drop):
        with self._lock:
            if self._suspended:
                return
            self._load.append(load.detach())
            self._drop.append(drop.detach())
            if len(self._load) > self.MAX_PENDING:
                del self._load[:-self.MAX_PENDING]
                del self._drop[:-self.MAX_PENDING]

    @property
    def pending(self):
        return len(self._load)

    def drain(self):
        """Averaged scalars since the last drain (0-d fp32 tensors on
        the statistics' device), or None when nothing was emitted."""
        with self._lock:
            load, self._load = self._load, []
            drop, self._drop = self._drop, []
        if not load:
            return None
        mean_load = torch.stack(load).double().mean(dim=0)       # [E]
        mean = mean_load.mean()
        return {
            "Train/MoE/expert_load_min": mean_load.min().float(),
            "Train/MoE/expert_load_max": mean_load.max().float(),
            # coefficient of variation (numpy's population std): 0 =
            # perfectly balanced; the one imbalance series worth alerting
            # on
            "Train/MoE/expert_load_cv":
                (mean_load.std(correction=0) /
                 torch.clamp(mean, min=1e-12)).float(),
            "Train/MoE/capacity_drop_fraction":
                torch.stack(drop).double().mean().float(),
        }


ROUTING_STATS = _RoutingStatsCollector()


def _emit_routing_stats(route, E, g, group=None):
    """Emit one routing observation (sort engine only: the route's
    counts already hold the position-in-expert bookkeeping, so the
    statistics cost two reductions). The virtual-expert counts fold back
    to real experts (virtual id = expert·g + group). Under a routing
    ``group`` of more than one rank the counts, the kept copies and the
    copies are summed over its ranks first: the global route's
    statistics, on every rank."""
    kT = route.pos.shape[0]                      # routed copies (T·top_k)
    counts_e = route.counts.reshape(E, g).sum(dim=1)
    kept = route.sizes.sum()
    if group is not None and ds_dist.get_world_size(group) > 1:
        tot = torch.cat([counts_e, kept.reshape(1),
                         torch.full((1,), kT, dtype=counts_e.dtype,
                                    device=counts_e.device)])
        tot = ds_dist.all_reduce_sum(tot, group)
        counts_e, kept, kT = tot[:E], tot[E], int(tot[E + 1])
    load = counts_e.float() / max(kT, 1)
    drop = 1.0 - kept.float() / max(kT, 1)
    ROUTING_STATS._record(load, drop)


def _one_hot(idx, n):
    """float one-hot of int ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row (`jax.nn.one_hot`)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class _GroupSync:
    """The global GShard queue of a routing group that spans ``rpg``
    whole ranks of ``group`` (its tokens rank-major, ``tg`` of them):
    called with this rank's first- and second-choice counts [E] (long)
    and its sum of the gate probabilities [E] over its tokens, it
    returns (off1, off2, aux). A first-choice copy's place in its
    expert's queue is ``off1`` (the group's earlier ranks' first
    choices) plus its local place among first choices; a second choice's
    is ``off2`` (the group's total of first choices plus the earlier
    ranks' second choices) plus its local place among second choices:
    GShard's queue, all first choices in token order, then all second
    choices. ``aux`` is the mean over the global groups of E·Σ me·ce,
    with ``me`` and ``ce`` the means over each group's tokens; the
    probability sums come through a differentiable all-gather, whose
    backward sums every rank's cotangent (each rank's loss reads the same
    aux). One all-gather of the counts, one of the sums."""

    def __init__(self, group, rank, world, rpg, tg):
        self.group, self.rank, self.world = group, rank, world
        self.rpg, self.tg = rpg, tg

    def __call__(self, c1, c2, psum):
        E = c1.shape[0]
        counts = torch.stack([c1, torch.zeros_like(c1) if c2 is None
                              else c2])                       # [2, E]
        every = ds_dist.all_gather(counts, self.group)        # [world, 2, E]
        sums = ds_dist.all_gather(psum, self.group)           # [world, E]
        lo = self.rank // self.rpg * self.rpg
        earlier = every[lo:self.rank].sum(dim=0)
        off1 = earlier[0]
        off2 = every[lo:lo + self.rpg, 0].sum(dim=0) + earlier[1]
        ng = self.world // self.rpg
        me = sums.reshape(ng, self.rpg, E).sum(dim=1) / self.tg
        ce = every[:, 0].reshape(ng, self.rpg, E).sum(dim=1).float() / \
            self.tg
        aux = (E * (me * ce).sum(dim=-1)).mean()
        return off1, off2, aux


def _route_plan(groups, T_local, group):
    """How a rank routes its ``T_local`` tokens of a global micro-batch
    over ``group`` (None: alone) → (local group count, tokens a routing
    group, `_GroupSync` or None). The groups are resolved over the global
    token count; a rank holding whole groups routes them alone, a group
    spanning whole ranks syncs (`_GroupSync`), a group straddling ranks
    is refused."""
    world = 1 if group is None else ds_dist.get_world_size(group)
    if world == 1:
        g = _resolve_groups(groups, T_local)
        return g, T_local // g, None
    T = T_local * world
    g = _resolve_groups(groups, T)
    tg = T // g
    if T_local % tg == 0:
        return T_local // tg, tg, None
    if tg % T_local == 0:
        return 1, tg, _GroupSync(group, ds_dist.get_rank(group), world,
                                 tg // T_local, tg)
    raise DeepSpeedConfigError(
        f"MoE routing groups of {tg} tokens straddle the ranks' "
        f"{T_local}-token shards (groups={groups!r} over {T} tokens on "
        f"{world} ranks): the port routes a group that lies within one "
        f"rank or spans whole ranks; groups across rank boundaries are "
        f"not ported yet (ROADMAP.md A.6)")


def _gate_logits(gate, xg, rng, jitter_eps):
    """Gate logits [g, Tg, E] in fp32, times GShard's multiplicative
    uniform jitter in [1 - eps, 1 + eps] when ``rng`` (a
    `torch.Generator` on xg's device) is given and eps > 0. The one draw
    point of both engines."""
    logits = (xg @ gate.to(xg.dtype)).float()
    if rng is not None and jitter_eps > 0.0:
        noise = torch.empty_like(logits).uniform_(
            1.0 - jitter_eps, 1.0 + jitter_eps, generator=rng)
        logits = logits * noise
    return logits


# ---------------------------------------------------------------------------
# einsum engine
# ---------------------------------------------------------------------------

def _choice_dispatch(onehot, capacity, base_counts=None):
    """Per-choice capacity bookkeeping: position-ordered slots within
    each expert's queue, offset by `base_counts` (earlier choices'
    occupancy). Returns (dispatch [T, E, C], counts [E])."""
    pos = torch.cumsum(onehot, dim=0) * onehot               # [T, E]
    if base_counts is not None:
        pos = pos + base_counts[None, :] * onehot
    pos_in_expert = pos.sum(dim=-1) - 1.0                    # [T]
    keep = (pos_in_expert < capacity).float()
    slot = _one_hot(pos_in_expert.long(), capacity)          # [T, C]
    dispatch = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
    return dispatch, onehot.sum(dim=0)


def _one_hot_dispatch(gate_logits, capacity, top_k=1,
                      renorm_kept_choices=False, sync=None):
    """Top-k capacity routing of one group: (jittered) logits [T, E] fp32
    → (dispatch [T, E, C], combine [T, E, C], aux). ``sync`` (a
    `_GroupSync`: the group spans ranks) gives the queues' offsets and
    the group's aux."""
    T, E = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    expert1 = torch.argmax(probs, dim=-1)
    onehot1 = _one_hot(expert1, E)
    g1 = probs.gather(1, expert1[:, None])[:, 0]
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    if top_k == 2:
        probs2 = probs * (1.0 - onehot1)                     # mask top-1
        expert2 = torch.argmax(probs2, dim=-1)
        onehot2 = _one_hot(expert2, E)
        g2 = probs.gather(1, expert2[:, None])[:, 0]
    base1 = base2 = None
    if sync is None:
        aux = E * torch.sum(probs.mean(dim=0) * onehot1.mean(dim=0))
    else:
        off1, off2, aux = sync(
            onehot1.sum(dim=0).long(),
            onehot2.sum(dim=0).long() if top_k == 2 else None,
            probs.sum(dim=0))
        base1, base2 = off1.float(), off2.float()
    dispatch1, counts1 = _choice_dispatch(onehot1, capacity, base1)
    if top_k == 1:
        return dispatch1, dispatch1 * g1[:, None, None], aux
    dispatch2, _ = _choice_dispatch(
        onehot2, capacity, base_counts=counts1 if sync is None else base2)
    if renorm_kept_choices:
        w1 = g1 * dispatch1.sum(dim=(1, 2))
        w2 = g2 * dispatch2.sum(dim=(1, 2))
        denom = w1 + w2 + 1e-9
        g1n, g2n = w1 / denom, w2 / denom
    else:
        denom = g1 + g2 + 1e-9
        g1n, g2n = g1 / denom, g2 / denom
    combine = dispatch1 * g1n[:, None, None] + dispatch2 * g2n[:, None, None]
    return dispatch1 + dispatch2, combine, aux


def _expert_ffn(w_in, b_in, w_out, b_out, x):
    """Every expert's FFN on x [E, C, H] (weights [E, H, I] / [E, I, H])."""
    dt = x.dtype
    h = F.gelu(torch.bmm(x, w_in.to(dt)) + b_in.to(dt)[:, None, :],
               approximate="tanh")                   # jax.nn.gelu's default
    return torch.bmm(h, w_out.to(dt)) + b_out.to(dt)[:, None, :]


def _route_groups(gate, xg, capacity, top_k, rng, jitter_eps,
                  renorm_kept_choices=False, sync=None):
    """Route each group independently: xg [g, Tg, H] → (dispatch [g, Tg,
    E, C], combine [g, Tg, E, C], aux averaged over groups), dispatch and
    combine in the compute dtype. ``sync``: `_one_hot_dispatch`."""
    logits = _gate_logits(gate, xg, rng, jitter_eps)
    routed = [_one_hot_dispatch(lg, capacity, top_k, renorm_kept_choices,
                                sync) for lg in logits]
    dispatch = torch.stack([r[0] for r in routed]).to(xg.dtype)
    combine = torch.stack([r[1] for r in routed]).to(xg.dtype)
    return dispatch, combine, torch.stack([r[2] for r in routed]).mean()


# ---------------------------------------------------------------------------
# sort engine
# ---------------------------------------------------------------------------

class _SortRoute(NamedTuple):
    """Routing plan over V = E·g virtual experts (expert-major: v =
    expert·g + group). Copy-major arrays are [k·T]: copy c < T is token
    c's first choice, copy c ≥ T its second."""
    experts_v: torch.Tensor   # [kT] virtual expert per copy
    pos: torch.Tensor         # [kT] position in its expert's queue
    weights: tuple            # top_k of [T] combine weights
    counts: torch.Tensor      # [V] routed copies per virtual expert
    starts: torch.Tensor      # [V] exclusive prefix of counts
    order: torch.Tensor       # [kT] stable sort permutation
    aux: torch.Tensor
    sizes: torch.Tensor       # [V] copies kept (a prefix of each queue)


def _jittered_probs(gate, xg, rng, jitter_eps):
    """Gate probabilities [g, Tg, E] from the einsum engine's logits and
    noise."""
    return torch.softmax(_gate_logits(gate, xg, rng, jitter_eps), dim=-1)


def _sort_route(probs, capacity, top_k, renorm_kept_choices, sync=None):
    """probs [g, Tg, E] fp32 → `_SortRoute`. The stable sort over
    (virtual) expert ids of the choice-major copies reproduces the GShard
    queue: within an expert, first choices in token order, then second
    choices — the position bookkeeping of `_choice_dispatch` without the
    one-hot tensors. With ``sync`` (a `_GroupSync`, one local group) a
    copy is kept when its place in the global queue is below the
    capacity; ``pos`` stays its place among this rank's copies (its row
    in the buffer), and the kept copies are a prefix of each local queue,
    since both places grow along it."""
    g, tg, E = probs.shape
    T = g * tg
    dev = probs.device
    p2 = probs.reshape(T, E)
    gi = torch.arange(T, device=dev) // tg
    expert1 = torch.argmax(p2, dim=-1)
    onehot1 = _one_hot(expert1, E)
    g1 = p2.gather(1, expert1[:, None])[:, 0]
    if sync is None:
        me = probs.mean(dim=1)                               # [g, E]
        ce = onehot1.reshape(g, tg, E).mean(dim=1)           # [g, E]
        aux = (E * (me * ce).sum(dim=-1)).mean()
    v1 = expert1 * g + gi
    if top_k == 1:
        experts_v, gates = v1, (g1,)
    elif top_k == 2:
        expert2 = torch.argmax(p2 * (1.0 - onehot1), dim=-1)
        g2 = p2.gather(1, expert2[:, None])[:, 0]
        experts_v, gates = torch.cat([v1, expert2 * g + gi]), (g1, g2)
    else:
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")

    kT, V = experts_v.shape[0], E * g
    order = torch.argsort(experts_v, stable=True)
    counts = torch.zeros(V, dtype=torch.long, device=dev).index_add_(
        0, experts_v, torch.ones_like(experts_v))
    starts = torch.cumsum(counts, dim=0) - counts
    pos_sorted = torch.arange(kT, device=dev) - starts[experts_v[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    if sync is None:
        kept = (pos < capacity).float()
        sizes = torch.clamp(counts, max=capacity)
    else:
        c1 = torch.zeros(V, dtype=torch.long, device=dev).index_add_(
            0, v1, torch.ones_like(v1))
        off1, off2, aux = sync(c1, counts - c1 if top_k == 2 else None,
                               p2.sum(dim=0))
        # a second choice's local place counts the rank's first choices
        off = torch.cat([off1[v1], (off2 - c1)[experts_v[T:]]]) \
            if top_k == 2 else off1[v1]
        kept_b = pos + off < capacity
        kept = kept_b.float()
        sizes = torch.zeros(V, dtype=torch.long, device=dev).index_add_(
            0, experts_v, kept_b.long())
    k1 = kept[:T]
    if top_k == 1:
        weights = (gates[0] * k1,)
    else:
        k2 = kept[T:]
        g1, g2 = gates
        if renorm_kept_choices:
            w1, w2 = g1 * k1, g2 * k2
            denom = w1 + w2 + 1e-9
            weights = (w1 / denom, w2 / denom)
        else:
            denom = g1 + g2 + 1e-9
            weights = (g1 / denom * k1, g2 / denom * k2)
    return _SortRoute(experts_v, pos, weights, counts, starts, order, aux,
                      sizes)


def _fill_buffer(x, route, span):
    """Compact the routed copies into the [V·span, H] expert-major buffer
    by a gather: row (v, p) holds the p-th surviving copy of virtual
    expert v, zero when p ≥ its kept count (``route.sizes``: min(count,
    capacity) on one rank). Returns (buffer, group_sizes [V])."""
    T, H = x.shape
    kT = route.order.shape[0]
    V = route.counts.shape[0]
    tok_sorted = route.order % T
    p = torch.arange(span, device=x.device)
    src = route.starts[:, None] + p[None, :]                 # [V, span]
    sizes = route.sizes
    valid = p[None, :] < sizes[:, None]
    tok = tok_sorted[src.clamp(0, kT - 1)].reshape(-1)
    # index_select, not x[tok]: its backward is one index_add, where
    # advanced indexing's sorts the indices first (measured: PERF.md, PR 4)
    buf = x.index_select(0, tok).reshape(V, span, H)
    return buf.masked_fill(~valid[..., None], 0).reshape(V * span, H), sizes


def _sort_ffn(params, buf, sizes, span, lut, n_w, rows_per_w,
              use_kernels=True, ffn_quant=None):
    """The expert FFN over the packed buffer as two grouped matmuls. The
    biases ride a [n_w, rows, ·] view; dead rows come out of the second
    matmul as exact zeros plus a bias term, which the combine never
    gathers.

    ``ffn_quant`` = (recipe, margin, amax_row [4, H]) runs both grouped
    matmuls on delayed-scaling fake-quantized operands
    (`grouped_scaled_operands`) and makes the return (out, new_amax_row).
    Each amax covers the whole buffer, dead rows included, as in JAX:
    the buffer's are zeros, and the first product's are exact zeros
    before the bias and gelu, so those of ``h`` are gelu(b_in)."""
    gmm = grouped_matmul if use_kernels else grouped_matmul_reference
    dt = buf.dtype
    w_in, b_in = params["w_in"].to(dt), params["b_in"].to(dt)
    w_out, b_out = params["w_out"].to(dt), params["b_out"].to(dt)
    inter, hidden = w_in.shape[-1], w_out.shape[-1]
    if ffn_quant is not None:
        recipe, margin, amax_row = ffn_quant
        buf, w_in, hx_in, hw_in = grouped_scaled_operands(
            buf, w_in, amax_row[0], amax_row[1], recipe, margin)
    h = gmm(buf, w_in, sizes, span, lut)
    h = F.gelu(h.reshape(n_w, rows_per_w, inter) + b_in[:, None, :],
               approximate="tanh").reshape(-1, inter)
    if ffn_quant is not None:
        h, w_out, hx_out, hw_out = grouped_scaled_operands(
            h, w_out, amax_row[2], amax_row[3], recipe, margin)
    out = gmm(h, w_out, sizes, span, lut)
    out = out.reshape(n_w, rows_per_w, hidden) + b_out[:, None, :]
    out = out.reshape(-1, hidden)
    if ffn_quant is None:
        return out
    return out, torch.stack([hx_in, hw_in, hx_out, hw_out])


def _sort_combine(out_buf, route, span, T, dtype):
    """y[t] = Σ_k weight_k[t] · out_buf[row of copy k]: the gather and
    weighted add in place of the combine einsum. Dropped copies carry
    weight 0 (their clamped row gather is a no-op)."""
    R = out_buf.shape[0]
    rows = torch.clamp(route.experts_v * span + route.pos, 0, R - 1)
    y = None
    for c, wk in enumerate(route.weights):
        term = wk.to(dtype)[:, None] * out_buf.index_select(
            0, rows[c * T:(c + 1) * T])
        y = term if y is None else y + term
    return y


# ---------------------------------------------------------------------------
# the exchange (expert parallelism)
# ---------------------------------------------------------------------------

def _overlap_chunks(requested, e_local):
    """Largest divisor of the local expert count ≤ the requested chunk
    count (1 = no pipelining)."""
    n = max(1, min(int(requested), e_local))
    while e_local % n:
        n -= 1
    return n


def _exchange_ffn(params, buf, sizes, ep, g, span, group, n_chunks,
                  use_kernels):
    """The sort engine's expert FFN across ``ep`` ranks: the
    expert-major buffer [E·g·span, H] (E = ep·e_local, its spans'
    ``sizes`` [E·g]) goes to the experts' owners by an all-to-all, each
    owner runs its ``params`` (e_local experts) over the received
    [ep, e_local, g·span, H] rows as two grouped matmuls (the received
    sizes are the ragged group sizes; the LUT: e_local experts of ep·g
    spans each), and a second all-to-all brings the outputs back →
    [E·g·span, H] in the buffer's layout. ``n_chunks`` > 1 splits the
    local experts and pipelines the exchange: chunk i+1's all-to-all is
    issued (asynchronously) before chunk i's FFN runs; each chunk's
    products are those of the unchunked exchange, so the result is the
    same bit for bit."""
    H = buf.shape[1]
    e_local = params["w_in"].shape[0]
    n_ch = _overlap_chunks(n_chunks, e_local)
    e_chunk = e_local // n_ch
    send = buf.reshape(ep, e_local, g * span, H)
    sz_send = sizes.reshape(ep, e_local, g)

    def issue(ci):
        sl = slice(ci * e_chunk, (ci + 1) * e_chunk)
        rbuf, handle = ds_dist.all_to_all(send[:, sl], group, async_op=True)
        rsz = ds_dist.all_to_all(sz_send[:, sl], group)
        return rbuf, handle, rsz

    lut = tuple(np.repeat(np.arange(e_chunk), ep * g).tolist())
    recv = [issue(0)]
    outs = []
    for ci in range(n_ch):
        if ci + 1 < n_ch:
            recv.append(issue(ci + 1))
        rbuf, handle, rsz = recv[ci]
        rbuf = ds_dist.a2a_wait(rbuf, handle)
        flat = rbuf.transpose(0, 1).reshape(e_chunk * ep * g * span, H)
        fsz = rsz.transpose(0, 1).reshape(e_chunk * ep * g)
        sl = slice(ci * e_chunk, (ci + 1) * e_chunk)
        pchunk = {k: params[k][sl] for k in ("w_in", "b_in", "w_out",
                                             "b_out")}
        out = _sort_ffn(pchunk, flat, fsz, span, lut, e_chunk,
                        ep * g * span, use_kernels=use_kernels)
        out = out.reshape(e_chunk, ep, g * span, H).transpose(0, 1)
        outs.append(ds_dist.all_to_all(out, group))
    out_full = outs[0] if n_ch == 1 else torch.cat(outs, dim=1)
    return out_full.reshape(ep * e_local * g * span, H)


def _einsum_exchange_ffn(params, expert_in, ep, group):
    """The einsum engine's expert FFN across ``ep`` ranks: expert_in
    [E, g·C, H] → the owners' [ep, e_local, g·C, H] → every local
    expert's FFN over ep·g·C rows → back → [E, g·C, H]."""
    E, rows, H = expert_in.shape
    e_local = E // ep
    recv = ds_dist.all_to_all(expert_in.reshape(ep, e_local, rows, H),
                              group)
    flat = recv.transpose(0, 1).reshape(e_local, ep * rows, H)
    out = _expert_ffn(params["w_in"], params["b_in"], params["w_out"],
                      params["b_out"], flat)
    out = out.reshape(e_local, ep, rows, H).transpose(0, 1)
    return ds_dist.all_to_all(out, group).reshape(E, rows, H)


def _fold_rank(rng, group):
    """A generator for this rank's jitter: one draw from ``rng`` (the
    same on every rank) folded with the rank, as `jax.random.fold_in(rng,
    axis_index)` decorrelates the ranks' noise (the numbers are not
    JAX's)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device))
    rank = ds_dist.get_rank(group)
    return torch.Generator(device=rng.device).manual_seed(
        (seed + 0x9E3779B97F4A7C15 * (rank + 1)) % 2 ** 63)


def _resolve_group(group):
    """A process group from ``group``: itself, a 1-D `DeviceMesh`'s
    group, or the default group for None. The exchange needs the ranks of
    a process group (`init_distributed`), where the JAX function needs a
    `shard_map` over a named axis."""
    if isinstance(group, str):
        raise TypeError(
            f"moe_ffn_expert_parallel takes a process group or a DeviceMesh "
            f"for its ranks, not an axis name ({group!r}): the port runs one "
            f"process a rank, not a shard_map")
    if not ds_dist.is_initialized():
        raise RuntimeError(
            "moe_ffn_expert_parallel exchanges tokens between the ranks of "
            "a process group: init_distributed first")
    if group is None:
        import torch.distributed as dist
        return dist.group.WORLD
    if hasattr(group, "get_group"):
        names = getattr(group, "mesh_dim_names", None) or ()
        return group.get_group("expert" if "expert" in names else 0)
    return group


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def moe_ffn_dense(params, x, capacity_factor=1.25, top_k=1, rng=None,
                  jitter_eps=0.0, groups=1, dispatch="einsum",
                  renorm_kept_choices=False, use_kernels=True,
                  ffn_quant=None, observe=False, group=None,
                  expert_parallel=False, a2a_overlap_chunks=1):
    """The MoE FFN of the JAX package's `moe_ffn_dense`: one device over
    the (global) micro-batch. ``params``: stacked expert weights {"w_in"
    [E, H, I], "b_in" [E, I], "w_out" [E, I, H], "b_out" [E, H], "gate"
    [H, E]}; x [T, H] → (y [T, H], aux_loss). ``groups`` splits the
    tokens into independent routing groups (capacity per group);
    ``dispatch`` picks the engine; ``rng`` is a `torch.Generator` for the
    gate jitter; ``use_kernels=False`` sends the sort engine's grouped
    matmuls to their plain version on any device. ``ffn_quant`` =
    (recipe, margin, amax_row [4, H]) quantizes the sort engine's
    grouped products (`_sort_ffn`) and makes the return (y, aux_loss,
    new_amax_row); the einsum engine refuses it. ``observe`` emits the
    sort engine's routing statistics (`ROUTING_STATS`).

    Across ranks: ``group`` (a process group) makes ``x`` this rank's
    share of the global micro-batch, rank-major, and the route the
    global one (`_route_plan`); the aux loss is the global batch's
    where a group spans ranks, and where each rank holds whole groups the
    ranks' mean (the data-parallel average). ``expert_parallel`` (the
    "expert" mesh, over the same group): ``params`` hold this rank's
    E/world experts (the gate whole) and the sort engine's buffer is
    exchanged with their owners (`_exchange_ffn`, pipelined over
    ``a2a_overlap_chunks`` chunks; at world 1 the exchange is a copy and
    the result the one-card one bit for bit). At world 1, or with no
    group, the route is the one-card one."""
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, "
                         f"got {dispatch!r}")
    if observe and dispatch != "sort":
        raise ValueError(
            "observe=True requires dispatch='sort': the routing stats "
            "come from the sort engine's position-in-expert bookkeeping")
    if ffn_quant is not None and dispatch != "sort":
        raise ValueError(
            "quantization.ffn on MoE blocks requires dispatch='sort': "
            "the delayed-scaling path quantizes the grouped expert "
            "matmul operands (the einsum engine spends its flops on the "
            "one-hot dispatch tensor, which quantization cannot help)")
    ep = ds_dist.get_world_size(group) if expert_parallel else 1
    if expert_parallel and (dispatch != "sort" or ffn_quant is not None):
        raise DeepSpeedConfigError(
            "experts sharded over an \"expert\" mesh run the sort "
            "engine without quantization.ffn; the einsum engine and the "
            "quantized FFN there are not ported yet (ROADMAP.md A.6)")
    T, H = x.shape
    E = params["w_in"].shape[0] * ep
    g, tg, sync = _route_plan(groups, T, group)
    capacity = max(1, int(capacity_factor * top_k * tg / E))
    xg = x.reshape(g, T // g, H)

    if dispatch == "einsum":
        dispatch_t, combine, aux = _route_groups(
            params["gate"], xg, capacity, top_k, rng, jitter_eps,
            renorm_kept_choices=renorm_kept_choices, sync=sync)
        expert_in = torch.einsum("gtec,gth->egch", dispatch_t, xg)
        expert_out = _expert_ffn(
            params["w_in"], params["b_in"], params["w_out"], params["b_out"],
            expert_in.reshape(E, g * capacity, H))           # [E, g·C, H]
        y = torch.einsum("gtec,egch->gth", combine,
                         expert_out.reshape(E, g, capacity, H))
        return y.reshape(T, H), aux

    probs = _jittered_probs(params["gate"], xg, rng, jitter_eps)
    route = _sort_route(probs, capacity, top_k, renorm_kept_choices, sync)
    if observe:
        _emit_routing_stats(route, E, g, group)
    span, _ = pick_span(capacity)
    buf, sizes = _fill_buffer(x, route, span)
    if expert_parallel:
        out_buf = _exchange_ffn(params, buf, sizes, ep, g, span, group,
                                a2a_overlap_chunks, use_kernels)
        return _sort_combine(out_buf, route, span, T, x.dtype), route.aux
    lut = tuple(np.repeat(np.arange(E), g).tolist())
    out_buf = _sort_ffn(params, buf, sizes, span, lut, E, g * span,
                        use_kernels=use_kernels, ffn_quant=ffn_quant)
    if ffn_quant is not None:
        out_buf, new_amax_row = out_buf
        return (_sort_combine(out_buf, route, span, T, x.dtype), route.aux,
                new_amax_row)
    return _sort_combine(out_buf, route, span, T, x.dtype), route.aux


def moe_ffn_expert_parallel(params, x, group, ep, capacity_factor=1.25,
                            top_k=1, rng=None, jitter_eps=0.0, groups=1,
                            dispatch="einsum", renorm_kept_choices=False,
                            a2a_overlap_chunks=1, use_kernels=True,
                            observe=False):
    """The JAX package's `moe_ffn_expert_parallel` (its `shard_map`
    semantics) on ``ep`` ranks of ``group`` (a process group, a 1-D
    `DeviceMesh` with an "expert" dimension, or None for the default
    group: the counterpart of ``axis_name``). ``x`` is this rank's token
    shard [T_local, H]; ``params`` carry this rank's experts ({"w_in"
    [E/ep, H, I], ...}) and the whole gate. Each rank routes its own
    shard (capacity per local routing group, as `moe_ffn_dense` per
    shard), all-to-alls send the expert-major token blocks to the
    experts' owners and the outputs back, and the aux loss is averaged
    over the group through a differentiable all-reduce (its backward
    sums: the gradients are those of the mean over the ranks of each
    rank's loss, the data-parallel convention). The jitter draws from
    ``rng`` folded with the rank (`_fold_rank`). With ``dispatch="sort"``
    and ``a2a_overlap_chunks`` > 1 the exchange is pipelined over chunks
    of local experts (`_exchange_ffn`), bit-identical to one chunk."""
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, "
                         f"got {dispatch!r}")
    if observe and dispatch != "sort":
        raise ValueError(
            "observe=True requires dispatch='sort': the routing stats "
            "come from the sort engine's position-in-expert bookkeeping")
    group = _resolve_group(group)
    T, H = x.shape
    e_local = params["w_in"].shape[0]
    E = e_local * ep
    g = _resolve_groups(groups, T)
    tg = T // g
    capacity = max(1, int(capacity_factor * top_k * tg / E))
    if rng is not None and jitter_eps > 0.0:
        rng = _fold_rank(rng, group)
    xg = x.reshape(g, tg, H)

    if dispatch == "einsum":
        dispatch_t, combine, aux = _route_groups(
            params["gate"], xg, capacity, top_k, rng, jitter_eps,
            renorm_kept_choices=renorm_kept_choices)
        expert_in = torch.einsum("gtec,gth->egch", dispatch_t, xg)
        expert_out = _einsum_exchange_ffn(
            params, expert_in.reshape(E, g * capacity, H), ep, group)
        y = torch.einsum("gtec,egch->gth", combine,
                         expert_out.reshape(E, g, capacity, H))
        return y.reshape(T, H), ds_dist.all_reduce_sum(aux, group) / ep

    probs = _jittered_probs(params["gate"], xg, rng, jitter_eps)
    route = _sort_route(probs, capacity, top_k, renorm_kept_choices)
    if observe:
        # this rank's shard's statistics; the collector averages the
        # ranks' emissions, as the JAX host collector does
        _emit_routing_stats(route, E, g)
    span, _ = pick_span(capacity)
    buf, sizes = _fill_buffer(x, route, span)
    out_buf = _exchange_ffn(params, buf, sizes, ep, g, span, group,
                            a2a_overlap_chunks, use_kernels)
    y = _sort_combine(out_buf, route, span, T, x.dtype)
    return y, ds_dist.all_reduce_sum(route.aux, group) / ep


def expert_shard(params, rank, ep):
    """This rank's slice of a whole MoE params tree: the expert leaves'
    rows [rank·E/ep, (rank + 1)·E/ep), the gate whole."""
    out = {}
    for k, v in params.items():
        if k == "gate":
            out[k] = v
        else:
            n = v.shape[0] // ep
            out[k] = v[rank * n:(rank + 1) * n]
    return out


class MoELayer:
    """MoE FFN layer with the JAX package's init/apply protocol,
    expert-parallel when ``mesh`` (a `torch.distributed.device_mesh.
    DeviceMesh`, the counterpart of `jax.sharding.Mesh`) has an
    ``axis_name`` dimension of more than one rank: ``apply`` then takes
    this rank's token shard and its experts (`shard_params`) and runs
    `moe_ffn_expert_parallel`. ``device=None`` means the GPU; the CPU
    must be asked for."""

    def __init__(self, hidden_size, intermediate_size, num_experts,
                 capacity_factor=1.25, mesh=None, axis_name="expert",
                 param_dtype=torch.float32, top_k=1, jitter_eps=0.0,
                 groups=1, dispatch="einsum", renorm_kept_choices=False,
                 a2a_overlap_chunks=1, device=None):
        if dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, "
                             f"got {dispatch!r}")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.jitter_eps = jitter_eps
        self.groups = groups
        self.dispatch = dispatch
        self.renorm_kept_choices = renorm_kept_choices
        self.a2a_overlap_chunks = a2a_overlap_chunks
        self.axis_name = axis_name
        names = getattr(mesh, "mesh_dim_names", None) or ()
        self.mesh = mesh
        self.ep = int(mesh.size(names.index(axis_name))) \
            if mesh is not None and axis_name in names else 1
        if num_experts % max(self.ep, 1) != 0:
            raise ValueError(f"num_experts {num_experts} must divide over "
                             f"expert-parallel size {self.ep}")
        self.group = mesh.get_group(axis_name) if self.ep > 1 else None
        self.param_dtype = param_dtype
        self.device = resolve_device(device, "MoELayer")

    def init(self, seed=0):
        """Seeded parameters (the whole layer): normal × 0.02 for the
        gate and the expert weights, zero biases (`MoELayer.init`; the
        draws come from a `torch.Generator`, not the JAX package's)."""
        E, H, I = self.num_experts, self.hidden_size, self.intermediate_size
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def normal(*shape):
            return (0.02 * torch.randn(shape, generator=gen,
                                       device=self.device)).to(
                self.param_dtype)

        zeros = functools.partial(torch.zeros, dtype=self.param_dtype,
                                  device=self.device)
        return {"gate": normal(H, E), "w_in": normal(E, H, I),
                "b_in": zeros(E, I), "w_out": normal(E, I, H),
                "b_out": zeros(E, H)}

    def param_specs(self):
        """The leaves' shardings, as `PartitionSpec` entries: the expert
        dim over the expert axis (``(axis_name,)``), the gate replicated
        (``()``); all replicated without expert parallelism."""
        ax = (self.axis_name,) if self.ep > 1 else ()
        return {"gate": (), "w_in": ax, "b_in": ax, "w_out": ax,
                "b_out": ax}

    def shard_params(self, params, rank=None):
        """This rank's slice of the whole ``params`` (`expert_shard`);
        the tree itself without expert parallelism."""
        if self.ep == 1:
            return params
        if rank is None:
            rank = ds_dist.get_rank(self.group)
        return expert_shard(params, rank, self.ep)

    def apply(self, params, x, rng=None, use_kernels=True):
        """x [..., H] → (y [..., H], aux_loss); with expert parallelism
        ``x`` is this rank's shard and ``params`` its experts."""
        lead = x.shape[:-1]
        kw = dict(capacity_factor=self.capacity_factor, top_k=self.top_k,
                  rng=rng, jitter_eps=self.jitter_eps if rng is not None
                  else 0.0, groups=self.groups, dispatch=self.dispatch,
                  renorm_kept_choices=self.renorm_kept_choices,
                  use_kernels=use_kernels)
        flat = x.reshape(-1, self.hidden_size)
        if self.ep > 1:
            y, aux = moe_ffn_expert_parallel(
                params, flat, self.group, self.ep,
                a2a_overlap_chunks=self.a2a_overlap_chunks, **kw)
        else:
            y, aux = moe_ffn_dense(params, flat, **kw)
        return y.reshape(*lead, self.hidden_size), aux
