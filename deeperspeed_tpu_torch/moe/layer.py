"""Mixture-of-Experts FFN on one card.

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
engine drains into ``Train/MoE/*`` scalars. Expert parallelism
(`moe_ffn_expert_parallel`, a mesh) is not ported yet.
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


def _emit_routing_stats(route, capacity, E, g):
    """Emit one routing observation (sort engine only: the route's
    counts already hold the position-in-expert bookkeeping, so the
    statistics cost two reductions). The virtual-expert counts fold back
    to real experts (virtual id = expert·g + group)."""
    kT = route.pos.shape[0]                      # routed copies (T·top_k)
    counts_e = route.counts.reshape(E, g).sum(dim=1)
    load = counts_e.float() / max(kT, 1)
    kept = torch.clamp(route.counts, max=capacity).sum()
    drop = 1.0 - kept.float() / max(kT, 1)
    ROUTING_STATS._record(load, drop)


def _one_hot(idx, n):
    """float one-hot of int ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row (`jax.nn.one_hot`)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


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
                      renorm_kept_choices=False):
    """Top-k capacity routing of one group: (jittered) logits [T, E] fp32
    → (dispatch [T, E, C], combine [T, E, C], aux)."""
    T, E = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    expert1 = torch.argmax(probs, dim=-1)
    onehot1 = _one_hot(expert1, E)
    g1 = probs.gather(1, expert1[:, None])[:, 0]
    aux = E * torch.sum(probs.mean(dim=0) * onehot1.mean(dim=0))
    dispatch1, counts1 = _choice_dispatch(onehot1, capacity)
    if top_k == 1:
        return dispatch1, dispatch1 * g1[:, None, None], aux
    if top_k != 2:
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    probs2 = probs * (1.0 - onehot1)                         # mask top-1
    expert2 = torch.argmax(probs2, dim=-1)
    onehot2 = _one_hot(expert2, E)
    g2 = probs.gather(1, expert2[:, None])[:, 0]
    dispatch2, _ = _choice_dispatch(onehot2, capacity, base_counts=counts1)
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
                  renorm_kept_choices=False):
    """Route each group independently: xg [g, Tg, H] → (dispatch [g, Tg,
    E, C], combine [g, Tg, E, C], aux averaged over groups), dispatch and
    combine in the compute dtype."""
    logits = _gate_logits(gate, xg, rng, jitter_eps)
    routed = [_one_hot_dispatch(lg, capacity, top_k, renorm_kept_choices)
              for lg in logits]
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


def _jittered_probs(gate, xg, rng, jitter_eps):
    """Gate probabilities [g, Tg, E] from the einsum engine's logits and
    noise."""
    return torch.softmax(_gate_logits(gate, xg, rng, jitter_eps), dim=-1)


def _sort_route(probs, capacity, top_k, renorm_kept_choices):
    """probs [g, Tg, E] fp32 → `_SortRoute`. The stable sort over
    (virtual) expert ids of the choice-major copies reproduces the GShard
    queue: within an expert, first choices in token order, then second
    choices — the position bookkeeping of `_choice_dispatch` without the
    one-hot tensors."""
    g, tg, E = probs.shape
    T = g * tg
    dev = probs.device
    p2 = probs.reshape(T, E)
    gi = torch.arange(T, device=dev) // tg
    expert1 = torch.argmax(p2, dim=-1)
    onehot1 = _one_hot(expert1, E)
    g1 = p2.gather(1, expert1[:, None])[:, 0]
    me = probs.mean(dim=1)                                   # [g, E]
    ce = onehot1.reshape(g, tg, E).mean(dim=1)               # [g, E]
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
    kept = (pos < capacity).float()
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
    return _SortRoute(experts_v, pos, weights, counts, starts, order, aux)


def _fill_buffer(x, route, capacity, span):
    """Compact the routed copies into the [V·span, H] expert-major buffer
    by a gather: row (v, p) holds the p-th surviving copy of virtual
    expert v, zero when p ≥ min(count, capacity). Returns (buffer,
    group_sizes [V])."""
    T, H = x.shape
    kT = route.order.shape[0]
    V = route.counts.shape[0]
    tok_sorted = route.order % T
    p = torch.arange(span, device=x.device)
    src = route.starts[:, None] + p[None, :]                 # [V, span]
    sizes = torch.clamp(route.counts, max=capacity)
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
# entry points
# ---------------------------------------------------------------------------

def moe_ffn_dense(params, x, capacity_factor=1.25, top_k=1, rng=None,
                  jitter_eps=0.0, groups=1, dispatch="einsum",
                  renorm_kept_choices=False, use_kernels=True,
                  ffn_quant=None, observe=False):
    """The MoE FFN on one device. ``params``: stacked expert weights
    {"w_in" [E, H, I], "b_in" [E, I], "w_out" [E, I, H], "b_out" [E, H],
    "gate" [H, E]}; x [T, H] → (y [T, H], aux_loss). ``groups`` splits
    the tokens into independent routing groups (capacity per group);
    ``dispatch`` picks the engine; ``rng`` is a `torch.Generator` for the
    gate jitter; ``use_kernels=False`` sends the sort engine's grouped
    matmuls to their plain version on any device. ``ffn_quant`` =
    (recipe, margin, amax_row [4, H]) quantizes the sort engine's
    grouped products (`_sort_ffn`) and makes the return (y, aux_loss,
    new_amax_row); the einsum engine refuses it. ``observe`` emits the
    sort engine's routing statistics (`ROUTING_STATS`)."""
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
    T, H = x.shape
    E = params["w_in"].shape[0]
    g = _resolve_groups(groups, T)
    tg = T // g
    capacity = max(1, int(capacity_factor * top_k * tg / E))
    xg = x.reshape(g, tg, H)

    if dispatch == "einsum":
        dispatch_t, combine, aux = _route_groups(
            params["gate"], xg, capacity, top_k, rng, jitter_eps,
            renorm_kept_choices=renorm_kept_choices)
        expert_in = torch.einsum("gtec,gth->egch", dispatch_t, xg)
        expert_out = _expert_ffn(
            params["w_in"], params["b_in"], params["w_out"], params["b_out"],
            expert_in.reshape(E, g * capacity, H))           # [E, g·C, H]
        y = torch.einsum("gtec,egch->gth", combine,
                         expert_out.reshape(E, g, capacity, H))
        return y.reshape(T, H), aux

    probs = _jittered_probs(params["gate"], xg, rng, jitter_eps)
    route = _sort_route(probs, capacity, top_k, renorm_kept_choices)
    if observe:
        _emit_routing_stats(route, capacity, E, g)
    span, _ = pick_span(capacity)
    buf, sizes = _fill_buffer(x, route, capacity, span)
    lut = tuple(np.repeat(np.arange(E), g).tolist())
    out_buf = _sort_ffn(params, buf, sizes, span, lut, E, g * span,
                        use_kernels=use_kernels, ffn_quant=ffn_quant)
    if ffn_quant is not None:
        out_buf, new_amax_row = out_buf
        return (_sort_combine(out_buf, route, span, T, x.dtype), route.aux,
                new_amax_row)
    return _sort_combine(out_buf, route, span, T, x.dtype), route.aux


def moe_ffn_expert_parallel(*args, **kwargs):
    """Expert parallelism (experts sharded over ranks, all-to-all token
    exchange) is not ported yet: it comes with the ranks slice after
    data-parallel ZeRO 1-2 (ROADMAP.md A.6). Replicated experts train
    across data-parallel ranks like any other leaf."""
    raise NotImplementedError(
        "moe_ffn_expert_parallel is not ported yet (expert parallelism "
        "comes after data-parallel ZeRO 1-2 in the ranks slice, A.6; see "
        "ROADMAP.md)")


class MoELayer:
    """MoE FFN layer with the JAX package's init/apply protocol, on one
    device (``device=None`` means the GPU; the CPU must be asked for). A
    ``mesh`` (expert parallelism) is not ported yet."""

    def __init__(self, hidden_size, intermediate_size, num_experts,
                 capacity_factor=1.25, mesh=None, axis_name="expert",
                 param_dtype=torch.float32, top_k=1, jitter_eps=0.0,
                 groups=1, dispatch="einsum", renorm_kept_choices=False,
                 a2a_overlap_chunks=1, device=None):
        if dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, "
                             f"got {dispatch!r}")
        if mesh is not None:
            raise NotImplementedError(
                "MoELayer with a mesh (expert parallelism) is not ported "
                "yet (scale-out, ROADMAP.md A.6)")
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
        self.param_dtype = param_dtype
        self.device = resolve_device(device, "MoELayer")

    def init(self, seed=0):
        """Seeded parameters: normal × 0.02 for the gate and the expert
        weights, zero biases (`MoELayer.init`; the draws come from a
        `torch.Generator`, not the JAX package's)."""
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

    def apply(self, params, x, rng=None, use_kernels=True):
        """x [..., H] → (y [..., H], aux_loss)."""
        lead = x.shape[:-1]
        y, aux = moe_ffn_dense(
            params, x.reshape(-1, self.hidden_size),
            capacity_factor=self.capacity_factor, top_k=self.top_k, rng=rng,
            jitter_eps=self.jitter_eps if rng is not None else 0.0,
            groups=self.groups, dispatch=self.dispatch,
            renorm_kept_choices=self.renorm_kept_choices,
            use_kernels=use_kernels)
        return y.reshape(*lead, self.hidden_size), aux
