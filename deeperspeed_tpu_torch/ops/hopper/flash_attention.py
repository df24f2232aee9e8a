"""Flash attention, forward and backward: the CUDA kernels and their
plain versions.

Replaces the TPU kernels of `deeperspeed_tpu/ops/pallas/flash_attention.py`
that `flash_attention` / `flash_attention_segmented` reach: the forward
`_fwd_kernel` (tiled, segmented) and `_fwd_single_kernel` /
`_fwd_single_mh_kernel` (one block, S <= 1024) are one function, computed
by `csrc/flash_fwd.cu` at every S; the backward `_bwd_single_kernel` /
`_bwd_single_mh_kernel` and the tiled `_bwd_dkv_kernel` / `_bwd_dq_kernel`
are one function too, computed by `csrc/flash_bwd.cu`. The headers of the
sources say what bounds each kernel on the H100 and what its design does
about that. Each source holds two designs, chosen by dtype and head dim
in its C dispatch (`flash_design` mirrors the choice): bf16 and fp16 at
D = 64 and 128 run tensor-core kernels (`mma.sync`, `ldmatrix`,
`cp.async`; `csrc/attention_mma.cuh`), which need each 16-bit operand
16-byte aligned (`check_alignment`); fp32 and D = 256 run the FMA tile
steps of `csrc/attention_tiles.cuh`. In fp16 (the loss-scaled training
path) the kernels round dS to fp16 before dQ and dK, as the plain
backward does, so a dS past 65504 is inf in both. Launches are counted
by design too
(`design_launches`).

The layout-mask flag (`make_masked_flash_attention`, the dense-ish arm of
`SparseSelfAttention`) replaces `_apply_layout_mask` on the same TPU
kernels: the kernels take an ``[H, S/128, S/128]`` int32 block map and
skip every tile of an inactive 128×128 block, which gives what the
TPU kernel's additive -1e30 penalty gives. Those launches are counted
apart (``masked_*``), so a run can tell the two arms apart.

The key-bias and dropout flags (`flash_attention_kbias`,
`flash_attention_train`: the fused BERT encoder layer's attention)
replace those flags of the same TPU kernels (`use_bias`,
`dropout_rate`): a ``[B, S]`` fp32 bias added to every row's scores
after the scale, and dropout on the probabilities by the keep-mask of
`_dropout_keep` (`dropout_keep` here), a hash of (seed, b·H + h,
absolute row, absolute key) that the backward regenerates. Their
launches are counted apart by flag combination (`flag_launches`).

Contract (the JAX package's):

- q, k, v ``[B, S, H, D]`` in, out ``[B, S, H, D]`` in q's dtype; lse
  ``[B·H, S]`` fp32 (the JAX package's ``[B·H, 1, S]`` residual,
  squeezed);
- causal or not, with ``segment_ids`` ``[B, S]`` int (optional) and the
  layout's blocks ANDed into the mask; masked scores are -1e30, and the
  key bias is added to them;
- dropout: the softmax sum counts the undropped probabilities, a kept
  one is scaled by 1 / (1 - rate) (torch's dropout(softmax(s)));
- a row with no live key gives zero output, lse = +1e30 and zero
  gradients;
- ``sm_scale`` defaults to 1/√D;
- the backward takes delta = rowsum(dO ∘ out) as one plain reduction, as
  the JAX package does (`_bwd`).

`flash_attention_segmented`, `flash_attention_kbias` and
`flash_attention_train` are a `torch.autograd.Function`: on CUDA tensors
its forward launches the forward kernel and its backward the two
backward kernels; on CPU tensors both directions take the plain
versions. An unsupported dtype or head dim on a CUDA tensor raises.
Unlike the JAX package, which sends a sequence that no 128-multiple
block divides (S = 64 among the serving buckets) to its XLA fallback,
every length goes through the kernels here.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

NEG_INF = -1e30

MASK_GRAIN = 128  # layout-mask granularity (one sparsity block)

# kernel launches since the last reset (`chip_smoke.py` reads these):
# plain causal / segmented calls, and calls with a layout mask
launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
masked_launches = 0
masked_bwd_dkv_launches = 0
masked_bwd_dq_launches = 0
# calls with the key-bias or dropout flags, by kernel ("fwd", "dkv",
# "dq") and flag combination
FLAG_COMBOS = ("kbias", "dropout", "kbias_dropout")
flag_launches = {kernel: dict.fromkeys(FLAG_COMBOS, 0)
                 for kernel in ("fwd", "dkv", "dq")}


# the dtypes and head dims that take the tensor-core kernels (`takes_mma`
# in csrc/attention_mma.cuh), and the launches by kernel and design
MMA_DTYPES = (torch.bfloat16, torch.float16)
MMA_HEAD_DIMS = (64, 128)
DESIGNS = ("mma", "fma")
design_launches = {kernel: dict.fromkeys(DESIGNS, 0)
                   for kernel in ("fwd", "dkv", "dq")}


# the design the wrapper last ran ("mma", "fma" or "plain"), by direction;
# `ops.dispatch_report` reads it
LAST_DESIGN = {}


def reset_flag_launches():
    for counts in flag_launches.values():
        counts.update(dict.fromkeys(counts, 0))


def reset_design_launches():
    for counts in design_launches.values():
        counts.update(dict.fromkeys(counts, 0))


def flash_design(dtype, head_dim):
    """"mma" (the bf16 and fp16 tensor-core kernels) or "fma" (the FMA
    tile steps) for a call on ``dtype`` at ``head_dim``."""
    return "mma" if dtype in MMA_DTYPES and \
        head_dim in MMA_HEAD_DIMS else "fma"


def check_alignment(tensors, what):
    """Raise unless each (name, tensor) has its base pointer and the
    strides of its batch, sequence and head dims (where they exceed 1)
    on 16-byte multiples: the tensor-core kernels load rows by 16-byte
    cp.async copies."""
    for name, t in tensors:
        steps = [st * t.element_size()
                 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 16 for st in steps):
            raise ValueError(
                f"{what} kernel ({t.dtype}, tensor-core design) needs "
                f"{name}'s base pointer and its row strides on 16-byte "
                f"multiples, got the pointer at {t.data_ptr() % 16} mod 16 "
                f"and strides {tuple(t.stride())}")


def _flag_combo(kbias, dropout):
    """The `flag_launches` key of a call, or None without flags."""
    return "_".join(name for name, on in (("kbias", kbias is not None),
                                          ("dropout", dropout)) if on) or None


def check_dropout_rate(rate):
    """Refuse a rate outside [0, 1): 1 / (1 - rate) is inf or NaN at 1
    and a negative rate keeps everything (`_check_dropout_rate`)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")


def dropout_threshold(rate):
    """The keep threshold on the hash's low 31 bits, in double on the
    host as the JAX package computes it."""
    return int(min(max(rate, 0.0), 1.0) * 2147483647)


def dropout_keep(seed, pid, row0, col0, shape, rate):
    """`_dropout_keep`'s keep-mask, in plain torch: the 2-round int32
    avalanche hash of (seed, pid = b·H + h, row0 + row, col0 + col) over
    a ``shape`` = (rows, cols) tile, kept where its low 31 bits reach
    `dropout_threshold`. int32 products wrap and ``>>`` is arithmetic,
    as in the TPU kernel. ``seed`` and ``pid`` are ints or int32 tensors
    (a ``pid`` of shape [B, H, 1, 1] gives a [B, H, rows, cols] mask)."""
    device = seed.device if isinstance(seed, torch.Tensor) else None
    seed = torch.as_tensor(seed, dtype=torch.int32, device=device)
    pid = torch.as_tensor(pid, dtype=torch.int32, device=device)
    rows = torch.arange(shape[0], dtype=torch.int32,
                        device=device)[:, None] + row0
    cols = torch.arange(shape[1], dtype=torch.int32,
                        device=device)[None, :] + col0
    x = (rows * -1640531527) ^ (cols * -2048144789)   # 0x9E3779B9/0x85EBCA6B
    x = x ^ (seed + pid * -1028477387)                # 0xC2B2AE35
    x = (x ^ ((x >> 16) & 0xFFFF)) * 0x7FEB352D
    x = (x ^ ((x >> 15) & 0x1FFFF)) * -2073452917     # 0x84699E8B
    x = x ^ ((x >> 16) & 0xFFFF)
    return (x & 0x7FFFFFFF) >= dropout_threshold(rate)


def _keep_mask(seed, B, H, S, rate, device):
    """The keep-mask of every (b, h) of a call, [B, H, S, S]."""
    pid = torch.arange(B * H, dtype=torch.int32,
                       device=device).reshape(B, H, 1, 1)
    return dropout_keep(seed.to(device).reshape(()), pid, 0, 0, (S, S), rate)


def flash_attention_supported(shape):
    """The shapes the JAX package's flash kernels take (S divisible by a
    128-multiple block of at most 1024, head dim 64, 128 or 256); its
    callers send the rest to the materialized path, and so does the
    port's transformer layer, so that both take the same path."""
    _, s, _, d = shape
    return s % 128 == 0 and s >= 128 and d in (64, 128, 256)


def _acc(t):
    """``t`` upcast to fp32 for the plain versions' sums (float64 stays,
    so a gradient check keeps its precision)."""
    return t if t.dtype == torch.float64 else t.float()


def layout_token_mask(layout, S):
    """[H, S/128, S/128] block map → [H, S, S] bool token mask."""
    mask = layout.to(torch.bool)
    return mask.repeat_interleave(S // mask.shape[1], dim=1) \
        .repeat_interleave(S // mask.shape[2], dim=2)


def _live_mask(S, segment_ids, device, layout=None, causal=True):
    """Live (row, key) pairs [1 or B, 1 or H, S, S]: causal (or all),
    ANDed with segment equality and the layout's blocks."""
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril()
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None] ==
                       segment_ids[:, None, None, :])
    if layout is not None:
        mask = mask & layout_token_mask(layout.to(device), S)[None]
    return mask


def flash_attention_segmented_reference(q, k, v, segment_ids=None,
                                        sm_scale=None, layout=None,
                                        causal=True, kbias=None, seed=None,
                                        dropout_rate=0.0):
    """Plain PyTorch version: `causal_attention`'s XLA branch
    (`gpt_neox.py:355-364`) plus the lse, on any device; with a
    ``layout``, dense attention under its token mask (the JAX package's
    `dense_masked_attention`); ``kbias`` [B, S] is added to the masked
    scores and ``dropout_rate`` > 0 drops probabilities by
    `dropout_keep` at ``seed`` (int32 [1]) after the sum. Returns (out
    [B, S, H, D] in v's dtype, lse [B·H, S] fp32)."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale
    mask = _live_mask(S, segment_ids, q.device, layout, causal)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    if kbias is not None:
        logits = logits + kbias.to(logits.dtype)[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(logits <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, B, H, S, dropout_rate, q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(p))
    probs = (p / l_safe).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    lse = torch.where(l == 0, torch.full_like(l, -NEG_INF),
                      m + torch.log(l_safe))
    return out, lse.reshape(B * H, S)


def _check(q, k, v, segment_ids):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if segment_ids is not None and tuple(segment_ids.shape) != q.shape[:2]:
        raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != "
                         f"{tuple(q.shape[:2])}")


def _check_kbias(q, kbias):
    if kbias is not None and tuple(kbias.shape) != tuple(q.shape[:2]):
        raise ValueError(f"kbias shape {tuple(kbias.shape)} != "
                         f"{tuple(q.shape[:2])} ([B, S])")


def _flag_args(q, kbias, seed, dropout_rate, what):
    """Check the flags the kernels take → (fp32 [B, S] kbias or None,
    int32 [1] seed or None, thresh, 1 / keep); the seed is passed only
    when dropout is on."""
    kb = None
    if kbias is not None:
        _check_kbias(q, kbias)
        if kbias.device != q.device:
            raise ValueError("kbias must be on q's device")
        kb = kbias.to(torch.float32).contiguous()
    if dropout_rate <= 0.0:
        return kb, None, 0, 1.0
    check_dropout_rate(dropout_rate)
    if not (isinstance(seed, torch.Tensor) and seed.dtype == torch.int32
            and seed.numel() == 1 and seed.device == q.device):
        raise ValueError(f"{what} kernel needs the dropout seed as one "
                         f"int32 on q's device")
    return kb, seed.reshape(1), dropout_threshold(dropout_rate), \
        1.0 / (1.0 - dropout_rate)


def _kernel_args(q, k, v, segment_ids, what, layout=None):
    """Check what the kernels take → (int32 segment ids or None, int32
    layout or None, dtype code, sm_scale default)."""
    B, S, H, D = q.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32, bfloat16 or "
                        f"float16, got "
                        f"{q.dtype}")
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in "
                         f"{_build.HEAD_DIMS}, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what} kernel needs the head dim of q, k, v "
                         f"contiguous (stride 1)")
    if B * H > 65535 or S < 1:
        raise ValueError(f"{what} kernel grid: B·H = {B * H} must be <= "
                         f"65535 and S = {S} >= 1")
    seg = None
    if segment_ids is not None:
        if segment_ids.device != q.device:
            raise ValueError("segment_ids must be on q's device")
        seg = segment_ids.to(torch.int32).contiguous()
    lay = None
    if layout is not None:
        n = S // MASK_GRAIN
        if S % MASK_GRAIN or tuple(layout.shape) != (H, n, n):
            raise ValueError(f"{what} kernel needs S a multiple of "
                             f"{MASK_GRAIN} and the layout [H, S/128, "
                             f"S/128] = {(H, n, n)}, got S = {S} and "
                             f"{tuple(layout.shape)}")
        if layout.device != q.device:
            raise ValueError("layout must be on q's device")
        lay = layout.to(torch.int32).contiguous()
    return seg, lay, _build.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D)


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_attention_cuda(q, k, v, segment_ids=None, sm_scale=None,
                         layout=None, causal=True, kbias=None, seed=None,
                         dropout_rate=0.0):
    """Launch `csrc/flash_fwd.cu` on CUDA tensors → (out, lse). ``kbias``
    is [B, S] (any float dtype, added in fp32); ``seed`` an int32 [1] on
    the device, read when ``dropout_rate`` > 0."""
    global launches, masked_launches
    B, S, H, D = q.shape
    seg, lay, code, default_scale = _kernel_args(
        q, k, v, segment_ids, "flash attention forward", layout)
    kb, sd, thresh, inv = _flag_args(q, kbias, seed, dropout_rate,
                                     "flash attention forward")
    scale = sm_scale if sm_scale is not None else default_scale
    design = flash_design(q.dtype, D)
    if design == "mma":
        check_alignment((("q", q), ("k", k), ("v", v)),
                        "flash attention forward")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), _ptr(lay),
        _ptr(kb), _ptr(sd), out.data_ptr(), lse.data_ptr(), B, S, H, D,
        *_strides(q, k, v), float(scale), int(causal), thresh, float(inv),
        code, _build.stream_ptr(q))
    _build.check(err, "ds_flash_fwd")
    LAST_DESIGN["fwd"] = design
    design_launches["fwd"][design] += 1
    combo = _flag_combo(kb, sd is not None)
    if combo is not None:
        flag_launches["fwd"][combo] += 1
    elif lay is None:
        launches += 1
    else:
        masked_launches += 1
    return out, lse


def attention_delta(out, do):
    """delta = rowsum(dO ∘ out) → [B·H, S] fp32 (`_bwd`'s one plain
    reduction)."""
    B, S, H, _ = out.shape
    delta = (_acc(do) * _acc(out)).sum(dim=-1)            # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, S).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do, segment_ids=None,
                                  sm_scale=None, layout=None, causal=True,
                                  kbias=None, seed=None, dropout_rate=0.0):
    """Plain PyTorch backward from the saved (out, lse), by the explicit
    formulas (no autograd): P = exp(s·scale + kbias − lse) on live
    pairs, dS = P ∘ (dP' − delta) · scale, dV = P'ᵀ dO, dK = dSᵀ Q, dQ =
    dS K, where with dropout P' and dP' are P and dP kept by the
    forward's mask and scaled by 1 / (1 − rate) (else P and dP), every
    sum in fp32 → (dq, dk, dv) [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, kf, vf, dof = _acc(q), _acc(k), _acc(v), _acc(do)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if kbias is not None:
        s = s + kbias.to(s.dtype)[:, None, None, :]
    lse4 = lse.reshape(B, H, S, 1).to(s.dtype)
    live = _live_mask(S, segment_ids, q.device, layout, causal)
    p = torch.where(live, torch.exp(s - lse4), torch.zeros_like(s))
    delta = attention_delta(out, do).reshape(B, H, S, 1).to(s.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    p_v = p
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, B, H, S, dropout_rate, q.device)
        inv = 1.0 / (1.0 - dropout_rate)
        p_v = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    ds = p * (dp - delta) * scale
    if q.dtype == torch.float16:
        # the kernels' A operand of dQ and dK: dS rounded to fp16, inf
        # past 65504 (an overflow the loss scaler must see)
        ds = ds.to(torch.float16).to(ds.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_v, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# fp16's overflow threshold: a value at or past it rounds to inf
FP16_INF_AT = 65520.0


def fp16_overflow_undecided(q, k, v, out, lse, do, segment_ids=None,
                            sm_scale=None, causal=True, margin=1e-3,
                            layout=None):
    """Where two correct fp16 backward passes may disagree on overflow →
    (dq, dk, dv) bool masks, [B, S, H, D]: an element whose own fp32 value
    (the plain version's, before its fp16 rounding) or, for dq and dk, a
    dS entry of its row or key lies within ``margin`` (relative) of
    `FP16_INF_AT`, where a last-bit difference in exp or in the order of
    a sum decides between 65504 and inf. Everywhere else the kernels and
    the plain version must be non-finite at the same places. Plain
    PyTorch, fp32, by the formulas of `flash_attention_bwd_reference`;
    ``layout`` ([H, S/128, S/128]) restricts the live pairs to its blocks,
    as the block-sparse kernels do."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    live = _live_mask(S, segment_ids, q.device, layout, causal)
    p = torch.where(live, torch.exp(s - lse.reshape(B, H, S, 1)),
                    torch.zeros_like(s))
    delta = attention_delta(out, do).reshape(B, H, S, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta) * scale
    lo, hi = FP16_INF_AT * (1 - margin), FP16_INF_AT * (1 + margin)

    def near(x):
        return (x.abs() >= lo) & (x.abs() <= hi)
    ds16 = ds.to(torch.float16).float()
    near_ds = near(ds)
    row = near_ds.any(dim=3).permute(0, 2, 1)[..., None]     # [B, S, H, 1]
    col = near_ds.any(dim=2).permute(0, 2, 1)[..., None]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return near(dq) | row, near(dk) | col, near(dv)


def flash_attention_bwd_cuda(q, k, v, lse, do, delta, segment_ids=None,
                             sm_scale=None, layout=None, causal=True,
                             kbias=None, seed=None, dropout_rate=0.0):
    """Launch the two kernels of `csrc/flash_bwd.cu` on CUDA tensors →
    (dq, dk, dv), [B, S, H, D] contiguous in q's dtype. ``do`` is made
    contiguous; ``delta`` is `attention_delta` [B·H, S] fp32; ``kbias``,
    ``seed`` and ``dropout_rate`` are the forward's."""
    global bwd_dkv_launches, bwd_dq_launches
    global masked_bwd_dkv_launches, masked_bwd_dq_launches
    B, S, H, D = q.shape
    seg, lay, code, default_scale = _kernel_args(
        q, k, v, segment_ids, "flash attention backward", layout)
    kb, sd, thresh, inv = _flag_args(q, kbias, seed, dropout_rate,
                                     "flash attention backward")
    combo = _flag_combo(kb, sd is not None)
    scale = sm_scale if sm_scale is not None else default_scale
    do = do.to(q.dtype).contiguous()
    design = flash_design(q.dtype, D)
    if design == "mma":
        check_alignment((("q", q), ("k", k), ("v", v), ("do", do)),
                        "flash attention backward")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B * H, S) or \
                not t.is_contiguous():
            raise ValueError(f"flash attention backward needs {name} as a "
                             f"contiguous [B·H, S] fp32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    lib = _build.load_library()
    stream = _build.stream_ptr(q)
    common = (B, S, H, D, *_strides(q, k, v), float(scale), int(causal),
              thresh, float(inv), code, stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), _ptr(seg), _ptr(lay), _ptr(kb),
           _ptr(sd))
    err = lib.ds_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *common)
    _build.check(err, "ds_flash_bwd_dkv")
    LAST_DESIGN["bwd"] = design
    design_launches["dkv"][design] += 1
    if combo is not None:
        flag_launches["dkv"][combo] += 1
    elif lay is None:
        bwd_dkv_launches += 1
    else:
        masked_bwd_dkv_launches += 1
    err = lib.ds_flash_bwd_dq(*ins, dq.data_ptr(), *common)
    _build.check(err, "ds_flash_bwd_dq")
    design_launches["dq"][design] += 1
    if combo is not None:
        flag_launches["dq"][combo] += 1
    elif lay is None:
        bwd_dq_launches += 1
    else:
        masked_bwd_dq_launches += 1
    return dq, dk, dv


@torch.library.custom_op("deeperspeed_tpu_torch::flash_fwd",
                         mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              segment_ids: Optional[torch.Tensor],
              layout: Optional[torch.Tensor], kbias: Optional[torch.Tensor],
              seed: Optional[torch.Tensor], sm_scale: Optional[float],
              causal: bool, dropout_rate: float,
              use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of `_FlashAttention` as one dispatcher op → (out, lse):
    the kernel on CUDA tensors (``use_kernels``), the plain version on
    CPU tensors. Being an op, it is what a selective-checkpoint policy
    sees (`runtime/activation_checkpointing`: ``attn_residuals`` keeps
    exactly its two outputs, so a recomputed span never launches the
    forward kernel again); a raw ctypes launch would be invisible to
    it."""
    flags = (kbias, seed, dropout_rate)
    if use_kernels and q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, segment_ids, sm_scale, layout,
                                    causal, *flags)
    LAST_DESIGN["fwd"] = "plain"
    return flash_attention_segmented_reference(
        q, k, v, segment_ids, sm_scale, layout, causal, *flags)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, segment_ids, layout, kbias, seed, sm_scale,
                    causal, dropout_rate, use_kernels):
    """The op's shapes for fake tensors (the flops count's pass): out
    [B, S, H, D] in q's dtype, lse [B·H, S] fp32."""
    B, S, H, D = q.shape
    return (q.new_empty((B, S, H, D)),
            q.new_empty((B * H, S), dtype=torch.float32))


class _FlashAttention(torch.autograd.Function):
    """The kernels (CUDA tensors, ``use_kernels``) or the plain versions
    in both directions; segment ids, the layout, the scale and the seed
    take no gradient, the key bias a zero one (it is a mask, as in the
    JAX package). The forward goes through the `flash_fwd` op."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale, layout=None,
                causal=True, use_kernels=True, kbias=None, seed=None,
                dropout_rate=0.0):
        kernels = use_kernels and q.device.type == "cuda"
        out, lse = flash_fwd(q, k, v, segment_ids, layout, kbias, seed,
                             sm_scale, causal, float(dropout_rate),
                             bool(use_kernels))
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, layout, kbias,
                              seed)
        ctx.args = (sm_scale, causal, kernels, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids, layout, kbias, seed = \
            ctx.saved_tensors
        sm_scale, causal, kernels, dropout_rate = ctx.args
        flags = (kbias, seed, dropout_rate)
        if kernels:
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, lse, do, attention_delta(out, do), segment_ids,
                sm_scale, layout, causal, *flags)
        else:
            LAST_DESIGN["bwd"] = "plain"
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, do, segment_ids, sm_scale, layout, causal,
                *flags)
        dkbias = torch.zeros_like(kbias) if ctx.needs_input_grad[8] else None
        return dq, dk, dv, None, None, None, None, None, dkbias, None, None


def flash_attention_segmented(q, k, v, segment_ids=None, sm_scale=None,
                              causal=True, use_kernels=True):
    """Causal (or, with ``causal=False``, bidirectional) attention on
    [B, S, H, D], intra-segment with ``segment_ids`` [B, S] (pad id 0
    attends to pad, as in the JAX package) → out, differentiable in q,
    k, v: the CUDA kernels for CUDA tensors (``use_kernels``), the plain
    versions for CPU tensors. The non-causal form is BERT's packed
    encoder attention (the JAX layer's `flash_attention_segmented(...,
    causal=False)`)."""
    _check(q, k, v, segment_ids)
    _check_device(q)
    return _FlashAttention.apply(q, k, v, segment_ids, sm_scale, None,
                                 bool(causal), use_kernels, None, None, 0.0)


def _check_device(q):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention path for device {q.device}")


def flash_attention_kbias(q, k, v, kbias, causal=False, sm_scale=None,
                          use_kernels=True):
    """Flash attention with an additive per-key bias (the JAX package's
    `flash_attention_kbias`): ``kbias`` [B, S] (0 keeps a key, -1e30
    masks it; finite values act as biases) is added to every query row's
    scores after the scale. A row whose keys are all masked gives zeros
    and zero gradients. Differentiable in q, k, v; the bias gets a zero
    gradient. The CUDA kernels for CUDA tensors (``use_kernels``), the
    plain versions for CPU tensors."""
    _check(q, k, v, None)
    _check_device(q)
    _check_kbias(q, kbias)
    return _FlashAttention.apply(q, k, v, None, sm_scale, None, causal,
                                 use_kernels, kbias, None, 0.0)


def flash_attention_train(q, k, v, kbias, seed, causal=False,
                          sm_scale=None, dropout_rate=0.0, use_kernels=True):
    """Training-mode flash attention (the JAX package's
    `flash_attention_train`): the optional per-key bias of
    `flash_attention_kbias` and dropout on the probabilities, by the
    keep-mask `dropout_keep` at ``seed`` (an int32 [1] tensor on q's
    device: the backward regenerates the forward's mask from it). The
    softmax sum counts the undropped probabilities and a kept one is
    scaled by 1 / (1 − rate). ``dropout_rate`` outside [0, 1) raises."""
    check_dropout_rate(dropout_rate)
    _check(q, k, v, None)
    _check_device(q)
    _check_kbias(q, kbias)
    return _FlashAttention.apply(q, k, v, None, sm_scale, None, causal,
                                 use_kernels, kbias, seed,
                                 float(dropout_rate))


def make_masked_flash_attention(layout128, causal=False, sm_scale=None):
    """Flash attention honoring a static 128-grain block layout (the JAX
    package's `make_masked_flash_attention`, the high-density arm of
    `SparseSelfAttention`): the exact block-sparse pattern semantics,
    with the kernels skipping the tiles of inactive blocks.

    layout128: [H, S/128, S/128] numpy bool/int block-activity mask.
    Returns fn(q, k, v, use_kernels=True) on [B, S, H, D], differentiable
    in q, k, v: the CUDA kernels for CUDA tensors, the plain versions for
    CPU tensors or with ``use_kernels=False``."""
    # numpy until a call puts it on its device (a tensor made here under
    # the flops count's FakeTensorMode would be a fake one)
    layout = (np.asarray(layout128) != 0).astype(np.int32)
    on_device = {}

    def fn(q, k, v, use_kernels=True):
        h, s = q.shape[2], q.shape[1]
        if h != layout.shape[0]:
            raise ValueError(
                f"got {h} heads, layout has {layout.shape[0]}")
        if s != layout.shape[1] * MASK_GRAIN:
            raise ValueError(
                f"got seq {s}, layout covers "
                f"{layout.shape[1] * MASK_GRAIN}")
        _check(q, k, v, None)
        _check_device(q)
        lay = _build.device_cached(on_device, str(q.device),
                                   lambda: torch.as_tensor(
                                       layout, device=q.device))
        return _FlashAttention.apply(q, k, v, None, sm_scale, lay, causal,
                                     use_kernels, None, None, 0.0)

    fn.layout = layout
    fn.causal = causal
    return fn
