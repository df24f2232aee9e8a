"""Segmented causal flash attention, forward and backward: the CUDA
kernels and their plain versions.

Replaces the TPU kernels of `deeperspeed_tpu/ops/pallas/flash_attention.py`
that `flash_attention` / `flash_attention_segmented` reach: the forward
`_fwd_kernel` (tiled, segmented) and `_fwd_single_kernel` /
`_fwd_single_mh_kernel` (one block, S <= 1024) are one function, computed
by `csrc/flash_fwd.cu` at every S; the backward `_bwd_single_kernel` /
`_bwd_single_mh_kernel` and the tiled `_bwd_dkv_kernel` / `_bwd_dq_kernel`
are one function too, computed by `csrc/flash_bwd.cu`. The headers of the
sources say what bounds each kernel on the H100 and what its design does
about that.

Contract (the JAX package's):

- q, k, v ``[B, S, H, D]`` in, out ``[B, S, H, D]`` in q's dtype; lse
  ``[B·H, S]`` fp32 (the JAX package's ``[B·H, 1, S]`` residual,
  squeezed);
- causal, with ``segment_ids`` ``[B, S]`` int (optional) ANDed into the
  mask; masked scores are -1e30;
- a row with no live key gives zero output, lse = +1e30 and zero
  gradients;
- ``sm_scale`` defaults to 1/√D;
- the backward takes delta = rowsum(dO ∘ out) as one plain reduction, as
  the JAX package does (`_bwd`).

`flash_attention_segmented` is a `torch.autograd.Function`: on CUDA
tensors its forward launches the forward kernel and its backward the two
backward kernels; on CPU tensors both directions take the plain
versions. An unsupported dtype or head dim on a CUDA tensor raises.
Unlike the JAX package, which sends a sequence that no 128-multiple
block divides (S = 64 among the serving buckets) to its XLA fallback,
every length goes through the kernels here.
"""

import math

import torch

from . import _build

NEG_INF = -1e30

# kernel launches since the last reset (`chip_smoke.py` reads these)
launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0


def _acc(t):
    """``t`` upcast to fp32 for the plain versions' sums (float64 stays,
    so a gradient check keeps its precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _live_mask(S, segment_ids, device):
    """Causal mask [1 or B, S, S], ANDed with segment equality."""
    mask = torch.ones(S, S, dtype=torch.bool, device=device).tril()[None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    return mask


def flash_attention_segmented_reference(q, k, v, segment_ids=None,
                                        sm_scale=None):
    """Plain PyTorch version: `causal_attention`'s XLA branch
    (`gpt_neox.py:355-364`) plus the lse, on any device. Returns
    (out [B, S, H, D] in v's dtype, lse [B·H, S] fp32)."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale
    mask = _live_mask(S, segment_ids, q.device)
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(logits <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
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


def _kernel_args(q, k, v, segment_ids, what):
    """Check what the kernels take → (int32 segment ids or None, dtype
    code, sm_scale default)."""
    B, S, H, D = q.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
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
    return seg, _build.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D)


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))


def flash_attention_cuda(q, k, v, segment_ids=None, sm_scale=None):
    """Launch `csrc/flash_fwd.cu` on CUDA tensors → (out, lse)."""
    global launches
    B, S, H, D = q.shape
    seg, code, default_scale = _kernel_args(q, k, v, segment_ids,
                                            "flash attention forward")
    scale = sm_scale if sm_scale is not None else default_scale
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None,
        out.data_ptr(), lse.data_ptr(), B, S, H, D, *_strides(q, k, v),
        float(scale), code, _build.stream_ptr(q))
    _build.check(err, "ds_flash_fwd")
    launches += 1
    return out, lse


def attention_delta(out, do):
    """delta = rowsum(dO ∘ out) → [B·H, S] fp32 (`_bwd`'s one plain
    reduction)."""
    B, S, H, _ = out.shape
    delta = (_acc(do) * _acc(out)).sum(dim=-1)            # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, S).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do, segment_ids=None,
                                  sm_scale=None):
    """Plain PyTorch backward from the saved (out, lse), by the explicit
    formulas (no autograd): P = exp(s·scale − lse) on live pairs, dS =
    P ∘ (dP − delta) · scale, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K, every
    sum in fp32 → (dq, dk, dv) [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, kf, vf, dof = _acc(q), _acc(k), _acc(v), _acc(do)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse4 = lse.reshape(B, H, S, 1).to(s.dtype)
    live = _live_mask(S, segment_ids, q.device)[:, None]
    p = torch.where(live, torch.exp(s - lse4), torch.zeros_like(s))
    delta = attention_delta(out, do).reshape(B, H, S, 1).to(s.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_cuda(q, k, v, lse, do, delta, segment_ids=None,
                             sm_scale=None):
    """Launch the two kernels of `csrc/flash_bwd.cu` on CUDA tensors →
    (dq, dk, dv), [B, S, H, D] contiguous in q's dtype. ``do`` is made
    contiguous; ``delta`` is `attention_delta` [B·H, S] fp32."""
    global bwd_dkv_launches, bwd_dq_launches
    B, S, H, D = q.shape
    seg, code, default_scale = _kernel_args(q, k, v, segment_ids,
                                            "flash attention backward")
    scale = sm_scale if sm_scale is not None else default_scale
    do = do.to(q.dtype).contiguous()
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
    common = (B, S, H, D, *_strides(q, k, v), float(scale), code, stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           seg.data_ptr() if seg is not None else None)
    err = lib.ds_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *common)
    _build.check(err, "ds_flash_bwd_dkv")
    bwd_dkv_launches += 1
    err = lib.ds_flash_bwd_dq(*ins, dq.data_ptr(), *common)
    _build.check(err, "ds_flash_bwd_dq")
    bwd_dq_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels (CUDA tensors) or the plain versions (CPU tensors) in
    both directions; segment ids and the scale take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale):
        if q.device.type == "cuda":
            out, lse = flash_attention_cuda(q, k, v, segment_ids, sm_scale)
        else:
            out, lse = flash_attention_segmented_reference(
                q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, lse, do, attention_delta(out, do), segment_ids,
                ctx.sm_scale)
        else:
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, do, segment_ids, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_segmented(q, k, v, segment_ids=None, sm_scale=None):
    """Causal (optionally segmented) attention on [B, S, H, D] → out,
    differentiable in q, k, v: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors."""
    _check(q, k, v, segment_ids)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention path for device {q.device}")
    return _FlashAttention.apply(q, k, v, segment_ids, sm_scale)
