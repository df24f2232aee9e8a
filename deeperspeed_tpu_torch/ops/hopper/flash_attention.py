"""Segmented causal flash-attention forward: the CUDA kernel and its plain
version.

Replaces `_fwd_kernel` of `deeperspeed_tpu/ops/pallas/flash_attention.py`
as `flash_attention_segmented` reaches it (`_fwd` with ``seg``). The
kernel is `csrc/flash_fwd.cu`; its header says what bounds it on the
H100 and what the design does about that.

Contract (the JAX package's):

- q, k, v ``[B, S, H, D]`` in, out ``[B, S, H, D]`` in q's dtype; lse
  ``[B·H, S]`` fp32 (the JAX package's ``[B·H, 1, S]`` residual,
  squeezed);
- causal, with ``segment_ids`` ``[B, S]`` int (optional) ANDed into the
  mask; masked scores are -1e30;
- a row with no live key gives zero output and lse = +1e30;
- ``sm_scale`` defaults to 1/√D.

`flash_attention_segmented` launches the kernel on CUDA tensors and
takes `flash_attention_segmented_reference` only for CPU tensors; an
unsupported dtype or head dim on a CUDA tensor raises. Unlike the JAX
package, which sends a sequence that no 128-multiple block divides (S =
64 among the serving buckets) to its XLA fallback, every length goes
through the kernel here.
"""

import math

import torch

from . import _build

NEG_INF = -1e30

# kernel launches since the last reset (`chip_smoke.py` reads this)
launches = 0


def flash_attention_segmented_reference(q, k, v, segment_ids=None,
                                        sm_scale=None):
    """Plain PyTorch version: `causal_attention`'s XLA branch
    (`gpt_neox.py:355-364`) plus the lse, on any device. Returns
    (out [B, S, H, D] in v's dtype, lse [B·H, S] fp32)."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
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


def flash_attention_cuda(q, k, v, segment_ids=None, sm_scale=None):
    """Launch `csrc/flash_fwd.cu` on CUDA tensors → (out, lse)."""
    global launches
    B, S, H, D = q.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash prefill kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"flash prefill kernel takes head_dim in "
                         f"{_build.HEAD_DIMS}, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash prefill kernel needs the head dim of q, k, "
                         "v contiguous (stride 1)")
    if B * H > 65535 or S < 1:
        raise ValueError(f"flash prefill kernel grid: B·H = {B * H} must "
                         f"be <= 65535 and S = {S} >= 1")
    seg = None
    if segment_ids is not None:
        if segment_ids.device != q.device:
            raise ValueError("segment_ids must be on q's device")
        seg = segment_ids.to(torch.int32).contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None,
        out.data_ptr(), lse.data_ptr(), B, S, H, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(err, "ds_flash_fwd")
    launches += 1
    return out, lse


def flash_attention_segmented(q, k, v, segment_ids=None, sm_scale=None):
    """Causal (optionally segmented) attention on [B, S, H, D] → out: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v, segment_ids)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, segment_ids, sm_scale)[0]
    if q.device.type == "cpu":
        return flash_attention_segmented_reference(q, k, v, segment_ids,
                                                   sm_scale)[0]
    raise ValueError(f"no flash prefill path for device {q.device}")
