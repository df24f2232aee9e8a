"""Paged decode attention: the CUDA kernels and their plain version.

Replaces `_decode_kernel` and `_decode_kernel_quant` of
`deeperspeed_tpu/ops/pallas/decode_attention.py`. The kernels are
`csrc/paged_decode.cu` (`ds_paged_decode` over bf16/fp32 pools,
`ds_paged_decode_int8` over int8 pools); its header says what bounds
them on the H100 and what the design does about that.

Contract (the JAX package's):

- ``q`` [B, H, D]: one query row per sequence;
- ``k_pages``/``v_pages`` [P, H, page_size, D]: one layer's pools (the
  engine passes the per-layer view of its [L, P, H, ps, D] pool; the
  kernel reads it through its strides, without a copy);
- ``page_table`` [B, NP] int32: page ids in position order; entries
  past a sequence's live pages are don't-care (the trash page 0);
- ``lengths`` [B] int32: tokens valid for attention, including the one
  being decoded; a length of 0 gives exact zeros;
- ``k_scales``/``v_scales`` [P, H, page_size] bf16 mark int8 pools
  (``kv_cache_dtype: "int8"``, `inference.kv_cache.QuantizedPages`):
  each K/V element is ``float(q) · float(scale[slot])``, q is widened to
  fp32 and the output is in q's dtype.

``backend`` maps from ``inference.kernel``: None/"auto" and "pallas"
launch the kernel on CUDA tensors and take the plain version on CPU
tensors; "xla" always takes the plain version.
"""

import math

import torch

from . import _build

NEG_INF = -1e30

# kernel launches since the last reset (`chip_smoke.py` reads these):
# the bf16/fp32-pool kernel and the int8-pool kernel
launches = 0
launches_int8 = 0


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, sm_scale=None, k_scales=None,
                                     v_scales=None):
    """Plain PyTorch version (`paged_decode_attention_xla`): gather the
    sequence's pages into a contiguous [B, H, NP·ps, D] view and run a
    masked softmax. int8 pools dequantize at the gather, and their
    probabilities stay fp32 through P·V."""
    B, H, D = q.shape
    ps = k_pages.shape[2]
    NP = page_table.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].movedim(2, 1).reshape(B, H, NP * ps, D)
    v = v_pages[pt].movedim(2, 1).reshape(B, H, NP * ps, D)
    if k_scales is not None:
        ks = k_scales[pt].movedim(2, 1).reshape(B, H, NP * ps)
        vs = v_scales[pt].movedim(2, 1).reshape(B, H, NP * ps)
        k = k.float() * ks.float()[..., None]
        v = v.float() * vs.float()[..., None]
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    pos = torch.arange(NP * ps, device=q.device)
    s = torch.where(pos[None, None, :] < lengths[:, None, None].to(pos.dtype),
                    s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhs,bhsd->bhd", (p / l_safe).to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales):
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    B, H, D = q.shape
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if k_pages.dim() != 4:
        raise ValueError(f"k_pages must be [P, H, page_size, D], got "
                         f"{tuple(k_pages.shape)}")
    _, Hk, _, Dk = k_pages.shape
    if (Hk, Dk) != (H, D):
        raise ValueError(f"cache heads/dim {(Hk, Dk)} != query {(H, D)}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table shape {tuple(page_table.shape)} must "
                         f"be [{B}, n_pages]")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    P, Hk, ps, _ = k_pages.shape
    if k_scales is not None and (
            tuple(k_scales.shape) != (P, Hk, ps) or v_scales is None or
            tuple(v_scales.shape) != (P, Hk, ps)):
        raise ValueError(
            f"int8 pool scales must both be [{P}, {Hk}, {ps}]; got "
            f"{_shape(k_scales)} / {_shape(v_scales)}")


def _shape(t):
    return None if t is None else tuple(t.shape)


def _check_kernel_args(q, k_pages, v_pages, page_table, lengths):
    """What both kernels take beyond `_check`: int32 page tables and
    lengths on q's device, a head dim they are built for, whole 8-key
    chunks a page, contiguous head dims and one pool layout."""
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device or t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on {q.device}, got "
                            f"{t.dtype} on {t.device}")
    if page_table.stride(1) != 1 or lengths.stride(0) != 1:
        raise ValueError("page_table rows and lengths must be contiguous")
    D = q.shape[2]
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_build.HEAD_DIMS}, got {D}")
    if k_pages.shape[2] % 8:
        raise ValueError(f"paged decode kernel needs page_size % 8 == 0, "
                         f"got {k_pages.shape[2]}")
    if k_pages.stride() != v_pages.stride():
        raise ValueError("k_pages and v_pages must share one layout")
    if q.stride(2) != 1 or k_pages.stride(3) != 1:
        raise ValueError("paged decode kernel needs the head dim of q and "
                         "the pools contiguous (stride 1)")


def paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                      sm_scale=None):
    """Launch `ds_paged_decode` (`csrc/paged_decode.cu`) on CUDA tensors
    → [B, H, D]."""
    global launches
    B, H, D = q.shape
    ps = k_pages.shape[2]
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16 "
                        f"q and pools of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    _check_kernel_args(q, k_pages, v_pages, page_table, lengths)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _build.load_library()
    err = lib.ds_paged_decode(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        page_table.data_ptr(), page_table.stride(0), lengths.data_ptr(),
        out.data_ptr(), B, H, D, ps, page_table.shape[1], float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(err, "ds_paged_decode")
    launches += 1
    return out


def paged_decode_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                           page_table, lengths, sm_scale=None):
    """Launch `ds_paged_decode_int8` (`csrc/paged_decode.cu`) on CUDA
    tensors: int8 pools with bf16 per-slot scales → [B, H, D] in q's
    dtype."""
    global launches_int8
    B, H, D = q.shape
    ps = k_pages.shape[2]
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8:
        raise TypeError(f"int8 paged decode kernel takes float32 or "
                        f"bfloat16 q and int8 pools, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if k_scales.dtype != torch.bfloat16 or v_scales.dtype != torch.bfloat16:
        raise TypeError(f"int8 paged decode kernel takes bfloat16 scales, "
                        f"got {k_scales.dtype}, {v_scales.dtype}")
    _check_kernel_args(q, k_pages, v_pages, page_table, lengths)
    if k_scales.stride() != v_scales.stride() or k_scales.stride(2) != 1:
        raise ValueError("k_scales and v_scales must share one layout with "
                         "the slot dim contiguous (stride 1)")
    for name, t in (("k_pages", k_pages), ("k_scales", k_scales),
                    ("v_scales", v_scales)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _build.load_library()
    err = lib.ds_paged_decode_int8(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        k_scales.data_ptr(), v_scales.data_ptr(),
        k_scales.stride(0), k_scales.stride(1),
        page_table.data_ptr(), page_table.stride(0), lengths.data_ptr(),
        out.data_ptr(), B, H, D, ps, page_table.shape[1], float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(err, "ds_paged_decode_int8")
    launches_int8 += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           sm_scale=None, backend=None, k_scales=None,
                           v_scales=None):
    """One decode step of paged attention: ``out[b, h] = softmax(q[b, h]
    · K[b]) · V[b]`` with K/V read through ``page_table[b]`` and masked
    at ``lengths[b]``. ``k_scales``/``v_scales`` [P, H, page_size] mark
    int8 pools: the kernel dequantizes each element after its load, the
    plain version at the gather."""
    _check(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    if backend not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"unknown paged decode backend {backend!r}")
    if backend == "xla" or q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode path for device {q.device}")
    if k_scales is not None:
        return paged_decode_int8_cuda(q, k_pages, v_pages, k_scales,
                                      v_scales, page_table, lengths,
                                      sm_scale)
    return paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                             sm_scale)
