"""Paged decode attention: the CUDA kernel and its plain version.

Replaces `_decode_kernel` of
`deeperspeed_tpu/ops/pallas/decode_attention.py`. The kernel is
`csrc/paged_decode.cu`; its header says what bounds it on the H100 and
what the design does about that.

Contract (the JAX package's):

- ``q`` [B, H, D]: one query row per sequence;
- ``k_pages``/``v_pages`` [P, H, page_size, D]: one layer's pools (the
  engine passes the per-layer view of its [L, P, H, ps, D] pool; the
  kernel reads it through its strides, without a copy);
- ``page_table`` [B, NP] int32: page ids in position order; entries
  past a sequence's live pages are don't-care (the trash page 0);
- ``lengths`` [B] int32: tokens valid for attention, including the one
  being decoded; a length of 0 gives exact zeros.

``backend`` maps from ``inference.kernel``: None/"auto" and "pallas"
launch the kernel on CUDA tensors and take the plain version on CPU
tensors; "xla" always takes the plain version. The int8 pools of
``kv_cache_dtype: "int8"`` (the TPU's `_decode_kernel_quant`) are not
ported yet.
"""

import math

import torch

from . import _build

NEG_INF = -1e30

# kernel launches since the last reset (`chip_smoke.py` reads this)
launches = 0


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, sm_scale=None):
    """Plain PyTorch version (`paged_decode_attention_xla`): gather the
    sequence's pages into a contiguous [B, H, NP·ps, D] view and run a
    masked softmax."""
    B, H, D = q.shape
    ps = k_pages.shape[2]
    NP = page_table.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].movedim(2, 1).reshape(B, H, NP * ps, D)
    v = v_pages[pt].movedim(2, 1).reshape(B, H, NP * ps, D)
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


def _check(q, k_pages, v_pages, page_table, lengths):
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


def paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                      sm_scale=None):
    """Launch `csrc/paged_decode.cu` on CUDA tensors → [B, H, D]."""
    global launches
    B, H, D = q.shape
    ps = k_pages.shape[2]
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16 "
                        f"q and pools of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_build.HEAD_DIMS}, got {D}")
    if ps % 8:
        raise ValueError(f"paged decode kernel needs page_size % 8 == 0, "
                         f"got {ps}")
    if k_pages.stride() != v_pages.stride():
        raise ValueError("k_pages and v_pages must share one layout")
    if q.stride(2) != 1 or k_pages.stride(3) != 1:
        raise ValueError("paged decode kernel needs the head dim of q and "
                         "the pools contiguous (stride 1)")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device or t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on {q.device}, got "
                            f"{t.dtype} on {t.device}")
    if page_table.stride(1) != 1 or lengths.stride(0) != 1:
        raise ValueError("page_table rows and lengths must be contiguous")
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


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           sm_scale=None, backend=None):
    """One decode step of paged attention: ``out[b, h] = softmax(q[b, h]
    · K[b]) · V[b]`` with K/V read through ``page_table[b]`` and masked
    at ``lengths[b]``."""
    _check(q, k_pages, v_pages, page_table, lengths)
    if backend not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"unknown paged decode backend {backend!r}")
    if backend == "xla" or q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages,
                                                page_table, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode path for device {q.device}")
    return paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                             sm_scale)
