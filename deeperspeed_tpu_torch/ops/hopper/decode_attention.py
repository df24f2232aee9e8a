"""Paged decode attention: the CUDA kernels and their plain version.

Replaces `_decode_kernel` and `_decode_kernel_quant` of
`deeperspeed_tpu/ops/pallas/decode_attention.py`. The kernels are
`csrc/paged_decode.cu` (`ds_paged_decode` over bf16/fp32 pools,
`ds_paged_decode_int8` over int8 pools); its header says what bounds
them on the H100 and what the designs do about that. Two designs:
"cluster" (bf16, fp16 and int8 pools at head dims 64 and 128: the KV
pages of a (sequence, head) split over a thread-block cluster of
`launch_plan` CTAs, merged in rank order in shared memory) and "single" (fp32 pools
and head dim 256: one block a (sequence, head)).

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
tensors; "xla" always takes the plain version. With None/"auto" a CUDA
call on a shape the kernels cannot take (`paged_decode_supported`: head
dim 64, 128 or 256, page size a multiple of 8) takes the plain version
too, decided from the shapes before any launch, as the JAX package sends
such shapes to its XLA path; it is counted under the design "plain".
"pallas" forces the kernel, which raises on such a shape.
"""

import math

import torch

from . import _build

NEG_INF = -1e30

# the cluster design's reach, its largest (portable) cluster, and one
# wave of it on the H100: 132 SMs holding 6 CTAs each (the bf16 D = 64
# kernel's occupancy, bounded by its shared memory)
CLUSTER_HEAD_DIMS = (64, 128)
CLUSTER_POOL_DTYPES = (torch.bfloat16, torch.float16, torch.int8)
# the q dtypes the int8-pool kernels are built for (the scales stay bf16)
INT8_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_CLUSTER = 8
SMS, CTAS_PER_SM = 132, 6
# "plain": a CUDA call the shape dispatch sent to the plain version
DESIGNS = ("cluster", "single", "plain")

# kernel launches since the last reset (`chip_smoke.py` reads these):
# the bf16/fp32-pool kernel and the int8-pool kernel, all and by design
# (the "plain" entries count CUDA calls of unsupported shapes, which
# launch nothing)
launches = 0
launches_int8 = 0
launches_by_design = dict.fromkeys(DESIGNS, 0)
launches_by_design_int8 = dict.fromkeys(DESIGNS, 0)


# the design the wrapper last ran ("cluster", "single" or "plain");
# `ops.dispatch_report` reads it
LAST_DESIGN = {}


def reset_launches_by_design():
    launches_by_design.update(dict.fromkeys(DESIGNS, 0))
    launches_by_design_int8.update(dict.fromkeys(DESIGNS, 0))


def paged_decode_supported(head_dim, page_size):
    """The shapes the kernels take under ``backend`` None/"auto": a head
    dim they are built for (the JAX package's on-TPU head dims) and whole
    8-key chunks a page, for bf16, fp32 and int8 pools alike. The JAX
    rule also asks 32 slots a page of int8 pools (one int8 sublane tile
    on a TPU); the CUDA kernel has no such rule, so int8 pools at page
    sizes 8-24 launch it here where the JAX package takes its XLA path."""
    return head_dim in _build.HEAD_DIMS and page_size % 8 == 0


def decode_route(device_type, head_dim, page_size, backend):
    """Where a call goes: "kernel", "plain" (CPU tensors or ``backend``
    "xla") or "unsupported" (CUDA tensors of a shape
    `paged_decode_supported` refuses under None/"auto": the plain
    version, counted as the "plain" design)."""
    if backend not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"unknown paged decode backend {backend!r}")
    if backend == "xla" or device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"no paged decode path for device {device_type}")
    if backend != "pallas" and not paged_decode_supported(head_dim,
                                                          page_size):
        return "unsupported"
    return "kernel"


def kernel_design(q, k_pages):
    """The design a launch takes: "cluster" for bf16, fp16 and int8 pools
    at head dims 64 and 128, else "single"."""
    if k_pages.dtype in CLUSTER_POOL_DTYPES and \
            q.shape[2] in CLUSTER_HEAD_DIMS:
        return "cluster"
    return "single"


def launch_plan(B, H, n_pages_row):
    """The cluster kernel's CTAs a (sequence, head): ``min(8,
    n_pages_row)`` (at least 1), halved while the grid of ``B·H·C`` CTAs
    would not fit one wave of the card. From the shapes alone, never from
    the lengths, so one launch serves any lengths (and a CUDA graph)."""
    cluster = max(1, min(MAX_CLUSTER, n_pages_row))
    while cluster > 1 and B * H * cluster > SMS * CTAS_PER_SM:
        cluster = -(-cluster // 2)
    return cluster


def paged_attention_reference(q, k_pages, v_pages, page_table, qpos,
                              sm_scale=None, k_scales=None, v_scales=None):
    """Plain paged attention over a window of queries (the JAX package's
    `paged_decode_attention_xla`, and its serving engine's chunk
    ``attend``): gather each sequence's pages into a contiguous
    [B, H, NP·ps, D] view; query ``s`` of row ``b`` (``q`` [B, S, H, D])
    sees slots ``0..qpos[b, s]`` (-1: none, an exact zero row) →
    [B, S, H, D] fp32. int8 pools dequantize at the gather. Scores and
    P·V sum in fp32; the probabilities round to the pool dtype (fp32 for
    int8 pools) before P·V."""
    B, S, H, D = q.shape
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
    s = torch.einsum("bshd,bhkd->bhsk", q.float(), k.float()) * scale
    kpos = torch.arange(NP * ps, device=q.device)
    mask = kpos[None, None, None, :] <= qpos.long()[:, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum("bhsk,bhkd->bshd", (p / l_safe).to(v.dtype).float(),
                        v.float())


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, sm_scale=None, k_scales=None,
                                     v_scales=None):
    """Plain PyTorch version of the decode: `paged_attention_reference`
    with one query a row, at position ``lengths - 1`` → [B, H, D] in q's
    dtype."""
    qpos = (lengths.long() - 1)[:, None]
    return paged_attention_reference(
        q[:, None], k_pages, v_pages, page_table, qpos, sm_scale,
        k_scales=k_scales, v_scales=v_scales)[:, 0].to(q.dtype)


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


def _check_cluster_layout(k_pages, v_pages, k_scales=None,
                          v_scales=None):
    """What the cluster kernel's 16-byte tile loads need: a (page, head)
    of each pool one contiguous page_size x D block (slot stride == D),
    16-byte aligned pools, page and head strides; for int8 pools the
    same of the scale pools' (page, head) rows."""
    D = k_pages.shape[3]
    if k_pages.stride(2) != D:
        raise ValueError(f"the cluster paged-decode kernel reads a (page, "
                         f"head) as one contiguous tile: it needs the slot "
                         f"stride == head_dim ({D}), got {k_pages.stride(2)}")
    pools = [k_pages, v_pages]
    if k_scales is not None:
        pools += [k_scales, v_scales]
    for t in pools:
        es = t.element_size()
        if t.data_ptr() % 16 or (t.stride(0) * es) % 16 or \
                (t.stride(1) * es) % 16:
            raise ValueError(
                f"the cluster paged-decode kernel reads 16-byte chunks: it "
                f"needs 16-byte aligned pools and scale pools with page "
                f"and head strides a multiple of 16 bytes, got a "
                f"{t.dtype} pool with strides {tuple(t.stride())}")


def launch_kernel(q, k_pages, v_pages, page_table, lengths, sm_scale,
                  cluster, k_scales=None, v_scales=None):
    """One launch of `ds_paged_decode` (with scales: `ds_paged_decode_int8`)
    on arguments the wrappers have checked, with ``cluster`` CTAs a
    (sequence, head) (0: the single-block kernel) → [B, H, D] in q's
    dtype. Counts nothing: the wrappers count their launches."""
    B, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    scale_args = ()
    name = "ds_paged_decode"
    if k_scales is not None:
        name = "ds_paged_decode_int8"
        scale_args = (k_scales.data_ptr(), v_scales.data_ptr(),
                      k_scales.stride(0), k_scales.stride(1))
    err = getattr(_build.load_library(), name)(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        *scale_args, page_table.data_ptr(), page_table.stride(0),
        lengths.data_ptr(), out.data_ptr(), B, H, D, k_pages.shape[2],
        page_table.shape[1], float(scale), cluster,
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(err, name)
    return out


def paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                      sm_scale=None):
    """Launch `ds_paged_decode` (`csrc/paged_decode.cu`) on CUDA tensors
    → [B, H, D]: the cluster kernel for bf16 and fp16 pools at head dims
    64 and 128, the single-block kernel for fp32 pools and head dim 256."""
    global launches
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged decode kernel takes float32, bfloat16 or "
                        f"float16 q and pools of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    _check_kernel_args(q, k_pages, v_pages, page_table, lengths)
    design = kernel_design(q, k_pages)
    if design == "cluster":
        _check_cluster_layout(k_pages, v_pages)
    cluster = launch_plan(*q.shape[:2], page_table.shape[1]) \
        if design == "cluster" else 0
    out = launch_kernel(q, k_pages, v_pages, page_table, lengths, sm_scale,
                        cluster)
    LAST_DESIGN["decode"] = design
    if q.shape[0]:
        launches += 1
        launches_by_design[design] += 1
    return out


def paged_decode_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                           page_table, lengths, sm_scale=None):
    """Launch `ds_paged_decode_int8` (`csrc/paged_decode.cu`) on CUDA
    tensors: int8 pools with bf16 per-slot scales → [B, H, D] in q's
    dtype; the cluster kernel at head dims 64 and 128, the single-block
    kernel at 256."""
    global launches_int8
    if q.dtype not in INT8_Q_DTYPES or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8:
        raise TypeError(f"int8 paged decode kernel takes float32, "
                        f"bfloat16 or float16 q and int8 pools, got "
                        f"{q.dtype}, "
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
    design = kernel_design(q, k_pages)
    if design == "cluster":
        _check_cluster_layout(k_pages, v_pages, k_scales, v_scales)
    cluster = launch_plan(*q.shape[:2], page_table.shape[1]) \
        if design == "cluster" else 0
    out = launch_kernel(q, k_pages, v_pages, page_table, lengths, sm_scale,
                        cluster, k_scales, v_scales)
    LAST_DESIGN["decode"] = design
    if q.shape[0]:
        launches_int8 += 1
        launches_by_design_int8[design] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           sm_scale=None, backend=None, k_scales=None,
                           v_scales=None):
    """One decode step of paged attention: ``out[b, h] = softmax(q[b, h]
    · K[b]) · V[b]`` with K/V read through ``page_table[b]`` and masked
    at ``lengths[b]``. ``k_scales``/``v_scales`` [P, H, page_size] mark
    int8 pools: the kernels fold the scales into the scores and the
    probabilities (the single-block kernel dequantizes each element), the
    plain version dequantizes at the gather."""
    _check(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    quant = k_scales is not None
    route = decode_route(q.device.type, q.shape[2], k_pages.shape[2],
                         backend)
    LAST_DESIGN["decode_kv"] = "int8" if quant else str(k_pages.dtype)
    if route != "kernel":
        LAST_DESIGN["decode"] = "plain"
        if route == "unsupported":
            (launches_by_design_int8 if quant
             else launches_by_design)["plain"] += 1
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    if quant:
        return paged_decode_int8_cuda(q, k_pages, v_pages, k_scales,
                                      v_scales, page_table, lengths,
                                      sm_scale)
    return paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                             sm_scale)
