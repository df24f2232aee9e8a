"""Block-sparse attention over a static 128-grain layout, forward and
backward: the CUDA kernels and their plain versions.

Replaces the TPU kernels of
`deeperspeed_tpu/ops/pallas/block_sparse_attention.py`: the forward
`_sparse_fwd_kernel` (`sparse_attention_fwd`) and the backward
`_sparse_dkv_kernel` / `_sparse_dq_kernel` (`sparse_attention_bwd`),
computed by `csrc/block_sparse_attention.cu`, whose header says what
bounds each kernel on the H100 and what its design does about that.

Contract (the JAX package's):

- q, k, v ``[B, S, H, D]`` in, out ``[B, S, H, D]`` in q's dtype; lse
  ``[B·H, S]`` fp32;
- ``layout`` ``[H, S/128, S/128]`` 0/1: query block i attends key block
  j where it is 1; with ``causal`` a key after its query is masked
  element by element inside every block (it matters on the diagonal);
  masked scores are -1e30;
- a row with no live key (an empty layout row, or every live block
  masked by ``causal``) gives zero output, lse = +1e30 and zero
  gradients;
- ``sm_scale`` defaults to 1/√D;
- the backward takes delta = rowsum(dO ∘ out) as one plain reduction.

The TPU kernels group rows and fan out over key blocks to feed the MXU
(`build_row_union_lut`); the port keeps no such grouping: its LUTs list,
for each 128-row block, the active 128-column blocks (`build_lut`), and
for the dk/dv kernel, over the transposed layout, each key block's query
blocks.

`BlockSparseAttention` is the callable `SparseSelfAttention` builds for
its block-sparse arm; its autograd Function launches the three kernels
on CUDA tensors and takes the plain versions on CPU tensors (or when
called with ``use_kernels=False``). An unsupported dtype or head dim on
a CUDA tensor raises. fp32, bf16 and fp16 are built; in fp16 (the
loss-scaled training path) the kernels and the plain backward round dS
to fp16 before dQ and dK, as the Pallas kernel's ``ds.astype(k.dtype)``
does, so an overflow shows as inf.
"""

import math

import numpy as np
import torch

from . import _build
from . import flash_attention as fa
from .flash_attention import MASK_GRAIN as BLOCK  # the layout grain
from .flash_attention import _acc, _strides, attention_delta
from .flash_attention import _kernel_args as _flash_kernel_args

NEG_INF = -1e30

# the plain versions work on this many bytes of fp32 scores at a time
PLAIN_CHUNK_BYTES = 1 << 29

# kernel launches since the last reset (`chip_smoke.py` reads these), and
# by kernel ("fwd", "dkv", "dq") and design: "mma" (bf16 and fp16 at D =
# 64 and 128, the tensor-core tile steps) or "fma"
launches = 0
dkv_launches = 0
dq_launches = 0
PARTS = ("fwd", "dkv", "dq")
# the part codes of the C entry point `ds_block_sparse_info`
PART_CODES = {part: i for i, part in enumerate(PARTS)}
DESIGNS = ("mma", "fma")
design_launches = {part: dict.fromkeys(DESIGNS, 0) for part in PARTS}


def reset_design_launches():
    for counts in design_launches.values():
        counts.update(dict.fromkeys(DESIGNS, 0))


def _design(q, tensors, what):
    """The design a call on q takes; the tensor-core design loads rows by
    16-byte cp.async, so it refuses ``tensors`` off 16-byte pointers and
    row strides."""
    design = fa.flash_design(q.dtype, q.shape[-1])
    if design == "mma":
        fa.check_alignment(tensors, what)
    return design


def build_lut(layout):
    """[H, nQ, nK] 0/1 layout → (lut [H, nQ, maxA] int32, counts [H, nQ]
    int32, order [nQ] int32): lut[h, i, :counts[h, i]] lists the active
    column blocks of row block i in ascending order, the rest is 0;
    ``order`` lists the row blocks by descending count (the most over
    the heads), so the kernels start the longest rows first. For the
    dk/dv kernel call it with ``layout.transpose(0, 2, 1)``."""
    layout = np.asarray(layout) != 0
    h, n_q, _ = layout.shape
    counts = layout.sum(axis=2).astype(np.int32)
    max_active = max(1, int(counts.max()))
    lut = np.zeros((h, n_q, max_active), np.int32)
    for hi in range(h):
        for qi in range(n_q):
            cols = np.nonzero(layout[hi, qi])[0]
            lut[hi, qi, :len(cols)] = cols
    order = np.argsort(-counts.max(axis=0), kind="stable").astype(np.int32)
    return lut, counts, order


class LayoutLuts:
    """The forward and transposed LUTs of one layout, built once on the
    host; `on(device)` caches their device copies."""

    def __init__(self, layout):
        layout = np.asarray(layout) != 0
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
            raise ValueError(f"layout must be [H, nQ, nQ], got "
                             f"{layout.shape}")
        self.layout = layout
        self.fwd = build_lut(layout)
        self.bwd = build_lut(layout.transpose(0, 2, 1))
        self._dev = {}

    def on(self, device):
        """{"fwd": (lut, counts, order), "bwd": ...} as int32 tensors on
        ``device``, contiguous."""
        return _build.device_cached(self._dev, str(device), lambda: {
            name: tuple(torch.as_tensor(a, device=device).contiguous()
                        for a in luts)
            for name, luts in (("fwd", self.fwd), ("bwd", self.bwd))})


# ---------------------------------------------------------------------------
# plain versions: per active block, in chunks of query blocks
# ---------------------------------------------------------------------------

def _blocks(x, block):
    """[B, S, H, D] → [B, H, S/block, block, D] fp32 (float64 stays)."""
    B, S, H, D = x.shape
    return _acc(x).reshape(B, S // block, block, H, D).permute(0, 3, 1, 2, 4)


def _chunks(B, H, n_q, max_active, block):
    """Query-block ranges whose fp32 scores fit `PLAIN_CHUNK_BYTES`."""
    per_row = B * H * max_active * block * block * 4
    step = max(1, PLAIN_CHUNK_BYTES // per_row)
    return [(r0, min(n_q, r0 + step)) for r0 in range(0, n_q, step)]


def _chunk_scores(qb, kb, lut, counts, r0, r1, causal, scale, block):
    """Scores of query blocks [r0, r1) against their LUT's key blocks →
    (s [B, H, n, blk, A·blk] with masked entries -1e30, live mask, the
    key-block index [H, n·A] the keys came from)."""
    B, H = qb.shape[:2]
    A = lut.shape[-1]
    n = r1 - r0
    lut_c = lut[:, r0:r1]                                  # [H, n, A]
    heads = torch.arange(H, device=qb.device)[:, None]
    idx = lut_c.reshape(H, n * A)
    kg = kb[:, heads, idx].reshape(B, H, n, A * block, -1)
    s = torch.einsum("bhnqd,bhnkd->bhnqk", qb[:, :, r0:r1], kg) * scale
    valid = torch.arange(A, device=qb.device)[None, None] < \
        counts[:, r0:r1, None]                             # [H, n, A]
    live = valid[:, :, None, :, None].expand(H, n, block, A, block)
    if causal:
        rows = (torch.arange(r0, r1, device=qb.device)[:, None] * block +
                torch.arange(block, device=qb.device))      # [n, blk]
        cols = lut_c[..., None] * block + torch.arange(
            block, device=qb.device)                        # [H, n, A, blk]
        live = live & (cols[:, :, None] <= rows[None, :, :, None, None])
    live = live.reshape(H, n, block, A * block)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    return s, live, idx


def _check_layout(q, luts):
    B, S, H, D = q.shape
    n = S // BLOCK
    if S % BLOCK or luts.layout.shape != (H, n, n):
        raise ValueError(f"q of shape {tuple(q.shape)} needs S a multiple "
                         f"of {BLOCK} and a [H, S/128, S/128] = {(H, n, n)} "
                         f"layout, got {luts.layout.shape}")


def block_sparse_attention_reference(q, k, v, luts, causal, sm_scale=None):
    """Plain PyTorch version on any device, per active block: for each
    query block, its LUT's key/value blocks are gathered, scored,
    masked, softmaxed and multiplied by V, a chunk of query blocks at a
    time, so memory scales with the active blocks. Returns (out [B, S,
    H, D] in q's dtype, lse [B·H, S] fp32)."""
    _check_layout(q, luts)
    B, S, H, D = q.shape
    scale = sm_scale or 1.0 / math.sqrt(D)
    lut, counts, _ = luts.on(q.device)["fwd"]
    lut, counts = lut.long(), counts.long()
    qb, kb, vb = (_blocks(t, BLOCK) for t in (q, k, v))
    n_q, A = lut.shape[1], lut.shape[2]
    out = qb.new_empty(qb.shape)
    lse = torch.empty((B, H, n_q, BLOCK), dtype=torch.float32,
                      device=q.device)
    heads = torch.arange(H, device=q.device)[:, None]
    for r0, r1 in _chunks(B, H, n_q, A, BLOCK):
        s, live, idx = _chunk_scores(qb, kb, lut, counts, r0, r1, causal,
                                     scale, BLOCK)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        vg = vb[:, heads, idx].reshape(B, H, r1 - r0, A * BLOCK, D)
        out[:, :, r0:r1] = torch.einsum("bhnqk,bhnkd->bhnqd", p / l_safe, vg)
        lse[:, :, r0:r1] = torch.where(
            l == 0, torch.full_like(l, -NEG_INF), m + torch.log(l_safe))[
                ..., 0].float()
    out = out.permute(0, 2, 3, 1, 4).reshape(B, S, H, D).to(q.dtype)
    return out, lse.reshape(B * H, S)


def block_sparse_attention_bwd_reference(q, k, v, out, lse, do, luts, causal,
                                         sm_scale=None):
    """Plain PyTorch backward from the saved (out, lse), by the explicit
    formulas per active block: P = exp(s·scale − lse) on live pairs, dS =
    P ∘ (dP − delta) · scale, dQ = dS K, and dK = dSᵀ Q, dV = Pᵀ dO added
    into each key block with `index_add` → (dq, dk, dv) [B, S, H, D] in
    q's dtype."""
    _check_layout(q, luts)
    B, S, H, D = q.shape
    scale = sm_scale or 1.0 / math.sqrt(D)
    lut, counts, _ = luts.on(q.device)["fwd"]
    lut, counts = lut.long(), counts.long()
    qb, kb, vb, dob = (_blocks(t, BLOCK) for t in (q, k, v, do))
    n_q, A = lut.shape[1], lut.shape[2]
    lse_b = lse.reshape(B, H, n_q, BLOCK, 1).to(qb.dtype)
    delta = attention_delta(out, do).reshape(B, H, n_q, BLOCK, 1).to(
        qb.dtype)
    dq = torch.empty_like(qb)
    dk = qb.new_zeros((B, H * n_q, BLOCK, D))
    dv = torch.zeros_like(dk)
    heads = torch.arange(H, device=q.device)[:, None]
    for r0, r1 in _chunks(B, H, n_q, A, BLOCK):
        n = r1 - r0
        s, live, idx = _chunk_scores(qb, kb, lut, counts, r0, r1, causal,
                                     scale, BLOCK)
        p = torch.where(live, torch.exp(s - lse_b[:, :, r0:r1]),
                        torch.zeros_like(s))
        kg = kb[:, heads, idx].reshape(B, H, n, A * BLOCK, D)
        vg = vb[:, heads, idx].reshape(B, H, n, A * BLOCK, D)
        dp = torch.einsum("bhnqd,bhnkd->bhnqk", dob[:, :, r0:r1], vg)
        ds = p * (dp - delta[:, :, r0:r1]) * scale
        if q.dtype == torch.float16:
            # the kernels' A operand of dQ and dK: dS rounded to fp16, inf
            # past 65504 (an overflow the loss scaler must see)
            ds = ds.to(torch.float16).to(ds.dtype)
        dq[:, :, r0:r1] = torch.einsum("bhnqk,bhnkd->bhnqd", ds, kg)
        dkg = torch.einsum("bhnqk,bhnqd->bhnkd", ds, qb[:, :, r0:r1])
        dvg = torch.einsum("bhnqk,bhnqd->bhnkd", p, dob[:, :, r0:r1])
        dest = (heads * n_q + idx).reshape(-1)             # [H·n·A]
        dk.index_add_(1, dest, dkg.reshape(B, H * n * A, BLOCK, D))
        dv.index_add_(1, dest, dvg.reshape(B, H * n * A, BLOCK, D))

    def back(x):
        return x.reshape(B, H, n_q, BLOCK, D).permute(0, 2, 3, 1, 4).reshape(
            B, S, H, D).to(q.dtype)

    return back(dq), back(dk), back(dv)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# the dtypes csrc/block_sparse_attention.cu is built for
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _kernel_args(q, k, v, luts, what):
    """Check what the kernels take (fp32, bf16 or fp16; the flash kernels'
    head dims, strides and grid, and the layout) → (dtype code, default
    sm_scale)."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    _check_layout(q, luts)
    _, _, code, default_scale = _flash_kernel_args(q, k, v, None, what)
    return code, default_scale


def _lut_args(luts):
    lut, counts, order = luts
    return (lut.data_ptr(), counts.data_ptr(), order.data_ptr(),
            lut.shape[-1])


def block_sparse_attention_cuda(q, k, v, luts, causal, sm_scale=None):
    """Launch the forward kernel of `csrc/block_sparse_attention.cu` on
    CUDA tensors → (out, lse). bf16 and fp16 at D = 64 and 128 take the
    tensor-core design, whose 16-byte loads need q, k and v on 16-byte
    pointers and row strides."""
    global launches
    B, S, H, D = q.shape
    code, default_scale = _kernel_args(q, k, v, luts, "block-sparse forward")
    scale = sm_scale or default_scale
    dev = luts.on(q.device)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    design = _design(q, (("q", q), ("k", k), ("v", v)),
                     "block-sparse forward")
    lib = _build.load_library()
    err = lib.ds_block_sparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *_lut_args(dev["fwd"]),
        out.data_ptr(), lse.data_ptr(), B, S, H, D, *_strides(q, k, v),
        float(scale), int(bool(causal)), code, _build.stream_ptr(q))
    _build.check(err, "ds_block_sparse_fwd")
    launches += 1
    design_launches["fwd"][design] += 1
    return out, lse


def _bwd_args(q, k, v, lse, do, delta, luts, causal, sm_scale, what):
    """Check the backward's inputs → (the pointer and scalar arguments
    both kernels share, before and after their LUT and outputs)."""
    B, S, H, D = q.shape
    code, default_scale = _kernel_args(q, k, v, luts, what)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B * H, S) or \
                not t.is_contiguous():
            raise ValueError(f"{what} needs {name} as a contiguous [B·H, S] "
                             f"fp32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if do.dtype != q.dtype or tuple(do.shape) != tuple(q.shape) or \
            not do.is_contiguous():
        raise ValueError(f"{what} needs dO contiguous in q's shape and "
                         f"dtype")
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    common = (B, S, H, D, *_strides(q, k, v), float(sm_scale or
                                                    default_scale),
              int(bool(causal)), code, _build.stream_ptr(q))
    return ins, common


def block_sparse_attention_dkv_cuda(q, k, v, lse, do, delta, luts, causal,
                                    sm_scale=None):
    """Launch the dk/dv kernel of `csrc/block_sparse_attention.cu` on CUDA
    tensors → (dk, dv), [B, S, H, D] contiguous in q's dtype. ``do`` is
    contiguous in q's dtype; ``delta`` is `attention_delta` [B·H, S]
    fp32. bf16 and fp16 at D = 64 and 128 take the tensor-core design,
    whose 16-byte loads need q, k, v and dO on 16-byte pointers and row
    strides."""
    global dkv_launches
    ins, common = _bwd_args(q, k, v, lse, do, delta, luts, causal, sm_scale,
                            "block-sparse dk/dv")
    design = _design(q, (("q", q), ("k", k), ("v", v), ("dO", do)),
                     "block-sparse dk/dv")
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _build.load_library().ds_block_sparse_bwd_dkv(
        *ins, *_lut_args(luts.on(q.device)["bwd"]), dk.data_ptr(),
        dv.data_ptr(), *common)
    _build.check(err, "ds_block_sparse_bwd_dkv")
    dkv_launches += 1
    design_launches["dkv"][design] += 1
    return dk, dv


def block_sparse_attention_dq_cuda(q, k, v, lse, do, delta, luts, causal,
                                   sm_scale=None):
    """Launch the dq kernel of `csrc/block_sparse_attention.cu` on CUDA
    tensors → dq [B, S, H, D] contiguous in q's dtype; bf16 and fp16 at D
    = 64 and 128 need the dk/dv kernel's 16-byte alignment."""
    global dq_launches
    ins, common = _bwd_args(q, k, v, lse, do, delta, luts, causal, sm_scale,
                            "block-sparse dq")
    design = _design(q, (("q", q), ("k", k), ("v", v), ("dO", do)),
                     "block-sparse dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.load_library().ds_block_sparse_bwd_dq(
        *ins, *_lut_args(luts.on(q.device)["fwd"]), dq.data_ptr(), *common)
    _build.check(err, "ds_block_sparse_bwd_dq")
    dq_launches += 1
    design_launches["dq"][design] += 1
    return dq


def block_sparse_attention_bwd_cuda(q, k, v, lse, do, delta, luts, causal,
                                    sm_scale=None):
    """Both backward kernels → (dq, dk, dv); ``do`` is made contiguous in
    q's dtype."""
    do = do.to(q.dtype).contiguous()
    dk, dv = block_sparse_attention_dkv_cuda(q, k, v, lse, do, delta, luts,
                                             causal, sm_scale)
    dq = block_sparse_attention_dq_cuda(q, k, v, lse, do, delta, luts,
                                        causal, sm_scale)
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """The kernels (CUDA tensors, ``use_kernels``) or the plain versions
    in both directions."""

    @staticmethod
    def forward(ctx, q, k, v, luts, causal, sm_scale, use_kernels):
        kernels = use_kernels and q.device.type == "cuda"
        if kernels:
            out, lse = block_sparse_attention_cuda(q, k, v, luts, causal,
                                                   sm_scale)
        else:
            out, lse = block_sparse_attention_reference(q, k, v, luts,
                                                        causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (luts, causal, sm_scale, kernels)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        luts, causal, sm_scale, kernels = ctx.args
        if kernels:
            dq, dk, dv = block_sparse_attention_bwd_cuda(
                q, k, v, lse, do, attention_delta(out, do), luts, causal,
                sm_scale)
        else:
            dq, dk, dv = block_sparse_attention_bwd_reference(
                q, k, v, out, lse, do, luts, causal, sm_scale)
        return dq, dk, dv, None, None, None, None


class BlockSparseAttention:
    """Callable bound to one (layout, block, causal) configuration (the
    JAX package's `BlockSparseAttention`): the LUTs are built on the host
    once; calls are differentiable in q, k, v. A ``block`` that is a
    multiple of 128 is refined to the kernels' 128 grain (the same
    pattern); the TPU kernel's ``group`` / ``fanout`` grid geometry has
    no counterpart here."""

    def __init__(self, layout, block=BLOCK, causal=False, sm_scale=None):
        layout = np.asarray(layout)
        if block % BLOCK:
            raise ValueError(f"block {block} must be a multiple of {BLOCK}")
        refine = block // BLOCK
        self.layout = layout
        self.block = block
        self.causal = causal
        self.sm_scale = sm_scale
        self.luts = LayoutLuts(np.repeat(np.repeat(layout, refine, axis=1),
                                         refine, axis=2))

    def __call__(self, q, k, v, use_kernels=True):
        """q/k/v: [B, S, H, D] with H == layout heads, S == layout seq
        (= nQ * block). ``use_kernels=False`` takes the plain versions
        on any device."""
        b, s, h, d = q.shape
        if h != self.layout.shape[0]:
            raise ValueError(
                f"got {h} heads, layout has {self.layout.shape[0]}")
        if s != self.layout.shape[1] * self.block:
            raise ValueError(
                f"seq {s} != layout blocks {self.layout.shape[1]} × block "
                f"{self.block}")
        if k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"q, k, v must share one [B, S, H, D] shape, "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if q.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no block-sparse attention path for device "
                             f"{q.device}")
        return _BlockSparseAttention.apply(q, k, v, self.luts, self.causal,
                                           self.sm_scale, use_kernels)
