"""Grouped (ragged) expert matmul: the CUDA kernels and their plain
version.

Replaces the TPU kernels of `deeperspeed_tpu/ops/pallas/grouped_matmul.py`:
`_fwd_kernel` (via `_gmm_pallas`, which also computes dx against w^T) and
`_dw_kernel` (via `_dw_pallas`). The kernels are `csrc/grouped_matmul.cu`;
its header says what bounds them on the H100 and what the design does
about that.

Contract (the JAX package's):

- ``x`` [R, K]: rows grouped into G = R / span contiguous spans of
  ``span`` rows;
- ``w`` [W, K, N]: span g multiplies ``w[lut[g]]``; ``lut`` is a static
  non-decreasing map that covers every weight (identity when G == W);
- ``group_sizes`` [G] int: the live rows of each span. Rows at or past
  the size give exact-zero output, contribute nothing to dW and receive
  zero dx.

`grouped_matmul` is differentiable in x and w: on CUDA tensors a
`torch.autograd.Function` whose forward is the forward kernel and whose
backward is the forward kernel against w read transposed (dx) and the dW
kernel (fp32, cast to w's dtype), as `_gmm_vjp_bwd` does; on CPU tensors
the plain version, differentiated by autograd. The sizes are read on the
device by the kernels: nothing here copies them to the host.
"""

import numpy as np
import torch

from . import _build

DEFAULT_BLOCK_M = 256

# kernel launches since the last reset (`chip_smoke.py` reads these): the
# forward kernel (forward and dx products), the same by design ("wgmma":
# bf16 and fp16, "fma": fp32), and the dW kernel, also by design
launches = 0
DESIGNS = ("wgmma", "fma")
design_launches = dict.fromkeys(DESIGNS, 0)
dw_launches = 0
dw_design_launches = dict.fromkeys(DESIGNS, 0)

# the most weights the 16-bit dW kernel ranks by live rows in one launch
# (`DW_MAX_WEIGHTS` in csrc/grouped_matmul.cu)
DW_MAX_WEIGHTS = 512

# the dtypes that take the wgmma kernels (fp32 takes the FMA ones)
HALF_DTYPES = (torch.bfloat16, torch.float16)


def reset_design_launches():
    design_launches.update(dict.fromkeys(DESIGNS, 0))
    dw_design_launches.update(dict.fromkeys(DESIGNS, 0))

# device int32 copies of the static LUTs, per (lut, device)
_LUT_CACHE = {}


def pick_span(capacity, block_m=None):
    """(span, block_m) for a grouped-matmul buffer: span = capacity
    rounded up to the row-block, preferring fat blocks but never padding
    a span by more than ~12.5%; small capacities degrade to a single
    8-aligned tile per span (a copy of the JAX package's `pick_span`, so
    both packages lay out the same buffer)."""
    cap = max(1, int(capacity))
    target = int(block_m) if block_m else DEFAULT_BLOCK_M
    for cand in (target, target // 2, target // 4):
        if cand >= 8:
            span = -(-cap // cand) * cand
            if span - cap <= max(cap // 8, 7):
                return span, cand
    span = -(-cap // 8) * 8
    return span, span


def _check(x_shape, w_shape, group_sizes, span, lut):
    """The JAX entry's argument checks, with its messages → (G, lut as a
    tuple)."""
    R, K = x_shape
    n_w, kw, _ = w_shape
    if kw != K:
        raise ValueError(f"w contraction dim {kw} != x feature dim {K}")
    if span < 1 or R % span:
        raise ValueError(f"span={span} must divide the {R} buffer rows")
    G = R // span
    lut_t = tuple(range(n_w)) if lut is None else tuple(int(v) for v in lut)
    if len(lut_t) != G:
        raise ValueError(f"lut has {len(lut_t)} entries for {G} spans")
    if any(b > a for a, b in zip(lut_t[1:], lut_t)) or \
            set(lut_t) != set(range(n_w)):
        # every weight must be covered: the dW kernel zeroes only the
        # weights it visits in the JAX package, and the gradient of a
        # skipped weight would be undefined
        raise ValueError("lut must be non-decreasing and cover every "
                         "weight row 0..n_w-1 (spans of one weight "
                         "contiguous, no gaps)")
    if tuple(group_sizes.shape) != (G,):
        raise ValueError(f"group_sizes shape {tuple(group_sizes.shape)} "
                         f"!= ({G},)")
    return G, lut_t


def grouped_matmul_reference(x, w, group_sizes, span, lut=None):
    """Plain PyTorch version (`grouped_matmul_xla`): a batched product in
    fp32 over the spans (spans sharing a weight in a uniform repeat LUT
    collapse into one batch entry; any other LUT gathers per-span
    weights), rows at or past each span's size set to 0, cast to
    ``x.dtype``. Differentiable by autograd: the row mask zeroes dx of
    the dead rows and keeps them out of dW."""
    R, K = x.shape
    n_w, _, N = w.shape
    G = R // span
    lut_arr = np.arange(n_w) if lut is None else np.asarray(lut, np.int64)
    valid = (torch.arange(span, device=x.device)[None, :]
             < group_sizes.to(x.device)[:, None])[..., None]   # [G, span, 1]
    reps = G // n_w
    x32, w32 = x.float(), w.float()
    if n_w * reps == G and np.array_equal(
            lut_arr, np.repeat(np.arange(n_w), reps)):
        y = torch.bmm(x32.reshape(n_w, reps * span, K), w32)
        y = y.reshape(G, span, N)
    else:
        idx = torch.as_tensor(lut_arr, device=w.device)
        y = torch.bmm(x32.reshape(G, span, K), w32[idx])
    return y.masked_fill(~valid, 0.0).to(x.dtype).reshape(R, N)


def grouped_matmul_dw_reference(x, dy, group_sizes, span, lut, n_weights):
    """Plain PyTorch version of the dW kernel (`_dw_pallas`): per weight,
    x^T @ dy over its spans' live rows, in fp32 → [n_weights, K, N]. The
    dead rows of both x and dy are masked, as the kernel never reads them:
    whatever they hold (NaN included) contributes exact zeros. The Pallas
    kernel masks dy's alone, which agrees wherever the dead rows of x are
    finite."""
    R, K = x.shape
    N = dy.shape[1]
    G = R // span
    valid = (torch.arange(span, device=x.device)[None, :]
             < group_sizes.to(x.device)[:, None])[..., None]
    xm = x.float().reshape(G, span, K).masked_fill(~valid, 0.0)
    dym = dy.float().reshape(G, span, N).masked_fill(~valid, 0.0)
    per_span = torch.bmm(xm.transpose(1, 2), dym)
    idx = torch.as_tensor(np.asarray(lut, np.int64), device=x.device)
    return torch.zeros((n_weights, K, N), dtype=torch.float32,
                       device=x.device).index_add_(0, idx, per_span)


def _device_lut(lut_t, device):
    return _build.device_cached(
        _LUT_CACHE, (lut_t, str(device)),
        lambda: torch.tensor(lut_t, dtype=torch.int32, device=device))


def _kernel_sizes(group_sizes, device):
    if group_sizes.device != device:
        raise ValueError(f"group_sizes on {group_sizes.device}, x on "
                         f"{device}")
    return group_sizes.to(torch.int32).contiguous()


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def grouped_matmul_cuda(x, w, group_sizes, span, lut=None, transpose_w=False):
    """Launch the forward kernel of `csrc/grouped_matmul.cu` on CUDA
    tensors → y [R, N] in ``x.dtype``. x [R, K] is read through its row
    stride (K contiguous); w is [W, K, N] contiguous, or with
    ``transpose_w`` the [W, N, K] weight whose transpose is multiplied (dx
    = dy @ w^T, read in place). fp32 takes the FMA kernel; bf16 and fp16
    the wgmma kernel, whose TMA loads read 16-byte chunks: it needs K, N
    and the row stride multiples of 8 and 16-byte aligned tensors;
    anything else raises."""
    global launches
    w_eff = w.transpose(1, 2) if transpose_w else w
    G, lut_t = _check(x.shape, w_eff.shape, group_sizes, span, lut)
    R, K = x.shape
    N = w_eff.shape[2]
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"grouped matmul kernel takes float32, bfloat16 or "
                        f"float16 x and w of one dtype, got {x.dtype}, "
                        f"{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if not w.is_contiguous():
        raise ValueError("grouped matmul kernel needs a contiguous weight")
    if R > 1 and K > 1 and x.stride(1) != 1:
        raise ValueError(f"grouped matmul kernel needs x's contraction dim "
                         f"contiguous, got strides {tuple(x.stride())}")
    ldx = x.stride(0) if R > 1 else K
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if x.dtype in HALF_DTYPES and not (
            K % 8 == 0 and N % 8 == 0 and ldx % 8 == 0 and
            _aligned(x, w, out)):
        raise ValueError(
            f"the 16-bit grouped matmul kernel reads 16-byte chunks: it needs "
            f"K % 8 == 0 (K={K}), N % 8 == 0 (N={N}), a row stride that is "
            f"a multiple of 8 (got {ldx}) and 16-byte aligned x and w")
    tile_m = 128 if x.dtype in HALF_DTYPES else 64
    if G * -(-span // tile_m) > 65535:
        raise ValueError(f"grouped matmul kernel grid: {G} spans of "
                         f"{span} rows exceed 65535 row tiles")
    sizes = _kernel_sizes(group_sizes, x.device)
    lib = _build.load_library()
    err = lib.ds_grouped_matmul(
        x.data_ptr(), ldx, w.data_ptr(), int(transpose_w), sizes.data_ptr(),
        _device_lut(lut_t, x.device).data_ptr(), out.data_ptr(), R, K, N,
        w.shape[0], span, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(err, "ds_grouped_matmul")
    launches += 1
    design_launches["wgmma" if x.dtype in HALF_DTYPES else "fma"] += 1
    return out


def grouped_matmul_dw_cuda(x, dy, group_sizes, span, lut, n_weights):
    """Launch the dW kernel of `csrc/grouped_matmul.cu` on CUDA tensors →
    dw [n_weights, K, N] fp32: per weight, x^T @ dy summed over its spans'
    live rows, zeros for a weight with none. x [R, K] and dy [R, N] are
    made contiguous, in one dtype (fp32: the FMA kernel; bf16 and fp16:
    the wgmma kernel, which needs K and N multiples of 8, 16-byte aligned
    x and dy and at most `DW_MAX_WEIGHTS` weights)."""
    global dw_launches
    R, K = x.shape
    N = dy.shape[1]
    if dy.shape[0] != R:
        raise ValueError(f"dy has {dy.shape[0]} rows, x {R}")
    _, lut_t = _check(x.shape, (n_weights, K, N), group_sizes, span, lut)
    if x.dtype not in _build.DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"grouped matmul dW kernel takes float32, "
                        f"bfloat16 or float16 x and dy of one dtype, got "
                        f"{x.dtype}, {dy.dtype}")
    if dy.device != x.device:
        raise ValueError(f"dy on {dy.device}, x on {x.device}")
    x, dy = x.contiguous(), dy.contiguous()
    dw = torch.empty((n_weights, K, N), dtype=torch.float32, device=x.device)
    if x.dtype in HALF_DTYPES and not (
            K % 8 == 0 and N % 8 == 0 and _aligned(x, dy)):
        raise ValueError(
            f"the 16-bit grouped matmul dW kernel reads 16-byte chunks: it "
            f"needs K % 8 == 0 (K={K}), N % 8 == 0 (N={N}) and 16-byte "
            f"aligned x and dy")
    if x.dtype in HALF_DTYPES and n_weights > DW_MAX_WEIGHTS:
        raise ValueError(f"the 16-bit grouped matmul dW kernel ranks at most "
                         f"{DW_MAX_WEIGHTS} weights, got {n_weights}")
    sizes = _kernel_sizes(group_sizes, x.device)
    lib = _build.load_library()
    err = lib.ds_grouped_matmul_dw(
        x.data_ptr(), dy.data_ptr(), sizes.data_ptr(),
        _device_lut(lut_t, x.device).data_ptr(), dw.data_ptr(), R, K, N,
        span, n_weights, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(err, "ds_grouped_matmul_dw")
    dw_launches += 1
    dw_design_launches["wgmma" if x.dtype in HALF_DTYPES else "fma"] += 1
    return dw


class _GroupedMatmul(torch.autograd.Function):
    """The kernels in both directions (CUDA tensors only); the sizes, the
    span and the LUT take no gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, span, lut_t):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.span, ctx.lut = span, lut_t
        return grouped_matmul_cuda(x, w, group_sizes, span, lut_t)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_cuda(dy, w, group_sizes, ctx.span, ctx.lut,
                                     transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw_cuda(x, dy, group_sizes, ctx.span,
                                        ctx.lut, w.shape[0]).to(w.dtype)
        return dx, dw, None, None, None


def grouped_matmul(x, w, group_sizes, span, lut=None):
    """y[r] = x[r] @ w[lut[r // span]] with ragged tail masking (the JAX
    package's `grouped_matmul`): the kernels for CUDA tensors, the plain
    version for CPU tensors; any other device raises."""
    _, lut_t = _check(x.shape, w.shape, group_sizes, span, lut)
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, group_sizes, span, lut_t)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped matmul path for device {x.device}")
    return _GroupedMatmul.apply(x, w, group_sizes, span, lut_t)
