"""Weight-only int8 matmul: the CUDA kernel and its plain version.

Replaces `_wq_kernel` of `deeperspeed_tpu/ops/pallas/quant_matmul.py`
(launched by `quant_matmul_pallas`). The kernel is
`csrc/quant_matmul.cu`; its header says what bounds it on the H100 and
what the design does about that.

Serving stores the block matmul weights as int8 with one fp32 scale per
output channel (`QuantizedWeight`, made by `quantize_weight` at load):
``y[m, n] = sum_k x[m, k] · qval[k, n] · scale[n]``, accumulated in
fp32, written in ``x.dtype``. The per-channel scale commutes with the
contraction, so it is applied once to the fp32 sum.

``backend`` is ``inference.kernel``, handed down by the serving engine
through the model's block functions: None/"auto" and "pallas" launch
the kernel on CUDA tensors and take the plain version on CPU tensors;
"xla" always takes the plain version.

Delayed scaling (training; the "quantization.ffn" block): the dense and
grouped FFN matmuls quantize both operands each step with scales taken
from an amax history (`scale_from_history`, `amax_history_update`), as
a fake-quant with a straight-through estimator (`_fake_quant`), so the
backward is the full-precision transpose. The JAX module leaves this
part to XLA (no Pallas kernel), so here it is plain PyTorch: the
fake-quantized operands go to cuBLAS (`scaled_matmul`) or to the
grouped-matmul kernel (`grouped_scaled_operands`) unchanged.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

INT8_QMAX = 127.0
FP8_QMAX = 448.0      # float8_e4m3fn finite max
QUANT_RECIPES = ("int8", "fp8")

# the wgmma kernel's tiles (bf16 and fp16 x): 128 weight columns by a
# token tile (the rows of x, wgmma's N) a CTA, K in tiles of 64
WGMMA_WN, WGMMA_BK = 128, 64
TOKEN_TILES = (16, 32, 64, 128, 256)
# the K range splits over a cluster of up to 8 CTAs while the CTAs fit
# the H100's 132 SMs and each keeps at least 2 K tiles
SMS, MAX_CLUSTER, MIN_K_TILES = 132, 8, 2

# kernel launches since the last reset (`chip_smoke.py` reads these): all
# of them, and by design ("wgmma": the bf16 and fp16 kernel, "fma": fp32)
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
launches = 0
DESIGNS = ("wgmma", "fma")
design_launches = dict.fromkeys(DESIGNS, 0)


# the design the wrapper last ran ("wgmma", "fma" or "plain");
# `ops.dispatch_report` reads it
LAST_DESIGN = {}


def reset_design_launches():
    design_launches.update(dict.fromkeys(DESIGNS, 0))


class QuantizedWeight:
    """Int8 weight at rest + per-output-channel fp32 scales:
    ``dequant = qval.float() * scale[None, :]``. The model's `_wmat`
    dispatches on it."""

    __slots__ = ("qval", "scale")

    def __init__(self, qval, scale):
        self.qval = qval
        self.scale = scale

    def dequant(self, dtype=torch.float32):
        return (self.qval.float() * self.scale[..., None, :]).to(dtype)


def quantize_weight(w, qmax=INT8_QMAX):
    """[K, N] (or [..., K, N]) float weight → `QuantizedWeight` with
    per-output-channel symmetric scales over the contraction dim:
    ``scale[n] = max_k |w[k, n]| / 127`` in fp32, 1 for a zero column;
    the values round half to even, as `jnp.round` does, so the int8
    values and scales are bit-equal to the JAX package's."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / qmax, 1.0)
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -qmax, qmax)
    return QuantizedWeight(q.to(torch.int8), scale)


def quant_matmul_reference(x, qw):
    """Plain PyTorch version (`quant_matmul_xla`): widen the int8 weight,
    contract in fp32, scale the fp32 sum, cast to ``x.dtype``."""
    y = torch.matmul(x.float(), qw.qval.float())
    return (y * qw.scale).to(x.dtype)


def launch_plan(M, N, K):
    """The wgmma kernel's one launch for x [M, K] and an int8 [K, N]:
    ``(tile, cluster, grid)``. ``tile`` is the token tile: the least of
    16, 32, 64 and 128 rows that holds M, and above 128 rows 128 until
    128-row tiles alone would fill the card's SMs, then 256; ``cluster``
    CTAs (1, 2, 4 or 8) split the K tiles of one output tile; ``grid`` is
    the number of CTAs."""
    n_tiles = -(-N // WGMMA_WN)
    tile = next((t for t in TOKEN_TILES[:-1] if M <= t), TOKEN_TILES[-2])
    if n_tiles * -(-M // tile) > SMS:
        tile = TOKEN_TILES[-1]
    tiles = n_tiles * -(-M // tile)
    k_tiles = -(-K // WGMMA_BK)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * 2 * cluster <= SMS
           and k_tiles >= MIN_K_TILES * 2 * cluster):
        cluster *= 2
    return tile, cluster, tiles * cluster


def quant_matmul_cuda(x, qw):
    """Launch `csrc/quant_matmul.cu` on CUDA tensors: x [M, K] (rows
    through a row stride, K contiguous) → [M, N] in ``x.dtype``, one
    launch. fp32 x takes the FMA kernel; bf16 and fp16 x take the wgmma
    kernel with `launch_plan`, whose TMA loads read 16-byte chunks and so
    need K % 8 == 0, N % 16 == 0, a row stride that is a multiple of 8
    and 16-byte aligned x and weight (every GPT-NeoX block matmul meets
    them); anything else raises."""
    global launches
    M, K = x.shape
    N = qw.qval.shape[1]
    if x.dtype not in (torch.float32, *WGMMA_DTYPES):
        raise TypeError(f"quant matmul kernel takes float32, bfloat16 or "
                        f"float16 x, got {x.dtype}")
    q, s = qw.qval, qw.scale
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"quant matmul kernel takes an int8 weight and "
                        f"float32 scales, got {q.dtype}, {s.dtype}")
    if q.device != x.device or s.device != x.device:
        raise ValueError(f"weight on {q.device}/{s.device}, x on "
                         f"{x.device}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("quant matmul kernel needs a contiguous int8 "
                         "weight and scale vector")
    if K > 1 and x.stride(1) != 1:
        raise ValueError(f"quant matmul kernel needs x's contraction dim "
                         f"contiguous, got strides {tuple(x.stride())}")
    ldx = x.stride(0) if M > 1 else K
    wgmma = x.dtype in WGMMA_DTYPES
    if wgmma and not (
            K > 0 and K % 8 == 0 and N % 16 == 0 and ldx % 8 == 0
            and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0):
        raise ValueError(
            f"the {x.dtype} quant matmul kernel reads 16-byte chunks: it "
            f"needs "
            f"K % 8 == 0 (K={K}), N % 16 == 0 (N={N}), a row stride that "
            f"is a multiple of 8 (got {ldx}) and 16-byte aligned x and "
            f"weight")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    design = "wgmma" if wgmma else "fma"
    tile, cluster, _ = launch_plan(M, N, K)
    lib = _build.load_library()
    err = lib.ds_quant_matmul(
        x.data_ptr(), ldx, q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N,
        K, tile, cluster, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(err, "ds_quant_matmul")
    LAST_DESIGN["quant_matmul"] = design
    launches += 1
    design_launches[design] += 1
    return out


def quant_matmul(x, qw, backend=None):
    """``y[m, n] = sum_k x[m, k] · qval[k, n] · scale[n]``: weight-only
    int8 matmul, fp32 accumulate, output in ``x.dtype``. Leading dims of
    ``x`` are flattened and restored."""
    if x.dim() != 2:
        lead = x.shape[:-1]
        y = quant_matmul(x.reshape(-1, x.shape[-1]), qw, backend=backend)
        return y.reshape(*lead, y.shape[-1])
    M, K = x.shape
    Kw, N = qw.qval.shape
    if K != Kw:
        raise ValueError(f"x contraction dim {K} != weight rows {Kw}")
    if tuple(qw.scale.shape) != (N,):
        raise ValueError(f"scale shape {tuple(qw.scale.shape)} != ({N},)")
    if backend not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"unknown quant_matmul backend {backend!r}")
    if backend == "xla" or x.device.type == "cpu":
        LAST_DESIGN["quant_matmul"] = "plain"
        return quant_matmul_reference(x, qw)
    if x.device.type != "cuda":
        raise ValueError(f"no quant matmul path for device {x.device}")
    return quant_matmul_cuda(x, qw)


# ---------------------------------------------------------------------------
# delayed scaling (training): amax history + fake-quant matmul
# ---------------------------------------------------------------------------

def recipe_qmax(recipe):
    if recipe == "int8":
        return INT8_QMAX
    if recipe == "fp8":
        return FP8_QMAX
    raise ValueError(
        f"unknown quantization recipe {recipe!r}; expected one of "
        f"{list(QUANT_RECIPES)}")


def scale_from_history(history, current_amax, qmax, margin=1.0):
    """Delayed-scaling scale: ``margin · max(history) / qmax``, falling
    back to the current step's amax while the history is still all-zero
    (step 0, or a freshly extended state), so the bootstrap step never
    quantizes against a degenerate scale. A 0-d fp32 tensor.

    The constant factor is one fp32 multiplier, ``fp32(margin) ·
    fp32(1 / qmax)``, as XLA compiles the JAX function's ``amax * margin
    / qmax`` (it folds the division by a constant into the multiplier),
    so the scales are the JAX engine's bit for bit; on CUDA a multiply
    by a Python scalar is exact, where a divide by one would take the
    reciprocal anyway."""
    hist_amax = history.max()
    amax = torch.where(hist_amax > 0.0, hist_amax, current_amax)
    amax = torch.clamp(amax, min=1e-12)
    factor = np.float32(margin) * (np.float32(1.0) / np.float32(qmax))
    return amax * float(factor)


def amax_history_update(history, current_amax):
    """Roll the window one step and record the current amax at slot 0
    (a new tensor: the old history stays as it was)."""
    cur = torch.as_tensor(current_amax, dtype=history.dtype,
                          device=history.device).reshape(1)
    return torch.cat([cur, history[:-1]])


def _amax(v):
    """max |v| in fp32, outside the differentiated graph (exact: the
    largest magnitude of v's own dtype)."""
    return v.detach().abs().amax().float()


def _fake_quant(v, scale, recipe):
    """Quantize → dequantize at ``scale`` with a straight-through
    estimator: the forward value is the exact representable
    low-precision value, the backward is identity (the reference
    delayed-scaling recipe runs only the forward GEMM low-precision).
    Divide (not multiply by a reciprocal), round half to even (int8),
    clamp before the float8_e4m3fn cast (e4m3fn has no inf: an
    out-of-range cast is NaN, and a delayed scale is stale by
    construction), then cast to v's dtype; ``v + (dq - v)`` in v's
    dtype, as in JAX."""
    f = v.float() / scale
    if recipe == "int8":
        dq = torch.clamp(torch.round(f), -INT8_QMAX, INT8_QMAX) * scale
    else:
        f = torch.clamp(f, -FP8_QMAX, FP8_QMAX)
        dq = f.to(torch.float8_e4m3fn).float() * scale
    dq = dq.to(v.dtype)
    return v + (dq - v).detach()


def scaled_matmul(x, w, hist_x, hist_w, recipe, margin=1.0):
    """One delayed-scaled matmul: quantize both operands with scales from
    their amax histories, contract x's last dim with w's first (the one
    contraction the JAX function's callers use; its ``dim_numbers`` is
    not carried), and return ``(y, new_hist_x, new_hist_w)``, the
    histories advanced with this step's amaxes (the amax observation is
    outside the differentiated graph). 16-bit operands take cuBLAS's
    16-bit product, which sums in fp32 and rounds once to x's dtype, as
    the JAX ``preferred_element_type=float32`` product cast back does."""
    xq, wq, hx, hw = grouped_scaled_operands(x, w, hist_x, hist_w, recipe,
                                             margin)
    return torch.matmul(xq, wq).to(x.dtype), hx, hw


def grouped_scaled_operands(x, w, hist_x, hist_w, recipe, margin=1.0):
    """Delayed-scaling fake-quant of a grouped-expert-matmul operand
    pair: ``x`` [R, K] (the span-packed token buffer, dead rows
    included in its amax) and ``w`` [E, K, N] (the stacked expert
    weights) quantized against their amax histories, to be fed unchanged
    into `grouped_matmul`. Returns (xq, wq, new_hist_x, new_hist_w);
    `scaled_matmul` quantizes its pair the same way."""
    qmax = recipe_qmax(recipe)
    amax_x, amax_w = _amax(x), _amax(w)
    sx = scale_from_history(hist_x, amax_x, qmax, margin)
    sw = scale_from_history(hist_w, amax_w, qmax, margin)
    return (_fake_quant(x, sx, recipe), _fake_quant(w, sw, recipe),
            amax_history_update(hist_x, amax_x),
            amax_history_update(hist_w, amax_w))


# per-block dense-FFN amax state layout: 4 tensors (ffn-in x/w, ffn-out
# x/w), each with its own history row; `models.gpt_neox` threads one
# [4, history_len] row per layer through the blocks (the MoE sort path
# reuses the layout: in-buf/in-w, out-buf/out-w)
FFN_AMAX_TENSORS = 4


def init_amax_history(num_layers, history_len, n_tensors=FFN_AMAX_TENSORS,
                      device=None):
    """Zero-initialized per-layer amax history: [L, n_tensors, H] fp32."""
    return torch.zeros((int(num_layers), int(n_tensors), int(history_len)),
                       dtype=torch.float32, device=device)


def ffn_scaled_matmuls(x2d, w_in, b_in, w_out, amax_row, recipe,
                       margin=1.0):
    """The dense-FFN pair under delayed scaling: in-proj → gelu (tanh,
    `jax.nn.gelu`'s default, the JAX function's default activation) →
    out-proj, both matmuls quantized against ``amax_row`` [4, H] (rows:
    in-x, in-w, out-x, out-w). Returns (y2d, new_amax_row); the output
    bias is not added (callers fold it after the product, as the plain
    FFN does)."""
    h, hx_in, hw_in = scaled_matmul(x2d, w_in.to(x2d.dtype), amax_row[0],
                                    amax_row[1], recipe, margin)
    h = F.gelu(h + b_in.to(h.dtype), approximate="tanh")
    y, hx_out, hw_out = scaled_matmul(h, w_out.to(h.dtype), amax_row[2],
                                      amax_row[3], recipe, margin)
    return y, torch.stack([hx_in, hw_in, hx_out, hw_out])
