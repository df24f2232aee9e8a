"""Flat Adam(W): the CUDA kernel and its plain version.

Replaces `_adam_kernel` of `deeperspeed_tpu/ops/pallas/optimizer.py`
(through `fused_adam_flat`): one read-and-write pass over a flat
partition, the layout the training engine keeps its masters, moments and
gradients in (`runtime/engine.py`). The kernel is `csrc/adam.cu`; its
header says what bounds it on the H100 and what the design does about
that.

`fused_adam_flat_` updates p, m and v in place: it launches the kernel
on CUDA tensors and takes `adam_flat_reference` for CPU tensors, or
where the caller asks for the plain path (``use_kernel=False``, the
model's ``use_kernels=False``). The kernel takes p in fp32, bf16 or fp16
(as `fused_adam_flat` does: a 16-bit p is the lean state's master,
updated in its own dtype from the fp32 math), m and v both in fp32, bf16
or fp16 (`FusedAdam`'s ``state_dtype``), g in fp32, bf16 or fp16, and,
with an fp32 p only, an optional bf16 or fp16 ``p_out`` (the
compute-parameter copy written in the same pass); anything else raises.
"""

import numpy as np
import torch

from . import _build

# kernel launches since the last reset (`chip_smoke.py` reads this), in
# all and by storage variant: "fp32" (fp32 p, m, v: the classic masters,
# with a bf16 copy or none), "fp16 classic" (the same with an fp16 copy
# or an fp16 g: the loss-scaled fp16 path), "lean" (bf16 p, bf16 m, v),
# "fp16 lean" (fp16 p, m, v), else "p <dtype>, m <dtype>"
launches = 0
variant_launches = {}


def _variant(p_dtype, m_dtype, g_dtype=None, c_dtype=None):
    """The `variant_launches` key of a call on p and moments of these
    dtypes (g's and the copy's dtypes tell the classic fp16 variant)."""
    if p_dtype == m_dtype == torch.float32:
        return "fp16 classic" if torch.float16 in (g_dtype, c_dtype) \
            else "fp32"
    if p_dtype == m_dtype == torch.bfloat16:
        return "lean"
    if p_dtype == m_dtype == torch.float16:
        return "fp16 lean"
    return f"p {str(p_dtype)[6:]}, m {str(m_dtype)[6:]}"


def reset_launches():
    global launches
    launches = 0
    variant_launches.clear()


def bias_corrections(beta1, beta2, step, bias_correction=True):
    """(1 - beta1^step, 1 - beta2^step) in fp32, as the JAX package
    computes them; (1, 1) without bias correction."""
    if not bias_correction:
        return 1.0, 1.0
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(beta1) ** t),
            float(np.float32(1.0) - np.float32(beta2) ** t))


def sqrt_rn(x):
    """fp32 square root rounded to nearest, as the kernel's `__fsqrt_rn`
    and XLA's sqrt round it. On the CPU `torch.sqrt` goes through MKL's
    vector math, which is accurate to 1 ulp but not correctly rounded
    (sqrt(1.1671932f) comes out 1.0803671f, not 1.0803672f); a float64
    square root rounded to fp32 is: no fp32 square root lies within
    2^-50 of an fp32 rounding midpoint, far more than a float64 ulp."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def adam_flat_reference(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decay=0.0, adam_w=True,
                        bias_correction=True):
    """Plain PyTorch Adam(W) (a copy of the JAX `adam_flat_reference`,
    with the moments read and written in their own dtype as the JAX
    `FusedAdam` keeps them under ``state_dtype``) → (new_p in p's dtype,
    new_m and new_v in m's dtype); the math runs in fp32 and the inputs
    are not changed."""
    g = g.float()
    p32 = p.float()
    if not adam_w and weight_decay != 0:
        g = g + weight_decay * p32
    m32 = beta1 * m.float() + (1 - beta1) * g
    v32 = beta2 * v.float() + (1 - beta2) * g * g
    # the corrections as 0-dim tensors on the device: PyTorch's CUDA
    # division by a Python scalar multiplies by its reciprocal, which
    # rounds differently from the division the kernel and JAX do
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=p.device)
              for c in bias_corrections(beta1, beta2, step,
                                        bias_correction))
    update = (m32 / c1) / (sqrt_rn(v32 / c2) + eps)
    if adam_w and weight_decay != 0:
        update = update + weight_decay * p32
    return ((p32 - lr * update).to(p.dtype), m32.to(m.dtype),
            v32.to(v.dtype))


def _check(p, g, m, v, p_out):
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("p_out", p_out)):
        if t is None:
            continue
        if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"flat Adam needs {name} as a contiguous 1-D "
                             f"tensor of {n} elements, got "
                             f"{tuple(t.shape)}")
        if t.device != p.device:
            raise ValueError(f"flat Adam: {name} is on {t.device}, p on "
                             f"{p.device}")
    if v.dtype != m.dtype:
        raise TypeError(f"flat Adam keeps m and v in one dtype, got "
                        f"{m.dtype}, {v.dtype}")


def _check_kernel_dtypes(p, g, m, p_out):
    """Raise on a dtype combination `csrc/adam.cu` is not built for."""
    for name, t in (("p", p), ("m", m), ("g", g)):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"flat Adam kernel takes {name} in float32, "
                            f"bfloat16 or float16, got {t.dtype}")
    if p_out is not None and (
            p.dtype != torch.float32 or
            p_out.dtype not in (torch.bfloat16, torch.float16)):
        raise TypeError(f"flat Adam kernel writes a bfloat16 or float16 "
                        f"p_out beside float32 masters only, got p "
                        f"{p.dtype}, p_out {p_out.dtype}")


def adam_cuda(p, g, m, v, lr, step, *, beta1, beta2, eps, weight_decay,
              adam_w, bias_correction, p_out=None):
    """Launch `csrc/adam.cu` on CUDA tensors: p, m, v updated in place
    (each in its own dtype), and the new p written in ``p_out``'s dtype
    (bf16 or fp16) into ``p_out`` when given."""
    global launches
    _check(p, g, m, v, p_out)
    _check_kernel_dtypes(p, g, m, p_out)
    c1, c2 = bias_corrections(beta1, beta2, step, bias_correction)
    lib = _build.load_library()
    err = lib.ds_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        p_out.data_ptr() if p_out is not None else None, p.numel(),
        float(lr), float(beta1), float(beta2), 1 - beta1, 1 - beta2,
        float(eps), float(weight_decay), c1, c2, int(bool(adam_w)),
        _build.DTYPE_CODES[g.dtype], _build.DTYPE_CODES[p.dtype],
        _build.DTYPE_CODES[m.dtype],
        _build.DTYPE_CODES[p_out.dtype] if p_out is not None else 0,
        _build.stream_ptr(p))
    _build.check(err, "ds_adam")
    launches += 1
    key = _variant(p.dtype, m.dtype, g.dtype,
                   p_out.dtype if p_out is not None else None)
    variant_launches[key] = variant_launches.get(key, 0) + 1


def fused_adam_flat_(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.0, adam_w=True,
                     bias_correction=True, p_out=None, use_kernel=True):
    """One Adam(W) step over flat 1-D tensors, in place: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors or with
    ``use_kernel=False``. ``step`` is the 1-based count of the step
    being taken; ``p_out`` (optional) receives the new p in its own
    dtype."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              adam_w=adam_w, bias_correction=bias_correction)
    if use_kernel and p.device.type == "cuda":
        adam_cuda(p, g, m, v, lr, step, p_out=p_out, **kw)
        return
    if use_kernel and p.device.type != "cpu":
        raise ValueError(f"no flat Adam path for device {p.device}")
    _check(p, g, m, v, p_out)
    new_p, new_m, new_v = adam_flat_reference(p, g, m, v, lr, step, **kw)
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)
    if p_out is not None:
        p_out.copy_(new_p)
