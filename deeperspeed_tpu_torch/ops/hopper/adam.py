"""Flat Adam(W): the CUDA kernel and its plain version.

Replaces `_adam_kernel` of `deeperspeed_tpu/ops/pallas/optimizer.py`
(through `fused_adam_flat`): one read-and-write pass over a flat fp32
partition, the layout the training engine keeps its masters, moments and
gradients in (`runtime/engine.py`). The kernel is `csrc/adam.cu`; its
header says what bounds it on the H100 and what the design does about
that.

`fused_adam_flat_` updates p, m and v in place: it launches the kernel
on CUDA tensors and takes `adam_flat_reference` for CPU tensors, or
where the caller asks for the plain path (``use_kernel=False``, the
model's ``use_kernels=False``). The kernel takes p, m, v in fp32, g in
fp32 or bf16 and an optional bf16 ``p_out`` (the compute-parameter copy
written in the same pass); anything else raises.
"""

import numpy as np
import torch

from . import _build

# kernel launches since the last reset (`chip_smoke.py` reads this)
launches = 0


def bias_corrections(beta1, beta2, step, bias_correction=True):
    """(1 - beta1^step, 1 - beta2^step) in fp32, as the JAX package
    computes them; (1, 1) without bias correction."""
    if not bias_correction:
        return 1.0, 1.0
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(beta1) ** t),
            float(np.float32(1.0) - np.float32(beta2) ** t))


def adam_flat_reference(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decay=0.0, adam_w=True,
                        bias_correction=True):
    """Plain PyTorch Adam(W) (a copy of the JAX `adam_flat_reference`) →
    (new_p in p's dtype, new_m, new_v); the inputs are not changed."""
    g = g.float()
    p32 = p.float()
    if not adam_w and weight_decay != 0:
        g = g + weight_decay * p32
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    c1, c2 = bias_corrections(beta1, beta2, step, bias_correction)
    update = (m / c1) / (torch.sqrt(v / c2) + eps)
    if adam_w and weight_decay != 0:
        update = update + weight_decay * p32
    return (p32 - lr * update).to(p.dtype), m, v


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
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"flat Adam keeps m and v in float32, got "
                        f"{m.dtype}, {v.dtype}")


def adam_cuda(p, g, m, v, lr, step, *, beta1, beta2, eps, weight_decay,
              adam_w, bias_correction, p_out=None):
    """Launch `csrc/adam.cu` on CUDA tensors: p, m, v updated in place,
    and the new p written as bf16 into ``p_out`` when given."""
    global launches
    if p.dtype != torch.float32:
        raise TypeError(f"flat Adam kernel updates float32 masters, got "
                        f"{p.dtype}")
    if g.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flat Adam kernel takes float32 or bfloat16 "
                        f"grads, got {g.dtype}")
    if p_out is not None and p_out.dtype != torch.bfloat16:
        raise TypeError(f"flat Adam kernel writes a bfloat16 copy, got "
                        f"p_out {p_out.dtype}")
    c1, c2 = bias_corrections(beta1, beta2, step, bias_correction)
    lib = _build.load_library()
    err = lib.ds_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        p_out.data_ptr() if p_out is not None else None, p.numel(),
        float(lr), float(beta1), float(beta2), float(eps),
        float(weight_decay), c1, c2, int(bool(adam_w)),
        _build.DTYPE_CODES[g.dtype], _build.stream_ptr(p))
    _build.check(err, "ds_adam")
    launches += 1


def fused_adam_flat_(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.0, adam_w=True,
                     bias_correction=True, p_out=None, use_kernel=True):
    """One Adam(W) step over flat 1-D tensors, in place: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors or with
    ``use_kernel=False``. ``step`` is the 1-based count of the step
    being taken; ``p_out`` (optional) receives the new p in its own
    dtype."""
    _check(p, g, m, v, p_out)
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              adam_w=adam_w, bias_correction=bias_correction)
    if use_kernel and p.device.type == "cuda":
        adam_cuda(p, g, m, v, lr, step, p_out=p_out, **kw)
        return
    if use_kernel and p.device.type != "cpu":
        raise ValueError(f"no flat Adam path for device {p.device}")
    new_p, new_m, new_v = adam_flat_reference(p, g, m, v, lr, step, **kw)
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)
    if p_out is not None:
        p_out.copy_(new_p)
