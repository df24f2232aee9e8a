"""Gradient-norm helpers over the engine's flat fp32 gradient.

The port of `global_norm` / `clip_grad_norm_` of
`deeperspeed_tpu/runtime/utils.py`: the JAX versions sum squares leaf by
leaf over a pytree; the port's gradient is one flat buffer, so the norm
is one reduction and the clip one scale, both on the device (no host
read).
"""

import torch


def global_norm(flat):
    """L2 norm of a flat tensor, as a 0-d fp32 tensor."""
    return torch.linalg.vector_norm(flat.float())


def clip_grad_norm_(flat, max_norm, norm=None):
    """Scale ``flat`` in place so its L2 norm is at most ``max_norm``.
    A non-finite norm leaves it unscaled (the fp16 overflow skip handles
    those steps). Returns the norm before clipping."""
    total = global_norm(flat) if norm is None else norm
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    coef = torch.where(torch.isfinite(total), coef, torch.ones_like(coef))
    flat.mul_(coef.to(flat.dtype))
    return total
