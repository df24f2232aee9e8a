"""Tiled and memory-efficient linear layers for huge weight matrices.

The port of `deeperspeed_tpu/runtime/zero/tiling.py` (no Pallas kernel
there: the products are left to XLA, and here to `torch.matmul`):

- `TiledLinear`: one Linear stored as a grid of ``in_splits x
  out_splits`` tiles in a single stacked ``(in_splits, out_splits,
  in_tile, out_tile)`` Parameter (the JAX layer's layout, so its params
  carry across unchanged: `models.convert.tiled_linear_from_jax`), ragged
  dims zero-padded up to the grid. The forward loops over input tiles,
  each step touching one ``(out_splits, in_tile, out_tile)`` slab, and
  sums the products in fp32 (`promote_types(x.dtype, fp32)`, as the JAX
  scan's accumulator). Zero-padded inputs and the sliced output give the
  padding exactly zero gradient, so it stays zero under any optimizer
  whose step is zero for a zero gradient and a zero weight.
- `memory_efficient_linear`: a linear whose autograd node saves the
  input and the weight parameter as it rests, never a gathered or
  converted copy of the weight (the JAX layer recomputes under
  ``jax.checkpoint(nothing_saveable)``; the reference's
  ``LinearFunctionForZeroStage3``).

Per tile in bf16 or fp16, `torch.matmul` rounds the tile's product to
x's dtype before the fp32 sum, where XLA keeps it in fp32
(``preferred_element_type``): with ``in_splits`` > 1 the two differ by an
ulp of x's dtype.
"""

import math

import torch
from torch import nn


class TiledLinear(nn.Module):
    """``y = x @ W + b`` with W ``(in_features, out_features)`` stored as a
    grid of tiles: ``weight`` is ``(in_splits, out_splits, in_tile,
    out_tile)`` (``in_tile = ceil(in_features / in_splits)``), ``bias``
    ``(out_features,)``. The padding rows and columns are zero."""

    def __init__(self, in_features, out_features, bias=True, in_splits=1,
                 out_splits=1, device=None, dtype=torch.float32):
        super().__init__()
        if in_splits < 1 or out_splits < 1:
            raise ValueError("in_splits/out_splits must be >= 1")
        self.in_features = in_features
        self.out_features = out_features
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.in_tile = -(-in_features // in_splits)
        self.out_tile = -(-out_features // out_splits)
        self.use_bias = bias
        self.weight = nn.Parameter(torch.zeros(
            in_splits, out_splits, self.in_tile, self.out_tile,
            device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None

    @property
    def pad_in(self):
        return self.in_splits * self.in_tile - self.in_features

    @property
    def pad_out(self):
        return self.out_splits * self.out_tile - self.out_features

    def padding_mask(self):
        """``weight``-shaped bool: True on the padding rows and columns."""
        w = self.weight
        rows = torch.arange(self.in_splits * self.in_tile, device=w.device) \
            >= self.in_features
        cols = torch.arange(self.out_splits * self.out_tile,
                            device=w.device) >= self.out_features
        dense = rows[:, None] | cols[None, :]
        return dense.reshape(self.in_splits, self.in_tile, self.out_splits,
                             self.out_tile).permute(0, 2, 1, 3)

    def init_params(self, generator=None):
        """Uniform(-1/√in, 1/√in) tiles with the padding zeroed, a zero
        bias (the JAX layer's `init_params` law); returns self."""
        scale = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            w = torch.rand(self.weight.shape, generator=generator,
                           dtype=torch.float32) * (2 * scale) - scale
            w.masked_fill_(self.padding_mask().cpu(), 0.0)
            self.weight.copy_(w)
            if self.bias is not None:
                self.bias.zero_()
        return self

    def from_dense(self, weight, bias=None):
        """Pack a dense ``(in, out)`` weight (and bias) into the tiles, in
        place; returns self."""
        weight = torch.as_tensor(weight)
        if tuple(weight.shape) != (self.in_features, self.out_features):
            raise ValueError(f"dense weight must be "
                             f"{(self.in_features, self.out_features)}, got "
                             f"{tuple(weight.shape)}")
        w = nn.functional.pad(weight, (0, self.pad_out, 0, self.pad_in))
        w = w.reshape(self.in_splits, self.in_tile, self.out_splits,
                      self.out_tile).permute(0, 2, 1, 3)
        with torch.no_grad():
            self.weight.copy_(w)
            if self.bias is not None:
                if bias is None:
                    self.bias.zero_()
                else:
                    self.bias.copy_(torch.as_tensor(bias))
        return self

    def to_dense(self):
        """The dense ``(in_features, out_features)`` weight (a copy)."""
        w = self.weight.permute(0, 2, 1, 3).reshape(
            self.in_splits * self.in_tile, self.out_splits * self.out_tile)
        return w[:self.in_features, :self.out_features]

    def forward(self, x):
        """``y = x @ W + b`` over input-tile slabs. The products run in
        the promoted dtype of x and the weight (a bf16 input on fp32
        parameters computes in fp32, as the JAX layer's einsum promotes)
        and sum in fp32; the sum is cast to x's dtype before the bias
        add, which promotes again."""
        lead = x.shape[:-1]
        ct = torch.result_type(x, self.weight)
        xp = nn.functional.pad(x.reshape(-1, self.in_features),
                               (0, self.pad_in)).to(ct)
        n = xp.shape[0]
        acc = None
        for i in range(self.in_splits):
            xi = xp[:, i * self.in_tile:(i + 1) * self.in_tile]
            # [out_splits, n, out_tile]: one slab of the weight a step
            part = torch.matmul(xi, self.weight[i].to(ct)).float()
            acc = part if acc is None else acc + part
        # cast before the permute's copy: half the bytes in 16 bits
        y = acc.to(x.dtype).permute(1, 0, 2).reshape(
            n, self.out_splits * self.out_tile)[:, :self.out_features]
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, self.out_features)


class _MemoryEfficientLinear(torch.autograd.Function):
    """y = x @ W (+ b): saves x and W as they rest (no gathered copy),
    and forms dx = dy Wᵀ, dW = xᵀ dy, db = Σ dy in the backward. Mixed
    dtypes compute in their promoted dtype (`torch.result_type`, as the
    JAX function's ``x @ W`` promotes); each gradient returns in its
    input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        ct = torch.result_type(x, weight)
        y = torch.matmul(x.to(ct), weight.to(ct))
        return y + bias if bias is not None else y

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        ct = torch.result_type(x, weight)
        dx = torch.matmul(dy.to(ct), weight.to(ct).t()).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).to(ct).t(),
                          dy.reshape(-1, dy.shape[-1]).to(ct)).to(
                              weight.dtype) \
            if ctx.needs_input_grad[1] else None
        db = dy.reshape(-1, dy.shape[-1]).sum(0) \
            if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def memory_efficient_linear(params, x):
    """``x @ params["weight"] (+ params["bias"])`` (the JAX function's
    signature; the weight ``(in, out)``) through `_MemoryEfficientLinear`,
    whose autograd node keeps no gathered or converted weight."""
    return _MemoryEfficientLinear.apply(x, params["weight"],
                                        params.get("bias"))
