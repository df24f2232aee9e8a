"""Standalone block-sparse Softmax op, in plain PyTorch: the port of
`deeperspeed_tpu/ops/sparse_attention/softmax.py` (reference:
`deepspeed/ops/sparse_attention/softmax.py:230`).

Normalizes each *row* of the logical [H, nQ*B, nK*B] sparse matrix across
all of that row's active blocks, in the reference's sparse tensor format
``[Z, nnz, block, block]`` (row-major (head, row-block, col-block) block
order, `matmul._layout_indices`). The JAX package computes it in XLA
(segment max and sum over the block axis), so the port's counterpart is
plain torch: `scatter_reduce` / `index_add` over the blocks of each
(head, row-block). Autograd differentiates it; the row maximum is only
a shift the result does not depend on, so it carries no gradient.

Mask semantics match `softmax_fwd.tr` exactly: x*scale → +rpe →
+key-padding-mask → +attn-mask, where a "mul"-mode mask contributes
-1e30 where the mask is 0 and 0 elsewhere, and an "add"-mode mask is
added verbatim.
"""

import numpy as np
import torch

from .matmul import _layout_indices

_NEG = -1e30  # finite -inf stand-in: keeps fully-masked rows NaN-free


def _mask_term(mask, mode):
    mask = torch.as_tensor(mask).float()
    if mode == "mul":
        return torch.where(mask == 0, torch.full_like(mask, _NEG),
                           torch.zeros_like(mask))
    if mode == "add":
        return mask
    raise ValueError(f"mask mode must be 'add' or 'mul', got {mode!r}")


class Softmax:
    """Block-sparse softmax with the reference's class API
    (`softmax.py:230-318`). Construct once per (layout, block); call on a
    sparse tensor. Functional: unlike the reference it does NOT mutate x
    in place."""

    def __init__(self, layout, block, bench=False):
        layout = np.asarray(layout)
        self.layout = layout
        self.block = int(block)
        self.spdims = layout.shape
        self.num_blocks = int(layout.sum())
        self.bench = bench
        self.h_idx, self.mi_idx, self.ni_idx = _layout_indices(layout)
        h, n_q, n_k = layout.shape
        # row-group id per block: all blocks of one (head, row-block) pool
        # their columns into a single softmax domain
        self.seg = self.h_idx * n_q + self.mi_idx
        self.num_segments = h * n_q

    def _rows_cols(self, device):
        bsz = self.block
        rows = self.mi_idx[:, None] * bsz + np.arange(bsz)[None]
        cols = self.ni_idx[:, None] * bsz + np.arange(bsz)[None]
        return (torch.as_tensor(rows, device=device),
                torch.as_tensor(cols, device=device))

    def __call__(self, x, scale=1.0, rpe=None, key_padding_mask=None,
                 attn_mask=None, key_padding_mask_mode="add",
                 attn_mask_mode="add"):
        """x: sparse [Z, nnz, B, B] (or [nnz, B, B]); rpe: dense
        [Z|1, H, S, S]; key_padding_mask: [Z, S]; attn_mask: [S, S]."""
        x = torch.as_tensor(x)
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        z, nnz, bsz, _ = x.shape
        if nnz != len(self.h_idx):
            raise ValueError(
                f"expected {len(self.h_idx)} blocks, got {nnz}")
        dev = x.device
        seg = torch.as_tensor(self.seg, device=dev)

        f = x.float() * scale
        if rpe is not None:
            rpe = torch.as_tensor(rpe, device=dev)
            if rpe.dim() != 4:
                raise ValueError("rpe must be [Z|1, H, S, S]")
            rows, cols = self._rows_cols(dev)
            h = torch.as_tensor(self.h_idx, device=dev)
            blk = rpe[:, h[:, None, None], rows[:, :, None],
                      cols[:, None, :]]                  # [Z|1, nnz, B, B]
            f = f + blk.float()
        if key_padding_mask is not None:
            kpm = _mask_term(key_padding_mask, key_padding_mask_mode).to(
                dev)                                     # [Z, S]
            _, cols = self._rows_cols(dev)
            blk = kpm.index_select(1, cols.reshape(-1))  # [Z, nnz*B]
            f = f + blk.reshape(z, nnz, 1, bsz)
        if attn_mask is not None:
            am = _mask_term(attn_mask, attn_mask_mode).to(dev)   # [S, S]
            rows, cols = self._rows_cols(dev)
            f = f + am[rows[:, :, None], cols[:, None, :]][None]

        # row-wise max and sum across every active block of the row
        nseg = self.num_segments
        row_max = f.detach().amax(dim=-1)                # [Z, nnz, B]
        g_max = row_max.new_full((z, nseg, bsz), -float("inf"))
        g_max = g_max.scatter_reduce(
            1, seg[None, :, None].expand_as(row_max), row_max, "amax",
            include_self=False)
        # rows whose every active entry is masked to ~-inf emit zeros (the
        # dense path's convention; the Triton kernel emits NaN there)
        dead = g_max <= _NEG / 2                         # [Z, nseg, B]
        g_max = g_max.clamp(min=_NEG)   # keep exp() finite on dead rows
        e = torch.exp(f - g_max.index_select(1, seg)[..., None])
        g_sum = e.new_zeros((z, nseg, bsz)).index_add(1, seg, e.sum(dim=-1))
        s = g_sum.index_select(1, seg)[..., None]
        alive = ~dead.index_select(1, seg)[..., None]
        y = torch.where(alive & (s > 0), e / s.clamp(min=1e-30),
                        torch.zeros_like(e)).to(x.dtype)
        return y[0] if squeeze else y
