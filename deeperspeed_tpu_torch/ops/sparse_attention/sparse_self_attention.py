"""Sparse self-attention module: the port of
`deeperspeed_tpu/ops/sparse_attention/sparse_self_attention.py`
(reference: `deepspeed/ops/sparse_attention/sparse_self_attention.py`).

Applies a `SparsityConfig`-driven block-sparse attention to q/k/v with
the JAX module's routing (`get_layout`, `forward`), one of three arms:

- the block-sparse kernels (`ops/hopper/block_sparse_attention.py`)
  when the layout, refined to 128-blocks, has density < 0.25;
- the layout-masked flash kernels (`make_masked_flash_attention`) when
  the density is >= 0.25 and the map fits [H, S/128, S/128] x 4 <= 32768
  bytes (the TPU kernel's scalar-memory cap, kept so both packages take
  the same arm);
- the reference's three-op path (sdd → block softmax → dsd, plain torch,
  as the JAX package runs it in XLA) when the block or S is no multiple
  of 128, the head dim is not 64, 128 or 256, or an rpe / mask is given.

The JAX module consults the TPU autotuner for the block-sparse kernel's
grid geometry (`_autotuned_kernel`); the port's kernels have no such
knob, so there is no hook.
"""

import math

import numpy as np
import torch

from ..hopper.block_sparse_attention import BlockSparseAttention
from ..hopper.flash_attention import make_masked_flash_attention
from .matmul import MatMul
from .softmax import _NEG, Softmax, _mask_term
from .sparsity_config import FixedSparsityConfig, SparsityConfig


def layout_to_token_mask(layout, block):
    """[H, nQ, nK] block layout → [H, S, S] boolean token mask (numpy)."""
    layout = np.asarray(layout, bool)
    return np.repeat(np.repeat(layout, block, axis=1), block, axis=2)


def dense_masked_attention(q, k, v, token_mask, causal, sm_scale=None):
    """Dense attention with the block mask applied elementwise, on [B, S,
    H, D]; token_mask is [H, S, S] (shared across batch) or [B, H, S, S].
    Fully masked rows give zeros."""
    b, s, h, d = q.shape
    scale = sm_scale or 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.as_tensor(token_mask, dtype=torch.bool, device=q.device)
    if mask.dim() == 3:
        mask = mask[None]  # [1, H, S, S]
    if causal:
        mask = mask & torch.ones(s, s, dtype=torch.bool,
                                 device=q.device).tril()
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


class SparseSelfAttention:
    """Layout-cached sparse attention, one instance per layer.

    `forward(q, k, v)` takes [B, S, H, D] (the reference takes
    [B, H, S, D]; use `transpose_inputs=True` for that layout).
    """

    # the JAX module's sparse-vs-dense switch point, kept so both packages
    # take the same arm (whether it is this card's crossover is PERF.md's)
    DENSE_DISPATCH_DENSITY = 0.25

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048,
                 transpose_inputs=False, dense_dispatch_density=None):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        if not isinstance(self.sparsity_config, SparsityConfig):
            raise TypeError("sparsity_config must be a SparsityConfig")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self.transpose_inputs = transpose_inputs
        # auto kernel dispatch threshold; 1.0 forces the sparse kernels,
        # 0.0 forces the masked flash path
        self.dense_dispatch_density = (
            self.DENSE_DISPATCH_DENSITY if dense_dispatch_density is None
            else dense_dispatch_density)
        self._cache = {}

    @property
    def block(self):
        return self.sparsity_config.block

    def get_layout(self, seq_len):
        """(layout, kernel or None, causal, (sdd, softmax, dsd)) for one
        sequence length, built once."""
        if seq_len not in self._cache:
            layout = self.sparsity_config.make_layout(seq_len)
            causal = getattr(self.sparsity_config, "attention",
                             "bidirectional") == "unidirectional"
            kernel = None
            block = self.block
            if seq_len % 128 == 0 and block % 128 == 0:
                # the kernels take 128-blocks; coarser layouts are refined
                refine = block // 128
                fine = np.repeat(np.repeat(layout, refine, axis=1),
                                 refine, axis=2)
                density = float(np.asarray(fine, bool).mean())
                mask_fits = fine.shape[1] * fine.shape[2] * 4 <= 32768
                if density >= self.dense_dispatch_density and mask_fits:
                    kernel = make_masked_flash_attention(fine,
                                                         causal=causal)
                else:
                    kernel = BlockSparseAttention(fine, block=128,
                                                  causal=causal)
            # the reference's three-op pipeline for masked/rpe calls and
            # shapes the kernels do not take; fp32 scores into the softmax
            ops = (MatMul(layout, block, "sdd", trans_b=True,
                          out_dtype=torch.float32),
                   Softmax(layout, block),
                   MatMul(layout, block, "dsd"))
            self._cache[seq_len] = (layout, kernel, causal, ops)
        return self._cache[seq_len]

    def arm(self, seq_len, head_dim, masked=False):
        """Which arm a call takes: "block_sparse", "masked_flash" or
        "three_op"."""
        _, kernel, _, _ = self.get_layout(seq_len)
        if kernel is None or head_dim not in (64, 128, 256) or masked:
            return "three_op"
        return "block_sparse" if isinstance(kernel, BlockSparseAttention) \
            else "masked_flash"

    def forward(self, query, key, value, rpe=None, key_padding_mask=None,
                attn_mask=None, use_kernels=True):
        """``use_kernels=False`` keeps the arm but takes its kernels'
        plain versions on any device."""
        if self.transpose_inputs:
            query, key, value = (x.transpose(1, 2)
                                 for x in (query, key, value))
        b, s, h, d = query.shape
        if s % self.block != 0:
            raise ValueError(
                f"sequence length {s} must be divisible by block "
                f"{self.block}")
        layout, kernel, causal, (sdd, softmax, dsd) = self.get_layout(s)

        masked = not (rpe is None and key_padding_mask is None and
                      attn_mask is None)
        if self.arm(s, d, masked) != "three_op":
            out = kernel(query, key, value, use_kernels=use_kernels)
        else:
            qh, kh, vh = (x.transpose(1, 2) for x in (query, key, value))
            scores = sdd(qh, kh)
            am, am_mode = attn_mask, self.attn_mask_mode
            if causal:
                # unidirectional patterns leave intra-block causality to
                # the attention mask; fold the triangular mask into any
                # user mask additively
                tril = torch.where(
                    torch.ones(s, s, dtype=torch.bool,
                               device=query.device).tril(),
                    0.0, _NEG)
                if am is not None:
                    am = _mask_term(torch.as_tensor(am, device=query.device),
                                    am_mode) + tril
                else:
                    am = tril
                am_mode = "add"
            if (key_padding_mask is not None
                    and self.key_padding_mask_mode == "add"
                    and not torch.as_tensor(
                        key_padding_mask).is_floating_point()):
                raise ValueError(
                    "bool/int key_padding_mask with mode 'add' looks like "
                    "a 0/1 keep-mask: pass an additive float mask (e.g. "
                    "-1e4 on padded keys), or use "
                    "key_padding_mask_mode='mul' for keep-masks")
            probs = softmax(
                scores, scale=1.0 / math.sqrt(d), rpe=rpe,
                key_padding_mask=key_padding_mask, attn_mask=am,
                key_padding_mask_mode=self.key_padding_mask_mode,
                attn_mask_mode=am_mode)
            out = dsd(probs, vh).transpose(1, 2).to(query.dtype)
        if self.transpose_inputs:
            out = out.transpose(1, 2)
        return out

    __call__ = forward
