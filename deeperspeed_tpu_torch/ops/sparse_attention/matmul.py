"""Standalone block-sparse MatMul op, in plain PyTorch: the port of
`deeperspeed_tpu/ops/sparse_attention/matmul.py` (reference:
`deepspeed/ops/sparse_attention/matmul.py:615`).

The JAX package lowers the three modes to XLA, not to a Pallas kernel,
so the port's counterpart is plain torch too: a batched matmul over the
layout's active blocks (``[nnz, block, block]`` batches for cuBLAS),
gathers of the operands' blocks, and `index_add` for the reduction over
blocks that share an output tile (a fixed order on the CPU, no locks).
Autograd differentiates it.

Block-sparse tensor format (the reference's): ``[Z, nnz, block, block]``
where ``nnz`` enumerates the nonzero blocks of ``layout [H,
n_row_blocks, n_col_blocks]`` in row-major (head, row, col) order.

Modes over a logical dense [Z, H, M, K] x [Z, H, K, N]:
  - ``sdd``: sparse = dense @ dense (only active output blocks computed)
  - ``dsd``: dense = sparse @ dense
  - ``dds``: dense = dense @ sparse
``trans_a``/``trans_b`` transpose the *logical* operand; for sparse
operands this swaps the row/col roles of the layout and transposes each
stored block. Products are summed in fp32 (float64 stays), as the JAX
package's ``preferred_element_type=float32``.
"""

import numpy as np
import torch


def _layout_indices(layout):
    """layout [H, nQ, nK] 0/1 → (h, mi, ni) int64 arrays in row-major
    nonzero order — the block enumeration shared with `Softmax` and the
    reference's sparse tensor format."""
    layout = np.asarray(layout)
    if layout.ndim != 3:
        raise ValueError(f"layout must be [H, nQ, nK], got {layout.shape}")
    h, mi, ni = np.nonzero(layout)
    if h.size == 0:
        raise ValueError("layout has no nonzero blocks")
    return h.astype(np.int64), mi.astype(np.int64), ni.astype(np.int64)


def _acc(t):
    """``t`` upcast to fp32 for the sums (float64 stays)."""
    return t if t.dtype == torch.float64 else t.float()


def _pad_shape(x):
    """Left-pad with singleton dims to 4: dense to [Z, H, M, N], sparse to
    [Z, nnz, block, block]."""
    while x.dim() < 4:
        x = x[None]
    return x


def _idx(a, device):
    return torch.as_tensor(a, dtype=torch.long, device=device)


def _seg_reduce(x, seg, num_segments):
    """Sum [Z, nnz, ...] over axis 1 grouped by ``seg`` → [Z,
    num_segments, ...] (the JAX package's `segment_sum`)."""
    out = x.new_zeros((x.shape[0], num_segments, *x.shape[2:]))
    return out.index_add(1, _idx(seg, x.device), x)


def dense_to_sparse(x, layout, block):
    """Dense [Z, H, nQ*B, nK*B] → sparse [Z, nnz, B, B] in the layout's
    row-major nonzero block order."""
    h_idx, mi_idx, ni_idx = _layout_indices(layout)
    z, h, m, n = x.shape
    blocks = x.reshape(z, h, m // block, block, n // block, block)
    blocks = blocks.permute(0, 1, 2, 4, 3, 5)     # [Z, H, nQ, nK, B, B]
    dev = x.device
    return blocks[:, _idx(h_idx, dev), _idx(mi_idx, dev), _idx(ni_idx, dev)]


def sparse_to_dense(x, layout, block, fill=0.0):
    """Sparse [Z, nnz, B, B] → dense [Z, H, nQ*B, nK*B]; inactive blocks
    take ``fill`` (use -inf-like fills for pre-softmax score matrices)."""
    layout = np.asarray(layout)
    h_idx, mi_idx, ni_idx = _layout_indices(layout)
    h, n_q, n_k = layout.shape
    z = x.shape[0]
    flat = x.new_full((z, h * n_q * n_k, block, block), fill)
    dest = (h_idx * n_q + mi_idx) * n_k + ni_idx
    flat = flat.index_copy(1, _idx(dest, x.device), x)
    blocks = flat.reshape(z, h, n_q, n_k, block, block)
    return blocks.permute(0, 1, 2, 4, 3, 5).reshape(
        z, h, n_q * block, n_k * block)


class MatMul:
    """Block-sparse matmul with the reference's class API
    (`matmul.py:615-745`): construct once per (layout, block, mode), call
    on ``(a, b)``. Pure function of its inputs, differentiable by
    autograd."""

    def __init__(self, layout, block, mode, trans_a=False, trans_b=False,
                 bench=False, out_dtype=None):
        if mode not in ("sdd", "dsd", "dds"):
            raise NotImplementedError("Supported modes are: sdd, dsd, dds")
        layout = np.asarray(layout)
        self.layout = layout
        self.block = int(block)
        self.mode = mode
        self.trans_a = bool(trans_a)
        self.trans_b = bool(trans_b)
        self.spdims = layout.shape
        self.bench = bench  # accepted for API compatibility
        # out_dtype=torch.float32 keeps the fp32 sums in the output
        # (attention scores feeding a softmax shouldn't round to bf16)
        self.out_dtype = out_dtype
        self.h_idx, self.mi_idx, self.ni_idx = _layout_indices(layout)
        self.nnz = self.h_idx.size

    # -- mode implementations -------------------------------------------

    def _sdd(self, a, b):
        """dense a [Z,H,M,K] @ dense b [Z,H,K,N] → sparse [Z,nnz,B,B],
        computing only the active output blocks."""
        bsz = self.block
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        z, h, m, k = a.shape
        n_q, n_k = self.spdims[1], self.spdims[2]
        a_blocks = a.reshape(z, h * n_q, bsz, k)
        b_blocks = b.transpose(-1, -2).reshape(z, h * n_k, bsz, k)
        dev = a.device
        a_sel = _acc(a_blocks).index_select(
            1, _idx(self.h_idx * n_q + self.mi_idx, dev))
        b_sel = _acc(b_blocks).index_select(
            1, _idx(self.h_idx * n_k + self.ni_idx, dev))
        out = torch.einsum("znik,znjk->znij", a_sel, b_sel)
        return out.to(self.out_dtype or a.dtype)

    def _dsd(self, a, b):
        """sparse a @ dense b → dense. Logical a is [Z,H,nQ*B,nK*B] (or its
        transpose when trans_a): gather b's contraction blocks per active
        block, batch-matmul, sum into output row blocks."""
        bsz = self.block
        if self.trans_b:
            b = b.transpose(-1, -2)
        z = a.shape[0]
        h, n_q, n_k = self.spdims
        n = b.shape[-1]
        if not self.trans_a:
            contract_idx, out_idx, out_blocks = self.ni_idx, self.mi_idx, n_q
            contract_blocks = n_k
            blocks = a
        else:
            contract_idx, out_idx, out_blocks = self.mi_idx, self.ni_idx, n_k
            contract_blocks = n_q
            blocks = a.transpose(-1, -2)
        b_blocks = b.reshape(z, h * contract_blocks, bsz, n)
        b_sel = _acc(b_blocks).index_select(
            1, _idx(self.h_idx * contract_blocks + contract_idx, b.device))
        prod = torch.einsum("znab,znbc->znac", _acc(blocks), b_sel)
        out = _seg_reduce(prod, self.h_idx * out_blocks + out_idx,
                          h * out_blocks)
        return out.reshape(z, h, out_blocks * bsz, n).to(
            self.out_dtype or b.dtype)

    def _dds(self, a, b):
        """dense a @ sparse b → dense. Logical b is [Z,H,nQ*B,nK*B] (or its
        transpose when trans_b)."""
        bsz = self.block
        if self.trans_a:
            a = a.transpose(-1, -2)
        z = a.shape[0]
        h, n_q, n_k = self.spdims
        m = a.shape[-2]
        if not self.trans_b:
            contract_idx, out_idx, out_blocks = self.mi_idx, self.ni_idx, n_k
            contract_blocks = n_q
            blocks = b
        else:
            contract_idx, out_idx, out_blocks = self.ni_idx, self.mi_idx, n_q
            contract_blocks = n_k
            blocks = b.transpose(-1, -2)
        # a's contraction blocks: [Z, H*contract_blocks, M, B]
        a_blocks = a.reshape(z, h, m, contract_blocks, bsz)
        a_blocks = a_blocks.movedim(3, 2).reshape(
            z, h * contract_blocks, m, bsz)
        a_sel = _acc(a_blocks).index_select(
            1, _idx(self.h_idx * contract_blocks + contract_idx, a.device))
        prod = torch.einsum("znmb,znbc->znmc", a_sel, _acc(blocks))
        out = _seg_reduce(prod, self.h_idx * out_blocks + out_idx,
                          h * out_blocks)
        # [Z, H*out_blocks, M, B] → [Z, H, M, out_blocks*B]
        out = out.reshape(z, h, out_blocks, m, bsz)
        out = out.movedim(2, 3).reshape(z, h, m, out_blocks * bsz)
        return out.to(self.out_dtype or a.dtype)

    def __call__(self, a, b):
        """Applies block-sparse matmul (reference `matmul.py:695`)."""
        a = _pad_shape(torch.as_tensor(a))
        b = _pad_shape(torch.as_tensor(b))
        if self.mode == "sdd":
            return self._sdd(a, b)
        if self.mode == "dsd":
            return self._dsd(a, b)
        return self._dds(a, b)
