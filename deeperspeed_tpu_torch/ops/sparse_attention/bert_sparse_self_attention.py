"""BERT-style self-attention over `SparseSelfAttention`: the port of
`deeperspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py`.

q/k/v projections (``query`` / ``key`` / ``value``, each a ``kernel``
[H, H] in the ``[in, out]`` layout and a ``bias``), block-sparse
attention over the pattern, heads merged. The key padding mask is a
0/1 keep-mask ("mul" mode, the HF user convention).
"""

import math

import torch
from torch import nn

from ...utils.device import resolve_device
from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import FixedSparsityConfig


def _projection(size, device):
    m = nn.Module()
    m.kernel = nn.Parameter(torch.empty(size, size, device=device))
    m.bias = nn.Parameter(torch.empty(size, device=device))
    return m


class BertSparseSelfAttention(nn.Module):
    """q/k/v projections + block-sparse scaled-dot-product attention.
    ``config`` needs ``hidden_size`` and ``num_attention_heads`` (the HF
    `BertConfig`). Parameters are created empty on ``device`` (None
    means the GPU, and raises without CUDA): call `init_params(seed)`
    or load a state dict."""

    def __init__(self, config, sparsity_config=None, max_seq_length=2048,
                 device=None):
        super().__init__()
        if config.hidden_size % config.num_attention_heads != 0:
            raise ValueError(
                f"hidden size {config.hidden_size} not a multiple of the "
                f"number of attention heads {config.num_attention_heads}")
        device = resolve_device(device, "BertSparseSelfAttention")
        self.num_attention_heads = config.num_attention_heads
        self.attention_head_size = (config.hidden_size //
                                    config.num_attention_heads)
        self.all_head_size = (self.num_attention_heads *
                              self.attention_head_size)
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(
                num_heads=config.num_attention_heads),
            key_padding_mask_mode="mul",
            max_seq_length=max_seq_length)
        self.query = _projection(self.all_head_size, device)
        self.key = _projection(self.all_head_size, device)
        self.value = _projection(self.all_head_size, device)

    @torch.no_grad()
    def init_params(self, seed=0):
        """Kernels normal × 1/√H, biases zero (the JAX rule, drawn from a
        `torch.Generator`)."""
        gen = torch.Generator(device=self.query.kernel.device) \
            .manual_seed(int(seed))
        scale = 1.0 / math.sqrt(self.all_head_size)
        for proj in (self.query, self.key, self.value):
            proj.kernel.normal_(0.0, scale, generator=gen)
            proj.bias.zero_()
        return self

    def params(self):
        return {name: {"kernel": proj.kernel, "bias": proj.bias}
                for name, proj in (("query", self.query), ("key", self.key),
                                   ("value", self.value))}

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_attention_heads,
                         self.attention_head_size)

    def apply(self, params, hidden_states, attention_mask=None,
              use_kernels=True):
        """[B, S, H·D] → [B, S, H·D] context."""
        def proj(p):
            return hidden_states @ p["kernel"] + p["bias"]

        q, k, v = (self._split_heads(proj(params[n]))
                   for n in ("query", "key", "value"))
        ctx = self.sparse_self_attention.forward(
            q, k, v, key_padding_mask=attention_mask,
            use_kernels=use_kernels)
        b, s = hidden_states.shape[:2]
        return ctx.reshape(b, s, self.all_head_size)

    def forward(self, hidden_states, attention_mask=None):
        return self.apply(self.params(), hidden_states, attention_mask)
