"""Block-sparsity pattern configs: the port's own copy of
`deeperspeed_tpu/ops/sparse_attention/sparsity_config.py` (numpy and the
`random` module, as there), so a pattern gives the same layout in both
packages; `variable` and `bigbird` draw their random blocks from
`random.sample`, so seed `random` to reproduce them.

Each config produces a layout array [num_heads, num_blocks, num_blocks]
(1 = block attends) that `SparseSelfAttention` routes to the block-sparse
kernels, the layout-masked flash kernels or the three-op path. Pattern
semantics match the reference (Dense / Fixed / Variable / BigBird /
BSLongformer / LocalSlidingWindow).
"""

import random

import numpy as np


class SparsityConfig:
    """Base: block size, head count, layout allocation/propagation."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError

    # -- shared primitives -------------------------------------------------

    @staticmethod
    def _tril(layout, h):
        layout[h] = np.tril(layout[h])
        return layout

    def _window(self, layout, h, start, end, unidirectional):
        """Dense window over block rows/cols [start, end)."""
        for row in range(start, end):
            hi = (row + 1) if unidirectional else end
            layout[h, row, start:hi] = 1
        return layout

    def _sliding(self, layout, h, width, bidirectional):
        num_blocks = layout.shape[1]
        if num_blocks < width:
            raise ValueError(
                f"Number of sliding window blocks, {width}, must be smaller "
                f"than total blocks in a row, {num_blocks}")
        w = width // 2
        rows = np.arange(num_blocks)[:, None]
        cols = np.arange(num_blocks)[None, :]
        mask = (cols >= rows - w)
        mask &= (cols <= rows + w) if bidirectional else (cols <= rows)
        layout[h] |= mask.astype(layout.dtype)
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active; kept for comparison/fallback."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (Sparse Transformers, arXiv:1904.10509): dense local
    windows of `num_local_blocks`, plus per-window global representative
    columns (and rows if `horizontal_global_attention`)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_global_blocks > 0 and num_local_blocks % num_global_blocks:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional mode")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_global_blocks > 0 and num_different_global_patterns > \
                num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns "
                f"{num_different_global_patterns} cannot exceed "
                f"{num_local_blocks // num_global_blocks}")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        uni = self.attention == "unidirectional"
        for i in range(0, num_blocks, self.num_local_blocks):
            layout = self._window(layout, h, i,
                                  min(i + self.num_local_blocks, num_blocks),
                                  uni)
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        ng = self.num_global_blocks
        first_idx = self.num_local_blocks - \
            (1 + h % self.num_different_global_patterns) * ng

        end = num_blocks - (num_blocks % self.num_local_blocks)
        for i in range(first_idx, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + ng] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + ng, :] = 1
        if end < num_blocks:  # short trailing window
            start = min(end + first_idx, num_blocks - ng)
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:start + ng] = 1
            if self.horizontal_global_attention:
                layout[h, start:start + ng, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            if self.num_global_blocks > 0:
                layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + explicit global block indices +
    optional random blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != \
                    len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have the same length")
            for start, end in zip(self.global_block_indices,
                                  global_block_end_indices):
                if start >= end:
                    raise ValueError(
                        f"global block start {start} must be < end {end}")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional mode")
        self.horizontal_global_attention = horizontal_global_attention

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} must be <= "
                f"total blocks {num_blocks}")
        for row in range(num_blocks):
            cols = random.sample(range(num_blocks), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        uni = self.attention == "unidirectional"
        start = 0
        block_size = self.local_window_blocks[-1]
        for size in self.local_window_blocks:
            layout = self._window(layout, h, start,
                                  min(start + size, num_blocks), uni)
            start += size
        for i in range(start, num_blocks, block_size):
            layout = self._window(layout, h, i,
                                  min(i + block_size, num_blocks), uni)
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(idx, idx + 1) for idx in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start, end in spans:
            if start >= num_blocks:
                continue
            end = min(end, num_blocks)
            if self.horizontal_global_attention:
                layout[h, start:end, :] = 1
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:end] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            if self.num_random_blocks > 0:
                layout = self.set_random_layout(h, layout)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (arXiv:2007.14062): random + sliding window + global ITC
    blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} must be <= "
                f"total blocks {num_blocks}")
        for row in range(num_blocks):
            pool = range(num_blocks) if self.attention == "bidirectional" \
                else range(row + 1)
            cols = random.sample(pool,
                                 min(self.num_random_blocks, len(pool)))
            layout[h, row, cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        return self._sliding(layout, h, self.num_sliding_window_blocks,
                             self.attention == "bidirectional")

    def set_global_layout_itc(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_global_blocks:
            raise ValueError(
                f"num_global_blocks {self.num_global_blocks} must be <= "
                f"total blocks {num_blocks}")
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        if self.attention == "unidirectional":
            layout = self._tril(layout, h)
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (arXiv:2004.05150): sliding window + global
    rows/columns at given indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != \
                    len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have the same length")
            for start, end in zip(self.global_block_indices,
                                  global_block_end_indices):
                if start >= end:
                    raise ValueError(
                        f"global block start {start} must be < end {end}")
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        return self._sliding(layout, h, self.num_sliding_window_blocks,
                             bidirectional=True)

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(idx, idx + 1) for idx in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start, end in spans:
            if start >= num_blocks:
                continue
            end = min(end, num_blocks)
            layout[h, start:end, :] = 1
            layout[h, :, start:end] = 1
        if self.attention == "unidirectional":
            layout = self._tril(layout, h)
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding-window attention."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        return self._sliding(layout, h, self.num_sliding_window_blocks,
                             self.attention == "bidirectional")

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


MODE_TO_CONFIG = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
}


def sparsity_config_from_dict(d):
    """Build a SparsityConfig from the parsed "sparse_attention" config
    block (`runtime/config.py` schema)."""
    d = dict(d)
    mode = d.pop("mode", "fixed")
    if mode not in MODE_TO_CONFIG:
        raise ValueError(f"unknown sparse attention mode {mode!r}")
    cls = MODE_TO_CONFIG[mode]
    d.setdefault("num_heads", 1)
    import inspect
    valid = set(inspect.signature(cls.__init__).parameters)
    kwargs = {k: v for k, v in d.items() if k in valid and v is not None}
    return cls(**kwargs)
