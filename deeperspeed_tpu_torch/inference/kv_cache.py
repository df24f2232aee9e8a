"""Preallocated paged KV cache for the serving engine.

The port of `PagedKVCache` and `pages_for_tokens` in
`deeperspeed_tpu/inference/kv_cache.py`. Layout: one K and one V pool
per model, torch tensors ``[L, P, H, page_size, D]`` (layers, pool
pages, heads, slots per page, head dim) on the engine's device. One
page id addresses the same page row in every layer, so the allocator is
layer-agnostic.

Page 0 is RESERVED as the trash page: the allocator never hands it out,
schedulers pad dead page-table entries with it, and inactive batch rows
write their (masked) K/V there.

Allocation is host-side: a free list of page ids plus a per-page
REFERENCE COUNT, copied as it is from the JAX package. The pools are
updated in place by the engine's prefill scatter and decode store.

**Int8 pages** (``kv_cache_dtype: "int8"``): each pool is a
`QuantizedPages`, the int8 data pool plus a SCALE pool ``[L, P, H,
page_size]`` of bf16, one scale per (head, slot), page-row aligned so
the decode kernel resolves both through one page-table lookup. K/V
vectors quantize symmetrically per (head, slot) at write time
(`quantize_kv`). A resident token costs ``2·L·H·(D + 2)`` bytes instead
of ``2·L·H·D·2`` at bf16: 128/66 ≈ 1.94× more sessions at a fixed pool
budget for D = 64. The prefix registry (`PrefixCache`) waits for a
later slice.
"""

import torch

KV_QMAX = 127.0


class QuantizedPages:
    """Int8 page pool + its per-slot scale pool. Indexing takes the same
    index of both (``pool[layer]`` is one layer's pair of views), so the
    engine addresses a quantized pool as it does a plain one."""

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    def __getitem__(self, index):
        return QuantizedPages(self.data[index], self.scale[index])


def quantize_kv(vec):
    """Symmetric per-vector int8 quantization over the trailing (head
    dim) axis: returns (q int8, scale fp32 [...]) with ``dequant = q ·
    scale[..., None]``. Zero vectors keep scale 1. The scale is computed
    in fp32 and the values are rounded with it (half to even, like
    `jnp.round`); the caller stores the scale as bf16 afterwards, in
    that order, as the JAX package does."""
    v32 = vec.float()
    amax = v32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / KV_QMAX, 1.0)
    q = torch.clamp(torch.round(v32 / scale[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def pages_for_tokens(n_tokens, page_size):
    """Pages needed to hold n_tokens (ceil division)."""
    return -(-int(n_tokens) // int(page_size))


class PagedKVCache:
    """The pooled K/V store plus its free-list allocator.

    ``num_pages`` includes the reserved trash page 0, so the usable pool
    is ``num_pages - 1`` pages = ``(num_pages - 1) * page_size`` tokens
    per layer.
    """

    def __init__(self, num_layers, num_pages, num_heads, page_size,
                 head_dim, dtype=torch.bfloat16, device=None):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved trash "
                f"page), got {num_pages}")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.num_heads = int(num_heads)
        self.page_size = int(page_size)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.device = torch.device(device) if device is not None else None
        self.k = self._make_pool()
        self.v = self._make_pool()
        # free list: every page except the trash page, low ids first so
        # tests are deterministic
        self._free = list(range(self.num_pages - 1, 0, -1))
        # reference counts for allocated pages (absent = free)
        self._refcount = {}

    def _make_pool(self):
        shape = (self.num_layers, self.num_pages, self.num_heads,
                 self.page_size, self.head_dim)
        data = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if not self.quantized:
            return data
        # unit scales on the zero pool: dequant of the trash page stays
        # exact zero. bf16 scales: their rounding (2^-9) is noise under
        # the int8 step (2^-7), and fp32 scales would cut the capacity
        # gain at head_dim 64 from 128/66 to 128/68
        scale = torch.ones(shape[:-1], dtype=torch.bfloat16,
                           device=self.device)
        return QuantizedPages(data, scale)

    def data_array(self, pool):
        """The raw data tensor of a pool (the pool itself when the cache
        is not quantized)."""
        return pool.data if isinstance(pool, QuantizedPages) else pool

    # -- allocator (host-side) --------------------------------------------

    @property
    def num_free(self):
        return len(self._free)

    @property
    def tokens_capacity(self):
        return self.num_free * self.page_size

    def allocate(self, n):
        """Pop n pages from the free list (each carrying ONE
        reference), or None when fewer remain (all-or-nothing: a
        partial grab would deadlock admission)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        if n == 0:
            return []
        pages, self._free = self._free[-n:][::-1], self._free[:-n]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def retain(self, pages):
        """Add one reference to each page. Pages must be currently
        allocated."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p not in self._refcount:
                raise ValueError(
                    f"cannot retain page {p}: not currently allocated")
        for p in pages:
            self._refcount[p] += 1

    def refcount(self, page):
        """Current reference count of a page (0 = free)."""
        return self._refcount.get(int(page), 0)

    def free(self, pages):
        """Drop one reference per occurrence; a page returns to the
        free list at zero. Raises — BEFORE mutating anything — when a
        call would take any page below zero references: duplicates
        within one call and double-frees across calls both name the
        offending page id."""
        counts = {}
        for p in pages:
            p = int(p)
            if p <= 0 or p >= self.num_pages:
                raise ValueError(f"page {p} is not an allocatable id")
            counts[p] = counts.get(p, 0) + 1
        for p, n in counts.items():
            held = self._refcount.get(p, 0)
            if n > held:
                raise ValueError(
                    f"double free of page {p}: {n} release(s) in one "
                    f"call against {held} held reference(s)")
        for p, n in counts.items():
            left = self._refcount[p] - n
            if left:
                self._refcount[p] = left
            else:
                del self._refcount[p]
                self._free.append(p)

    def bytes_per_token(self):
        """K + V bytes of cache one token occupies across all layers
        (int8 pools count the per-slot bf16 scale)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_head = self.head_dim * itemsize + (2 if self.quantized else 0)
        return 2 * self.num_layers * self.num_heads * per_head
