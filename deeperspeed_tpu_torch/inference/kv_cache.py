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
budget for D = 64.

**Prefix registry** (`PrefixCache`, the JAX class copied as it is):
full prompt pages are registered as a chain keyed by their token ids;
a later prompt that starts with a registered chain shares its pages by
reference count and prefills only its suffix. The registry holds one
reference a page, and an allocation shortfall first reclaims its least
recently used unshared pages.
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
        # reference counts for allocated pages (absent = free); the
        # prefix registry and co-reading requests hold extra references
        self._refcount = {}
        # optional `PrefixCache` (set by its constructor): allocation
        # shortfalls reclaim LRU unshared registry pages before failing
        self.prefix_cache = None

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

    def reset_pools(self):
        """Rebuild the K/V pools zeroed (int8 pools: zero data and unit
        scales), keeping the allocator state. The serving engine's
        quarantine path calls this when a step lost its pools
        mid-execution (`pools_lost`); it then re-prefills every running
        sequence, so the zeroed contents are never read."""
        self.k = self._make_pool()
        self.v = self._make_pool()

    def pools_lost(self):
        """True when a pool's storage is gone (released to size 0): the
        port's counterpart of a donated JAX buffer that a call consumed.
        Torch updates the pools in place, so a call that raises between
        layers leaves them allocated, holding K/V past each request's
        committed length; only a released storage counts as lost."""
        return any(self.data_array(pool).untyped_storage().nbytes() == 0
                   for pool in (self.k, self.v))

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
        partial grab would deadlock admission). A shortfall first asks
        the prefix registry to reclaim LRU unshared pages."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free) and self.prefix_cache is not None:
            self.prefix_cache.reclaim(n - len(self._free))
        if n > len(self._free):
            return None
        if n == 0:
            return []
        pages, self._free = self._free[-n:][::-1], self._free[:-n]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def retain(self, pages):
        """Add one reference to each page (prefix sharing: the new
        reader frees through the ordinary `free` path). Pages must be
        currently allocated."""
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


class _PrefixNode:
    """One registered full page: keyed under its parent by the page's
    exact token ids, so the (parent, key) chain IS the chained content
    hash: dict lookup hashes it, equality verifies it."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.last_used = 0


class PrefixCache:
    """Radix-style page-granular prefix registry over a `PagedKVCache`.

    A completed prefill registers each FULL prompt page as a chain node
    (`register`); a new prompt walks the tree (`lookup`) and shares the
    longest matching page chain via refcounts, so its prefill starts at
    the first divergent page. The registry holds one reference per
    registered page, so pages outlive the request that built them;
    `reclaim` releases least-recently-used UNSHARED leaves back to the
    allocator when the pool runs short (or past ``max_pages``), and
    `clear` drops everything (a weight swap: the cached K/V no longer
    matches what a forward pass would produce).

    Host-side and deterministic: recency is a logical tick counter, not
    wall clock, so the same request stream always caches and reclaims
    the same pages."""

    def __init__(self, cache, max_pages=None):
        self.cache = cache
        self.page_size = cache.page_size
        if max_pages is not None and int(max_pages) < 1:
            raise ValueError(
                f"prefix_cache max_pages must be >= 1, got {max_pages}")
        self.max_pages = None if max_pages is None else int(max_pages)
        self.stats = {"lookups": 0, "hits": 0, "pages_shared": 0,
                      "saved_prefill_tokens": 0, "registered_pages": 0,
                      "reclaimed_pages": 0}
        self._root = _PrefixNode(None, None, None)
        self._pages = 0
        self._tick = 0
        cache.prefix_cache = self

    @staticmethod
    def page_key(tokens):
        """The canonical node key for one page's worth of tokens."""
        return tuple(int(t) for t in tokens)

    def _touch(self, node):
        self._tick += 1
        node.last_used = self._tick

    def lookup(self, tokens):
        """Longest registered page chain covering a prefix of `tokens`,
        capped so at least ONE token is left to prefill (prefill always
        samples the first generated token). Returns the node chain
        (possibly empty); the caller retains the pages."""
        ps = self.page_size
        limit = max((len(tokens) - 1) // ps, 0)
        node = self._root
        chain = []
        for i in range(limit):
            child = node.children.get(
                self.page_key(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            chain.append(child)
            node = child
        for n in chain:
            self._touch(n)
        return chain

    def register(self, parent, keys, pages):
        """Extend the chain under `parent` (None = root) with full
        pages: `keys[i]` is `page_key(...)` of the page's tokens,
        `pages[i]` the request-owned page holding their K/V. A key
        already registered keeps the EXISTING node/page (the request's
        copy stays request-owned and frees normally); a new key retains
        the page for the registry. Returns the deepest node."""
        node = parent if parent is not None else self._root
        for key, page in zip(keys, pages):
            child = node.children.get(key)
            if child is None:
                self.cache.retain([page])
                child = _PrefixNode(key, int(page), node)
                node.children[key] = child
                self._pages += 1
            self._touch(child)
            node = child
        self.stats["registered_pages"] = self._pages
        if self.max_pages is not None and self._pages > self.max_pages:
            self.reclaim(self._pages - self.max_pages)
        return node

    def _lru_leaves(self):
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        out.sort(key=lambda n: n.last_used)
        return out

    def reclaim(self, n_pages):
        """Release up to `n_pages` least-recently-used UNSHARED leaf
        pages back to the allocator (refcount 1 = registry-only; a page
        some in-flight request still reads is never reclaimed). Interior
        nodes become leaves as their children go, so a whole cold chain
        drains back-to-front. Returns the number reclaimed."""
        reclaimed = 0
        while reclaimed < int(n_pages):
            leaf = next((l for l in self._lru_leaves()
                         if self.cache.refcount(l.page) == 1), None)
            if leaf is None:
                break
            leaf.parent.children.pop(leaf.key)
            self.cache.free([leaf.page])
            self._pages -= 1
            reclaimed += 1
        self.stats["registered_pages"] = self._pages
        self.stats["reclaimed_pages"] += reclaimed
        return reclaimed

    def clear(self):
        """Drop every chain and release the registry's references.
        Pages still shared with in-flight requests stay allocated until
        those requests free them; only the registry's claim ends."""
        stack = list(self._root.children.values())
        pages = []
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            pages.append(n.page)
        if pages:
            self.cache.free(pages)
        self._root.children.clear()
        self._pages = 0
        self.stats["registered_pages"] = 0
