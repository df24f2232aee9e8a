"""The port's prefix cache and its paged-decode shape dispatch against
the JAX package's, on the CPU (speculative decoding and the engine's
lifecycle: `test_torch_serve_lifecycle.py`).

- The allocator and `PrefixCache`: the same register / lookup / reclaim /
  clear sequences give the same chains, stats, refcounts and free lists
  as the JAX classes, errors included.
- The prefix-cache engine: the port's `InferenceEngine(device="cpu")`
  and the JAX `InferenceEngine` (use_pallas=False), on the same weights
  (made in JAX, carried by `models/convert.state_dict_from_jax`) and the
  same shared-prefix stream, give identical greedy tokens, prefix stats,
  bucket programs and sampling-program counts, for GPT-NeoX and GPT-2,
  with bf16 and with int8 KV pages.
- The paged-decode shape dispatch: the port's `paged_decode_supported`
  takes the JAX package's on-TPU head dims and page sizes (int8 pools
  also at page sizes the TPU rule refuses and the CUDA kernel takes),
  and a CUDA call of an unsupported shape takes the plain version,
  counted as the "plain" design.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.inference import PagedKVCache as JaxCache
from deeperspeed_tpu.inference import PrefixCache as JaxPrefixCache
from deeperspeed_tpu.ops.pallas import decode_attention as jda
from deeperspeed_tpu_torch import InferenceEngine
from deeperspeed_tpu_torch.inference import PagedKVCache, PrefixCache
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from torch_serving import (FAMILIES, PREFIX_STATS, assert_no_leaks,
                           build_models, config, engines, serve, stream)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    return build_models()


# ---------------------------------------------------------------------------
# allocator + registry
# ---------------------------------------------------------------------------

def _small(cache_cls, pages=16):
    kw = dict(num_layers=1, num_pages=pages, num_heads=2, page_size=4,
              head_dim=8)
    if cache_cls is JaxCache:
        return cache_cls(dtype=jnp.float32, **kw)
    return cache_cls(dtype=torch.float32, **kw)


def _state(cache, pc=None):
    return {"free": list(cache._free), "refcount": dict(cache._refcount),
            "stats": dict(pc.stats) if pc is not None else None}


def _chain(chain):
    return [n.page for n in chain]


def _key(pc, toks):
    return pc.page_key(toks)


def _register_lookup(Cache, PC):
    cache = _small(Cache)
    pc = PC(cache)
    tokens = list(range(1, 13))
    pages = cache.allocate(3)
    pc.register(None, [_key(pc, tokens[i * 4:(i + 1) * 4])
                       for i in range(3)], pages)
    other = tokens[:4] + [77] * 4 + [99]
    return [_chain(pc.lookup(tokens + [99])), _chain(pc.lookup(other)),
            _chain(pc.lookup(tokens)), _chain(pc.lookup(tokens[:8])),
            _state(cache, pc)]


def _reclaim_skips_shared(Cache, PC):
    cache = _small(Cache, pages=8)
    pc = PC(cache)
    a, b = cache.allocate(1), cache.allocate(1)
    pc.register(None, [_key(pc, [1, 2, 3, 4])], a)
    pc.register(None, [_key(pc, [5, 6, 7, 8])], b)
    cache.free(a + b)
    cache.retain(a)
    return [pc.reclaim(2), _state(cache, pc)]


def _shortfall_reclaims(Cache, PC):
    cache = _small(Cache, pages=5)
    pc = PC(cache)
    pages = cache.allocate(4)
    pc.register(None, [_key(pc, [i] * 4) for i in range(4)], pages)
    cache.free(pages)
    got = cache.allocate(3)
    return [got, cache.allocate(2), _state(cache, pc)]


def _max_pages_cap(Cache, PC):
    cache = _small(Cache)
    pc = PC(cache, max_pages=2)
    pages = cache.allocate(3)
    pc.register(None, [_key(pc, [i] * 4) for i in range(3)], pages)
    held = _state(cache, pc)
    cache.free(pages)
    extra = cache.allocate(1)
    pc.register(None, [_key(pc, [9] * 4)], extra)
    cache.free(extra)
    return [held, _state(cache, pc)]


def _lru_chains(Cache, PC):
    """Three chains touched in turn, a lookup refreshing the oldest; the
    reclaim drains the coldest leaves back to front."""
    cache = _small(Cache)
    pc = PC(cache)
    chains = []
    for c in range(3):
        toks = [c * 10 + i for i in range(1, 9)]
        pages = cache.allocate(2)
        pc.register(None, [_key(pc, toks[:4]), _key(pc, toks[4:])], pages)
        cache.free(pages)
        chains.append(toks)
    pc.lookup(chains[0] + [1])
    out = [pc.reclaim(3), _state(cache, pc)]
    out.append([_chain(pc.lookup(t + [1])) for t in chains])
    return out


def _clear(Cache, PC):
    cache = _small(Cache)
    pc = PC(cache)
    pages = cache.allocate(2)
    pc.register(None, [_key(pc, [1] * 4), _key(pc, [2] * 4)], pages)
    cache.free(pages[:1])
    pc.clear()
    return [_state(cache, pc), _chain(pc.lookup([1] * 4 + [9]))]


def _errors(Cache, PC):
    out = []
    for bad in (lambda c: c.free([c.allocate(2)[0]] * 2),
                lambda c: c.retain([3]),
                lambda c: c.free([0]),
                lambda c: PC(c, max_pages=0)):
        cache = _small(Cache)
        with pytest.raises(ValueError) as e:
            bad(cache)
        out.append((str(e.value), _state(cache)))
    return out


REGISTRY_CASES = {f.__name__[1:]: f for f in (
    _register_lookup, _reclaim_skips_shared, _shortfall_reclaims,
    _max_pages_cap, _lru_chains, _clear, _errors)}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_matches_jax(case):
    run = REGISTRY_CASES[case]
    assert run(PagedKVCache, PrefixCache) == run(JaxCache, JaxPrefixCache)


def test_chunk_writes_refuse_shared_pages(models):
    """The chunk store's guard: a window whose valid slots reach a page
    held more than once (a registered or shared prefix page) raises
    before anything runs."""
    _, _, model = models["gpt_neox"]["target"]
    eng = InferenceEngine(model, config=config(
        prefix_cache={"enabled": True}), device="cpu")
    prompts = stream(1, n=2)
    eng.generate(prompts, 2)
    # a request reading the registered page holds a second reference
    page = next(iter(eng.prefix_cache._root.children.values())).page
    eng.cache.retain([page])
    with pytest.raises(RuntimeError, match=f"page {page}, held 2"):
        eng._check_private([page], 0, 4)
    eng.cache.free([page])
    own = eng.cache.allocate(1)
    eng._check_private(own, 0, 16)
    eng.cache.free(own)
    assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# the prefix cache against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefix_cache_matches_the_jax_engine(models, family, kv):
    conf = config(prefix_cache={"enabled": True}, kv_cache_dtype=kv)
    jeng, eng = engines(models, family, conf)
    for seed in (0, 1):
        prompts = stream(seed)
        news = [8] * len(prompts)
        assert serve(eng, prompts, news) == serve(jeng, prompts, news)
        assert {k: eng.prefix_cache.stats[k] for k in PREFIX_STATS} == \
            {k: jeng.prefix_cache.stats[k] for k in PREFIX_STATS}
        assert eng.compile_count() == jeng.compile_count()
        assert eng.sampler_state() == jeng.sampler_state()
    # each seed's prefix misses in its first prefill call only
    assert eng.prefix_cache.stats["hits"] >= 8
    assert any(key[:3] == ("chunk", "target", "sample")
               for key in eng.program_calls)
    assert_no_leaks(eng)
    summary = eng.serve_stats()
    assert summary["prefix_hit_rate"] == pytest.approx(
        summary["prefix_hits"] / summary["prefix_lookups"])


# ---------------------------------------------------------------------------
# the paged-decode shape dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [32, 64, 80, 128, 256])
def test_decode_predicate_is_the_jax_on_tpu_rule(head_dim, monkeypatch):
    """The JAX on-TPU rule for bf16/fp32 pools; for int8 pools it also
    asks 32 slots a page (an int8 sublane tile), which the CUDA kernel
    does not, so the port takes int8 pools at page sizes 8 and 16 too."""
    monkeypatch.setattr(jda, "_interpret", lambda: False)
    for page_size in (8, 16, 32, 64):
        ours = da.paged_decode_supported(head_dim, page_size)
        assert ours == jda.paged_decode_supported(head_dim, page_size,
                                                  False)
        assert jda.paged_decode_supported(head_dim, page_size, True) == \
            (ours and page_size % 32 == 0)
        route = da.decode_route("cuda", head_dim, page_size, "auto")
        assert route == ("kernel" if ours else "unsupported")
        assert da.decode_route("cuda", head_dim, page_size, None) == route
        assert da.decode_route("cuda", head_dim, page_size,
                               "pallas") == "kernel"
        for backend in (None, "auto", "pallas", "xla"):
            assert da.decode_route("cpu", head_dim, page_size,
                                   backend) == "plain"
        assert da.decode_route("cuda", head_dim, page_size,
                               "xla") == "plain"


def test_unsupported_shape_takes_the_plain_version(monkeypatch):
    """A CUDA call the dispatch refuses runs the plain version, counted
    under "plain" and never as a kernel launch; "pallas" on such a shape
    reaches the kernel wrapper, which raises."""
    rng = np.random.default_rng(0)
    B, H, D, ps, NP = 3, 8, 32, 16, 4
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (B * NP + 1, H, ps, D)).astype(np.float32)).to(torch.bfloat16)
    vp = torch.from_numpy(rng.standard_normal(kp.shape).astype(np.float32)
                          ).to(torch.bfloat16)
    table = torch.arange(1, B * NP + 1, dtype=torch.int32).reshape(B, NP)
    lengths = torch.tensor([0, 17, 64], dtype=torch.int32)
    q = q.to(torch.bfloat16)
    monkeypatch.setattr(da, "launches_by_design",
                        dict.fromkeys(da.DESIGNS, 0))
    monkeypatch.setattr(da, "launches", 0)
    routes = []
    decode_route = da.decode_route

    def route(device_type, *args):
        routes.append(decode_route("cuda", *args))
        return routes[-1]

    monkeypatch.setattr(da, "decode_route", route)
    out = da.paged_decode_attention(q, kp, vp, table, lengths)
    want = da.paged_decode_attention_reference(q, kp, vp, table, lengths)
    assert routes == ["unsupported"]
    assert torch.equal(out, want)
    assert da.launches_by_design == {"cluster": 0, "single": 0, "plain": 1}
    assert da.launches == 0
    with pytest.raises(ValueError, match="head_dim"):
        da.paged_decode_attention(q, kp, vp, table, lengths,
                                  backend="pallas")
    assert da.launches == 0


@pytest.mark.parametrize("int8", [False, True])
def test_window_attention_is_the_decode_at_each_position(int8):
    """The chunk program's plain attention over a window of queries is,
    query by query, the plain decode at length ``qpos + 1`` (a query at
    -1 gives an exact zero row), on bf16 and on int8 pools."""
    rng = np.random.default_rng(3)
    B, S, H, D, ps, NP = 2, 5, 4, 32, 8, 3
    P = B * NP + 1
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(torch.bfloat16)
    if int8:
        kp, vp = (torch.from_numpy(rng.integers(
            -127, 128, (P, H, ps, D)).astype(np.int8)) for _ in range(2))
        scales = {n: torch.from_numpy(0.01 + 0.02 * rng.random(
            (P, H, ps)).astype(np.float32)).to(torch.bfloat16)
            for n in ("k_scales", "v_scales")}
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(
            (P, H, ps, D)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
        scales = {}
    table = torch.from_numpy(rng.permutation(np.arange(1, P)).reshape(
        B, NP).astype(np.int32))
    qpos = torch.tensor([[3, 4, 5, 6, -1], [17, 18, 19, 20, 21]])
    out = da.paged_attention_reference(q, kp, vp, table, qpos, **scales)
    assert out.shape == (B, S, H, D) and out.dtype == torch.float32
    for s in range(S):
        one = da.paged_decode_attention_reference(
            q[:, s], kp, vp, table, (qpos[:, s] + 1).to(torch.int32),
            **scales)
        torch.testing.assert_close(out[:, s].to(torch.bfloat16), one,
                                   rtol=0, atol=0)
    assert torch.equal(out[0, 4], torch.zeros(H, D))
