"""The port's serving slice against the JAX package's, on the CPU.

- The allocator and the scheduler hand out the same page ids and plans
  for one request stream.
- The whole slice: the port's `InferenceEngine(device="cpu")` and the
  JAX `InferenceEngine` (use_pallas=False), on the same weights and
  prompts, give identical greedy tokens and the same counters, with
  prefill buckets across page boundaries and evictions included.
- `device=None` without CUDA raises, unported features raise, the serving
  robustness blocks build and serve, the prefix cache and speculative
  decoding build, and CPU tensors never touch a kernel's launch counter.
"""

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.inference.kv_cache import PagedKVCache as JaxCache
from deeperspeed_tpu.inference.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from deeperspeed_tpu.inference.scheduler import Request as JaxRequest
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, InferenceEngine
from deeperspeed_tpu_torch.inference import (ContinuousBatchingScheduler,
                                             PagedKVCache, Request)
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=256)


def _config(**kw):
    block = {"enabled": True, "page_size": 16, "num_pages": 26,
             "max_batch_size": 4, "token_budget": 256,
             "prefill_lengths": [16, 32, 64, 128, 256],
             "prefill_batch_sizes": [1, 2], "decode_batch_sizes": [2, 4]}
    block.update(kw)
    return {"inference": block}


@pytest.fixture(scope="module")
def models():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    jmodel = jneox.GPTNeoX(config=jcfg, use_pallas=False)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    model = GPTNeoX(GPTNeoXConfig(**SIZE), device="cpu")
    model.load_jax_params(jparams)
    return jmodel, jparams, model


# ---------------------------------------------------------------------------
# allocator + scheduler
# ---------------------------------------------------------------------------

def _drive(sched_cls, cache_cls, req_cls, lengths):
    """Run one request stream through a scheduler with fake tokens and
    record every plan and every page id handed out."""
    cache = cache_cls(num_layers=1, num_pages=14, num_heads=1,
                      page_size=16, head_dim=8)
    sched = sched_cls(cache, max_seq_len=128, token_budget=160,
                      max_batch_size=4, prefill_lengths=[16, 32, 64, 128],
                      prefill_batch_sizes=[1, 2], decode_batch_sizes=[2, 4])
    for i, n in enumerate(lengths):
        sched.add_request(req_cls(prompt=list(range(1, n + 1)),
                                  max_new_tokens=10 + i % 3))
    trace, step = [], 0
    while sched.has_work:
        plan = sched.schedule()
        trace.append((
            [r.request_id for r in plan.prefills], plan.prefill_batch,
            plan.prefill_len, [r.request_id for r in plan.decodes],
            plan.decode_batch, [r.request_id for r in plan.evicted],
            [(r.request_id, list(r.pages)) for r in sched.running],
            cache.num_free))
        for r in plan.prefills:
            sched.complete_prefill(r, step % 7)
        for r in plan.decodes:
            if r.state == "running":
                sched.complete_decode(r, step % 5)
        step += 1
    finished = sorted((r.request_id, r.status, r.evictions,
                       list(r.generated)) for r in sched.pop_finished())
    return trace, finished, cache.num_free


def test_scheduler_and_allocator_match():
    lengths = [16, 32, 64, 17, 5, 100, 48, 9]
    ours = _drive(ContinuousBatchingScheduler, PagedKVCache, Request,
                  lengths)
    ref = _drive(JaxScheduler, JaxCache, JaxRequest, lengths)
    assert ours == ref
    trace, finished, num_free = ours
    assert num_free == 13                       # every page came back
    assert any(step[5] for step in trace)      # the stream evicts


def test_allocator_refcounts_match():
    caches = [cls(num_layers=1, num_pages=8, num_heads=1, page_size=4,
                  head_dim=2) for cls in (PagedKVCache, JaxCache)]
    for cache in caches:
        a = cache.allocate(3)
        cache.retain(a[:1])
        cache.free(a)
        assert cache.allocate(9) is None
        with pytest.raises(ValueError, match="double free"):
            cache.free([a[1]])
    ours, ref = caches
    assert ours._free == ref._free and ours._refcount == ref._refcount


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def test_greedy_tokens_match_the_jax_engine(models):
    jmodel, jparams, model = models
    rng = np.random.default_rng(0)
    # buckets across page edges (16 | 17, 32 | 33) and up to 256 tokens;
    # a pool of 19 usable pages runs dry while sequences grow: evictions
    lengths = [5, 16, 17, 33, 64, 64, 128, 200]
    prompts = [list(rng.integers(1, 512, size=n)) for n in lengths]
    conf = _config(num_pages=20)
    jeng = JaxEngine(jmodel, config=conf, params=jparams)
    ref = jeng.generate(prompts, max_new_tokens=20)
    eng = InferenceEngine(model, config=conf, device="cpu")
    out = eng.generate(prompts, max_new_tokens=20)
    assert out == ref
    keys = ("prefill_tokens", "decode_tokens", "steps", "evictions",
            "prefill_requests", "finished")
    assert {k: eng.stats[k] for k in keys} == \
        {k: jeng.stats[k] for k in keys}
    assert eng.stats["evictions"] > 0
    assert eng.cache.num_free == eng.cache.num_pages - 1
    summary = eng.serve_stats()
    assert summary["requests_ok"] == len(prompts)
    assert "ttft_p50_ms" in summary and "inter_token_p99_ms" in summary


def test_kernel_backends_agree_and_cpu_never_launches(models):
    _, _, model = models
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (7, 30, 70)]
    outs = []
    for kernel in ("auto", "pallas", "xla"):
        eng = InferenceEngine(model, config=_config(kernel=kernel),
                              device="cpu")
        outs.append(eng.generate(prompts, max_new_tokens=5))
    assert outs[0] == outs[1] == outs[2]
    model.use_kernels = False
    try:
        eng = InferenceEngine(model, config=_config(), device="cpu")
        assert eng.generate(prompts, max_new_tokens=5) == outs[0]
    finally:
        model.use_kernels = True
    assert (fa.launches, da.launches) == (0, 0)


def test_bf16_engine_rests_weights_in_bf16(models):
    _, _, model = models
    params = {k: (v.to(torch.bfloat16) if v.dim() >= 2 else v)
              for k, v in model.state_dict().items()}
    eng = InferenceEngine(model, config=_config(), params=params,
                          device="cpu")
    assert eng.compute_dtype == torch.bfloat16
    assert eng.cache.k.dtype == torch.bfloat16
    assert eng.params["blocks"][0]["attn"]["qkv_w"].dtype == torch.bfloat16
    assert eng.params["blocks"][0]["attn"]["qkv_b"].dtype == torch.float32
    (out,) = eng.generate([[1, 2, 3, 4, 5]], max_new_tokens=4)
    assert len(out) == 4 and all(0 <= t < 512 for t in out)


def test_sampling_is_seeded(models):
    _, _, model = models
    runs = [InferenceEngine(model, config=_config(temperature=1.0, seed=s),
                            device="cpu").generate([[3, 1, 4, 1, 5]],
                                                   max_new_tokens=8)
            for s in (7, 7)]
    assert runs[0] == runs[1]


def test_default_device_needs_cuda(models, monkeypatch):
    _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, config=_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTNeoX(GPTNeoXConfig(**SIZE))


UNPORTED = [
    ({"disaggregation": {"role": "prefill"}}, {}),
    ({"router": {}}, {}),
    ({}, {"telemetry": {"enabled": True}}),
]


@pytest.mark.parametrize("block,top", UNPORTED)
def test_unported_features_raise(models, block, top):
    """Scale-out features raise "not ported". The telemetry case is
    ported since: the engine builds with the block, as the JAX engine
    does, and holds a live telemetry of the same parsed config."""
    jmodel, jparams, model = models
    cfg = _config(**block)
    cfg.update(top)
    if "telemetry" not in top:
        with pytest.raises(DeepSpeedConfigError, match="not ported"):
            InferenceEngine(model, config=cfg, device="cpu")
        return
    eng = InferenceEngine(model, config=cfg, device="cpu")
    ref = JaxEngine(jmodel, config=cfg, params=jparams)
    assert eng.telemetry.enabled and ref.telemetry.enabled
    for attr in ("goodput_enabled", "mfu_enabled", "spans_enabled",
                 "trace_dir", "capture_start_step", "capture_num_steps"):
        assert getattr(eng.telemetry, attr) == getattr(ref.telemetry, attr)
    eng.drain()
    ref.drain()


@pytest.mark.parametrize("block", [
    {"prefix_cache": {"enabled": True}},
    {"speculative": {"enabled": True, "num_draft_tokens": 2}}])
def test_prefix_cache_and_speculative_construct(models, block):
    """Both serving features build (they raised "not ported" before the
    slice that carries them); speculation takes a draft model."""
    _, _, model = models
    draft = model if "speculative" in block else None
    eng = InferenceEngine(model, config=_config(**block), device="cpu",
                          draft_model=draft)
    assert (eng.prefix_cache is not None) == ("prefix_cache" in block)
    assert eng.spec_k == (2 if draft is not None else 0)
    (out,) = eng.generate([[3, 1, 4, 1, 5]], max_new_tokens=4)
    assert len(out) == 4


@pytest.mark.parametrize("block", [
    {"fault_injection": {"faults": []}},
    {"admission": {}},
    {"hang_timeout_s": 2.0}])
def test_robustness_blocks_construct_and_serve(models, block):
    """The serving robustness blocks build and serve (they raised "not
    ported" before the slice that carries them)."""
    _, _, model = models
    eng = InferenceEngine(model, config=_config(**block), device="cpu")
    assert (eng.admission is not None) == ("admission" in block)
    assert (eng.watchdog is not None) == ("hang_timeout_s" in block)
    assert eng.fault_injector is None       # an empty plan builds none
    (out,) = eng.generate([[3, 1, 4, 1, 5]], max_new_tokens=4)
    assert len(out) == 4
    assert eng.stats["requests_ok"] == 1 and eng.stats["quarantines"] == 0
    if eng.watchdog is not None:
        eng.watchdog.stop()


def test_unported_mesh_and_family_raise(models):
    _, _, model = models
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        InferenceEngine(model, config=_config(), device="cpu",
                        mesh=object())

    class GPT2Like(torch.nn.Module):
        config = model.config

        def named_parameters(self):
            return model.named_parameters()

    with pytest.raises(DeepSpeedConfigError,
                       match="serves the GPT-NeoX / GPT-2 families; got "
                             "GPT2Like"):
        InferenceEngine(GPT2Like(), config=_config(), device="cpu")


def test_config_checks(models):
    _, _, model = models
    with pytest.raises(DeepSpeedConfigError, match="exceeds"):
        InferenceEngine(model, config=_config(max_seq_len=512),
                        device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="cannot hold"):
        InferenceEngine(model, config=_config(num_pages=8), device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="required"):
        InferenceEngine(model, config={"inference": {"enabled": False}},
                        device="cpu")
