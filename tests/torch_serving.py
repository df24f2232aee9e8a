"""Shared set-up of the port's serving tests (`test_torch_prefix_spec.py`,
`test_torch_serve_lifecycle.py`, `test_torch_serving_robustness.py`,
`test_torch_serve_chaos.py`): tiny GPT-NeoX and GPT-2 targets and drafts
made in JAX and carried into the port, the engines on both sides, a
shared-prefix request stream, the serving loop both engines drive, and a
fake clock that both serving engines can run on."""

import types

import numpy as np
import pytest

import jax

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.models import gpt2 as jgpt2
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu_torch import GPT2, GPT2Config, GPTNeoX, GPTNeoXConfig
from deeperspeed_tpu_torch import InferenceEngine

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
# the draft: narrower, with head dim 16 (the plain decode path on a card)
DRAFT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=128)
FAMILIES = {
    "gpt_neox": (jneox.GPTNeoXConfig, jneox.GPTNeoX, GPTNeoXConfig, GPTNeoX),
    "gpt2": (jgpt2.GPT2Config, jgpt2.GPT2, GPT2Config, GPT2),
}
PREFIX_STATS = ("lookups", "hits", "pages_shared", "saved_prefill_tokens",
                "registered_pages", "reclaimed_pages")
SPEC_STATS = ("spec_steps", "spec_proposed", "spec_accepted")


def config(**kw):
    block = {"enabled": True, "page_size": 16, "num_pages": 40,
             "max_batch_size": 4, "token_budget": 256,
             "prefill_lengths": [16, 32, 64, 128],
             "prefill_batch_sizes": [1, 2], "decode_batch_sizes": [2, 4]}
    block.update(kw)
    return {"inference": block}


def pair(family, size, seed):
    """(JAX model, its params, the port model holding the same weights)."""
    jcfg_cls, jmodel_cls, cfg_cls, model_cls = FAMILIES[family]
    jmodel = jmodel_cls(jcfg_cls(**size), use_pallas=False)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(seed)))
    model = model_cls(cfg_cls(**size), device="cpu").load_jax_params(jparams)
    return jmodel, jparams, model


def build_models(families=tuple(FAMILIES)):
    """Per family: the target (seed 0) and the narrow draft (seed 3)."""
    return {family: {"target": pair(family, SIZE, 0),
                     "draft": pair(family, DRAFT, 3)}
            for family in families}


def engines(models, family, conf, draft=None):
    """The JAX engine and the port engine on ``conf``; ``draft`` "draft"
    serves the narrow draft, "target" a copy of the target's weights."""
    jmodel, jparams, model = models[family]["target"]
    jkw, kw = {}, {}
    if draft is not None:
        jd, jdp, d = models[family][draft]
        if draft == "target":
            jd = type(jd)(jd.config, use_pallas=False)
            d = type(d)(d.config, device="cpu").load_jax_params(jdp)
        jkw = {"draft_model": jd, "draft_params": jdp}
        kw = {"draft_model": d}
    return (JaxEngine(jmodel, config=conf, params=jparams, **jkw),
            InferenceEngine(model, config=conf, device="cpu", **kw))


def stream(seed, n=8, prefix_len=40, vocab=512):
    """A bursty shared-prefix stream: three of four prompts start with one
    40-token prefix (two and a half pages), the fourth is cold."""
    rng = np.random.default_rng(seed)
    prefix = list(rng.integers(1, vocab, size=prefix_len))
    out = []
    for i in range(n):
        tail = list(rng.integers(1, vocab, size=int(rng.integers(3, 20))))
        cold = list(rng.integers(1, vocab, size=prefix_len))
        out.append((cold if i % 4 == 3 else prefix) + tail)
    return out


def serve(eng, prompts, news):
    """Submit each prompt with its own max_new_tokens, drain, and return
    the generated lists in submission order (the JAX engine and the port
    share this API)."""
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    done = {}
    while eng.scheduler.has_work:
        eng.step()
        for r in eng.scheduler.pop_finished():
            done[r.request_id] = r
    return [list(done[i].generated) for i in ids]


def check_speculative_greedy(models, family, k, draft, quant):
    """Speculative greedy output at depth ``k`` (``draft`` "draft" or
    "target", int8 draft weights under ``quant``) equals the JAX engine's
    and the port's non-speculative engine's, with the JAX engine's
    speculative stats, bucket programs and sampling-program count, and no
    kernel launched on the CPU."""
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    spec = {"enabled": True, "num_draft_tokens": k}
    if quant:
        spec["draft_weight_quant"] = quant
    jeng, eng = engines(models, family, config(speculative=spec), draft)
    _, plain = engines(models, family, config())
    prompts = stream(2, n=6)
    # max_new_tokens 2 leaves a window of 0 at its one decode step
    news = [9, 2, 6, 1, 12, 2]
    want = serve(plain, prompts, news)
    assert serve(eng, prompts, news) == want
    assert serve(jeng, prompts, news) == want
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: jeng.stats[k] for k in SPEC_STATS}
    assert eng.compile_count() == jeng.compile_count()
    assert eng.sampler_state()["steps"] == jeng.sampler_state()["steps"]
    assert eng.stats["spec_steps"] > 0
    if draft == "target" and not quant:
        # the draft is the target: every proposal is the target's argmax
        assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"] > 0
    assert eng.cache.num_free == eng.cache.num_pages - 1
    assert eng.serve_stats()["spec_acceptance_rate"] == pytest.approx(
        eng.stats["spec_accepted"] / eng.stats["spec_proposed"])
    assert (fa.launches, da.launches, da.launches_int8) == (0, 0, 0)


def assert_no_leaks(eng):
    """Every page but the registry's is free, and each registered page is
    held by the registry alone."""
    pc = eng.prefix_cache
    reg = pc.stats["registered_pages"] if pc is not None else 0
    assert eng.cache.num_free == eng.cache.num_pages - 1 - reg
    assert sorted(eng.cache._refcount.values()) == [1] * reg


class FakeClock:
    """A clock that stands still until it is slept on or ticked: the
    serving engines' wall-clock parts (backoff windows, deadlines, the
    TTFT EMA, the drain deadline) then depend on the steps taken, not on
    how fast JAX or torch runs them."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def perf_counter(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(float(seconds), 0.0)

    tick = sleep

    def module(self):
        """A stand-in for the ``time`` module of an engine module."""
        return types.SimpleNamespace(perf_counter=self.perf_counter,
                                     sleep=self.sleep)


def fake_clocks(monkeypatch):
    """Patch the ``time`` of the JAX and the port's engine modules with a
    fake clock each → (JAX clock, port clock). The schedulers take the
    engine's ``now``; an engine's admission controller gets its clock
    from `on_clock`."""
    import deeperspeed_tpu.inference.engine as jax_engine_mod
    import deeperspeed_tpu_torch.inference.engine as engine_mod
    clocks = FakeClock(), FakeClock()
    for mod, clock in zip((jax_engine_mod, engine_mod), clocks):
        monkeypatch.setattr(mod, "time", clock.module())
    return clocks


def on_clock(eng, clock):
    """Point ``eng``'s admission controller (if any) at ``clock``."""
    if eng.admission is not None:
        eng.admission._clock = clock.perf_counter
    return eng
