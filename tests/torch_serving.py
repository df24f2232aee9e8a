"""Shared set-up of the port's prefix-cache and speculative serving tests
(`test_torch_prefix_spec.py`, `test_torch_serve_lifecycle.py`): tiny
GPT-NeoX and GPT-2 targets and drafts made in JAX and carried into the
port, the engines on both sides, a shared-prefix request stream and the
serving loop both engines drive."""

import numpy as np

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


def build_models():
    """Per family: the target (seed 0) and the narrow draft (seed 3)."""
    return {family: {"target": pair(family, SIZE, 0),
                     "draft": pair(family, DRAFT, 3)}
            for family in FAMILIES}


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


def assert_no_leaks(eng):
    """Every page but the registry's is free, and each registered page is
    held by the registry alone."""
    pc = eng.prefix_cache
    reg = pc.stats["registered_pages"] if pc is not None else 0
    assert eng.cache.num_free == eng.cache.num_pages - 1 - reg
    assert sorted(eng.cache._refcount.values()) == [1] * reg
