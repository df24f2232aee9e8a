"""The port's speculative decoding and the serving engine's lifecycle
against the JAX package's, on the CPU.

- Speculative decoding: greedy output token-identical to the JAX
  engine's and to the port's non-speculative engine, at k = 1, 2 and 3,
  with window-0 requests, a draft equal to the target (every proposal
  accepted) and int8 draft weights; the same speculative stats, bucket
  programs and sampling-program counts as the JAX engine.
- Sampled mode: two engines draw the same tokens, and
  `restore_sampler_state` on a fresh engine reproduces a stream.
- The draft model's errors carry the JAX engine's messages.
- The weight lifecycle: `hot_swap_weights` drops the prefix registry with
  no new bucket program, and `load_checkpoint` reads a checkpoint the
  JAX package wrote; both then serve what the JAX engine serves.
- A prefix + speculative soak: tokens equal to the JAX engine's wave by
  wave, no new program once warm, no page leaked, every registered page
  held by the registry alone.
"""

import numpy as np
import pytest
import torch

import jax

import deeperspeed_tpu
from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, InferenceEngine
from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from torch_serving import (DRAFT, PREFIX_STATS, SIZE, SPEC_STATS,
                           assert_no_leaks, build_models, config, engines,
                           serve, stream)

torch.set_num_threads(2)

BOTH = {"prefix_cache": {"enabled": True},
        "speculative": {"enabled": True, "num_draft_tokens": 2}}


@pytest.fixture(scope="module")
def models():
    return build_models()


# ---------------------------------------------------------------------------
# speculative decoding against the JAX engine and the plain engine
# ---------------------------------------------------------------------------

SPEC_CASES = [
    ("gpt_neox", 1, "draft", None), ("gpt_neox", 3, "draft", None),
    ("gpt2", 1, "draft", None), ("gpt2", 3, "draft", None),
    ("gpt_neox", 3, "target", None), ("gpt_neox", 2, "draft", "int8"),
    ("gpt2", 2, "target", "int8"),
]


@pytest.mark.parametrize("family,k,draft,quant", SPEC_CASES)
def test_speculative_greedy_matches_jax_and_plain(models, family, k, draft,
                                                  quant):
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


# ---------------------------------------------------------------------------
# sampling streams
# ---------------------------------------------------------------------------

def test_sampled_mode_is_deterministic_and_restorable(models):
    conf = config(temperature=0.8, speculative=BOTH["speculative"])
    jeng, eng = engines(models, "gpt_neox", conf, "draft")
    # the snapshot's layout and the rejection sampler's seed are JAX's
    assert eng.sampler_state() == jeng.sampler_state()
    _, twin = engines(models, "gpt_neox", conf, "draft")
    first, second = stream(4, n=6), stream(5, n=6)
    news = [6] * 6
    assert serve(eng, first, news) == serve(twin, first, news)
    snap = eng.sampler_state()
    assert snap == twin.sampler_state() and snap["steps"] > 0
    want = serve(eng, second, news)
    _, fresh = engines(models, "gpt_neox", conf, "draft")
    fresh.restore_sampler_state(snap)
    assert fresh.sampler_state() == snap
    assert serve(fresh, second, news) == want
    assert all(len(o) == 6 for o in want)


# ---------------------------------------------------------------------------
# the draft model's checks
# ---------------------------------------------------------------------------

def _draft_cases():
    big_vocab = dict(DRAFT, vocab_size=1024)
    short = dict(DRAFT, max_seq_len=64)
    moe = dict(DRAFT, moe_num_experts=2)
    return {"missing": None, "vocab": big_vocab, "window": short,
            "moe": moe}


@pytest.mark.parametrize("case", ["missing", "vocab", "window", "moe"])
def test_draft_errors_match_jax(models, case):
    jmodel, jparams, model = models["gpt_neox"]["target"]
    size = _draft_cases()[case]
    jd = d = None
    if size is not None:
        jd = jneox.GPTNeoX(jneox.GPTNeoXConfig(**size), use_pallas=False)
        d = GPTNeoX(GPTNeoXConfig(**size), device="cpu")
    conf = config(speculative={"enabled": True})
    with pytest.raises(Exception) as want:
        JaxEngine(jmodel, config=conf, params=jparams, draft_model=jd)
    with pytest.raises(DeepSpeedConfigError) as got:
        InferenceEngine(model, config=conf, device="cpu", draft_model=d)
    assert type(want.value).__name__ == "DeepSpeedConfigError"
    assert str(got.value) == str(want.value)


def test_prefix_and_speculative_construct(models):
    _, _, model = models["gpt2"]["target"]
    _, _, draft = models["gpt2"]["draft"]
    eng = InferenceEngine(model, config=config(**BOTH), device="cpu",
                          draft_model=draft)
    assert eng.spec_k == 2 and eng.scheduler.spec_tokens == 2
    assert eng.scheduler.prefix_cache is eng.prefix_cache
    assert eng.cache.prefix_cache is eng.prefix_cache
    assert eng.draft_cache.num_pages == eng.cache.num_pages
    assert (eng.draft_cache.k.shape[0], eng.draft_cache.k.shape[2:]) == \
        (DRAFT["num_layers"], (DRAFT["num_heads"], 16,
                               DRAFT["hidden_size"] // DRAFT["num_heads"]))
    assert eng.compile_count() == 0 and eng.sampler_state()["steps"] == 0


# ---------------------------------------------------------------------------
# the weight lifecycle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def new_weights():
    """Seed-5 GPT-NeoX weights: the JAX tree and the port's state dict."""
    tree = jax.device_get(jneox.GPTNeoX(
        jneox.GPTNeoXConfig(**SIZE), use_pallas=False).init_params(
            jax.random.PRNGKey(5)))
    return tree, state_dict_from_jax(tree)


def test_hot_swap_clears_the_registry(models, new_weights):
    tree, flat = new_weights
    jeng, eng = engines(models, "gpt_neox", config(**BOTH), "draft")
    prompts = stream(6, n=6)
    news = [5] * 6
    for e in (eng, jeng):
        serve(e, prompts, news)
        assert e.prefix_cache.stats["registered_pages"] > 0
        # a waiting request holds its attached prefix pages
        e.submit(prompts[0], 5)
        assert e.scheduler.waiting[0].n_shared > 0
    swap = eng.hot_swap_weights(flat)
    jswap = jeng.hot_swap_weights(tree)
    assert swap["compile_delta"] == jswap["compile_delta"] == 0
    assert swap["swap_ms"] >= 0
    for e in (eng, jeng):
        assert e.prefix_cache.stats["registered_pages"] == 0
        assert all(r.n_shared == 0 for r in e.scheduler.waiting)
        e.run()
        e.scheduler.pop_finished()
    assert_no_leaks(eng)
    assert serve(eng, prompts, news) == serve(jeng, prompts, news)
    assert eng.compile_count() == jeng.compile_count()
    assert eng.params["embed"]["wte"].data_ptr() != \
        models["gpt_neox"]["target"][2].embed.wte.data_ptr()


def test_load_checkpoint_reads_a_jax_checkpoint(models, new_weights,
                                                tmp_path):
    tree, _ = new_weights
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    trainer, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jcfg, use_pallas=False), model_parameters=tree,
        mesh=mesh, config_params={
            "train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    trainer.save_checkpoint(str(tmp_path))
    jeng, eng = engines(models, "gpt_neox", config(**BOTH), "draft")
    assert eng.load_checkpoint(str(tmp_path / "missing")) == (None, {})
    prompts = stream(7, n=4)
    news = [5] * 4
    serve(eng, prompts, news)
    assert eng.prefix_cache.stats["registered_pages"] > 0
    path, client = eng.load_checkpoint(str(tmp_path))
    jpath, jclient = jeng.load_checkpoint(str(tmp_path))
    assert path == jpath and path.endswith("global_step0")
    assert client == jclient
    assert eng.prefix_cache.stats["registered_pages"] == 0
    assert serve(eng, prompts, news) == serve(jeng, prompts, news)


# ---------------------------------------------------------------------------
# both features: the soak
# ---------------------------------------------------------------------------

def test_prefix_speculative_soak_matches_jax(models):
    jeng, eng = engines(models, "gpt_neox",
                        config(num_pages=24, **BOTH), "draft")
    rng = np.random.default_rng(11)
    for wave in range(4):
        prompts = stream(int(rng.integers(99)), n=6)
        news = [int(n) for n in rng.integers(1, 9, size=6)]
        assert serve(eng, prompts, news) == serve(jeng, prompts, news)
        assert {k: eng.prefix_cache.stats[k] for k in PREFIX_STATS} == \
            {k: jeng.prefix_cache.stats[k] for k in PREFIX_STATS}
        assert {k: eng.stats[k] for k in SPEC_STATS} == \
            {k: jeng.stats[k] for k in SPEC_STATS}
        assert eng.compile_count() == jeng.compile_count()
        assert_no_leaks(eng)
    # one stream three times: the first runs the miss buckets, the second
    # the registry-hit ones, the third no new bucket program (the JAX
    # engine's steady-state pin)
    replay = stream(40, n=6)
    for _ in range(2):
        assert eng.generate(replay, 4) == jeng.generate(replay, 4)
    outputs, stats = eng.generate_rollouts(replay, 4)
    jout, jstats = jeng.generate_rollouts(replay, 4)
    assert outputs == jout
    assert stats["compile_delta"] == jstats["compile_delta"] == 0
    assert stats["spec_acceptance_rate"] == jstats["spec_acceptance_rate"]
    assert stats["rollout_tokens"] == sum(map(len, outputs)) == 24
    assert 0.0 <= stats["spec_acceptance_rate"] <= 1.0
    assert eng.prefix_cache.stats["reclaimed_pages"] > 0
    assert_no_leaks(eng)
    assert eng.serve_stats()["prefix_hit_rate"] > 0
