"""The serving engine's weight lifecycle and the prefix + speculative
soak against the JAX package's, on the CPU.

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
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
from torch_serving import (DRAFT, PREFIX_STATS, SIZE, SPEC_STATS,
                           assert_no_leaks, config, engines, pair, serve,
                           stream)

torch.set_num_threads(2)

BOTH = {"prefix_cache": {"enabled": True},
        "speculative": {"enabled": True, "num_draft_tokens": 2}}


@pytest.fixture(scope="module")
def models():
    """The GPT-NeoX target (seed 0) and the narrow draft (seed 3)."""
    return {"gpt_neox": {"target": pair("gpt_neox", SIZE, 0),
                         "draft": pair("gpt_neox", DRAFT, 3)}}


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
