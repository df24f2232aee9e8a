"""The port's speculative decoding of GPT-2 against the JAX package's,
on the CPU (GPT-NeoX: `test_torch_serve_lifecycle.py`): greedy output
token-identical to the JAX engine's and to the port's non-speculative
engine at k = 1, 2 and 3, with a draft equal to the target and int8
draft weights, and an engine with both the prefix cache and speculation
built over the shared allocator."""

import pytest
import torch

from deeperspeed_tpu_torch import InferenceEngine
from torch_serving import (DRAFT, build_models, check_speculative_greedy,
                           config)

torch.set_num_threads(2)

BOTH = {"prefix_cache": {"enabled": True},
        "speculative": {"enabled": True, "num_draft_tokens": 2}}


@pytest.fixture(scope="module")
def models():
    return build_models(("gpt2",))


@pytest.mark.parametrize("k,draft,quant", [
    (1, "draft", None), (3, "draft", None), (2, "target", "int8")])
def test_speculative_greedy_matches_jax_and_plain(models, k, draft, quant):
    check_speculative_greedy(models, "gpt2", k, draft, quant)


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
