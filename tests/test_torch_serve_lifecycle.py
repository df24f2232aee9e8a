"""The port's speculative decoding against the JAX package's, on the
CPU, with GPT-NeoX (GPT-2: `test_torch_serve_spec_gpt2.py`; the weight
lifecycle and the prefix + speculative soak: `test_torch_serve_weights.py`).

- Speculative decoding: greedy output token-identical to the JAX
  engine's and to the port's non-speculative engine, at k = 1, 2 and 3,
  with window-0 requests, a draft equal to the target (every proposal
  accepted) and int8 draft weights; the same speculative stats, bucket
  programs and sampling-program counts as the JAX engine.
- Sampled mode: two engines draw the same tokens, and
  `restore_sampler_state` on a fresh engine reproduces a stream.
- The draft model's errors carry the JAX engine's messages.
"""

import pytest
import torch

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, InferenceEngine
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from torch_serving import (DRAFT, build_models, check_speculative_greedy,
                           config, engines, serve, stream)

torch.set_num_threads(2)

BOTH = {"prefix_cache": {"enabled": True},
        "speculative": {"enabled": True, "num_draft_tokens": 2}}


@pytest.fixture(scope="module")
def models():
    return build_models(("gpt_neox",))


# ---------------------------------------------------------------------------
# speculative decoding against the JAX engine and the plain engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,draft,quant", [
    (1, "draft", None), (3, "draft", None), (3, "target", None),
    (2, "draft", "int8")])
def test_speculative_greedy_matches_jax_and_plain(models, k, draft, quant):
    """GPT-NeoX; the GPT-2 cases are in `test_torch_serve_spec_gpt2.py`."""
    check_speculative_greedy(models, "gpt_neox", k, draft, quant)


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
