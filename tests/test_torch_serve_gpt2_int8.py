"""GPT-2 served with int8 block weights ("quantization": {"weights":
"int8"}) by the port's `InferenceEngine` against the JAX package's, on
the CPU, in fp32 (`test_torch_quant.py` holds GPT-NeoX to the same):

- every block matmul weight of both engines is a `QuantizedWeight`
  whose int8 values and fp32 scales are bit-equal, and every other leaf
  equal;
- the greedy tokens of a stream (ragged prompts, prefills across
  buckets, decode steps) are identical, with int8 weights alone and with
  int8 KV pages too, and no page is leaked;
- on CPU tensors no kernel launches (the int8 matmul's plain version).
"""

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.models import gpt2 as jgpt2
from deeperspeed_tpu.ops.pallas import quant_matmul as jqm
from deeperspeed_tpu_torch import GPT2, GPT2Config, InferenceEngine
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
BLOCK_WEIGHTS = (("attn", "qkv_w"), ("attn", "out_w"), ("mlp", "in_w"),
                 ("mlp", "out_w"))


def _config(kv=None):
    block = {"enabled": True, "page_size": 16, "num_pages": 40,
             "max_batch_size": 4, "token_budget": 256,
             "prefill_lengths": [16, 32, 64], "prefill_batch_sizes": [2],
             "decode_batch_sizes": [4]}
    if kv:
        block["kv_cache_dtype"] = kv
    return {"inference": block, "quantization": {"weights": "int8"}}


@pytest.fixture(scope="module")
def models():
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config(**SIZE), use_pallas=False)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    model = GPT2(GPT2Config(**SIZE), device="cpu").load_jax_params(jparams)
    return jmodel, jparams, model


def test_int8_leaves_bit_equal(models):
    jmodel, jparams, model = models
    jeng = JaxEngine(jmodel, config=_config(), params=jparams)
    eng = InferenceEngine(model, config=_config(), device="cpu")
    assert eng.weight_quant == "int8" and eng.dtypes["weight"] == "int8"
    assert {k: v.replace("torch.", "") for k, v in eng.dtypes.items()} == \
        jeng.dtypes
    for i, (ours, theirs) in enumerate(zip(eng.params["blocks"],
                                           jeng.params["blocks"])):
        for group, name in BLOCK_WEIGHTS:
            q, jq = ours[group][name], theirs[group][name]
            assert isinstance(q, qm.QuantizedWeight), (i, group, name)
            assert isinstance(jq, jqm.QuantizedWeight)
            assert q.qval.dtype == torch.int8
            np.testing.assert_array_equal(q.qval.numpy(),
                                          np.asarray(jq.qval))
            np.testing.assert_array_equal(q.scale.numpy(),
                                          np.asarray(jq.scale))
        for group, leaves in ours.items():
            for name, leaf in leaves.items():
                if (group, name) in BLOCK_WEIGHTS:
                    continue
                np.testing.assert_array_equal(
                    leaf.numpy(), np.asarray(theirs[group][name]),
                    err_msg=f"blocks.{i}.{group}.{name}")
    np.testing.assert_array_equal(eng.params["embed"]["wte"].numpy(),
                                  np.asarray(jeng.params["embed"]["wte"]))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_greedy_tokens_match_the_jax_engine(models, kv):
    jmodel, jparams, model = models
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 512, size=n))
               for n in (5, 17, 33, 60, 9)]
    counts = (qm.launches, da.launches, da.launches_int8, fa.launches)
    want = JaxEngine(jmodel, config=_config(kv), params=jparams).generate(
        prompts, max_new_tokens=12)
    eng = InferenceEngine(model, config=_config(kv), device="cpu")
    assert eng.generate(prompts, max_new_tokens=12) == want
    assert eng.cache.num_free == eng.cache.num_pages - 1
    assert eng.kv_quant == bool(kv)
    assert (qm.launches, da.launches, da.launches_int8,
            fa.launches) == counts
