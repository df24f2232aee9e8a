"""The port's "inference" config parser against the JAX package's: the
same blocks give equal dicts, and the same bad blocks raise
`DeepSpeedConfigError`."""

import pytest
import torch

from deeperspeed_tpu.runtime.config import \
    parse_inference_block as jax_parse
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.precision import \
    resolve_kv_cache_dtype as jax_resolve_kv
from deeperspeed_tpu_torch.runtime.config import parse_inference_block
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.precision import resolve_kv_cache_dtype

torch.set_num_threads(2)

VALID = [
    {},
    {"enabled": False},
    {"enabled": True},
    {"enabled": True, "page_size": 64, "num_pages": 513,
     "max_batch_size": 16, "token_budget": 2048,
     "prefill_batch_sizes": [4], "decode_batch_sizes": [16]},
    {"enabled": True, "page_size": 16, "max_seq_len": 256,
     "prefill_lengths": [16, 32, 64], "temperature": 0.7, "seed": 3,
     "kernel": "xla", "kv_cache_dtype": "BF16", "drain_deadline_s": 5,
     "default_priority": "batch", "hang_timeout_s": 1.5},
    {"enabled": True, "admission": {"max_queue_depth": 8,
                                    "shed_ttft_ema_ms": 250},
     "retry": {"max_attempts": 5, "jitter": 0.0}},
    {"enabled": True, "prefix_cache": {"enabled": True, "max_pages": 32},
     "speculative": {"enabled": True, "num_draft_tokens": 3}},
    {"enabled": True, "disaggregation": {"role": "prefill"},
     "router": {"ttft_weight": 0.5, "scale_up_util": 0.9}},
    {"enabled": True, "admission": {"enabled": False},
     "prefix_cache": {"enabled": False},
     "speculative": {"enabled": False}},
]

# the rejects of tests/test_inference.py::TestInferenceConfig, plus the
# sub-blocks' own
INVALID = [
    {"enabled": True, "page_szie": 128},
    {"enabled": "yes"},
    {"enabled": True, "page_size": 12},
    {"enabled": True, "num_pages": 1},
    {"enabled": True, "token_budget": 0},
    {"enabled": True, "prefill_lengths": []},
    {"enabled": True, "prefill_lengths": [256, 128]},
    {"enabled": True, "prefill_lengths": [100]},
    {"enabled": True, "max_batch_size": 8, "decode_batch_sizes": [1, 4]},
    {"enabled": True, "temperature": -1},
    {"enabled": True, "kernel": "cuda"},
    {"enabled": True, "kv_cache_dtype": "int7"},
    {"enabled": True, "admission": {"max_queue_depth": 0}},
    {"enabled": True, "retry": {"backoff_base_ms": 10,
                                "backoff_cap_ms": 5}},
    {"enabled": True, "speculative": {"enabled": True,
                                      "num_draft_tokens": 0}},
    {"enabled": True, "disaggregation": {"role": "router"}},
    {"enabled": True, "router": {"scale_up_util": 0}},
]


@pytest.mark.parametrize("block", VALID)
def test_same_dict(block):
    ours = parse_inference_block({"inference": block})
    ref = jax_parse({"inference": block})
    assert ours == ref


@pytest.mark.parametrize("block", INVALID)
def test_same_rejects(block):
    with pytest.raises(JaxConfigError):
        jax_parse({"inference": block})
    with pytest.raises(DeepSpeedConfigError):
        parse_inference_block({"inference": block})


def test_fault_injection_is_not_ported():
    block = {"enabled": True,
             "fault_injection": {"faults": [{"kind": "decode_error",
                                             "step": 1}]}}
    jax_parse({"inference": block})
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        parse_inference_block({"inference": block})


@pytest.mark.parametrize("spelling", ["bf16", "bfloat16", "fp32", "float",
                                      "half", "fp16", "int8"])
def test_kv_dtype_names(spelling):
    ours = resolve_kv_cache_dtype(spelling)
    ref = jax_resolve_kv(spelling)
    assert str(ours).replace("torch.", "") == ref.__name__


def test_kv_dtype_rejects():
    with pytest.raises(DeepSpeedConfigError):
        resolve_kv_cache_dtype("int4")
