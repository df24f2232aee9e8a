"""The port's "inference", "quantization" and "moe" config parsers
against the JAX package's: the same blocks give equal dicts, and the
same bad blocks raise `DeepSpeedConfigError`."""

import pytest
import torch

from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config import \
    parse_inference_block as jax_parse
from deeperspeed_tpu.runtime.config import \
    parse_quantization_block as jax_parse_quant
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.precision import \
    resolve_kv_cache_dtype as jax_resolve_kv
from deeperspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                  parse_inference_block,
                                                  parse_quantization_block)
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
    {"enabled": True, "page_size": 32, "kernel": "pallas",
     "kv_cache_dtype": "int8"},
    {"enabled": True, "page_size": 16, "kernel": "xla",
     "kv_cache_dtype": "INT8"},
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
    {"enabled": True, "page_size": 16, "kernel": "pallas",
     "kv_cache_dtype": "int8"},
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
    """The block raised "not ported" until the serving robustness slice;
    the port now parses it as the JAX package does, to the same dict."""
    block = {"enabled": True,
             "fault_injection": {"faults": [{"kind": "decode_error",
                                             "step": 1}]}}
    assert parse_inference_block({"inference": block}) == \
        jax_parse({"inference": block})


@pytest.mark.parametrize("spelling", ["bf16", "bfloat16", "fp32", "float",
                                      "half", "fp16", "int8"])
def test_kv_dtype_names(spelling):
    ours = resolve_kv_cache_dtype(spelling)
    ref = jax_resolve_kv(spelling)
    assert str(ours).replace("torch.", "") == ref.__name__


def test_kv_dtype_rejects():
    with pytest.raises(DeepSpeedConfigError):
        resolve_kv_cache_dtype("int4")


def test_int8_pallas_page_size_rejects_like_jax():
    """The JAX schema error for a forced kernel with int8 pages whose
    page_size is no multiple of 32, with the same message in both."""
    block = {"enabled": True, "page_size": 48, "kernel": "pallas",
             "kv_cache_dtype": "int8"}
    with pytest.raises(JaxConfigError) as jerr:
        jax_parse({"inference": block})
    with pytest.raises(DeepSpeedConfigError) as terr:
        parse_inference_block({"inference": block})
    assert str(terr.value) == str(jerr.value)
    assert "page_size % 32 == 0" in str(terr.value)
    block["kernel"] = "auto"
    assert parse_inference_block({"inference": block}) == \
        jax_parse({"inference": block})


QUANT_VALID = [
    None, {}, {"enabled": False, "weights": "int8"}, {"weights": "int8"},
    {"weights": None, "ffn": {"recipe": "fp8", "amax_history_len": 4,
                              "margin": 2}},
    {"gradient_compression": {"enabled": True, "packed_wire": True}},
    {"gradient_compression": {"enabled": False, "packed_wire": True}},
]
QUANT_INVALID = [
    "int8", {"enabled": "yes"}, {"weights": "int4"}, {"weigths": "int8"},
    {"ffn": []}, {"ffn": {"recipe": "int4"}},
    {"ffn": {"recipe": "int8", "amax_history_len": 0}},
    {"ffn": {"recipe": "int8", "margin": 0}},
    {"ffn": {"recipe": "int8", "window": 3}},
    {"gradient_compression": True},
    {"gradient_compression": {"enabled": 1}},
    {"gradient_compression": {"packed_wire": "no"}},
]


@pytest.mark.parametrize("block", QUANT_VALID)
def test_quantization_block_same_dict(block):
    d = {} if block is None else {"quantization": block}
    assert parse_quantization_block(d) == jax_parse_quant(d)


@pytest.mark.parametrize("block", QUANT_INVALID)
def test_quantization_block_same_rejects(block):
    d = {"quantization": block}
    with pytest.raises(JaxConfigError) as jerr:
        jax_parse_quant(d)
    with pytest.raises(DeepSpeedConfigError) as terr:
        parse_quantization_block(d)
    assert str(terr.value) == str(jerr.value)


MOE_VALID = [
    None, {}, {"enabled": False}, {"enabled": False, "num_experts": 8},
    {"num_experts": 8},
    {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25,
     "dispatch": "sort"},
    {"enabled": True, "num_experts": 4, "top_k": 1, "capacity_factor": 2,
     "jitter_eps": 0.1, "aux_loss_coef": 0.0, "num_groups": 0,
     "dispatch": "einsum", "a2a_overlap_chunks": 2,
     "renorm_kept_choices": True, "observability": False},
]
MOE_INVALID = [
    {"num_experts": 8, "topk": 2},
    {"enabled": True},
    {"enabled": True, "num_experts": -1},
    {"num_experts": "many"},
    {"num_experts": 8, "top_k": 3},
    {"num_experts": 8, "capacity_factor": 0},
    {"num_experts": 8, "capacity_factor": "big"},
    {"num_experts": 8, "jitter_eps": -0.1},
    {"num_experts": 8, "aux_loss_coef": -1},
    {"num_experts": 8, "num_groups": -1},
    {"num_experts": 8, "dispatch": "scatter"},
    {"num_experts": 8, "a2a_overlap_chunks": 0},
    {"num_experts": 8, "renorm_kept_choices": "yes"},
    {"num_experts": 8, "observability": 1},
    {"num_experts": 8, "observability": True},      # needs dispatch "sort"
]


def _moe_conf(block):
    conf = {"train_batch_size": 4}
    if block is not None:
        conf["moe"] = block
    return conf


@pytest.mark.parametrize("block", MOE_VALID)
def test_moe_block_same_params(block):
    ours = DeepSpeedConfig(_moe_conf(block))
    ref = JaxConfig(_moe_conf(block), world_size=1)
    assert ours.moe_enabled == ref.moe_enabled
    assert ours.moe_params == ref.moe_params


@pytest.mark.parametrize("block", MOE_INVALID)
def test_moe_block_same_rejects(block):
    with pytest.raises(JaxConfigError) as jerr:
        JaxConfig(_moe_conf(block), world_size=1)
    with pytest.raises(DeepSpeedConfigError) as terr:
        DeepSpeedConfig(_moe_conf(block))
    assert str(terr.value) == str(jerr.value)


def test_moe_observability_is_not_ported():
    """``moe.observability`` with sort dispatch is ported since: the
    port parses it into the JAX package's moe params."""
    block = {"num_experts": 8, "dispatch": "sort", "observability": True}
    ref = JaxConfig(_moe_conf(block), world_size=1).moe_params
    assert ref["observability"]
    assert DeepSpeedConfig(_moe_conf(block)).moe_params == ref
