"""Shared set-up of the quantized-training tests
(`test_torch_quant_engine.py`, `test_torch_quant_resume.py`,
`test_torch_quant_config.py`): the tiny GPT-NeoX of
`tests/test_quantization.py`'s engine tests on both sides, made from
one JAX seed, the "quantization.ffn" config and the engines.

Tolerances of the comparisons with the JAX engine, in fp32: losses rtol
1e-5; amax histories rtol 1e-5 while both engines hold the same weights
(the first step) and rtol 2e-2 after that. A one-ulp difference (the
two frameworks sum in other orders, and XLA's CPU jit computes the
straight-through add with an FMA) can move one element across an fp8 or
int8 rounding boundary, a step of up to 2^-3 of its value, and the amax
of the next layer's input follows it.
"""

import copy

import numpy as np
import pytest

import jax

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox

SIZE = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
            max_seq_len=64)
SEQ, BATCH, HIST = 32, 8, 4
LOSS_RTOL, AMAX_RTOL_SAME, AMAX_RTOL = 1e-5, 1e-5, 2e-2


def conf(recipe="int8", gas=1, **extra):
    out = {"train_batch_size": BATCH,
           "train_micro_batch_size_per_gpu": BATCH // gas,
           "gradient_accumulation_steps": gas, "steps_per_print": 10_000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "quantization": {"ffn": {"recipe": recipe,
                                    "amax_history_len": HIST}}}
    out.update(copy.deepcopy(extra))
    return out


@pytest.fixture(scope="module")
def weights():
    return jax.device_get(jneox.init_params(jneox.GPTNeoXConfig(**SIZE),
                                            jax.random.PRNGKey(0)))


def tokens(seed, gas=1):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], (gas, BATCH // gas, SEQ)).astype(np.int32)


def jax_engine(jparams, config, **size):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    eng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jneox.GPTNeoXConfig(**{**SIZE, **size}),
                            use_pallas=False),
        model_parameters=jparams, config_params=config, mesh=mesh)
    return eng


def port_engine(jparams, config, **size):
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**{**SIZE, **size}),
                         device="cpu")
    eng, *_ = dst.initialize(model=model, model_parameters=jparams,
                             config_params=config)
    return eng


def jax_amax(eng):
    return np.asarray(jax.device_get(eng.state.quant.amax))
