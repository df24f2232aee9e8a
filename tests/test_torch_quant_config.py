"""The training side of the "quantization" block in the port against
the JAX package, on the CPU (set-up in `torch_quant.py`):

- `DeepSpeedConfig.quantization_config` equal to the JAX config's for
  the same blocks ("weights" in a training config is parsed and read by
  nothing, as in JAX); a bad block raises `DeepSpeedConfigError` with
  the JAX message; an enabled ``gradient_compression`` raises "not
  ported" (it needs the explicit ZeRO-3 schedule and a data-parallel
  world: scale-out);
- every refusal of the JAX engine's `_configure_quantization` and of
  the model, with the JAX error type and words: progressive layer drop,
  ``number_checkpoints``, the legacy ``forward``, GPT-2 and BERT (their
  `apply_ds_config`), a client module without ``init_ffn_amax`` and one
  without ``apply_ds_config``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

import deeperspeed_tpu
from deeperspeed_tpu.models import bert as jbert
from deeperspeed_tpu.models import gpt2 as jgpt2
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch import (GPT2, BertConfig, BertForPreTraining,
                                   GPT2Config)
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

from torch_quant import (BATCH, conf, jax_engine, port_engine,
                         tokens, weights)

torch.set_num_threads(2)

__all__ = ["weights"]

BASE = {"train_batch_size": 4}

VALID = [
    None,
    {"enabled": False, "ffn": {"recipe": "fp8"}},
    {"ffn": {"recipe": "fp8"}},
    {"ffn": {"recipe": "int8", "amax_history_len": 1, "margin": 2}},
    {"weights": "int8"},
    {"weights": "int8", "ffn": {"recipe": "fp8", "margin": 0.5}},
    {"gradient_compression": {"enabled": False, "packed_wire": True}},
]

INVALID = [
    "fp8",
    {"ffn": "fp8"},
    {"ffn": {}},
    {"ffn": {"recipe": "int4"}},
    {"ffn": {"recipe": "fp8", "amax_history_len": 0}},
    {"ffn": {"recipe": "fp8", "amax_history_len": 2.5}},
    {"ffn": {"recipe": "fp8", "margin": 0}},
    {"ffn": {"recipe": "fp8", "margin": True}},
    {"ffn": {"recipe": "fp8", "history": 4}},
    {"weights": "int4"},
    {"enabled": "yes"},
    {"typo": 1},
    {"gradient_compression": {"enabled": 1}},
    {"gradient_compression": {"packed": True}},
]


def _cfg(block):
    return dict(BASE) if block is None else {**BASE, "quantization": block}


@pytest.mark.parametrize("block", VALID)
def test_quantization_config_same_as_jax(block):
    ours = DeepSpeedConfig(_cfg(block))
    ref = JaxConfig(_cfg(block), world_size=1)
    assert ours.quantization_config == ref.quantization_config


@pytest.mark.parametrize("block", INVALID)
def test_bad_blocks_raise_the_jax_message(block):
    with pytest.raises(JaxConfigError) as theirs:
        JaxConfig(_cfg(block), world_size=1)
    with pytest.raises(DeepSpeedConfigError) as ours:
        DeepSpeedConfig(_cfg(block))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("gc", [{}, {"enabled": True},
                                {"enabled": True, "packed_wire": True}])
def test_gradient_compression_is_not_ported(gc):
    with pytest.raises(DeepSpeedConfigError,
                       match="gradient_compression is not ported yet.*A.7"):
        DeepSpeedConfig(_cfg({"gradient_compression": gc}))


def test_weights_block_trains_full_precision(weights):
    eng = port_engine(weights, {**conf(), "quantization": {
        "weights": "int8"}})
    assert eng.quant is None and eng.module.config.ffn_quant_recipe is None


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _same_error(jax_call, port_call, etype):
    with pytest.raises(etype) as theirs:
        jax_call()
    with pytest.raises(etype) as ours:
        port_call()
    assert str(ours.value) == str(theirs.value)
    return str(ours.value)


def test_progressive_layer_drop_refused(weights):
    config = conf(progressive_layer_drop={"enabled": True, "theta": 0.5,
                                          "gamma": 0.001})
    msg = _same_error(lambda: jax_engine(weights, config),
                      lambda: port_engine(weights, config),
                      (DeepSpeedConfigError, JaxConfigError))
    assert "progressive_layer_drop" in msg


def test_number_checkpoints_refused(weights):
    config = conf(activation_checkpointing={"number_checkpoints": 2})
    toks = tokens(0)
    jeng, eng = jax_engine(weights, config), port_engine(weights, config)
    msg = _same_error(lambda: jeng.train_batch(batch=(toks, toks)),
                      lambda: eng.train_batch(batch=(toks, toks)),
                      ValueError)
    assert "number_checkpoints" in msg


def test_legacy_forward_refused(weights):
    toks = np.zeros((BATCH, 32), np.int32)
    jeng, eng = jax_engine(weights, conf()), port_engine(weights, conf())
    msg = _same_error(lambda: jeng.forward((toks, toks)),
                      lambda: eng.forward((toks, toks)), RuntimeError)
    assert "train_batch" in msg


def test_gpt2_and_bert_refused():
    """Their apply_ds_config refuses the block before any state is
    built (so neither reaches the init_ffn_amax check)."""
    gsize = dict(vocab_size=128, hidden_size=32, num_layers=2,
                 num_heads=4, max_seq_len=64)
    jg = jgpt2.GPT2(jgpt2.GPT2Config(**gsize), use_pallas=False)
    gparams = jax.device_get(jg.init_params(jax.random.PRNGKey(0)))
    msg = _same_error(
        lambda: deeperspeed_tpu.initialize(model=jg, model_parameters=gparams,
                                           config_params=conf(),
                                           mesh=_mesh()),
        lambda: dst.initialize(model=GPT2(GPT2Config(**gsize), device="cpu"),
                               config_params=conf()),
        NotImplementedError)
    assert msg.startswith("GPT2 does not implement the quantization.ffn")
    jb = jbert.BertForPreTraining(jbert.BertConfig.tiny())
    msg = _same_error(
        lambda: deeperspeed_tpu.initialize(
            model=jb, model_parameters=jax.device_get(
                jb.init_params(jax.random.PRNGKey(0))),
            config_params=conf(), mesh=_mesh()),
        lambda: dst.initialize(
            model=BertForPreTraining(BertConfig.tiny(), device="cpu"),
            config_params=conf()),
        NotImplementedError)
    assert msg.startswith("BERT does not implement the quantization.ffn")


class JaxBareClient:
    """A client module of the JAX engine: a linear least-squares loss."""

    def loss_fn(self, params, batch, rng=None):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2)


class JaxClient(JaxBareClient):
    def apply_ds_config(self, ds_config, mesh=None):
        pass


class BareClient(torch.nn.Module):
    """The same client module for the port."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4, 4))

    def params_tree(self):
        return {"w": self.w}

    def loss_fn(self, params, batch, rng=None):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()


class Client(BareClient):
    def apply_ds_config(self, ds_config):
        pass


def test_client_modules_refused():
    mesh = _mesh()
    params = {"w": np.zeros((4, 4), np.float32)}
    config = conf()

    def jax_init(model):
        return lambda: deeperspeed_tpu.initialize(
            model=model, model_parameters=params, config_params=config,
            mesh=mesh)
    msg = _same_error(jax_init(JaxClient()),
                      lambda: dst.initialize(model=Client(),
                                             config_params=config),
                      (DeepSpeedConfigError, JaxConfigError))
    assert msg.startswith("quantization.ffn needs a model exposing "
                          "init_ffn_amax()")
    # without apply_ds_config: refused before the state is built (each
    # message names its package's signature of the method)
    for call in (jax_init(JaxBareClient()),
                 lambda: dst.initialize(model=BareClient(),
                                        config_params=config)):
        with pytest.raises((DeepSpeedConfigError, JaxConfigError),
                           match="does not implement apply_ds_config"):
            call()
