"""The lean training state against the JAX package's, on the CPU.

``fp16.fp16_master_weights_and_grads`` makes the bf16 compute parameters
the masters (no fp32 copy of the model), and Adam's ``state_dtype:
"bfloat16"`` rests the moments in bf16 with the math in fp32:

- the flat Adam's plain version on bf16 p, m and v against the JAX
  `FusedAdam(state_dtype="bfloat16").update` over three steps: within
  one bf16 ulp (the JAX update rounds 1 - beta in Python, as the plain
  version does, but XLA may fuse multiply-adds, so the fp32 results may
  differ in their last bit before the one bf16 rounding);
- three bf16 lean `train_batch` steps against the JAX engine at one and
  at two micro-batches a step (losses rtol 2e-2, as the bf16 tests of
  `test_torch_train_engine.py`), with the state the JAX engine keeps:
  bf16 masters that are the parameters, bf16 moments, and an fp32
  accumulator only across micro-batches;
- the refusals with ZeRO stages and with the host-offload tier, with
  the JAX engine's messages;
- a lean checkpoint loaded by the port (the resumed steps bit for bit)
  and by the JAX engine, and a JAX lean checkpoint loaded by the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt2 as jgpt2
from deeperspeed_tpu.ops.adam.fused_adam import FusedAdam as JaxFusedAdam
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt2
from deeperspeed_tpu_torch.models.convert import (flat_from_jax,
                                                  state_dict_from_jax)
from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

SIZE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=128)
S = 128
LEAN = {"enabled": True, "type": "bfloat16",
        "fp16_master_weights_and_grads": True}


def _ulps(got, want):
    """|got - want| in bf16 ulps of want, elementwise."""
    g, w = got.float().numpy(), want.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    return np.abs(g - w) / ulp


def test_bf16_moments_match_the_jax_fused_adam():
    rng = np.random.default_rng(0)
    n = 4099
    p = jnp.asarray(rng.standard_normal(n), jnp.bfloat16)
    hp = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)
    jopt = JaxFusedAdam(state_dtype="bfloat16", **hp)
    jstate = jopt.init_state(p)
    opt = FusedAdam(state_dtype="bfloat16", **hp)
    tp = torch.from_numpy(np.asarray(p.astype(jnp.float32))) \
        .to(torch.bfloat16)
    state = opt.init_state(tp)
    assert state.exp_avg.dtype == torch.bfloat16
    for step in range(3):
        g = rng.standard_normal(n).astype(np.float32)
        p, jstate = jopt.update(jnp.asarray(g), jstate, p)
        p = p.astype(jnp.bfloat16)          # what the JAX engine stores
        state = opt.update(torch.from_numpy(g), state, tp)
        assert tp.dtype == state.exp_avg.dtype == torch.bfloat16
        for got, want in ((tp, p), (state.exp_avg, jstate.exp_avg),
                          (state.exp_avg_sq, jstate.exp_avg_sq)):
            want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
            assert _ulps(got, want).max() <= 1, step
    assert state.step == int(jstate.step) == 3
    # fp16 moments are the lean fp16 state's (the kernel's fp16 lean
    # variant); a dtype the kernel has no storage for is refused
    assert FusedAdam(state_dtype="float16").state_dtype == torch.float16
    with pytest.raises(ValueError, match="state_dtype"):
        FusedAdam(state_dtype="float64")


def _config(gas, **extra):
    conf = {"train_batch_size": 2 * gas, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
                "weight_decay": 0.01, "state_dtype": "bfloat16"}},
            "fp16": LEAN, "zero_optimization": {"stage": 0}}
    conf.update(extra)
    return conf


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jgpt2.init_params(jgpt2.GPT2Config(**SIZE),
                                            jax.random.PRNGKey(0)))


def _jax_engine(jparams, conf):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return deeperspeed_tpu.initialize(
        model=jgpt2.GPT2(jgpt2.GPT2Config(**SIZE), use_pallas=False),
        model_parameters=jparams, config_params=conf, mesh=mesh)[0]


def _port_engine(jparams, conf):
    return dst.initialize(model=gpt2.GPT2(gpt2.GPT2Config(**SIZE),
                                          device="cpu"),
                          model_parameters=jparams, config_params=conf)[0]


def _tokens(seed, gas):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=(gas, 2, S)).astype(np.int32)


@pytest.mark.parametrize("gas", [1, 2])
def test_lean_steps_match_jax(jparams, gas):
    conf = _config(gas, gradient_clipping=1.0)
    tokens = _tokens(1, gas)
    jeng = _jax_engine(jparams, conf)
    eng = _port_engine(jparams, conf)
    assert not eng.keep_master and not jeng.keep_master
    assert jeng.state.master is None
    # no fp32 copy of the model: the flat bf16 parameters are the masters
    assert eng._master is eng._params_flat
    assert eng._master.dtype == eng.opt_state.exp_avg.dtype == torch.bfloat16
    assert eng._grad_acc.dtype == (torch.bfloat16 if gas == 1
                                   else torch.float32)
    losses = np.array([(float(jeng.train_batch(batch=(tokens, tokens))),
                        eng.train_batch(batch=(tokens, tokens)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=2e-2)
    assert losses[-1, 1] < losses[0, 1]
    params = state_dict_from_jax(jax.device_get(jeng.state.params))
    for name, p in eng.module.named_parameters():
        assert p.dtype == torch.bfloat16
        err = _ulps(p.detach(), params[name])
        diff = np.abs(p.detach().float().numpy() -
                      params[name].float().numpy())
        assert ((err <= 2) | (diff <= 2e-2)).all(), name
    assert eng.opt_state.step == int(jeng.state.opt_state.step) == 3


ZERO_CASES = [{"stage": 1}, {"stage": 2},
              {"stage": 2, "offload_optimizer": {"device": "cpu"}},
              {"stage": 0, "offload_optimizer": {"device": "cpu"}}]


@pytest.mark.parametrize("zero", ZERO_CASES,
                         ids=["stage1", "stage2", "stage2-offload",
                              "stage0-offload"])
def test_refusals_match_jax(jparams, zero):
    conf = _config(1, zero_optimization=zero)
    with pytest.raises(JaxConfigError) as jerr:
        _jax_engine(jparams, conf)
    with pytest.raises(DeepSpeedConfigError) as err:
        _port_engine(jparams, conf)
    assert str(err.value) == str(jerr.value)
    assert "fp16_master_weights_and_grads" in str(err.value)


def _state(eng):
    return (eng._master.clone(), eng.opt_state.exp_avg.clone(),
            eng.opt_state.exp_avg_sq.clone(), eng.opt_state.step,
            eng.global_steps, eng.micro_steps)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_lean_checkpoint_resumes_in_the_port(jparams, tmp_path):
    conf = _config(2)
    tokens = _tokens(2, 2)
    eng = _port_engine(jparams, conf)
    for _ in range(2):
        eng.train_batch(batch=(tokens, tokens))
    eng.save_checkpoint(str(tmp_path))
    after = [eng.train_batch(batch=(tokens, tokens)) for _ in range(2)]
    fresh = _port_engine(jparams, conf)
    fresh.load_checkpoint(str(tmp_path))
    resumed = [fresh.train_batch(batch=(tokens, tokens)) for _ in range(2)]
    assert resumed == after
    _same(_state(fresh), _state(eng))
    assert fresh.opt_state.exp_avg.dtype == torch.bfloat16


def test_lean_checkpoints_cross_both_ways(jparams, tmp_path):
    """The port writes its bf16 leaves as fp32 values (ROADMAP §C); the
    JAX engine casts them back into its bf16 parameters and bf16 moments
    exactly, and trains on (losses rtol 2e-2, the two engines' bf16
    tolerance); a JAX lean checkpoint (ml_dtypes bf16 leaves) loads into
    the port bit for bit."""
    conf = _config(1)
    tokens = _tokens(3, 1)
    # port → JAX
    eng = _port_engine(jparams, conf)
    for _ in range(2):
        eng.train_batch(batch=(tokens, tokens))
    eng.save_checkpoint(str(tmp_path / "port"))
    jeng = _jax_engine(jparams, conf)
    jeng.load_checkpoint(str(tmp_path / "port"))
    names = eng.param_names
    state = jax.device_get(jeng.state)
    assert torch.equal(flat_from_jax(state.params, names),
                       eng._params_flat.float())
    assert torch.equal(flat_from_jax(state.opt_state.exp_avg, names),
                       eng.opt_state.exp_avg.float())
    moment_dtypes = {str(np.asarray(x).dtype) for x in
                     jax.tree_util.tree_leaves(state.opt_state.exp_avg)}
    assert jeng.global_steps == eng.global_steps == 2
    np.testing.assert_allclose(
        [float(jeng.train_batch(batch=(tokens, tokens))) for _ in range(2)],
        [eng.train_batch(batch=(tokens, tokens)) for _ in range(2)],
        rtol=2e-2)
    assert moment_dtypes == {"bfloat16"}
    # JAX → port
    jeng2 = _jax_engine(jparams, conf)
    for _ in range(2):
        jeng2.train_batch(batch=(tokens, tokens))
    jeng2.save_checkpoint(str(tmp_path / "jax"))
    port = _port_engine(jparams, _config(1))
    port.load_checkpoint(str(tmp_path / "jax"))
    state = jax.device_get(jeng2.state)
    assert torch.equal(port._params_flat.float(),
                       flat_from_jax(state.params, names))
    for ours, ref in ((port.opt_state.exp_avg, state.opt_state.exp_avg),
                      (port.opt_state.exp_avg_sq,
                       state.opt_state.exp_avg_sq)):
        assert ours.dtype == torch.bfloat16
        assert torch.equal(ours.float(), flat_from_jax(ref, names))
    assert port.opt_state.step == int(state.opt_state.step) == 2
    assert port.global_steps == 2
