"""The port's `FusedLamb` against the JAX package's, on the CPU.

- `FusedLamb.update` over the engine's flat layout (one segment a
  parameter) against the JAX class over the same leaves, step by step:
  the trust-ratio clamps (`max_coeff` binding, `min_coeff` binding),
  ``bias_correction`` off and on, ``eps_inside_sqrt``, weight decay, a
  zero leaf (trust ratio 1), masters and moments atol = rtol = 1e-6 (the
  per-leaf norms sum in another order);
- an engine built from the "Lamb" config block (the bing_bert options)
  and one given a `FusedLamb` client optimizer, against the JAX engine:
  three `train_batch` steps of a tiny GPT-NeoX in fp32 (losses rtol
  1e-5, masters and moments atol = rtol = 1e-4, the gradients' bound
  in the engine tests), and in fp16 with an overflow (losses rtol 2e-2,
  the same skipped steps and loss scale)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import flat_from_jax
from deeperspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb, LambState

torch.set_num_threads(2)

SHAPES = {"a": (16, 8), "b": (8,), "c": (4, 4, 3), "z": (5,)}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items()}
    return out


def _flat(tree):
    return torch.from_numpy(np.concatenate([tree[k].ravel()
                                            for k in sorted(tree)]))


OPTIONS = [
    dict(),
    dict(bias_correction=False, weight_decay=0.01, max_coeff=0.3,
         min_coeff=0.01),
    dict(eps_inside_sqrt=True, weight_decay=0.1),
    dict(max_coeff=10.0, min_coeff=5.0),     # the lower clamp binds
    dict(lr=1.0, max_coeff=0.05),            # the upper clamp binds
]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: str(sorted(o)))
def test_fused_lamb_matches_jax_step_by_step(opts):
    opts = {"lr": 1e-2, **opts}
    params = _leaves(0)
    params["z"][:] = 0.0                     # p_norm 0: trust ratio 1
    names = sorted(params)
    bounds = np.cumsum([0] + [params[k].size for k in names])
    segments = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
    ours, ref = FusedLamb(**opts), JFusedLamb(**opts)
    master = _flat(params)
    state = ours.init_state(master, segments=segments)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = ref.init_state(jp)
    for step in range(4):
        grads = _leaves(10 + step)
        state = ours.update(_flat(grads), state, master)
        jp, jstate = ref.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate, jp)
        for got, want in ((master, jp), (state.exp_avg, jstate.exp_avg),
                          (state.exp_avg_sq, jstate.exp_avg_sq)):
            np.testing.assert_allclose(
                got.numpy(), _flat(jax.device_get(want)).numpy(),
                atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            [float(c) for c in ours.get_lamb_coeffs()],
            [float(c) for c in ref.get_lamb_coeffs()], rtol=1e-5)
    assert state.step == int(jstate.step) == 4


def test_fused_lamb_writes_the_compute_copy_and_checks_segments():
    lamb = FusedLamb(lr=1e-2)
    master = torch.randn(10)
    state = lamb.init_state(master, segments=[(0, 4), (4, 10)])
    copy = torch.empty(10, dtype=torch.float16)
    state = lamb.update(torch.randn(10), state, master, compute_out=copy)
    assert torch.equal(copy, master.to(torch.float16))
    with pytest.raises(ValueError, match="tile"):
        lamb.init_state(master, segments=[(0, 4), (5, 10)])
    sd = lamb.state_dict(state)
    back = FusedLamb().load_state_dict(sd)
    assert isinstance(back, LambState) and back.segments == state.segments
    assert torch.equal(back.exp_avg, state.exp_avg)


SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
GAS, MICRO, S = 2, 2, 128
LAMB = {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                   "bias_correction": False,
                                   "max_coeff": 0.3, "min_coeff": 0.01}}


def _config(fp16):
    return {"train_batch_size": GAS * MICRO,
            "train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS, "steps_per_print": 1000,
            "optimizer": LAMB, "gradient_clipping": 1.0, "fp16": fp16,
            "zero_optimization": {"stage": 2}}


@pytest.fixture(scope="module")
def weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jcfg, jax.device_get(jneox.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S)).astype(np.int32)


def _jax_engine(weights, conf):
    jcfg, jparams = weights
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    eng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jcfg, use_pallas=False), model_parameters=jparams,
        config_params=conf, mesh=mesh)
    return eng


@pytest.mark.parametrize("client", [False, True],
                         ids=["config_block", "client_optimizer"])
def test_lamb_engine_fp32_matches_jax(weights, tokens, client):
    conf = _config({"enabled": False})
    jeng = _jax_engine(weights, conf)
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(weights[1])
    kw = {}
    if client:
        kw["optimizer"] = FusedLamb(**LAMB["params"])
        conf = {k: v for k, v in conf.items() if k != "optimizer"}
    eng, opt, *_ = dst.initialize(model=model, config_params=conf, **kw)
    assert isinstance(opt, FusedLamb)
    assert len(eng.opt_state.segments) == len(eng.param_names)
    losses = np.array([(float(jeng.train_batch(batch=(tokens, tokens))),
                        eng.train_batch(batch=(tokens, tokens)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    np.testing.assert_allclose(
        eng._master.numpy(),
        flat_from_jax(jax.device_get(jeng.state.master),
                      eng.param_names).numpy(), atol=1e-4, rtol=1e-4)
    js = jax.device_get(jeng.state.opt_state)
    for ours, ref in ((eng.opt_state.exp_avg, js.exp_avg),
                      (eng.opt_state.exp_avg_sq, js.exp_avg_sq)):
        np.testing.assert_allclose(
            ours.numpy(), flat_from_jax(ref, eng.param_names).numpy(),
            atol=1e-4, rtol=1e-4)
    assert eng.opt_state.step == int(js.step) == 3


def test_lamb_engine_fp16_overflow_matches_jax(weights, tokens):
    conf = _config({"enabled": True, "type": "fp16",
                    "initial_scale_power": 19})
    jeng = _jax_engine(weights, conf)
    eng, *_ = dst.initialize(
        model=neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
        .load_jax_params(weights[1]), config_params=conf)
    losses = np.array([(float(jeng.train_batch(batch=(tokens, tokens))),
                        eng.train_batch(batch=(tokens, tokens)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=2e-2)
    assert eng.skipped_steps == jeng.skipped_steps == 2
    assert eng.loss_scale == float(jeng.state.scale.cur_scale)
    assert eng.opt_state.step == int(jeng.state.opt_state.step) == 1
