"""The port's `FP16_Optimizer` / `FP16_UnfusedOptimizer` against the JAX
package's, on the CPU, mirroring `tests/test_fp16.py`'s cases on the same
numpy parameters and inputs: fp16 training with `FusedAdam` (the flat
fp32 master) and `FusedLamb` (per-leaf masters), the loss falling step
by step alike, one statically scaled step equal to an fp32 Adam step,
the overflow skip halving the scale, clipping (the pre-clip norm
reported), the state-dict round trip, the lean fp16 state through the
engine, and the refusal of the lean flag with a ZeRO stage.

Tolerances: fp16 parameters within 2 fp16 ulps of JAX's (one rounding
of fp32 masters that agree to 1e-6 relative, plus the quadratic loss's
gradients summed in another order); masters atol = rtol = 1e-6 after
one step; losses rtol 1e-3 over 30 steps (fp16 rounding of the
parameters feeds back into the next step's gradient)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models.gpt2 import GPT2 as JaxGPT2
from deeperspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deeperspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deeperspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.fp16 import FP16_Optimizer as JFP16
from deeperspeed_tpu.runtime.fp16 import FP16_UnfusedOptimizer as JFP16U

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models.gpt2 import GPT2, GPT2Config
from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deeperspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.fp16 import (FP16_Optimizer,
                                                FP16_UnfusedOptimizer)

torch.set_num_threads(2)

PAIRS = [(FP16_Optimizer, FusedAdam, JFP16, JFusedAdam),
         (FP16_UnfusedOptimizer, FusedLamb, JFP16U, JFusedLamb)]
IDS = ["fused_adam", "unfused_lamb"]


def _params(dtype=np.float16, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(dtype),
            "b": rng.standard_normal(8).astype(dtype)}


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal((4, 8)).astype(
        np.float32)


def _loss_t(p, x):
    h = x @ p["w"].float() + p["b"].float()
    return torch.mean(torch.square(h))


def _loss_j(p, x):
    h = x @ p["w"].astype(jnp.float32) + p["b"].astype(jnp.float32)
    return jnp.mean(jnp.square(h))


def _port_params(np_params):
    return {k: torch.tensor(v, requires_grad=True)
            for k, v in np_params.items()}


def _port_grads(opt, state, x):
    for p in state.params.values():
        p.grad = None
    opt.scale_loss(_loss_t(state.params, x), state).backward()
    return {k: p.grad for k, p in state.params.items()}


def _jax_grads(opt, state, x):
    return jax.grad(lambda p: opt.scale_loss(_loss_j(p, x), state))(
        state.params)


def _ulps_apart(got, want):
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    return np.abs(np.asarray(got, np.float32) - want) / ulp


@pytest.mark.parametrize("wrapper,base,jwrapper,jbase", PAIRS, ids=IDS)
def test_fp16_training_matches_jax(wrapper, base, jwrapper, jbase):
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args={"init_scale": 2 ** 8})
    opt, jopt = wrapper(base(lr=5e-2), **args), jwrapper(jbase(lr=5e-2),
                                                         **args)
    params = _params()
    state = opt.init_state(_port_params(params))
    jstate = jopt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    x = _x()
    tx = torch.from_numpy(x)
    with torch.no_grad():
        loss0 = float(_loss_t(state.params, tx))
    losses = []
    for _ in range(30):
        state, info = opt.step(state, _port_grads(opt, state, tx))
        jstate, jinfo = jopt.step(jstate, _jax_grads(jopt, jstate, x))
        assert info.overflow is False and not bool(jinfo.overflow)
        with torch.no_grad():
            losses.append((float(_loss_t(state.params, tx)),
                           float(_loss_j(jstate.params, x))))
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-3)
    assert losses[-1, 0] < loss0 * 0.5
    assert state.scale.cur_scale == float(jstate.scale.cur_scale)
    for k in params:
        assert state.params[k].dtype == torch.float16
        assert (_ulps_apart(state.params[k].detach().numpy(),
                            jstate.params[k]) <= 2).all(), k


def test_fp16_masters_match_fp32_reference():
    """One fp16 step with scale 128 equals an fp32 Adam step on the
    masters, here and in JAX (leaves in the JAX tree order: b, then w)."""
    params = _params(np.float32)
    x = _x()
    grads = jax.grad(_loss_j)(jax.tree_util.tree_map(jnp.asarray, params),
                              x)
    ref_opt = JFusedAdam(lr=1e-2)
    ref_new, _ = ref_opt.update(grads, ref_opt.init_state(params), params)
    flat_ref = np.concatenate([np.ravel(ref_new["b"]),
                               np.ravel(ref_new["w"])])
    opt = FP16_Optimizer(FusedAdam(lr=1e-2), static_loss_scale=128.0)
    state = opt.init_state({k: torch.from_numpy(v.copy())
                            for k, v in params.items()})
    scaled = {k: torch.from_numpy(np.asarray(g) * 128.0)
              for k, g in grads.items()}
    state, info = opt.step(state, scaled)
    assert not info.overflow
    np.testing.assert_allclose(state.flat_master.numpy(), flat_ref,
                               rtol=1e-6, atol=1e-6)
    jopt = JFP16(JFusedAdam(lr=1e-2), static_loss_scale=128.0)
    jstate = jopt.init_state(params)
    jstate, _ = jopt.step(jstate, jax.tree_util.tree_map(
        lambda g: g * 128.0, grads))
    np.testing.assert_allclose(state.flat_master.numpy(),
                               np.asarray(jstate.flat_master), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("wrapper,base,jwrapper,jbase", PAIRS, ids=IDS)
def test_overflow_skips_step_and_halves_scale(wrapper, base, jwrapper,
                                              jbase):
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args={"init_scale": 2 ** 8})
    opt, jopt = wrapper(base(lr=1e-2), **args), jwrapper(jbase(lr=1e-2),
                                                         **args)
    params = _params()
    state = opt.init_state(_port_params(params))
    jstate = jopt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    before = {k: p.detach().clone() for k, p in state.params.items()}
    master = state.flat_master.clone()
    bad = {k: torch.full(v.shape, float("inf")) for k, v in params.items()}
    state, info = opt.step(state, bad)
    jstate, jinfo = jopt.step(jstate, jax.tree_util.tree_map(
        lambda p: jnp.full(p.shape, jnp.inf, jnp.float32), jstate.params))
    assert info.overflow and bool(jinfo.overflow)
    assert state.scale.cur_scale == float(jstate.scale.cur_scale) == 2 ** 7
    assert info.loss_scale == float(jinfo.loss_scale) == 2 ** 8
    assert torch.equal(state.flat_master, master)
    for k, p in state.params.items():
        assert torch.equal(p.detach(), before[k])
    assert opt.optimizer is not None and state.opt_state.step == 0


def test_clip_grad_applied_and_norm_reported():
    params = _params(np.float32)
    big = {k: np.full(v.shape, 100.0, np.float32) for k, v in params.items()}
    opt = FP16_Optimizer(FusedAdam(lr=1e-2), static_loss_scale=1.0,
                         clip_grad=1.0)
    state = opt.init_state({k: torch.from_numpy(v.copy())
                            for k, v in params.items()})
    state, info = opt.step(state, {k: torch.from_numpy(v)
                                   for k, v in big.items()})
    jopt = JFP16(JFusedAdam(lr=1e-2), static_loss_scale=1.0, clip_grad=1.0)
    jstate, jinfo = jopt.step(jopt.init_state(params), big)
    assert float(info.grad_norm) == pytest.approx(float(jinfo.grad_norm),
                                                  rel=1e-6)
    assert float(info.grad_norm) > 1.0       # the pre-clip norm
    np.testing.assert_allclose(state.flat_master.numpy(),
                               np.asarray(jstate.flat_master), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("wrapper,base,jwrapper,jbase", PAIRS, ids=IDS)
def test_state_dict_roundtrip(wrapper, base, jwrapper, jbase):
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args={"init_scale": 2 ** 8})
    opt = wrapper(base(lr=1e-2), **args)
    params = _params()
    state = opt.init_state(_port_params(params))
    x = torch.from_numpy(_x())
    for _ in range(2):
        state, _ = opt.step(state, _port_grads(opt, state, x))
    sd = opt.state_dict(state)
    # the JAX wrapper's checkpoint keys
    jopt = jwrapper(jbase(lr=1e-2), **args)
    jsd = jopt.state_dict(jopt.init_state(
        jax.tree_util.tree_map(jnp.asarray, params)))
    assert set(sd) == set(jsd)
    opt2 = wrapper(base(lr=1e-2), **args)
    fresh = opt2.init_state(_port_params(_params(seed=5)))
    restored = opt2.load_state_dict(fresh, sd)
    assert restored.scale == state.scale
    assert torch.equal(restored.flat_master, state.flat_master)
    for k in params:
        assert torch.equal(restored.params[k].detach(),
                           state.params[k].detach())
    assert restored.opt_state.step == state.opt_state.step == 2
    assert torch.equal(restored.opt_state.exp_avg, state.opt_state.exp_avg)
    # both continue alike
    s1, _ = opt.step(state, _port_grads(opt, state, x))
    s2, _ = opt2.step(restored, _port_grads(opt2, restored, x))
    assert torch.equal(s1.flat_master, s2.flat_master)


def test_unfused_masters_are_per_leaf_views():
    opt = FP16_UnfusedOptimizer(FusedLamb(lr=1e-2), static_loss_scale=1.0)
    state = opt.init_state(_port_params(_params()))
    assert set(state.master) == {"w", "b"}
    assert state.master["w"].shape == (8, 8)
    assert state.master["w"].dtype == torch.float32
    # one trust ratio a leaf (the JAX unfused wrapper's LAMB sees leaves)
    assert state.opt_state.segments == ((0, 8), (8, 72))


def _gpt2_run(lean, jax_side):
    fp16 = {"enabled": True, "type": "float16", "initial_scale_power": 12}
    opt = {"lr": 1e-3}
    if lean:
        fp16["fp16_master_weights_and_grads"] = True
        opt["state_dtype"] = "float16"
        opt["eps"] = 1e-4
    conf = {"train_batch_size": 16, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": opt}, "fp16": fp16}
    jcfg = JaxGPT2Config.tiny()
    jparams = jax.device_get(JaxGPT2(jcfg, use_pallas=False).init_params(
        jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (1, 16, 32), np.int32)
    if jax_side:
        eng, *_ = deeperspeed_tpu.initialize(
            model=JaxGPT2(jcfg, use_pallas=False), model_parameters=jparams,
            config_params=conf)
        return [float(eng.train_batch(batch=(toks, toks)))
                for _ in range(4)], eng
    eng, *_ = dst.initialize(model=GPT2(GPT2Config.tiny(), device="cpu"),
                             model_parameters=jparams, config_params=conf)
    return [eng.train_batch(batch=(toks, toks)) for _ in range(4)], eng


def test_lean_fp16_state_matches_jax():
    """fp16_master_weights_and_grads in fp16: the fp16 parameters are the
    masters (no fp32 copy) and the moments fp16, as in the JAX engine;
    losses step by step within rtol 2e-3 of JAX's, and of the classic
    run's within 0.25 (the JAX test's bound)."""
    ours, eng = _gpt2_run(True, False)
    ref, jeng = _gpt2_run(True, True)
    assert eng._master is eng._params_flat
    assert eng._master.dtype == torch.float16
    assert eng.opt_state.exp_avg.dtype == torch.float16
    assert jeng.state.master is None
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert eng.skipped_steps == jeng.skipped_steps
    classic, _ = _gpt2_run(False, False)
    assert abs(ours[-1] - classic[-1]) < 0.25


def test_lean_mode_rejects_zero_stages():
    conf = {"train_batch_size": 16,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "fp16": {"enabled": True, "type": "float16",
                     "fp16_master_weights_and_grads": True},
            "zero_optimization": {"stage": 2}}
    jcfg = JaxGPT2Config.tiny()
    with pytest.raises(JaxConfigError) as ref:
        deeperspeed_tpu.initialize(
            model=JaxGPT2(jcfg, use_pallas=False),
            model_parameters=JaxGPT2(jcfg, use_pallas=False).init_params(
                jax.random.PRNGKey(0)), config_params=conf)
    with pytest.raises(DeepSpeedConfigError) as ours:
        dst.initialize(model=GPT2(GPT2Config.tiny(), device="cpu"),
                       config_params=conf)
    assert str(ours.value) == str(ref.value)
