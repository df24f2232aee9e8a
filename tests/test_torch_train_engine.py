"""The port's training slice against the JAX package's, on the CPU.

Both sides start from the same JAX-made weights (`init_params` →
`jax.device_get` → `load_jax_params`) and take the same numpy batches:

- `GPTNeoX.loss_fn` and its gradients against `jax.value_and_grad` of the
  JAX model's `loss_fn` (Pallas flash attention in interpret mode);
- three `train_batch` steps of `initialize()` engines with gradient
  accumulation 2, WarmupLR and clipping: fp32 (losses rtol 1e-5;
  masters and Adam moments atol = rtol = 1e-4; Adam's eps is 1e-3 so the
  update is smooth in the gradients) and bf16 (losses rtol 2e-2;
  compute parameters within 2 bf16 ulps or atol 2e-2);
- an fp16 run whose first two steps overflow, skipped alike on both
  sides (loss scale, hysteresis, skipped steps, Adam step);
- the LR schedules over 20 steps, the batch-triple errors (same
  messages), the blocks that are not ported, and the GPU default.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.ops.adam.fused_adam import FusedAdam as JaxFusedAdam
from deeperspeed_tpu.runtime import lr_schedules as jsched
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import (adam_state_from_jax,
                                                  flat_from_jax,
                                                  state_dict_from_jax)
from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deeperspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deeperspeed_tpu_torch.runtime import constants as c
from deeperspeed_tpu_torch.runtime import lr_schedules as sched
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
GAS, MICRO, S = 2, 2, 128


def _config(fp16, **extra):
    conf = {
        "train_batch_size": GAS * MICRO,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
            "warmup_num_steps": 5}},
        "gradient_clipping": 1.0,
        "fp16": fp16,
        "zero_optimization": {"stage": 2},
    }
    conf.update(extra)
    return conf


@pytest.fixture(scope="module")
def weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jcfg, jax.device_get(jneox.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S)).astype(np.int32)


def _port_model(jparams):
    return neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(jparams)


def _jax_engine(weights, conf, use_pallas):
    jcfg, jparams = weights
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    eng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jcfg, use_pallas=use_pallas),
        model_parameters=jparams, config_params=conf, mesh=mesh)
    return eng


def _run_both(weights, tokens, conf, use_pallas, steps=3):
    jeng = _jax_engine(weights, conf, use_pallas)
    eng, opt, loader, lr_sched = dst.initialize(
        model=_port_model(weights[1]), config_params=conf)
    assert opt is eng.optimizer and lr_sched is eng.lr_scheduler
    assert loader is None
    losses = [(float(jeng.train_batch(batch=(tokens, tokens))),
               eng.train_batch(batch=(tokens, tokens)))
              for _ in range(steps)]
    return jeng, eng, np.array(losses)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax(weights):
    jcfg, jparams = weights
    rng = np.random.default_rng(1)
    toks = rng.integers(0, SIZE["vocab_size"], size=(2, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, 100:] = -100            # ignored targets
    jloss, jgrads = jax.value_and_grad(
        jneox.GPTNeoX(jcfg, use_pallas=True).loss_fn)(
            jparams, (jnp.asarray(toks), jnp.asarray(labels)))
    model = _port_model(jparams)
    loss = model.loss_fn(model.params_tree(), (torch.from_numpy(toks),
                                               torch.from_numpy(labels)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# train_batch against the JAX engine
# ---------------------------------------------------------------------------

def test_fp32_steps_match_jax(weights, tokens):
    jeng, eng, losses = _run_both(weights, tokens, _config(
        {"enabled": False}), use_pallas=True)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    masters = flat_from_jax(jax.device_get(jeng.state.master),
                            eng.param_names)
    np.testing.assert_allclose(eng._master.numpy(), masters.numpy(),
                               atol=1e-4, rtol=1e-4)
    # fp32 compute: the parameters are the masters
    assert eng.module.embed.wte.data_ptr() == eng._master.data_ptr()
    moments = adam_state_from_jax(jax.device_get(jeng.state.opt_state),
                                  eng.param_names)
    assert moments.step == eng.opt_state.step == 3
    for ours, ref in ((eng.opt_state.exp_avg, moments.exp_avg),
                      (eng.opt_state.exp_avg_sq, moments.exp_avg_sq)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-4)
    assert eng.global_steps == jeng.global_steps == 3
    assert eng.get_lr() == pytest.approx(jeng.get_lr())
    assert eng.global_samples == 3 * GAS * MICRO
    assert eng.micro_steps == 3 * GAS


def test_bf16_steps_match_jax(weights, tokens):
    """Measured on the CPU: losses within 5.1e-5 relative; bf16
    parameters within 0.0078 absolute, 16% of elements more than one ulp
    apart (near zero, where an ulp is tiny)."""
    jeng, eng, losses = _run_both(weights, tokens, _config(
        {"enabled": True, "type": "bfloat16"}), use_pallas=False)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=2e-2)
    params = state_dict_from_jax(jax.device_get(jeng.state.params))
    for name, p in eng.module.named_parameters():
        assert p.dtype == torch.bfloat16
        got, want = p.detach().float().numpy(), params[name].float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        ok = (np.abs(got - want) <= 2 * ulp) | \
            (np.abs(got - want) <= 2e-2)
        assert ok.all(), name
    # the compute parameters are the recast of the fp32 masters
    torch.testing.assert_close(eng._params_flat,
                               eng._master.to(torch.bfloat16), rtol=0,
                               atol=0)


def test_fp16_overflow_skips_like_jax(weights, tokens):
    """initial_scale_power 19 overflows the fp16 gradients on both sides:
    with hysteresis 2 the first overflow keeps the scale, the second
    halves it, the third step is taken."""
    conf = _config({"enabled": True, "type": "fp16",
                    "initial_scale_power": 19})
    jeng, eng, losses = _run_both(weights, tokens, conf, use_pallas=False)
    assert eng.skipped_steps == jeng.skipped_steps == 2
    assert eng.loss_scale == float(jeng.state.scale.cur_scale) == 2.0 ** 18
    assert eng.opt_state.step == int(jeng.state.opt_state.step) == 1
    assert eng.global_steps == jeng.global_steps == 1
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=2e-2)
    # skipped steps did not move the scheduler: one step taken
    assert eng.lr_scheduler.last_batch_iteration == 0


def test_data_iter_matches_batch(weights, tokens):
    conf = _config({"enabled": False})
    samples = [(tokens[g, m], tokens[g, m]) for g in range(GAS)
               for m in range(MICRO)]
    eng_a, _, loader, _ = dst.initialize(
        model=_port_model(weights[1]), config_params=conf,
        training_data=samples)
    assert len(loader) == GAS
    eng_b, *_ = dst.initialize(model=_port_model(weights[1]),
                               config_params=conf)
    it = iter(dst.RepeatingLoader(loader))
    for _ in range(2):
        assert eng_a.train_batch(data_iter=it) == \
            eng_b.train_batch(batch=(tokens, tokens))
    ev = eng_a.eval_batch((tokens[0], tokens[0]))
    assert ev == eng_b.eval_batch(tokens[0])
    assert eng_a.global_steps == 2


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "WarmupLR": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2,
                 "warmup_num_steps": 7},
    "WarmupDecayLR": {"total_num_steps": 15, "warmup_min_lr": 0,
                      "warmup_max_lr": 6e-4, "warmup_num_steps": 5},
    "OneCycle": {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                 "cycle_first_step_size": 6, "decay_lr_rate": 0.1,
                 "decay_step_size": 2},
    "LRRangeTest": {"lr_range_test_min_lr": 1e-4,
                    "lr_range_test_step_size": 4,
                    "lr_range_test_step_rate": 2.0,
                    "lr_range_test_staircase": True},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    ours = sched.get_scheduler_class(name)(FusedAdam(lr=1e-3),
                                           **SCHEDULES[name])
    ref = jsched.get_scheduler_class(name)(JaxFusedAdam(lr=1e-3),
                                           **SCHEDULES[name])
    for _ in range(20):
        ours.step()
        ref.step()
        assert ours.get_last_lr() == ref.get_last_lr()
        assert ours.optimizer.param_groups[0]["betas"] == \
            ref.optimizer.param_groups[0]["betas"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

BAD_TRIPLES = [
    {},
    {"gradient_accumulation_steps": 2},
    {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 10, "gradient_accumulation_steps": 4},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 3},
    {"train_batch_size": 0, "train_micro_batch_size_per_gpu": 0,
     "gradient_accumulation_steps": 1},
    {"train_micro_batch_size_per_gpu": 2.5},
]


@pytest.mark.parametrize("conf", BAD_TRIPLES)
def test_batch_triple_errors_match_jax(conf):
    with pytest.raises(JaxConfigError) as ref:
        JaxConfig(conf, world_size=1)
    with pytest.raises(DeepSpeedConfigError) as ours:
        DeepSpeedConfig(conf)
    assert str(ours.value) == str(ref.value)


GOOD = [
    _config({"enabled": True, "type": "bfloat16"}),
    _config({"enabled": True, "initial_scale_power": 12, "hysteresis": 3,
             "loss_scale_window": 50}, prescale_gradients=True,
            gradient_predivide_factor=2.0),
    {"train_batch_size": 6, "gradient_accumulation_steps": 3,
     "zero_optimization": True},
    {"train_micro_batch_size_per_gpu": 4, "fp16": {"enabled": False}},
    # the "amp" block, parsed as the JAX package parses it
    {"train_batch_size": 4, "amp": {"enabled": True, "opt_level": "O1"}},
    {"train_batch_size": 4, "amp": {"enabled": False, "loss_scale": 128}},
]
FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "fp16_enabled", "bfloat16_enabled",
          "loss_scaling_enabled", "loss_scale", "initial_dynamic_scale",
          "dynamic_loss_scale_args", "gradient_clipping",
          "prescale_gradients", "gradient_predivide_factor",
          "optimizer_name", "optimizer_params", "scheduler_name",
          "scheduler_params", "zero_optimization_stage", "zero_enabled",
          "steps_per_print", "amp_enabled", "amp_params")


@pytest.mark.parametrize("conf", GOOD)
def test_config_values_match_jax(conf):
    ours, ref = DeepSpeedConfig(conf), JaxConfig(conf, world_size=1)
    for f in FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    assert str(ours.precision).replace("torch.", "") == \
        np.dtype(ref.precision).name


# the observability blocks, "rl" and ZeRO stage 3, ported since: their
# cases stay in the list and now hold the port's parse to the JAX
# package's
RETIRED = ("flops_profiler", "monitor", "rl", "telemetry", "tensorboard")
RETIRED_ZERO = ({"zero_optimization": {"stage": 3}},)
UNPORTED = [{k: {"enabled": True}} for k in sorted(
    set(c.NOT_PORTED_BLOCKS) | set(RETIRED))] + [
    {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 1, "cpu_offload": True}},
]


@pytest.mark.parametrize("block", UNPORTED,
                         ids=lambda b: "-".join(sorted(b)) + str(
                             sorted(next(iter(b.values())))))
def test_unported_blocks_raise(block):
    """A block the port does not carry raises "not ported"; a retired
    one parses as the JAX package parses it: the same attributes, or the
    same error (``monitor`` has no "enabled" key in either; stage 3
    compares the zero config)."""
    conf = {"train_batch_size": 4, **block}
    key = next(iter(block))
    if key not in RETIRED and block not in RETIRED_ZERO:
        with pytest.raises(DeepSpeedConfigError, match="not ported"):
            DeepSpeedConfig(conf)
        return
    try:
        ref = JaxConfig(conf, world_size=1)
    except JaxConfigError as e:
        with pytest.raises(DeepSpeedConfigError) as err:
            DeepSpeedConfig(conf)
        assert str(err.value) == str(e)
        return
    ours = DeepSpeedConfig(conf)
    if block in RETIRED_ZERO:
        theirs = vars(ref.zero_config)
        for name, value in vars(ours.zero_config).items():
            if name not in ("offload_param", "offload_optimizer",
                            "schedule"):
                assert value == theirs[name], name
        assert vars(ours.zero_config.schedule) == \
            vars(ref.zero_config.schedule)
        assert ours.zero_optimization_stage == \
            ref.zero_optimization_stage == 3
        return
    for attr in ("telemetry_config", "tensorboard_enabled",
                 "monitor_export_config", "flops_profiler_config",
                 "rl_params", "rl_enabled"):
        theirs = getattr(ref, attr)
        if attr == "telemetry_config":
            theirs = {k: v for k, v in theirs.items() if k != "fleet"}
        elif attr == "flops_profiler_config":
            theirs = vars(theirs)
            assert vars(getattr(ours, attr)) == theirs, attr
            continue
        assert getattr(ours, attr) == theirs, attr


def test_disabled_blocks_and_lamb(weights):
    """Disabled blocks parse; 1-bit Adam is refused as not ported, and
    "Lamb" builds the port's FusedLamb."""
    DeepSpeedConfig({"train_batch_size": 4, "moe": {"enabled": False},
                     "tensorboard": {}, "pipeline": None})
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        dst.initialize(model=_port_model(weights[1]), config_params={
            "train_batch_size": 4, "optimizer": {"type": "OneBitAdam"}})
    eng, opt, *_ = dst.initialize(model=_port_model(weights[1]),
                                  config_params={
                                      "train_batch_size": 4,
                                      "optimizer": {"type": "Lamb"}})
    assert isinstance(opt, FusedLamb) and opt is eng.optimizer


def test_unported_model_fields_raise():
    """A config field whose path is not ported raises at model build
    instead of training without it (the JAX model would use it); the
    quantized FFN's fields are ported and build. ``moe_observability``
    is ported since: the model builds, and on the einsum engine its
    forward raises the JAX model's ValueError (the statistics come from
    the sort engine)."""
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE, moe_num_experts=4,
                                            moe_observability=True),
                         device="cpu").init_params(0)
    with pytest.raises(ValueError, match="dispatch='sort'"):
        model(torch.zeros((1, 8), dtype=torch.long))
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE, ffn_quant_recipe="fp8"),
                         device="cpu")
    assert tuple(model.init_ffn_amax().shape) == (SIZE["num_layers"], 4, 16)


def test_engine_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dst.initialize(model=neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE)),
                       config_params=_config({"enabled": False}))
