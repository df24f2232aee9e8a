"""The port's online-RL engine path and `RLDriver` against the JAX
package's, on the CPU (tiny GPT-NeoX, JAX-made weights, fp32 unless
stated):

- the "rl" loss override's refusals with the JAX engine's words
  (``quantization.ffn``, a model without ``apply``), the blocks the
  port's config refuses as not ported, and ZeRO 1 composing;
- one PPO-clip step and one DPO step from the same batch through the JAX
  engine and the port's: the loss (rtol 1e-5) and the updated
  parameters (atol 2e-6);
- two greedy PPO iterations at ``group_size`` 1 through JAX's
  `RLDriver` and the port's: the same rollouts, the losses and mean KL
  (atol 1e-5), ``compile_delta`` 0 after the warm-up iteration and the
  same ``buffer.consumed``;
- the serving engine and the frozen reference hold copies of their own
  (fp32 and bf16): the serving weights stay the pre-update weights
  between ``train_batch`` and the swap and equal the trainer's after it,
  and the reference stays bit-equal to iteration 0's;
- an RL batch (a dict without ``input_ids``) through ``train_batch``
  with telemetry and the MFU count on; progressive layer drop's check
  reading the installed loss; the legacy loop and ``eval_batch`` on
  the RL loss;
- ``Train/RL/*`` on the borrowed monitor, which survives the serving
  drain (a recording monitor and the real one);
- the driver's geometry checks and a missing "rl" block raising the JAX
  driver's errors word for word.
"""

import types

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.rl import RLDriver as JaxDriver
from deeperspeed_tpu.rl import token_logprobs as jax_token_logprobs
from deeperspeed_tpu.runtime.config import parse_rl_block as jax_parse
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import _flatten
from deeperspeed_tpu_torch.module_inject.replace_module import \
    prepare_inference_params
from deeperspeed_tpu_torch.rl import RLDriver
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

from tests.torch_rl import (SIZE, RecMonitor, ds_config, jax_engine,
                            jax_model, jax_weights, port_engine, prompts,
                            reward, rl_block, serve_config)

torch.set_num_threads(2)

BF16 = {"enabled": True, "type": "bfloat16"}


@pytest.fixture(scope="module")
def jparams():
    return jax_weights(0)[1]


# ---------------------------------------------------------------------------
# the loss override
# ---------------------------------------------------------------------------

def _jax_override_error(config, model):
    """The JAX engine's `_apply_rl_loss_override` message for ``config``
    on ``model``, from the method itself on a stand-in engine."""
    fake = types.SimpleNamespace(
        _config=types.SimpleNamespace(
            rl_params=jax_parse(config),
            pipeline_config=None,
            zero_config=types.SimpleNamespace(
                schedule=types.SimpleNamespace(mode="gspmd"),
                offload_param=None),
            quantization_config=config.get("quantization")),
        module_obj=model)
    with pytest.raises(JaxConfigError) as err:
        JaxEngine._apply_rl_loss_override(fake)
    return str(err.value)


def test_override_refuses_quantized_ffn_like_jax(jparams):
    conf = ds_config(quantization={"ffn": {"recipe": "int8"}})
    with pytest.raises(DeepSpeedConfigError) as err:
        port_engine(jparams, conf)
    assert str(err.value) == _jax_override_error(conf, jax_model())
    assert "quantization.ffn" in str(err.value)


class _NoApply(torch.nn.Module):
    """A client module with a loss but no logits."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def params_tree(self):
        return {"w": self.w}

    def loss_fn(self, params, batch, rng=None):
        return (params["w"] * batch[0].float().mean()).sum()


def test_override_refuses_model_without_apply_like_jax():
    conf = ds_config()
    with pytest.raises(DeepSpeedConfigError) as err:
        dst.initialize(model=_NoApply(), config_params=conf)
    assert str(err.value) == _jax_override_error(conf, object())
    assert "apply(params" in str(err.value)


@pytest.mark.parametrize("extra", [
    {"pipeline": {"stages": 2}},
    {"zero_optimization": {"stage": 3, "schedule": {"mode": "explicit"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}},
], ids=["pipeline", "explicit_schedule", "offload_param"])
def test_modes_the_config_refuses(jparams, extra):
    """The JAX override's other refusals: the port's config stops them
    first, as not ported."""
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        port_engine(jparams, ds_config(**extra))


def test_installed_loss_and_zero1_compose(jparams):
    eng = port_engine(jparams, ds_config(zero_optimization={"stage": 1}))
    assert eng.loss_fn is not eng.module.loss_fn
    assert eng.loss_fn.__qualname__.startswith("build_ppo_clip")
    driver = RLDriver(eng, prompts(seed=13), reward, serve_config())
    out = driver.run_iteration()
    assert np.isfinite(out["loss"]) and eng.global_steps == 1


# ---------------------------------------------------------------------------
# one update against the JAX engine
# ---------------------------------------------------------------------------

def _update_batch(jparams, loss):
    """A seeded [1, 8, 16] RL micro-batch: behavior and reference
    logprobs near the model's own (JAX forward), ratios off 1."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, SIZE["vocab_size"], size=(8, 16)).astype(
        np.int32)
    logp = np.asarray(jax_token_logprobs(
        jax_model().apply(jparams, tokens), tokens))
    mask = np.zeros((8, 15), np.float32)
    mask[:, 6:] = 1.0
    ref = (logp + 0.1 * rng.normal(size=logp.shape)).astype(np.float32)
    batch = {"tokens": tokens, "mask": mask, "ref_logp": ref}
    if loss == "ppo_clip":
        batch["behavior_logp"] = (logp + 0.1 * rng.normal(
            size=logp.shape)).astype(np.float32)
        batch["advantages"] = rng.normal(size=8).astype(np.float32)
    return {k: v[None] for k, v in batch.items()}


@pytest.mark.parametrize("loss", ["ppo_clip", "dpo"])
def test_one_update_matches_jax_engine(jparams, loss):
    conf = ds_config(rl=rl_block(loss=loss, group_size=4,
                                 rollouts_per_iteration=16 if loss == "dpo"
                                 else 8))
    batch = _update_batch(jparams, loss)
    jeng = jax_engine(jparams, conf)
    eng = port_engine(jparams, conf)
    want = float(jeng.train_batch(batch=batch))
    got = eng.train_batch(batch=batch)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    ref = _flatten(jax.device_get(jeng.params_to_natural(jeng.state.params)),
                   "", {})
    mine = eng.params_to_natural()
    assert set(mine) == set(ref)
    moved = 0.0
    for name, leaf in ref.items():
        np.testing.assert_allclose(mine[name].numpy(), np.asarray(leaf),
                                   atol=2e-6, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(np.asarray(leaf) -
                                        np.asarray(_flatten(
                                            jparams, "", {})[name])).max()))
    assert moved > 1e-4     # the step moved the weights


# ---------------------------------------------------------------------------
# the driver against the JAX driver
# ---------------------------------------------------------------------------

def test_greedy_iterations_match_jax_driver(jparams):
    conf = ds_config(train_batch_size=4,
                     rl=rl_block(group_size=1, rollouts_per_iteration=4))
    sc = serve_config(temperature=0.0)
    ps = prompts(seed=10)
    seen = {"jax": [], "port": []}

    def recorder(side):
        def fn(prompt, response):
            seen[side].append(list(map(int, response)))
            return reward(prompt, response)
        return fn

    jdrv = JaxDriver(jax_engine(jparams, conf), ps, recorder("jax"), sc)
    drv = RLDriver(port_engine(jparams, conf), ps, recorder("port"), sc)
    want = jdrv.train(2)
    got = drv.train(2)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 8
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("iteration", "mean_reward", "rollout_tokens"):
            assert g[key] == w[key], key
        for key in ("loss", "mean_kl"):
            assert g[key] == pytest.approx(w[key], abs=1e-5), key
    assert got[1]["mean_kl"] != 0.0
    assert np.sign(got[1]["mean_kl"]) == np.sign(want[1]["mean_kl"])
    assert got[1]["compile_delta"] == want[1]["compile_delta"] == 0
    assert drv.buffer.consumed == jdrv.buffer.consumed == 8
    assert (drv.iteration, drv.cursor) == (jdrv.iteration, jdrv.cursor)
    assert drv.engine.global_steps == 2


# ---------------------------------------------------------------------------
# no aliasing: the serving engine and the reference hold copies
# ---------------------------------------------------------------------------

def _storages(eng):
    return {t.untyped_storage().data_ptr()
            for t in (eng._params_flat, eng._master, eng._grads_flat)}


def _serve_leaves(serve):
    return _flatten(serve.params, "", {})


def _prepared(serve, natural):
    return prepare_inference_params(natural, serve.compute_dtype)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_serving_and_reference_hold_copies(jparams, precision):
    conf = ds_config(fp16=BF16) if precision == "bf16" else ds_config()
    eng = port_engine(jparams, conf)
    assert eng.compute_dtype == (torch.bfloat16 if precision == "bf16"
                                 else torch.float32)
    drv = RLDriver(eng, prompts(seed=20), reward, serve_config())
    serve = drv.serve
    flat = _storages(eng)
    for leaf in _serve_leaves(serve).values():
        assert leaf.untyped_storage().data_ptr() not in flat
    ref_leaves = _flatten(drv.buffer._ref_params, "", {})
    for leaf in ref_leaves.values():
        assert leaf.untyped_storage().data_ptr() not in flat
        assert leaf.untyped_storage().data_ptr() not in {
            t.untyped_storage().data_ptr()
            for t in _serve_leaves(serve).values()}
    initial = eng.params_to_natural()
    _assert_equal(ref_leaves, initial)
    assert next(iter(initial.values())).dtype == eng.compute_dtype

    swap = serve.hot_swap_weights
    checked = []

    def checking_swap(natural):
        # after train_batch, before the swap: the pre-update weights
        _assert_equal(_serve_leaves(serve), _prepared(serve, before))
        assert any(not torch.equal(natural[n], before[n]) for n in before)
        checked.append(True)
        return swap(natural)

    serve.hot_swap_weights = checking_swap
    for it in range(2):
        before = eng.params_to_natural()
        drv.run_iteration()
        _assert_equal(_serve_leaves(serve),
                      _prepared(serve, eng.params_to_natural()))
        # the reference is iteration 0's, bit for bit
        _assert_equal(_flatten(drv.buffer._ref_params, "", {}), initial)
    assert checked == [True, True]
    assert any(not torch.equal(eng.params_to_natural()[n], initial[n])
               for n in initial)


def test_params_to_natural_is_a_copy(jparams):
    eng = port_engine(jparams, ds_config())
    nat = eng.params_to_natural()
    assert list(nat) == eng.param_names
    views = eng._natural_tree(eng._params_flat)
    for name, leaf in _flatten(views, "", {}).items():
        assert torch.equal(nat[name], leaf)
    with torch.no_grad():
        eng._params_flat.add_(1.0)
    assert not torch.equal(nat["embed.wte"], eng.module.embed.wte)


def test_rl_batch_through_train_batch_with_telemetry(jparams):
    """A dict batch without ``input_ids`` through ``train_batch``: every
    leaf reaches the device with its kind (ids as long, floats as they
    are), the telemetry counts its tokens and the MFU count runs the RL
    loss."""
    eng = port_engine(jparams, ds_config(
        telemetry={"enabled": True, "mfu": True}))
    batch = _update_batch(jparams, "ppo_clip")
    dev = eng._device_batch(batch)
    assert dev["tokens"].dtype == torch.long
    for k in ("mask", "behavior_logp", "ref_logp", "advantages"):
        assert dev[k].dtype == torch.float32, k
    assert eng._input_ids(dev) is dev["tokens"]
    loss = eng.train_batch(batch=batch)
    assert np.isfinite(loss) and eng.global_steps == 1
    assert eng._step_flops[1] > 0


class _PLDNeoX(neox.GPTNeoX):
    """A GPT-NeoX whose own loss takes progressive layer drop's theta."""

    def loss_fn(self, params, batch, rng=None, pld_theta=None):
        return super().loss_fn(params, batch, rng)


@pytest.mark.parametrize("rl", [True, False])
def test_pld_check_reads_the_installed_loss(jparams, rl):
    """The engine hands ``pld_theta`` to the loss only where the
    INSTALLED loss declares it: the RL losses do not, the model's own
    does."""
    conf = ds_config(progressive_layer_drop={"enabled": True,
                                             "theta": 0.5, "gamma": 0.001})
    if not rl:
        del conf["rl"]
    model = _PLDNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(jparams)
    eng, *_ = dst.initialize(model=model, config_params=conf)
    assert eng._pld_in_loss is (not rl)
    if rl:
        assert np.isfinite(eng.train_batch(
            batch=_update_batch(jparams, "ppo_clip")))


def test_legacy_loop_and_eval_use_the_installed_loss(jparams):
    """`forward` / `backward` / `step` and plain `eval_batch` run the RL
    loss: the legacy step equals `train_batch` bit for bit, and the eval
    loss before it equals the step's loss."""
    batch = _update_batch(jparams, "ppo_clip")
    a = port_engine(jparams, ds_config())
    b = port_engine(jparams, ds_config())
    micro = {k: v[0] for k, v in batch.items()}
    before = b.eval_batch(micro)
    want = a.train_batch(batch=batch)
    b.backward(b(micro))
    assert b.step() == want
    assert before == pytest.approx(want, rel=1e-6)
    assert torch.equal(a._params_flat, b._params_flat)


# ---------------------------------------------------------------------------
# the shared monitor
# ---------------------------------------------------------------------------

def test_monitor_gets_train_rl_scalars_and_survives_drain(jparams):
    eng = port_engine(jparams, ds_config())
    mon = RecMonitor()
    eng.monitor = mon
    drv = RLDriver(eng, prompts(seed=12), reward, serve_config())
    assert drv.serve.monitor is mon
    out = drv.run_iteration()
    tags = mon.tags()
    assert {f"Train/RL/{k}" for k in out} <= tags
    for tag in ("Train/RL/loss", "Train/RL/rollout_tokens_per_s",
                "Train/RL/swap_ms", "Train/RL/mean_kl"):
        assert tag in tags
    drv.serve.drain()
    assert not mon.closed and mon.flushes >= 1
    assert any(t.startswith("Serve/") for t in mon.tags())


def test_real_monitor_shared_and_left_open(jparams, tmp_path):
    eng = port_engine(jparams, ds_config(
        tensorboard={"enabled": True, "output_path": str(tmp_path),
                     "job_name": "rl_co"}))
    drv = RLDriver(eng, prompts(seed=6), reward, serve_config())
    assert drv.serve.monitor is eng.monitor
    drv.run_iteration()
    drv.serve.drain()
    assert eng.monitor.writer is not None
    eng.monitor.record(eng.global_samples, {"Train/Samples/train_loss": 0.0})
    assert not eng.monitor._warned_closed
    eng.monitor.close()


# ---------------------------------------------------------------------------
# the driver's errors, word for word
# ---------------------------------------------------------------------------

def _fake_jax_engine(rl, gas=1, tbs=8, max_seq_len=128):
    return types.SimpleNamespace(
        _config=types.SimpleNamespace(rl_params=rl),
        gradient_accumulation_steps=lambda: gas,
        train_batch_size=lambda: tbs,
        module_obj=types.SimpleNamespace(
            config=types.SimpleNamespace(max_seq_len=max_seq_len)))


@pytest.mark.parametrize("case", [
    dict(conf=dict(train_batch_size=16)),
    dict(conf=dict(train_batch_size=8,
                   rl=rl_block(loss="dpo", group_size=4))),
    dict(conf=dict(train_batch_size=16, gradient_accumulation_steps=2,
                   train_micro_batch_size_per_gpu=8)),
    dict(conf=dict(rl=rl_block(sequence_length=8))),
    dict(conf=dict(rl=rl_block(max_new_tokens=200))),
    dict(prompts=[]),
    dict(prompts=[[1, 2], []]),
], ids=["ppo_rows", "dpo_rows", "gas", "short_sequence", "past_max_seq_len",
        "no_prompts", "empty_prompt"])
def test_driver_errors_match_jax(jparams, case):
    conf = ds_config(**case.get("conf", {}))
    ps = case.get("prompts", prompts())
    eng = port_engine(jparams, conf)
    with pytest.raises(DeepSpeedConfigError) as got:
        RLDriver(eng, ps, reward, serve_config())
    fake = _fake_jax_engine(jax_parse(conf),
                            gas=eng.gradient_accumulation_steps(),
                            tbs=eng.train_batch_size())
    with pytest.raises(JaxConfigError) as want:
        JaxDriver(fake, ps, reward, serve_config())
    assert str(got.value) == str(want.value)


def test_missing_rl_block_like_jax(jparams):
    conf = ds_config()
    del conf["rl"]
    eng = port_engine(jparams, conf)
    with pytest.raises(DeepSpeedConfigError) as got:
        RLDriver(eng, prompts(), reward, serve_config())
    with pytest.raises(JaxConfigError) as want:
        JaxDriver(_fake_jax_engine(False), prompts(), reward,
                  serve_config())
    assert str(got.value) == str(want.value)
    assert "\"rl\"" in str(got.value)
