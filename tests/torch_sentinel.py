"""Shared set-up of the training-health engine tests
(`test_torch_sentinel_engine.py`, `test_torch_sentinel_rollback.py`,
`test_torch_sentinel_abort.py`):
the tiny GPT-NeoX of `test_torch_train_engine.py` on both sides, made
from one JAX seed, with a loss that declares ``pld_theta`` and takes an
optional third batch leaf that scales it (a NaN or a large scale gives
the legacy loop, which has no fault injector, its anomalies), the config
and the per-step state both engines are compared on.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
GAS, MICRO, S = 2, 2, 128
LOSS_RTOL = {"fp32": 1e-5, "bf16": 2e-2}
FP16 = {"fp32": {"enabled": False},
        "bf16": {"enabled": True, "type": "bfloat16"}}


class JaxProbeNeoX(jneox.GPTNeoX):
    def loss_fn(self, params, batch, rng=None, pld_theta=None):
        tokens, labels, *scale = batch
        loss = super().loss_fn(params, (tokens, labels), rng)
        if scale:
            loss = loss * jnp.mean(scale[0])
        if pld_theta is not None:
            loss = loss * pld_theta
        return loss


class ProbeNeoX(neox.GPTNeoX):
    def loss_fn(self, params, batch, rng=None, pld_theta=None):
        tokens, labels, *scale = batch
        loss = super().loss_fn(params, (tokens, labels), rng)
        if scale:
            loss = loss * scale[0].mean()
        if pld_theta is not None:
            loss = loss * pld_theta
        return loss


def jax_weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jax.device_get(jneox.init_params(jcfg, jax.random.PRNGKey(0)))


def config(precision="fp32", th=None, **extra):
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
        "fp16": FP16[precision] if isinstance(precision, str)
        else precision,
        "zero_optimization": {"stage": 2},
    }
    if th is not None:
        conf["training_health"] = th
    conf.update(extra)
    return conf


SCHEDULES = {
    "batch_size_schedule": {"enabled": True, "params": {
        "min_batch_size_multiplier": 0.5, "warmup_num_steps": 6,
        "num_intervals": 3}},
    "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.1},
}


def rollback_config(save_dir, fault_step, times=1, **th):
    """fp32, the schedules on, policy rollback after one anomaly, NaN
    gradients at ``fault_step`` (``times`` steps), checkpoints under
    ``save_dir``."""
    return config("fp32", {
        "enabled": True, "policy": "rollback", "rollback_after": 1,
        "warmup_steps": 100, **th,
        "fault_injection": {"faults": [
            {"kind": "nan_grads", "step": fault_step, "times": times}]}},
        checkpoint={"save_dir": str(save_dir)}, **SCHEDULES)


def engines(jparams, conf, training_data=None):
    """(JAX engine on a 1-device mesh, port engine on the CPU) from the
    same weights and config."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jeng, *_ = deeperspeed_tpu.initialize(
        model=JaxProbeNeoX(jneox.GPTNeoXConfig(**SIZE), use_pallas=False),
        model_parameters=jparams, config_params=conf, mesh=mesh,
        training_data=training_data)
    eng = port_engine(jparams, conf, training_data)
    return jeng, eng


def port_engine(jparams, conf, training_data=None):
    model = ProbeNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(jparams)
    eng, *_ = dst.initialize(model=model, config_params=conf,
                             training_data=training_data)
    return eng


def record_verdicts(eng):
    """Wrap the engine's step boundary so each step's verdict lands in
    the returned list (both engines' `_after_step` return it)."""
    verdicts = []
    after = eng._after_step

    def recorded(*args, **kwargs):
        verdict = after(*args, **kwargs)
        verdicts.append(verdict)
        return verdict

    eng._after_step = recorded
    return verdicts


def host_state(eng):
    """The host counters and schedules a step boundary moves."""
    s = eng.sentinel
    out = {"global_steps": eng.global_steps,
           "global_samples": eng.global_samples,
           "skipped_steps": eng.skipped_steps,
           "lr": eng.get_lr()}
    if s is not None:
        out.update(anomalies=s.anomalies, quarantined=s.quarantined,
                   consecutive=s.consecutive, rollbacks=s.rollbacks,
                   last_flags=s.last_flags,
                   windows=list(s.quarantined_windows))
    if eng.batch_size_scheduler is not None:
        out["bs"] = (eng.batch_size_scheduler.state_dict(),
                     eng.batch_size_scheduler.current_batch_size)
    if eng.progressive_layer_drop is not None:
        out["pld_theta"] = float(eng.progressive_layer_drop.get_theta())
    return out


def health(eng):
    """The probe state as numpy scalars (JAX: in the engine state; the
    port: ``engine.health``)."""
    h = eng.state.health if hasattr(eng, "state") else eng.health
    return {f: np.asarray(getattr(h, f)).item() for f in h._fields}


def assert_health_close(jeng, eng, rtol):
    want, got = health(jeng), health(eng)
    for f in ("flags", "count", "anomalies", "quarantined"):
        assert got[f] == want[f], f
    for f in ("loss_ema", "loss_sq_ema", "gnorm_ema", "gnorm_sq_ema"):
        np.testing.assert_allclose(got[f], want[f], rtol=rtol, err_msg=f)


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons between two CPU runs need one thread:
    with more, MKL may pick another thread count (and summation order)
    from run to run under load."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def flat_state(eng):
    """Clones of the port's masters, moments and compute parameters."""
    return [t.detach().clone() for t in (
        eng._master, eng.opt_state.exp_avg, eng.opt_state.exp_avg_sq,
        eng._params_flat)]


def assert_bit_equal(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def tokens(seed, n=None):
    """Seeded token batches [GAS, MICRO, S] (``n`` of them), or one."""
    rng = np.random.default_rng(seed)
    shape = (GAS, MICRO, S) if n is None else (n, GAS, MICRO, S)
    return rng.integers(0, SIZE["vocab_size"], size=shape).astype(np.int32)
