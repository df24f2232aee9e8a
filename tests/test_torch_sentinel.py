"""The port's training-health pieces against the JAX package's, on the CPU.

- `probe_update` on the same sequences of (loss, grad_norm, bad_grad):
  non-finite values, spikes after warmup, noise that must not flag, EMAs
  not poisoned by anomalies, the legacy loop's loss-free update. Flags,
  ``count``, ``anomalies`` and ``quarantined`` equal every step, the
  four EMAs within rtol 1e-6.
- `grad_anomaly` against `grad_anomaly_in_jit` for unscaled runs, a
  static scale, a dynamic scale above its floor and one at its floor.
- The "training_health", "progressive_layer_drop" and
  "batch_size_schedule" blocks and ``fp16.min_scale_patience``: the
  parsed values equal the JAX config's, bad values raise the same
  messages.
- The fault plan (determinism, ``DS_FAULT_INJECT``, the peer and slice
  kinds a training engine refuses), `ScaleFloorWatch`,
  `BatchSizeScheduler`, `ProgressiveLayerDrop`, `make_schedule_fn` and the
  dataloader's `position()` against the JAX copies.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.runtime import bs_schedules as jbs
from deeperspeed_tpu.runtime import fault_injection as jfi
from deeperspeed_tpu.runtime import lr_schedules as jsched
from deeperspeed_tpu.runtime import progressive_layer_drop as jpld
from deeperspeed_tpu.runtime import sentinel as jsn
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JaxLoader
from deeperspeed_tpu.runtime.fp16 import loss_scaler as jls

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.runtime import bs_schedules as bs
from deeperspeed_tpu_torch.runtime import fault_injection as fi
from deeperspeed_tpu_torch.runtime import lr_schedules as sched
from deeperspeed_tpu_torch.runtime import progressive_layer_drop as pld
from deeperspeed_tpu_torch.runtime import sentinel as sn
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deeperspeed_tpu_torch.runtime.fp16 import loss_scaler as ls

from test_torch_train_engine import SCHEDULES

torch.set_num_threads(2)

HEALTH_FIELDS = ("flags", "count", "anomalies", "quarantined")
EMA_FIELDS = ("loss_ema", "loss_sq_ema", "gnorm_ema", "gnorm_sq_ema")


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def _healthy(n, loss=1.0, gn=2.0):
    return [(loss, gn, False)] * n


def _noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(1.0 + 0.1 * rng.standard_normal(),
             2.0 + 0.2 * rng.standard_normal(), False) for _ in range(n)]


SEQUENCES = {
    # non-finite loss, the caller's bad_grad verdict, a NaN norm the
    # scaler owns (bad_grad False: no flag, EMAs untouched)
    "nonfinite": _healthy(10) + [(np.nan, 2.0, False), (1.0, np.nan, True),
                                 (1.0, np.nan, False), (1.0, 2.0, False)],
    # a 1000x loss spike and a 1000x grad-norm spike after warmup, then
    # normal traffic
    "spikes": _healthy(10) + [(1000.0, 2.0, False), (1.0, 2000.0, False),
                              (1.01, 2.02, False)],
    # spikes during warmup do not flag
    "warmup": [(1.0, 2.0, False), (1e4, 2e4, False), (1.0, 2.0, False)],
    # +-10% jitter around the mean must never flag
    "noise": _noise(200),
    # a NaN loss and a massive spike must leave the baselines untouched
    "not_poisoned": _healthy(10) + [(np.nan, 2.0, False),
                                    (1e9, 2.0, False),
                                    (1.01, 2.02, False)],
    # the legacy loop's update: no loss
    "no_loss": [(None, g, b) for _, g, b in _healthy(6) +
                [(1.0, 2000.0, False), (1.0, np.nan, True),
                 (1.0, 2.1, False)]],
}


@pytest.mark.parametrize("quarantine", [True, False])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_probe_matches_jax(name, quarantine):
    kw = dict(loss_zscore=6.0, grad_norm_zscore=6.0, ema_beta=0.9,
              warmup_steps=2 if name == "noise" else 3,
              quarantine=quarantine)
    jcfg, cfg = jsn.ProbeConfig(**kw), sn.ProbeConfig(**kw)
    jh, h = jsn.init_health_state(), sn.init_health_state("cpu")
    for step, (loss, gn, bad) in enumerate(SEQUENCES[name]):
        jh, jhard = jsn.probe_update(
            jh, None if loss is None else jnp.float32(loss),
            jnp.float32(gn), bad, jcfg)
        h, hard = sn.probe_update(
            h, None if loss is None else torch.tensor(loss,
                                                      dtype=torch.float32),
            torch.tensor(gn, dtype=torch.float32), bad, cfg)
        assert bool(hard) == bool(jhard), step
        for f in HEALTH_FIELDS:
            assert int(getattr(h, f)) == int(getattr(jh, f)), (step, f)
            assert getattr(h, f).dtype == torch.int32
        for f in EMA_FIELDS:
            np.testing.assert_allclose(float(getattr(h, f)),
                                       float(getattr(jh, f)), rtol=1e-6,
                                       err_msg=f"{step} {f}")
    if name == "noise":
        assert int(h.anomalies) == 0
    if name == "spikes":
        assert int(h.anomalies) == 2
        assert sn.decode_flags(sn.ANOM_GRAD_SPIKE | sn.ANOM_LOSS_SPIKE) \
            == jsn.decode_flags(sn.ANOM_GRAD_SPIKE | sn.ANOM_LOSS_SPIKE) \
            == ["loss_spike", "grad_norm_spike"]


def test_flag_bits_and_policies_match_jax():
    assert sn.FLAG_NAMES == jsn.FLAG_NAMES
    assert sn.POLICIES == jsn.POLICIES
    assert sn.ProbeConfig._fields == jsn.ProbeConfig._fields
    assert sn.HealthState._fields == jsn.HealthState._fields


def _fake_engine(fp16):
    """What `grad_anomaly` reads of an engine: the config's loss scaling
    and dynamic-scale arguments, and `dynamic_loss_scale()`."""
    jconf = JaxConfig({"train_batch_size": 1, "fp16": fp16}, world_size=1)
    conf = DeepSpeedConfig({"train_batch_size": 1, "fp16": fp16})
    dynamic = conf.loss_scaling_enabled and not (
        conf.loss_scale and conf.loss_scale > 0)
    return (types.SimpleNamespace(_config=jconf,
                                  dynamic_loss_scale=lambda: dynamic),
            types.SimpleNamespace(_config=conf,
                                  dynamic_loss_scale=lambda: dynamic))


SCALE_CASES = [
    # (fp16 block, cur_scale, grad norm, overflow)
    ({"enabled": False}, 1.0, 3.0, False),
    ({"enabled": False}, 1.0, np.nan, False),
    ({"enabled": True, "type": "bfloat16"}, 1.0, np.inf, False),
    ({"enabled": True, "loss_scale": 128}, 128.0, np.nan, True),
    ({"enabled": True, "loss_scale": 128}, 128.0, 3.0, False),
    ({"enabled": True, "min_loss_scale": 4}, 1024.0, np.nan, True),
    ({"enabled": True, "min_loss_scale": 4}, 4.0, np.nan, True),
    ({"enabled": True, "min_loss_scale": 4}, 4.0, 3.0, False),
]


@pytest.mark.parametrize("fp16, cur_scale, norm, overflow", SCALE_CASES)
def test_grad_anomaly_rule_matches_jax(fp16, cur_scale, norm, overflow):
    jeng, eng = _fake_engine(fp16)
    scale = ls.init_loss_scale_state(init_scale=cur_scale)
    jscale = types.SimpleNamespace(cur_scale=jnp.float32(cur_scale))
    want = jsn.grad_anomaly_in_jit(jeng, jscale, jnp.float32(norm),
                                   overflow)
    got = sn.grad_anomaly(eng, scale, torch.tensor(norm,
                                                   dtype=torch.float32),
                          overflow)
    assert bool(got) == bool(want)


# ---------------------------------------------------------------------------
# config blocks
# ---------------------------------------------------------------------------

def _cfg(**blocks):
    return {"train_batch_size": 8, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {"lr": 0.01}}, **blocks}


GOOD_BLOCKS = [
    {},
    {"training_health": {"enabled": True}},
    {"training_health": {"enabled": True, "policy": "skip_batch",
                         "loss_zscore": 4, "grad_norm_zscore": 0,
                         "ema_beta": 0.5, "warmup_steps": 0,
                         "hang_timeout_seconds": 2.5,
                         "fault_injection": {"faults": [
                             {"kind": "nan_grads", "step": 3}]}}},
    {"training_health": {"enabled": True, "policy": "rollback",
                         "rollback_after": 1, "max_rollbacks": 0},
     "checkpoint": {"save_dir": "/tmp/ckpt"}},
    {"training_health": {"enabled": False, "policy": "rollback"}},
    {"training_health": {"fault_injection": {"faults": [
        {"kind": "stall", "step": 1, "seconds": 0.5}]}}},
    {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                "gamma": 0.01}},
    {"progressive_layer_drop": {"enabled": True}},
    {"batch_size_schedule": {"enabled": True, "params": {
        "min_batch_size_multiplier": 0.25, "warmup_num_steps": 10}}},
    {"fp16": {"enabled": True, "min_scale_patience": 3}},
]
CONFIG_FIELDS = ("training_health_enabled", "training_health_config",
                 "pld_enabled", "pld_params", "batch_size_schedule_enabled",
                 "batch_size_schedule_params", "min_scale_patience")


@pytest.mark.parametrize("blocks", GOOD_BLOCKS)
def test_blocks_parse_like_jax(blocks):
    ours = DeepSpeedConfig(_cfg(**blocks))
    ref = JaxConfig(_cfg(**blocks), world_size=1)
    for f in CONFIG_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f


BAD_BLOCKS = [
    {"training_health": {"enabled": True, "bogus_knob": 1}},
    {"training_health": {"enabled": True, "policy": "restart"}},
    {"training_health": {"enabled": "yes"}},
    {"training_health": {"enabled": True, "loss_zscore": -1}},
    {"training_health": {"enabled": True, "ema_beta": 1.0}},
    {"training_health": {"enabled": True, "rollback_after": 0}},
    {"training_health": {"enabled": True, "warmup_steps": "soon"}},
    {"training_health": {"enabled": True, "hang_timeout_seconds": -2}},
    {"training_health": {"enabled": True, "abort_after": 0}},
    {"training_health": {"enabled": True, "max_rollbacks": -1}},
    {"training_health": {"enabled": True, "grad_norm_zscore": True}},
    {"training_health": {"enabled": True, "policy": "rollback"}},
    {"training_health": {"fault_injection": {"faults": [
        {"kind": "power_cut", "step": 1}]}}},
    {"training_health": {"fault_injection": {"faults": [
        {"kind": "nan_grads", "step": 1, "times": 0}]}}},
    {"fp16": {"enabled": True, "min_scale_patience": -1}},
]


@pytest.mark.parametrize("blocks", BAD_BLOCKS)
def test_bad_blocks_raise_like_jax(blocks):
    with pytest.raises(JaxConfigError) as ref:
        JaxConfig(_cfg(**blocks), world_size=1)
    with pytest.raises(DeepSpeedConfigError) as ours:
        DeepSpeedConfig(_cfg(**blocks))
    assert str(ours.value) == str(ref.value)


def test_amp_is_still_refused():
    """The "amp" block is ported now (parsed as the JAX config parses
    it, beside the training-health blocks); a block that is still not
    ported beside them ("aio") is refused."""
    conf = _cfg(amp={"enabled": True, "opt_level": "O1"},
                training_health={"enabled": True})
    ours, ref = DeepSpeedConfig(conf), JaxConfig(conf, world_size=1)
    assert ours.amp_enabled is ref.amp_enabled is True
    assert ours.amp_params == ref.amp_params == {"opt_level": "O1"}
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        DeepSpeedConfig(_cfg(aio={"block_size": 1048576}))


def test_exports_match_jax():
    import deeperspeed_tpu
    assert dst.TrainingHealthError is sn.TrainingHealthError
    assert "TrainingHealthError" in dir(deeperspeed_tpu)


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

PLAN = {"faults": [
    {"kind": "nan_grads", "step": 1},
    {"kind": "loss_spike", "step": 3, "times": 2, "factor": 7.0},
    {"kind": "stall", "step": 3, "seconds": 0.5},
    {"kind": "decode_error", "step": 5},
]}


def test_fault_plan_matches_jax():
    ours = fi.FaultInjector(fi.validate_fault_spec(PLAN))
    ref = jfi.FaultInjector(jfi.validate_fault_spec(PLAN))
    for _ in range(8):
        assert ours.plan_next_step() == ref.plan_next_step()
        assert ours.take_host_faults() == ref.take_host_faults()
    assert ours.fired == ref.fired == [(1, "nan_grads"), (3, "loss_spike"),
                                       (3, "stall"), (4, "loss_spike"),
                                       (5, "decode_error")]
    assert (fi.MODE_NONE, fi.MODE_NAN_GRADS, fi.MODE_LOSS_SPIKE) == \
        (jfi.MODE_NONE, jfi.MODE_NAN_GRADS, jfi.MODE_LOSS_SPIKE)


def test_fault_env_matches_jax(monkeypatch):
    monkeypatch.setenv(fi.ENV_VAR,
                       '{"faults": [{"kind": "nan_grads", "step": 2}]}')
    ours = fi.FaultInjector.from_config_env(
        {"faults": [{"kind": "stall", "step": 0}]})
    ref = jfi.FaultInjector.from_config_env(
        {"faults": [{"kind": "stall", "step": 0}]})
    assert ours.faults == ref.faults and ours.has_device_faults
    assert [ours.plan_next_step() for _ in range(3)] == \
        [ref.plan_next_step() for _ in range(3)]
    monkeypatch.setenv(fi.ENV_VAR, "not json")
    with pytest.raises(DeepSpeedConfigError, match="JSON"):
        fi.FaultInjector.from_config_env(None)
    monkeypatch.delenv(fi.ENV_VAR)
    assert fi.FaultInjector.from_config_env(None) is None


@pytest.mark.parametrize("fault", [
    {"kind": "peer_death", "step": 1}, {"kind": "slow_peer", "step": 1},
    {"kind": "barrier_timeout", "step": 1}, {"kind": "dcn_delay", "step": 1},
    {"kind": "slice_kill", "step": 1, "slice": "slice1"}])
def test_training_refuses_peer_and_slice_faults(fault):
    """The JAX engine's peer-health and multislice fault kinds act on a
    peer monitor and slices the port does not have: a training engine
    refuses them (a serving kind in a training plan does nothing, as in
    JAX)."""
    from deeperspeed_tpu_torch.models import gpt_neox as neox
    model = neox.GPTNeoX(neox.GPTNeoXConfig.tiny(), device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        dst.initialize(model=model.init_params(0), config_params=_cfg(
            training_health={"fault_injection": {"faults": [fault]}}))
    eng, *_ = dst.initialize(model=model, config_params=_cfg(
        training_health={"fault_injection": {"faults": [
            {"kind": "decode_error", "step": 0}]}}))
    assert eng._fault_injector.has_serving_faults


def test_apply_fault_matches_jax():
    g = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    for mode, factor in ((fi.MODE_NONE, 1.0), (fi.MODE_NAN_GRADS, 1.0),
                         (fi.MODE_LOSS_SPIKE, 1e4)):
        jloss, jg = jfi.apply_fault(jnp.float32(2.5), {"w": jnp.asarray(g)},
                                    (jnp.int32(mode), jnp.float32(factor)))
        loss, tg = fi.apply_fault(torch.tensor(2.5), torch.from_numpy(g),
                                  (mode, factor))
        assert float(loss) == float(jloss)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg["w"]))


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def _floor_trace(mod, patience):
    """The watch's returns and counters over a fixed skip/take sequence,
    and where it raises."""
    watch = mod.ScaleFloorWatch(min_scale=1.0, patience=patience)
    out = []
    for event in (1024.0, 1.0, "take", 1.0, 2.0, 1.0, 1.0, 1.0, 1.0):
        try:
            if event == "take":
                watch.on_step_taken()
                out.append(("take", watch.consecutive))
            else:
                out.append((watch.on_skip(event), watch.consecutive,
                            watch.warned))
        except mod.LossScaleFloorError as e:
            out.append(("raised", str(e)))
            break
    return out


@pytest.mark.parametrize("patience", [0, 2, 3])
def test_scale_floor_watch_matches_jax(patience):
    assert _floor_trace(ls, patience) == _floor_trace(jls, patience)
    if patience:
        assert _floor_trace(ls, patience)[-1][0] == "raised"


BS_PARAMS = [
    {},
    {"min_batch_size_multiplier": 0.25, "warmup_num_steps": 10},
    {"min_batch_size_multiplier": 0.5, "warmup_num_steps": 7,
     "num_intervals": 3},
    {"min_batch_size_multiplier": 0.1, "warmup_num_steps": 5,
     "num_intervals": 6, "last_batch_iteration": 2},
]


@pytest.mark.parametrize("params", BS_PARAMS)
def test_batch_size_scheduler_matches_jax(params):
    ours = bs.BatchSizeScheduler(final_batch_size=16, **params)
    ref = jbs.BatchSizeScheduler(final_batch_size=16, **params)
    assert ours.schedule == ref.schedule
    for step in range(30):
        ours.step()
        ref.step()
        assert ours.current_batch_size == ref.current_batch_size, step
        assert ours.state_dict() == ref.state_dict()
    resumed = bs.BatchSizeScheduler(final_batch_size=16, **params)
    resumed.load_state_dict(ref.state_dict())
    assert resumed.get_current_batch_size() == ref.get_current_batch_size()


@pytest.mark.parametrize("theta, gamma", [(0.5, 0.001), (0.1, 0.05),
                                          (1.0, 0.3)])
def test_progressive_layer_drop_matches_jax(theta, gamma):
    ours, ref = pld.ProgressiveLayerDrop(theta, gamma), \
        jpld.ProgressiveLayerDrop(theta, gamma)
    assert ours.get_state() == ref.get_state()
    for step in range(0, 400, 7):
        ours.update_state(step)
        ref.update_state(step)
        assert ours.get_theta() == ref.get_theta()
        assert ours.get_state() == ref.get_state()


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_make_schedule_fn_matches_jax(name):
    ours = sched.make_schedule_fn(name, SCHEDULES[name])
    ref = jsched.make_schedule_fn(name, SCHEDULES[name])
    assert [ours(s) for s in range(25)] == [ref(s) for s in range(25)]
    assert sched._DummyGroups().param_groups == \
        jsched._DummyGroups().param_groups


def test_loader_position_matches_jax():
    data = [np.full(4, i, np.int32) for i in range(10)]
    ours = DeepSpeedDataLoader(data, batch_size=3, shuffle=True, seed=5)
    ref = JaxLoader(data, batch_size=3, shuffle=True, seed=5)
    assert ours.position() == ref.position() == {"epoch": 0, "offset": 0}
    it, jit = iter(ours), iter(ref)
    for _ in range(len(ref)):
        np.testing.assert_array_equal(np.asarray(next(it)),
                                      np.asarray(next(jit)))
        assert ours.position() == ref.position()
    assert ours.position()["offset"] == len(ref)
    for end in (it, jit):
        with pytest.raises(StopIteration):
            next(end)
    assert ours.position() == ref.position() == {"epoch": 1, "offset": 0}
