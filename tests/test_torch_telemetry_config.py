"""The observability config blocks of the port against the JAX package's
parser, on the CPU: "telemetry", "monitor", "tensorboard",
"flops_profiler", ``wall_clock_breakdown`` / ``memory_breakdown`` and
``moe.observability``. Each case parses to the same values on both sides
or raises the same `DeepSpeedConfigError` message; the telemetry
bad-value cases are `tests/test_telemetry.py`'s own. ``telemetry.fleet``
(the cross-host layer) is refused as not ported (A.8.3).
"""

import pytest

from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

from tests import test_telemetry as jax_telemetry_tests


def _bad_telemetry_cases():
    """`test_config_rejects_bad_values`'s parametrize list."""
    mark = next(m for m in
                jax_telemetry_tests.test_config_rejects_bad_values.pytestmark
                if m.name == "parametrize")
    return [case[0] for case in mark.args[1]]


def cfg(**blocks):
    return {"train_batch_size": 8, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {"lr": 0.01}},
            **blocks}


def _same_error(conf):
    with pytest.raises(JaxConfigError) as jerr:
        JaxConfig(conf, world_size=1)
    with pytest.raises(DeepSpeedConfigError) as err:
        DeepSpeedConfig(conf)
    assert str(err.value) == str(jerr.value)


def _telemetry(conf):
    ref = dict(JaxConfig(conf, world_size=1).telemetry_config)
    assert ref.pop("fleet") is None
    return DeepSpeedConfig(conf).telemetry_config, ref


@pytest.mark.parametrize("block", _bad_telemetry_cases())
def test_telemetry_bad_values_same_error(block):
    _same_error(cfg(telemetry=block))


@pytest.mark.parametrize("block", [
    {"enalbed": True},
    {"enabled": True, "capture": {"start_step": 0}},
    {"enabled": True, "capture_on_anomaly": True},
    {"enabled": True, "trace_dir": "/tmp/x", "capture": {"start_step": "x"}},
    {"enabled": True, "fleet": [1]},
])
def test_telemetry_unknown_key_and_trace_dir_same_error(block):
    _same_error(cfg(telemetry=block))


@pytest.mark.parametrize("block", [
    None, {}, {"enabled": False}, {"enabled": True},
    {"enabled": True, "goodput": False, "mfu": False, "spans": False},
    {"enabled": True, "trace_dir": "/tmp/x",
     "capture": {"start_step": 3, "num_steps": 2},
     "memory_watermark_interval_steps": 5, "capture_on_anomaly": True,
     "anomaly_capture_steps": 2},
    {"enabled": True, "fleet": {"enabled": False}},
    {"enabled": True, "fleet": {"window_steps": 5}},
])
def test_telemetry_block_same_values(block):
    ours, ref = _telemetry(cfg(telemetry=block))
    assert ours == ref


@pytest.mark.parametrize("fleet", [{"enabled": True},
                                   {"enabled": True, "window_steps": 5}])
def test_telemetry_fleet_not_ported(fleet):
    conf = cfg(telemetry={"enabled": True, "fleet": fleet})
    assert JaxConfig(conf, world_size=1).telemetry_config["fleet"]
    with pytest.raises(DeepSpeedConfigError, match="not ported") as err:
        DeepSpeedConfig(conf)
    assert "A.8.3" in str(err.value)


@pytest.mark.parametrize("block", [
    {"enabled": True},
    {"export": [1]},
    {"export": {"bogus": 1}},
    {"export": {"prometheus_port": 70000}},
    {"export": {"prometheus_port": "x"}},
    {"export": {"jsonl": "yes"}},
    {"export": {"rotate_max_mb": "big"}},
    {"export": {"rotate_max_mb": -1}},
    {"export": {"rotate_keep": 0}},
    {"export": {"prometheus_host": ""}},
])
def test_monitor_bad_values_same_error(block):
    _same_error(cfg(monitor=block))


@pytest.mark.parametrize("block", [
    None, {}, {"export": {}},
    {"export": {"prometheus_port": 0}},
    {"export": {"prometheus_port": 9400, "prometheus_host": "0.0.0.0",
                "jsonl": True, "rotate_max_mb": 0.5, "rotate_keep": 2}},
])
def test_monitor_block_same_values(block):
    conf = cfg(monitor=block)
    ref, ours = JaxConfig(conf, world_size=1), DeepSpeedConfig(conf)
    assert ours.monitor_export_config == ref.monitor_export_config
    assert ours.monitor_export_active == ref.monitor_export_active


@pytest.mark.parametrize("extra", [
    {},
    {"tensorboard": {"enabled": True, "output_path": "/tmp/tb",
                     "job_name": "unit"}},
    {"tensorboard": {"enabled": False}},
    {"wall_clock_breakdown": True, "memory_breakdown": True},
])
def test_tensorboard_and_timer_keys_same_values(extra):
    conf = cfg(**extra)
    ref, ours = JaxConfig(conf, world_size=1), DeepSpeedConfig(conf)
    for attr in ("tensorboard_enabled", "tensorboard_output_path",
                 "tensorboard_job_name", "wall_clock_breakdown",
                 "memory_breakdown"):
        assert getattr(ours, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("block", [
    None, {"enabled": True},
    {"enabled": True, "profile_step": 3, "module_depth": 2,
     "top_modules": 5, "detailed": False},
])
def test_flops_profiler_block_same_values(block):
    conf = cfg(flops_profiler=block)
    ref, ours = JaxConfig(conf, world_size=1), DeepSpeedConfig(conf)
    assert vars(ours.flops_profiler_config) == \
        vars(ref.flops_profiler_config)


@pytest.mark.parametrize("block", [
    {"enabled": True, "profile_step": "three"},
    {"enabled": True, "top_modules": 2.5},
])
def test_flops_profiler_bad_values_same_error(block):
    _same_error(cfg(flops_profiler=block))


@pytest.mark.parametrize("moe", [
    {"num_experts": 8, "dispatch": "sort", "observability": True},
    {"num_experts": 8, "dispatch": "sort", "observability": False},
])
def test_moe_observability_same_values(moe):
    conf = cfg(moe=moe)
    assert DeepSpeedConfig(conf).moe_params == \
        JaxConfig(conf, world_size=1).moe_params


@pytest.mark.parametrize("moe", [
    {"num_experts": 8, "observability": True},
    {"num_experts": 8, "dispatch": "einsum", "observability": True},
    {"num_experts": 8, "dispatch": "sort", "observability": "on"},
])
def test_moe_observability_bad_values_same_error(moe):
    _same_error(cfg(moe=moe))
