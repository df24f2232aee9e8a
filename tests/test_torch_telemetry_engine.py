"""The training engine with the observability blocks on, against the
JAX engine, on the CPU: a tiny GPT-NeoX (2 layers, width 128, S 128,
gas 2 x micro 2) from one JAX seed trains 3 steps in both engines with
"tensorboard", "telemetry" and ``wall_clock_breakdown`` on.

- The sets of scalar tags the two monitors wrote are equal.
- train_loss and lr agree step for step within the engines' loss
  tolerance (fp32 1e-5; fp16 2e-2, where loss_scale is equal too: the
  dynamic scale moves by the same host rule); keyed by the same
  global_samples.
- The in-engine MFU is achieved TFLOP/s x 1e12 / the H100 peak.
- The port's counted flops equal a count reckoned from the shapes
  (`reckoned_flops`), and their ratio to the JAX engine's
  ``telemetry.compiled_flops[gas]`` (XLA's cost analysis of the whole
  step) is recorded with its tolerance.
- The legacy loop's wall_clock_breakdown timers reach the monitor, and
  the flops profiler fires at its profile step.
- The sentinel's hooks reach the engine's telemetry and monitor (one
  anomaly capture, Train/Sentinel/* scalars), a rollback restore runs
  inside its span, and an async save's stall and commit land in the
  goodput meter and the Train/Checkpoint/* scalars.
"""

import os

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.runtime import monitor as jmon
from deeperspeed_tpu_torch.profiling.hardware import PEAK_FLOPS_DEFAULT
from deeperspeed_tpu_torch.runtime import monitor as mon
from deeperspeed_tpu_torch.runtime.telemetry import NULL_TELEMETRY

import deeperspeed_tpu
from tests.torch_sentinel import (GAS, LOSS_RTOL, MICRO, S, SIZE,
                                  JaxProbeNeoX, config, jax_weights,
                                  port_engine, rollback_config)
from deeperspeed_tpu.models import gpt_neox as jneox

torch.set_num_threads(2)

STEPS = 3
FP16 = {"enabled": True, "type": "float16", "initial_scale_power": 19,
        "hysteresis": 2, "loss_scale_window": 2, "min_loss_scale": 1}
# the count of the port over XLA's cost analysis of the JAX step at this
# model's shapes (fp32): XLA also counts every elementwise operation
# (softmax, gelu, norms, the loss, Adam's update) and the attention
# products it fuses, where FlopCounterMode counts the matrix products
# only; the ratio is fixed by the shapes, so it holds to 1e-3
JAX_FLOPS_RATIO = 0.67985
JAX_FLOPS_RTOL = 1e-3


@pytest.fixture(scope="module")
def jparams():
    return jax_weights()


def _jax_engine(jparams, conf):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return deeperspeed_tpu.initialize(
        model=JaxProbeNeoX(jneox.GPTNeoXConfig(**SIZE), use_pallas=False),
        model_parameters=jparams, config_params=conf, mesh=mesh)[0]


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S)).astype(np.int32)


def _observed(tmp_path, precision, **extra):
    return config(precision,
                  tensorboard={"enabled": True, "output_path": str(tmp_path),
                               "job_name": "unit"},
                  telemetry={"enabled": True}, wall_clock_breakdown=True,
                  **extra)


def _rows(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(ev.step, ev.value) for ev in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def reckoned_flops(micro=MICRO, seq=S, gas=GAS):
    """The products of one train step of the tiny GPT-NeoX, from the
    shapes: each of the 4 block matmuls (12·h² weights a layer) and the
    head (on the S - 1 positions that carry a label) is 2 products
    forward and 4 backward; attention is QKᵀ and P·V over the full S×S
    square, 2 forward and 4 backward (a causal mask is computed and then
    masked); the embedding gather is no product."""
    h, L, V = SIZE["hidden_size"], SIZE["num_layers"], SIZE["vocab_size"]
    blocks = 6 * 12 * L * h * h * micro * seq
    head = 6 * h * V * micro * (seq - 1)
    attn = 6 * 2 * L * micro * seq * seq * h
    return gas * (blocks + head + attn)


@pytest.mark.skipif(not (mon._HAVE_TB and jmon._HAVE_TB),
                    reason="tensorboardX does not import on this host")
@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_scalar_tags_and_series_match_jax(tmp_path, jparams, precision):
    conf = _observed(tmp_path / precision, FP16 if precision == "fp16"
                     else "fp32")
    jconf = dict(conf, tensorboard=dict(conf["tensorboard"],
                                        output_path=str(tmp_path / "jax")))
    jeng, eng = _jax_engine(jparams, jconf), port_engine(jparams, conf)
    tokens = _tokens()
    for _ in range(STEPS):
        jeng.train_batch(batch=(tokens, tokens))
        eng.train_batch(batch=(tokens, tokens))
    jeng.monitor.close()
    eng.monitor.close()
    theirs = _rows(tmp_path / "jax" / "unit")
    ours = _rows(tmp_path / precision / "unit")
    assert set(ours) == set(theirs)
    rtol = LOSS_RTOL["fp32" if precision == "fp32" else "bf16"]
    for tag in ("Train/Samples/train_loss", "Train/Samples/lr") + \
            (("Train/Samples/loss_scale",) if precision == "fp16" else ()):
        assert [s for s, _ in ours[tag]] == [s for s, _ in theirs[tag]]
        np.testing.assert_allclose([v for _, v in ours[tag]],
                                   [v for _, v in theirs[tag]], rtol=rtol,
                                   err_msg=tag)
    if precision == "fp32":     # fp16's overflow skips advance no sample
        assert [s for s, _ in ours["Train/Samples/train_loss"]] == \
            [GAS * MICRO * (i + 1) for i in range(STEPS)]
    for (_, mfu), (_, tflops) in zip(ours["Train/Samples/mfu"],
                                     ours["Train/Samples/achieved_tflops"]):
        assert mfu == pytest.approx(tflops * 1e12 / PEAK_FLOPS_DEFAULT,
                                    rel=1e-6)
    assert "Train/Timers/comms_ms" in ours
    if precision == "fp32":
        flops = eng.telemetry.compiled_flops[GAS]
        assert flops == reckoned_flops()
        ratio = flops / jeng.telemetry.compiled_flops[GAS]
        assert ratio == pytest.approx(JAX_FLOPS_RATIO, rel=JAX_FLOPS_RTOL)
        assert set(eng.telemetry.compiled_flops) == \
            set(jeng.telemetry.compiled_flops) == {GAS}


def test_absent_blocks_leave_the_engine_bare(jparams):
    eng = port_engine(jparams, config("fp32"))
    assert eng.telemetry is NULL_TELEMETRY
    assert eng.monitor is None and eng.flops_profiler is None
    tokens = _tokens()
    eng.train_batch(batch=(tokens, tokens))
    assert eng._step_flops == {}


def test_legacy_loop_timers_and_flops_profiler(tmp_path, jparams):
    conf = _observed(tmp_path, "fp32",
                     flops_profiler={"enabled": True, "profile_step": 1})
    eng = port_engine(jparams, conf)
    tokens = _tokens()
    reports = []
    eng.flops_profiler.print_model_profile = \
        lambda **kw: reports.append(eng.flops_profiler.get_total_flops())
    for _ in range(2):
        for i in range(GAS):
            loss = eng((tokens[i], tokens[i]))
            eng.backward(loss)
        eng.step()
    eng.monitor.close()
    ours = _rows(tmp_path / "unit")
    assert {"Train/Timers/forward_ms", "Train/Timers/backward_ms"} <= \
        set(ours)
    assert len(ours["Train/Timers/forward_ms"]) == 2
    # the profiler counted one micro-batch at step 1: a gas-1 step
    assert reports == [reckoned_flops(gas=1)]
    assert eng.telemetry.goodput.buckets["productive"] > 0


def test_sentinel_and_checkpoint_reach_telemetry(tmp_path, jparams):
    th = {"enabled": True, "policy": "warn", "warmup_steps": 100,
          "fault_injection": {"faults": [{"kind": "nan_grads",
                                          "step": 2}]}}
    conf = _observed(tmp_path, "fp32", training_health=th,
                     checkpoint={"save_dir": str(tmp_path / "ckpt")})
    conf["telemetry"] = {"enabled": True, "trace_dir": str(tmp_path / "tr"),
                         "capture_on_anomaly": True}
    eng = port_engine(jparams, conf)
    tokens = _tokens()
    for step in range(4):
        eng.train_batch(batch=(tokens, tokens))
        if step == 0:
            eng.save_checkpoint_async(str(tmp_path / "ckpt"))
    eng.checkpoint_manager.wait()
    eng.train_batch(batch=(tokens, tokens))
    tel = eng.telemetry
    assert tel.anomaly_captures == 1 and len(tel.memory_snapshots) == 1
    assert tel.windows_opened == 1 and tel.exported_traces
    assert tel.goodput.buckets["ckpt_stall"] > 0
    eng.monitor.close()
    ours = _rows(tmp_path / "unit")
    assert "Train/Sentinel/anomalies" in ours
    assert {"Train/Checkpoint/stall_ms", "Train/Checkpoint/write_ms",
            "Train/Checkpoint/bytes_written"} <= set(ours)


def test_rollback_restore_runs_in_its_span(tmp_path, jparams):
    conf = rollback_config(tmp_path / "ckpt", fault_step=3)
    conf["telemetry"] = {"enabled": True}
    eng = port_engine(jparams, conf)
    seen = []
    tracer = eng.telemetry.tracer
    on_span = tracer._on_span
    tracer._on_span = lambda name, *a: (seen.append(name),
                                        on_span(name, *a))
    tokens = _tokens()
    for step in range(4):
        eng.train_batch(batch=(tokens, tokens))
        if step == 1:
            eng.save_checkpoint(str(tmp_path / "ckpt"))
    assert eng.sentinel.rollbacks == 1
    assert "rollback_restore" in seen and "sentinel" in seen
    assert eng.telemetry.goodput.buckets["rollback"] > 0
    assert os.path.isdir(tmp_path / "ckpt")
