"""The port's training-health sentinel against the JAX engine, on the CPU.

Both engines start from the same JAX-made weights of the tiny GPT-NeoX
(`torch_sentinel.py`), take the same batches and the same
"training_health" block, and are compared after every `train_batch`:
the step's verdict, the sentinel's counters and quarantine records (with
a `deepspeed_io` loader's epoch and offset), the probe state,
``global_steps``, the LR, the batch-size scheduler and the PLD theta
(through a loss that declares ``pld_theta``), and the loss (fp32 rtol
1e-5, bf16 rtol 2e-2; the probe's EMAs of the gradient norm at the
gradients' 1e-4). The port's state is bit-equal across each
quarantined step. Also: `warn` lets the NaN reach the parameters in
both, and under fp16 a scale pinned at its floor raises
`LossScaleFloorError` after ``min_scale_patience`` skips, or, under the
sentinel, is an anomaly that aborts. Rollback and the legacy loop:
`test_torch_sentinel_rollback.py`; `abort_after` and an exhausted
rollback budget: `test_torch_sentinel_abort.py`.
"""

import numpy as np
import pytest
import torch

from deeperspeed_tpu.runtime.fp16.loss_scaler import \
    LossScaleFloorError as JaxFloorError
from deeperspeed_tpu.runtime.sentinel import \
    TrainingHealthError as JaxHealthError

from deeperspeed_tpu_torch import TrainingHealthError
from deeperspeed_tpu_torch.runtime.fp16.loss_scaler import \
    LossScaleFloorError

from torch_sentinel import (LOSS_RTOL, MICRO, SCHEDULES, S,
                            assert_bit_equal, assert_health_close, config,
                            engines, flat_state, host_state, jax_weights,
                            record_verdicts, tokens)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jparams():
    return jax_weights()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_quarantine_and_schedules_match_jax(jparams, precision):
    """skip_batch: NaN gradients at step serial 3 and a x1e4 loss spike
    at serial 6 are quarantined alike; nothing else flags."""
    steps = 8
    samples = [(t, t) for t in tokens(3, steps).reshape(-1, S)]
    th = {"enabled": True, "policy": "skip_batch", "warmup_steps": 3,
          "fault_injection": {"faults": [
              {"kind": "nan_grads", "step": 3},
              {"kind": "loss_spike", "step": 6, "factor": 1e4}]}}
    jeng, eng = engines(jparams, config(precision, th, **SCHEDULES),
                        training_data=samples)
    assert eng._pld_in_loss and jeng._pld_in_loss
    jv, v = record_verdicts(jeng), record_verdicts(eng)
    jit, it = iter(jeng.training_dataloader), iter(eng.training_dataloader)
    rtol = LOSS_RTOL[precision]
    for step in range(steps):
        before = flat_state(eng)
        adam_step = eng.opt_state.step
        jloss = float(jeng.train_batch(data_iter=jit))
        loss = eng.train_batch(data_iter=it)
        np.testing.assert_allclose(loss, jloss, rtol=rtol, err_msg=step)
        assert v == jv, step
        assert host_state(eng) == host_state(jeng), step
        # the EMAs hold gradient norms: the existing engine tests' gradient
        # tolerance (1e-4) in fp32
        assert_health_close(jeng, eng, rtol=1e-4 if precision == "fp32"
                            else 2e-2)
        if v[-1] == "quarantined":
            # the update was skipped: masters, moments and the compute
            # parameters are untouched, bit for bit
            assert_bit_equal(before, flat_state(eng))
            assert eng.opt_state.step == adam_step
    assert v == ["ok"] * 3 + ["quarantined"] + ["ok"] * 2 + \
        ["quarantined", "ok"]
    assert [w["kinds"] for w in eng.sentinel.quarantined_windows] == \
        [["nonfinite_grad"], ["loss_spike"]]
    assert [(w["epoch"], w["offset"])
            for w in eng.sentinel.quarantined_windows] == [(0, 8), (0, 14)]
    assert eng.global_steps == steps - 2
    assert eng.batch_size_scheduler.current_batch_size == MICRO
    assert np.isfinite(eng._master.float().numpy()).all()


def test_warn_reaches_the_parameters(jparams):
    th = {"enabled": True, "policy": "warn", "warmup_steps": 100,
          "fault_injection": {"faults": [{"kind": "nan_grads", "step": 1}]}}
    jeng, eng = engines(jparams, config("fp32", th))
    jv, v = record_verdicts(jeng), record_verdicts(eng)
    toks = tokens(4)
    for _ in range(2):
        jeng.train_batch(batch=(toks, toks))
        eng.train_batch(batch=(toks, toks))
    assert v == jv == ["ok", "warned"]
    assert host_state(eng) == host_state(jeng)
    assert eng.sentinel.quarantined == 0 and eng.global_steps == 2
    # warn never blocks the update: the NaN reached the parameters
    assert not np.isfinite(np.asarray(jeng.state.params["embed"]["wte"])).all()
    assert not np.isfinite(eng.module.embed.wte.detach().numpy()).all()


FLOOR_CASES = {
    # no sentinel: the floor watch raises after 3 skips at the floor
    "patience": ({"enabled": True, "initial_scale_power": 0,
                  "min_loss_scale": 1, "min_scale_patience": 3},
                 {"fault_injection": {"faults": [
                     {"kind": "nan_grads", "step": 1, "times": 8}]}},
                 JaxFloorError, LossScaleFloorError,
                 "min_scale_patience=3", 3),
    # an overflow at the floor is an anomaly: abort_after 1 aborts
    "floor_anomaly": ({"enabled": True, "initial_scale_power": 0,
                       "min_loss_scale": 1},
                      {"enabled": True, "policy": "abort", "abort_after": 1,
                       "warmup_steps": 100, "fault_injection": {"faults": [
                           {"kind": "nan_grads", "step": 1}]}},
                      JaxHealthError, TrainingHealthError, "abort_after=1",
                      0),
}


@pytest.mark.parametrize("case", sorted(FLOOR_CASES))
def test_fp16_scale_floor_matches_jax(jparams, case):
    fp16, th, jerr, err, match, skipped = FLOOR_CASES[case]
    jeng, eng = engines(jparams, config(fp16, th))
    toks = tokens(6)
    jeng.train_batch(batch=(toks, toks))
    eng.train_batch(batch=(toks, toks))
    with pytest.raises(jerr, match=match) as ref:
        for _ in range(7):
            jeng.train_batch(batch=(toks, toks))
    with pytest.raises(err, match=match) as ours:
        for _ in range(7):
            eng.train_batch(batch=(toks, toks))
    assert str(ours.value) == str(ref.value)
    assert eng.skipped_steps == jeng.skipped_steps == skipped
    assert eng.loss_scale == float(jeng.state.scale.cur_scale) == 1.0
