"""The sentinel's rollback and the legacy loop, the port against the JAX
engine and against itself, on the CPU (fp32, the tiny GPT-NeoX of
`torch_sentinel.py`).

- Policy `rollback` (``rollback_after`` 1): NaN gradients at step serial
  5 after a save at step 5 restore the checkpoint; the loader is not
  rewound. The faulted run (batches 0-7) ends bit-identical to a clean
  run that never saw batch 5 (a never-firing fault: the same program),
  masters, moments, compute parameters, loss scale, LR, batch-size
  scheduler, PLD theta and counters; and it matches the JAX engine's
  faulted run (verdicts and counters equal, losses rtol 1e-5, masters
  atol = rtol = 1e-4).
- The legacy ``forward`` / ``backward`` / ``step`` loop with the
  sentinel on: its probe sees no loss, so a NaN-scaled micro-batch
  (nonfinite_grad, quarantined) and a 1e4-scaled one (grad-norm spike)
  flag alike, with the same verdicts, counters, probe state and
  parameters as JAX's legacy loop.
"""

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu_torch.models.convert import flat_from_jax

from torch_sentinel import (GAS, MICRO, assert_bit_equal,
                            assert_health_close, config, engines,
                            flat_state, host_state, jax_weights,
                            one_thread, port_engine, record_verdicts,
                            rollback_config, tokens)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jparams():
    return jax_weights()


def test_rollback_trajectory(jparams, tmp_path, one_thread):
    batches = tokens(7, 8)
    jeng, faulted = engines(jparams, rollback_config(tmp_path / "port", 5))
    jeng.checkpoint_manager.save_dir = str(tmp_path / "jax")
    jv, v = record_verdicts(jeng), record_verdicts(faulted)
    losses = []
    for i, b in enumerate(batches):
        if i == 5:
            faulted.save_checkpoint(str(tmp_path / "port"))
            jeng.save_checkpoint(str(tmp_path / "jax"))
        losses.append((float(jeng.train_batch(batch=(b, b))),
                       faulted.train_batch(batch=(b, b))))
        assert v == jv, i
        assert host_state(faulted) == host_state(jeng), i
    assert v == ["ok"] * 5 + ["rollback", "ok", "ok"]
    assert faulted.sentinel.rollbacks == 1 and faulted.global_steps == 7
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    masters = flat_from_jax(jax.device_get(jeng.state.master),
                            faulted.param_names)
    np.testing.assert_allclose(faulted._master.numpy(), masters.numpy(),
                               atol=1e-4, rtol=1e-4)
    assert_health_close(jeng, faulted, rtol=1e-4)

    # the same program, a fault that never fires, never sees batch 5
    clean = port_engine(jparams, rollback_config(tmp_path / "clean", 10_000))
    for i, b in enumerate(batches):
        if i != 5:
            clean.train_batch(batch=(b, b))
    assert_bit_equal(flat_state(faulted), flat_state(clean))
    assert faulted.opt_state.step == clean.opt_state.step == 7
    assert faulted.scale_state == clean.scale_state
    assert faulted.micro_steps == clean.micro_steps
    keep = ("global_steps", "global_samples", "skipped_steps", "lr", "bs",
            "pld_theta")
    assert {k: host_state(faulted)[k] for k in keep} == \
        {k: host_state(clean)[k] for k in keep}


def test_legacy_loop_matches_jax(jparams):
    th = {"enabled": True, "policy": "skip_batch", "warmup_steps": 2}
    jeng, eng = engines(jparams, config("fp32", th))
    jv, v = record_verdicts(jeng), record_verdicts(eng)
    batches = tokens(9, 6)
    scales = {3: np.nan, 5: 1e4}
    for step, b in enumerate(batches):
        scale = np.full(MICRO, scales.get(step, 1.0), np.float32)
        for m in range(GAS):
            micro = (b[m], b[m], scale)
            jeng.backward(jeng(micro))
            eng.backward(eng(micro))
        jloss = jeng.step().loss
        loss = eng.step()
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5,
                                   err_msg=step)
        assert v == jv, step
        assert host_state(eng) == host_state(jeng), step
        assert_health_close(jeng, eng, rtol=1e-4)
    assert v == ["ok"] * 3 + ["quarantined", "ok", "quarantined"]
    assert [w["kinds"] for w in eng.sentinel.quarantined_windows] == \
        [["nonfinite_grad"], ["grad_norm_spike"]]
    masters = flat_from_jax(jax.device_get(jeng.state.params),
                            eng.param_names)
    np.testing.assert_allclose(eng._master.numpy(), masters.numpy(),
                               atol=1e-4, rtol=1e-4)
