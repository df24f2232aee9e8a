"""The sentinel's aborts, the port against the JAX engine, on the CPU
(fp32, the tiny GPT-NeoX of `torch_sentinel.py`): policy `rollback` with
an exhausted rollback budget, and policy `abort` after ``abort_after``
consecutive anomalies, raise `TrainingHealthError` on the same step with
the same message, after the same counters.
"""

import pytest
import torch

from deeperspeed_tpu.runtime.sentinel import \
    TrainingHealthError as JaxHealthError

from deeperspeed_tpu_torch import TrainingHealthError

from torch_sentinel import (config, engines, host_state, jax_weights,
                            rollback_config, tokens)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jparams():
    return jax_weights()


def test_rollback_budget_exhausted(jparams, tmp_path):
    jeng, eng = engines(jparams, rollback_config(
        tmp_path / "port", 2, max_rollbacks=1, times=4))
    toks = tokens(8)
    for e, d in ((jeng, "jax"), (eng, "port")):
        for _ in range(2):
            e.train_batch(batch=(toks, toks))
        e.save_checkpoint(str(tmp_path / d))
        e.checkpoint_manager.save_dir = str(tmp_path / d)
        e.train_batch(batch=(toks, toks))   # rollback 1/1
    assert eng.sentinel.rollbacks == jeng.sentinel.rollbacks == 1
    assert host_state(eng) == host_state(jeng)
    with pytest.raises(JaxHealthError, match="budget") as ref:
        jeng.train_batch(batch=(toks, toks))
    with pytest.raises(TrainingHealthError, match="budget") as ours:
        eng.train_batch(batch=(toks, toks))
    assert str(ours.value) == str(ref.value)


def test_abort_after_matches_jax(jparams):
    th = {"enabled": True, "policy": "abort", "abort_after": 2,
          "warmup_steps": 100, "fault_injection": {"faults": [
              {"kind": "nan_grads", "step": 2, "times": 3}]}}
    jeng, eng = engines(jparams, config("fp32", th))
    toks = tokens(5)
    for _ in range(3):
        jeng.train_batch(batch=(toks, toks))
        eng.train_batch(batch=(toks, toks))
    assert host_state(eng) == host_state(jeng)
    assert eng.sentinel.quarantined == 1
    with pytest.raises(JaxHealthError, match="abort_after=2") as ref:
        jeng.train_batch(batch=(toks, toks))
    with pytest.raises(TrainingHealthError, match="abort_after=2") as ours:
        eng.train_batch(batch=(toks, toks))
    assert str(ours.value) == str(ref.value)
