"""The quantized FFN's amax history across checkpoints and skipped
steps, on the CPU (the mirror of `tests/test_quantization.py`'s
resume and skip tests; set-up in `torch_quant.py`):

- resume across the packages, both ways: the loaded history bit-equal
  to the saved one, the next loss within rtol 1e-5 of the saver's own
  next loss and the histories after it within rtol 2e-2; a resume
  inside the port is bit-exact (one thread);
- the JAX restore rules: a checkpoint without the state leaves an
  armed engine's history at zeros, a quantized one loads into an
  unarmed engine, each with the JAX warning; the model_states entry is
  {"amax": fp32 ndarray, "ef": None}, or None without the block;
- a quarantined ``nan_grads`` step (policy skip_batch) and fp16's
  opening overflow steps leave the history bit-equal, as in JAX.
"""

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.models import gpt_neox as jneox

from torch_quant import (AMAX_RTOL, LOSS_RTOL, SIZE, conf, jax_amax,
                         jax_engine, port_engine, tokens, weights)

torch.set_num_threads(2)

__all__ = ["weights"]


def _save_run(eng, tmp, tag, gas=1):
    toks = tokens(0, gas)
    for _ in range(2):
        eng.train_batch(batch=(toks, toks))
    eng.save_checkpoint(str(tmp), tag=tag)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(weights, tmp_path, direction):
    config = conf("fp8")
    nxt = tokens(9)
    if direction == "jax_to_port":
        saver = jax_engine(weights, config)
        _save_run(saver, tmp_path, "q1")
        saved = jax_amax(saver)
        loader = port_engine(weights, config)
        loader.load_checkpoint(str(tmp_path), tag="q1")
        np.testing.assert_array_equal(loader.quant.amax.numpy(), saved)
        got = loader.train_batch(batch=(nxt, nxt))
        want = float(saver.train_batch(batch=(nxt, nxt)))
        after = loader.quant.amax.numpy(), jax_amax(saver)
    else:
        saver = port_engine(weights, config)
        _save_run(saver, tmp_path, "q1")
        saved = saver.quant.amax.numpy().copy()
        loader = jax_engine(weights, config)
        loader.load_checkpoint(str(tmp_path), tag="q1")
        np.testing.assert_array_equal(jax_amax(loader), saved)
        got = float(loader.train_batch(batch=(nxt, nxt)))
        want = saver.train_batch(batch=(nxt, nxt))
        after = jax_amax(loader), saver.quant.amax.numpy()
    assert saved.max() > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(after[0], after[1], rtol=AMAX_RTOL)


def test_resume_in_port_is_bit_exact(weights, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = conf("int8", gas=2)
        eng = port_engine(weights, config)
        _save_run(eng, tmp_path, "q2", gas=2)
        fresh = port_engine(jax.device_get(jneox.init_params(
            jneox.GPTNeoXConfig(**SIZE), jax.random.PRNGKey(7))), config)
        fresh.load_checkpoint(str(tmp_path), tag="q2")
        assert torch.equal(fresh.quant.amax, eng.quant.amax)
        nxt = tokens(9, gas=2)
        assert fresh.train_batch(batch=(nxt, nxt)) == \
            eng.train_batch(batch=(nxt, nxt))
        assert torch.equal(fresh.quant.amax, eng.quant.amax)
    finally:
        torch.set_num_threads(threads)


def test_checkpoint_without_the_block(weights, tmp_path, monkeypatch):
    """The JAX rules both ways: a checkpoint of an engine without the
    block leaves an armed engine's history at zeros (warned); a
    quantized checkpoint loads into an unarmed engine (warned, and
    ignored); both packages write ``quantization_state`` alike."""
    from deeperspeed_tpu_torch.runtime import engine as engine_mod
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", warned.append)
    plain = port_engine(weights, {k: v for k, v in conf().items()
                                  if k != "quantization"})
    _save_run(plain, tmp_path / "plain", "p")
    armed = port_engine(weights, conf())
    armed.load_checkpoint(str(tmp_path / "plain"), tag="p")
    assert not armed.quant.amax.any()
    _save_run(armed, tmp_path / "armed", "a")
    plain.load_checkpoint(str(tmp_path / "armed"), tag="a")
    assert plain.quant is None
    assert len(warned) == 2
    assert "has no quantization state" in warned[0]
    assert "ignoring it" in warned[1]
    state = torch.load(tmp_path / "armed" / "a" /
                       "mp_rank_00_model_states.pt", weights_only=False)
    q = state["quantization_state"]
    assert set(q) == {"amax", "ef"} and q["ef"] is None
    assert q["amax"].dtype == np.float32 and q["amax"].shape == (4, 4, 4)
    assert torch.load(tmp_path / "plain" / "p" /
                      "mp_rank_00_model_states.pt",
                      weights_only=False)["quantization_state"] is None


@pytest.mark.fault_injection
def test_quarantined_step_keeps_the_history(weights):
    config = conf("int8", training_health={
        "enabled": True, "policy": "skip_batch",
        "fault_injection": {"faults": [{"kind": "nan_grads", "step": 2}]}})
    eng = port_engine(weights, config)
    toks = tokens(5)
    eng.train_batch(batch=(toks, toks))
    eng.train_batch(batch=(toks, toks))
    before = eng.quant.amax.clone()
    eng.train_batch(batch=(toks, toks))            # the faulted step
    assert int(eng.sentinel.quarantined) == 1
    assert torch.equal(eng.quant.amax, before)
    eng.train_batch(batch=(toks, toks))
    assert not torch.equal(eng.quant.amax, before)


def test_fp16_overflow_steps_keep_the_history(weights):
    """fp16 from 2^32: the opening steps overflow and are skipped, with
    the history left at its zeros; the first taken step writes slot 0."""
    config = conf("fp8", fp16={"enabled": True, "loss_scale": 0,
                               "initial_scale_power": 32, "hysteresis": 1})
    eng = port_engine(weights, config)
    toks = tokens(6)
    while eng.global_steps == 0:
        skipped = eng.skipped_steps
        eng.train_batch(batch=(toks, toks))
        if eng.skipped_steps > skipped:
            assert not eng.quant.amax.any()
    assert eng.skipped_steps > 0 and eng.quant.amax[..., 0].gt(0).all()
    assert not eng.quant.amax[..., 1:].any()
