"""The port's quantized training (the "quantization.ffn" block) against
the JAX engine's, on the CPU, on dense GPT-NeoX (the MoE model:
`test_torch_quant_moe.py`; resume and skipped steps:
`test_torch_quant_resume.py`).

Both engines start from the same JAX-made weights and take the same
numpy batches, in fp32 (Adam, no ZeRO): three `train_batch` steps, fp8
and int8, gas 1 and 2. Losses within rtol 1e-5; the [L, 4, H] amax
histories within rtol 1e-5 after the first step and 2e-2 after the
third (`torch_quant.py` says why), the unfilled slots zeros in both.
`eval_batch` runs full precision.
"""

import numpy as np
import pytest
import torch

from torch_quant import (AMAX_RTOL, AMAX_RTOL_SAME, HIST, LOSS_RTOL, SIZE,
                         conf, jax_amax, jax_engine, port_engine, tokens,
                         weights)

torch.set_num_threads(2)

__all__ = ["weights"]


@pytest.mark.parametrize("recipe,gas", [("fp8", 1), ("fp8", 2),
                                        ("int8", 1), ("int8", 2)])
def test_steps_and_histories_match_jax(weights, recipe, gas):
    config = conf(recipe, gas)
    jeng, eng = jax_engine(weights, config), port_engine(weights, config)
    assert eng.module.config.ffn_quant_recipe == recipe
    assert tuple(eng.quant.amax.shape) == (SIZE["num_layers"], 4, HIST)
    assert not eng.quant.amax.any() and eng.quant.ef is None
    losses = []
    for step in range(3):
        toks = tokens(step, gas)
        losses.append((float(jeng.train_batch(batch=(toks, toks))),
                       eng.train_batch(batch=(toks, toks))))
        if step == 0:
            np.testing.assert_allclose(eng.quant.amax.numpy(),
                                       jax_amax(jeng), rtol=AMAX_RTOL_SAME)
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=LOSS_RTOL)
    want, got = jax_amax(jeng), eng.quant.amax.numpy()
    np.testing.assert_allclose(got, want, rtol=AMAX_RTOL)
    filled = 3 * gas                 # one slot a micro-step
    assert (got[..., :min(filled, HIST)] > 0).all()
    assert not got[..., filled:].any() and not want[..., filled:].any()


def test_eval_batch_runs_full_precision(weights):
    toks = tokens(3)[0]
    quant = port_engine(weights, conf("fp8"))
    plain = port_engine(weights, {k: v for k, v in conf().items()
                                  if k != "quantization"})
    assert plain.quant is None
    assert quant.eval_batch((toks, toks)) == plain.eval_batch((toks, toks))
    assert not quant.quant.amax.any()
