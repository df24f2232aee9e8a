"""The quantized FFN on MoE GPT-NeoX (sort dispatch) against the JAX
package's, on the CPU (set-up in `torch_quant.py`).

- `_sort_ffn` with ``ffn_quant`` on one span-packed buffer, both
  recipes, fp32: dead rows (span tails, an empty expert) and biases
  large enough that gelu(b_in) on the dead rows is the amax of the first
  product's output, so the amax must carry the dead rows' values, as in
  JAX. The new amax row bit-equal (its out-x entry, a gelu of the same
  fp32 bias, within rtol 1e-6); the output within rtol 1e-5.
- The MoE model (the JSON "moe" block, sort, top-2) with the int8 and
  fp8 FFN: three fp32 `train_batch` steps against the JAX engine, the
  first loss within rtol 1e-5 and the later ones within 1e-4 (a
  quantization flip, `torch_quant.py`, moves an MoE loss further: the
  element also feeds the gate of the next layer), the histories within
  the rtols of `torch_quant.py`.
- Einsum dispatch is refused with the JAX engine's error ("sort").
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.moe import layer as jlayer
from deeperspeed_tpu_torch.moe import layer as tlayer

from torch_quant import (AMAX_RTOL, AMAX_RTOL_SAME, LOSS_RTOL, SIZE, conf,
                         jax_amax, jax_engine, port_engine, tokens)

torch.set_num_threads(2)

MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 1.25,
       "dispatch": "sort"}
MOE_CFG = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
               moe_dispatch="sort")


@pytest.mark.parametrize("recipe", ["int8", "fp8"])
def test_sort_ffn_amax_covers_dead_rows(recipe):
    rng = np.random.default_rng(0)
    E, H, inter, span = 3, 16, 32, 8
    sizes = np.array([5, 0, 8], np.int32)            # tails, an empty expert
    buf = rng.standard_normal((E * span, H)).astype(np.float32)
    for e, n in enumerate(sizes):
        buf[e * span + n:(e + 1) * span] = 0.0       # _fill_buffer's zeros
    params = {"w_in": rng.standard_normal((E, H, inter)) * 0.1,
              "b_in": rng.standard_normal((E, inter)) * 0.1,
              "w_out": rng.standard_normal((E, inter, H)) * 0.1,
              "b_out": rng.standard_normal((E, H)) * 0.1}
    params["b_in"][1, 3] = 6.0      # expert 1 has only dead rows
    params = {k: v.astype(np.float32) for k, v in params.items()}
    row = np.zeros((4, 4), np.float32)
    row[:, 1:] = rng.uniform(0.5, 2.0, (4, 3))
    lut = (0, 1, 2)
    jout, jrow = jax.jit(lambda b: jlayer._sort_ffn(
        params, b, jnp.asarray(sizes), span, lut, E, span, None, None,
        "xla", ffn_quant=(recipe, 1.0, row)))(buf)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    out, new_row = tlayer._sort_ffn(
        tparams, torch.from_numpy(buf), torch.from_numpy(sizes), span, lut,
        E, span, ffn_quant=(recipe, 1.0, torch.from_numpy(row)))
    jrow = np.asarray(jrow)
    np.testing.assert_array_equal(new_row.numpy()[[0, 1, 3]],
                                  jrow[[0, 1, 3]])
    np.testing.assert_allclose(new_row.numpy()[2], jrow[2], rtol=1e-6)
    # the out-x amax is gelu(6) from expert 1's dead rows, above every
    # live row's
    gelu6 = float(torch.nn.functional.gelu(torch.tensor(6.0),
                                           approximate="tanh"))
    assert new_row[2, 0].item() == pytest.approx(gelu6, rel=1e-6)
    live = np.concatenate([np.asarray(jout)[e * span:e * span + n]
                           for e, n in enumerate(sizes)])
    assert np.abs(live).max() < gelu6
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jout)).max())


@pytest.fixture(scope="module")
def moe_weights():
    return jax.device_get(jneox.init_params(
        jneox.GPTNeoXConfig(**SIZE, **MOE_CFG), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("recipe", ["int8", "fp8"])
def test_moe_quant_steps_match_jax(moe_weights, recipe):
    config = conf(recipe, gas=2, moe=MOE)
    jeng = jax_engine(moe_weights, config)
    eng = port_engine(moe_weights, config)
    assert eng.module.config.moe_dispatch == "sort"
    assert eng.module.config.ffn_quant_recipe == recipe
    losses = []
    for step in range(3):
        toks = tokens(step, 2)
        losses.append((float(jeng.train_batch(batch=(toks, toks))),
                       eng.train_batch(batch=(toks, toks))))
        if step == 0:
            np.testing.assert_allclose(eng.quant.amax.numpy(),
                                       jax_amax(jeng), rtol=AMAX_RTOL_SAME)
    losses = np.array(losses)
    np.testing.assert_allclose(losses[0, 1], losses[0, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    np.testing.assert_allclose(eng.quant.amax.numpy(), jax_amax(jeng),
                               rtol=AMAX_RTOL)
    assert (eng.quant.amax.numpy() > 0).all()


def test_einsum_dispatch_is_refused(moe_weights):
    config = conf("int8", moe=dict(MOE, dispatch="einsum"))
    with pytest.raises(ValueError) as theirs:
        jax_engine(moe_weights, config)
    with pytest.raises(ValueError) as ours:
        port_engine(moe_weights, config)
    assert str(ours.value) == str(theirs.value)
    assert "sort" in str(ours.value)
