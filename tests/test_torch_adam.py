"""The port's flat Adam(W) against the JAX package's: the plain version
against `fused_adam_flat` (the Pallas `_adam_kernel`, interpret mode on
the CPU) and `adam_flat_reference`, over every mode switch, a length no
multiple of the Pallas tile, and bf16 parameters; then the in-place
wrapper and `FusedAdam` that the engine calls.

fp32 within atol = rtol = 1e-6 (the sides differ only in where 1 - β is
rounded); bf16 parameters within one bf16 ulp (one rounding of the same
fp32 result). The CUDA kernel runs only on the card: `chip_smoke.py`
holds it against this plain version there."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.ops.pallas import optimizer as jopt
from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deeperspeed_tpu_torch.ops.hopper import adam

torch.set_num_threads(2)

N = 10_000          # not a multiple of the Pallas tile (8192)
TOL = dict(atol=1e-6, rtol=1e-6)
HP = dict(beta1=0.9, beta2=0.95, eps=1e-8)


def _state(n, seed, p_dtype=np.float32):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    if p_dtype != np.float32:
        p = np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    g = rng.standard_normal(n).astype(np.float32)
    m = (0.1 * rng.standard_normal(n)).astype(np.float32)
    v = (0.01 * rng.random(n)).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize(
    "adam_w,bias_correction,weight_decay",
    list(itertools.product([True, False], [True, False], [0.0, 0.01])))
def test_plain_matches_jax(adam_w, bias_correction, weight_decay):
    p, g, m, v = _state(N, 0)
    kw = dict(HP, weight_decay=weight_decay, adam_w=adam_w,
              bias_correction=bias_correction)
    ours = adam.adam_flat_reference(*map(torch.from_numpy, (p, g, m, v)),
                                    1e-3, 3, **kw)
    jargs = tuple(map(jnp.asarray, (p, g, m, v)))
    for ref in (jopt.fused_adam_flat(*jargs, 1e-3, 3, **kw),
                jopt.adam_flat_reference(*jargs, 1e-3, 3, **kw)):
        for name, o, r in zip(("p", "m", "v"), ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                       err_msg=name, **TOL)


def test_bf16_params_within_one_ulp():
    p, g, m, v = _state(N, 1, p_dtype="bf16")
    p = p.copy()
    kw = dict(HP, weight_decay=0.01)
    ours = adam.adam_flat_reference(
        torch.from_numpy(p).to(torch.bfloat16),
        *map(torch.from_numpy, (g, m, v)), 1e-2, 2, **kw)
    ref = jopt.fused_adam_flat(jnp.asarray(p, jnp.bfloat16),
                               *map(jnp.asarray, (g, m, v)), 1e-2, 2, **kw)
    assert ours[0].dtype == torch.bfloat16
    got = ours[0].float().numpy()
    want = np.asarray(ref[0].astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), **TOL)


def test_in_place_wrapper_and_recast():
    p, g, m, v = map(torch.from_numpy, _state(N, 2))
    gb = g.to(torch.bfloat16)                # bf16 grads, as the kernel takes
    want = adam.adam_flat_reference(p, gb, m, v, 1e-3, 5, **HP)
    out = torch.empty(N, dtype=torch.bfloat16)
    adam.fused_adam_flat_(p, gb, m, v, 1e-3, 5, p_out=out, **HP)
    for got, ref in zip((p, m, v), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(out, want[0].to(torch.bfloat16), rtol=0,
                               atol=0)
    assert adam.launches == 0


def test_wrapper_rejects_bad_buffers():
    p, g, m, v = map(torch.from_numpy, _state(16, 3))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        adam.fused_adam_flat_(p, g[:8], m, v, 1e-3, 1)
    with pytest.raises(TypeError, match="float32"):
        adam.fused_adam_flat_(p, g, m.double(), v, 1e-3, 1)


def test_fused_adam_counts_steps_and_reads_its_group():
    p, g, m, v = map(torch.from_numpy, _state(N, 4))
    opt = FusedAdam(lr=5e-3, betas=(0.8, 0.9), eps=1e-6, weight_decay=0.1,
                    adam_w_mode=False)
    state = opt.init_state(p)
    assert state.step == 0 and bool((state.exp_avg == 0).all())
    state = state._replace(exp_avg=m.clone(), exp_avg_sq=v.clone())
    ref = adam.adam_flat_reference(p, g, m, v, 5e-3, 1, beta1=0.8,
                                   beta2=0.9, eps=1e-6, weight_decay=0.1,
                                   adam_w=False)
    state = opt.update(g, state, p)
    assert state.step == 1
    for got, want in zip((p, state.exp_avg, state.exp_avg_sq), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    opt.param_groups[0]["lr"] = 0.0          # what a scheduler writes
    before = p.clone()
    state = opt.update(g, state, p)
    assert state.step == 2 and torch.equal(p, before)
