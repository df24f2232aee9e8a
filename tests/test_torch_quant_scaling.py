"""The port's delayed-scaling helpers (`ops/hopper/quant_matmul.py`,
"delayed scaling") against the JAX package's, on the CPU, in fp32 and
bf16, on the same numpy inputs.

- `recipe_qmax`, `scale_from_history` (the bootstrap on an all-zero
  history, the history max, the margin, the 1e-12 floor) and
  `amax_history_update` (the roll) bit-equal to the jitted JAX
  functions.
- `_fake_quant`: bit-equal to JAX in bf16 (jitted) and fp32 (eager: in
  fp32 XLA's CPU jit contracts the dequant multiply and the
  straight-through subtraction ``v + (dq - v)`` into one FMA, so the
  jitted fp32 result is held within 2 ulps of v instead); fp8 saturates
  at 10x the range without a NaN or inf, int8 rounds ties to even.
- `scaled_matmul`, `grouped_scaled_operands`, `ffn_scaled_matmuls`
  against the jitted JAX functions: outputs within fp32 rtol 1e-5 /
  bf16 rtol 1e-2 (another summation order; 3e-2 x max for the FFN pair,
  whose second product quantizes a bf16 intermediate), fake-quantized
  operands
  bit-equal in bf16 and within 2 ulps of the input in fp32, the advanced
  histories bit-equal, except the amax of the FFN's gelu output, one
  product apart (fp32 rtol 1e-6, bf16 one ulp); the straight-through
  gradient of `scaled_matmul` against `jax.grad` (fp32 rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.ops.pallas import quant_matmul as jqm
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
RECIPES = ("fp8", "int8")


def _np(x):
    """A JAX or torch array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _assert_ste_close(got, want, v, dtype):
    """bf16: bit-equal; fp32: within 2 ulps of the input v (XLA's FMA in
    the straight-through add, see the module docstring)."""
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 2.0 ** -22 * np.abs(v)).all()


def test_constants_and_qmax():
    assert (qm.INT8_QMAX, qm.FP8_QMAX, qm.QUANT_RECIPES,
            qm.FFN_AMAX_TENSORS) == (jqm.INT8_QMAX, jqm.FP8_QMAX,
                                     jqm.QUANT_RECIPES, jqm.FFN_AMAX_TENSORS)
    for recipe in RECIPES:
        assert qm.recipe_qmax(recipe) == jqm.recipe_qmax(recipe)
    with pytest.raises(ValueError) as ours:
        qm.recipe_qmax("int4")
    with pytest.raises(ValueError) as theirs:
        jqm.recipe_qmax("int4")
    assert str(ours.value) == str(theirs.value)


HISTORIES = [
    np.zeros(8, np.float32),                          # the bootstrap
    np.array([0, 3.7, 1.0, 0, 0.25, 0, 0, 2.0], np.float32),
    np.array([1e-20, 0, 0, 0], np.float32),           # below the floor
]


@pytest.mark.parametrize("margin", [1.0, 1.3, 0.7])
@pytest.mark.parametrize("recipe", RECIPES)
def test_scale_from_history_bit_equal(recipe, margin):
    """Over each history and 2000 current amaxes (0, the floor and a
    log-normal spread), the scale equals the jitted JAX function's."""
    qmax = jqm.recipe_qmax(recipe)
    cur = np.random.default_rng(0).lognormal(0, 4, 2000).astype(np.float32)
    cur[:2] = (0.0, 1e-13)
    fn = jax.jit(jax.vmap(
        lambda h, a: jqm.scale_from_history(h, a, qmax, margin),
        in_axes=(None, 0)))
    for hist in HISTORIES:
        want = np.asarray(fn(hist, cur))
        h = torch.from_numpy(hist)
        got = np.array([qm.scale_from_history(h, torch.tensor(a), qmax,
                                              margin).item() for a in cur],
                       np.float32)
        np.testing.assert_array_equal(got, want)
    zeros = qm.scale_from_history(torch.zeros(4), torch.tensor(0.0), qmax)
    assert zeros.item() > 0                     # the 1e-12 floor


def test_amax_history_update_rolls():
    hist = np.array([5.0, 4.0, 3.0, 2.0], np.float32)
    want = np.asarray(jax.jit(jqm.amax_history_update)(hist,
                                                       np.float32(7.5)))
    h = torch.from_numpy(hist.copy())
    got = qm.amax_history_update(h, torch.tensor(7.5))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(h.numpy(), hist)     # a new tensor
    one = qm.amax_history_update(torch.zeros(1), 3.0)  # a Python float too
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jqm.amax_history_update(jnp.zeros(1), 3.0)))
    np.testing.assert_array_equal(
        qm.init_amax_history(3, 5).numpy(),
        np.asarray(jqm.init_amax_history(3, 5)))


def _fq_inputs(seed, scale, qmax):
    """Values over ±10x the representable range at ``scale``, planted
    int8 ties (k + 0.5 after the division), zeros and signs."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-10, 10, (64, 48)).astype(np.float32) * qmax * scale
    v[0, :4] = np.array([2.5, -3.5, 0.5, 0.0], np.float32) * scale
    v[1, :3] = np.array([11, -11, 1e30], np.float32) * qmax * scale
    return v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("recipe", RECIPES)
def test_fake_quant_bit_equal(recipe, dtype):
    qmax = jqm.recipe_qmax(recipe)
    jit_fq = jax.jit(lambda v, s: jqm._fake_quant(v, s, recipe))
    for seed, scale in ((0, 0.0123), (1, 2.0 ** -7), (2, 3.3)):
        v = _fq_inputs(seed, scale, qmax)
        tv, jv = _pair(v, dtype)
        s = np.float32(scale)
        got = _np(qm._fake_quant(tv, torch.tensor(s), recipe))
        # saturated: no NaN or inf, within the range (bf16: the STE's
        # two roundings may each take a value one bf16 ulp out)
        assert np.isfinite(got).all()
        assert np.abs(got).max() <= qmax * scale * (
            1 + (1e-6 if dtype == "float32" else 2.0 ** -6))
        _assert_ste_close(got, _np(jit_fq(jv, s)), v, dtype)
        if dtype == "float32":
            np.testing.assert_array_equal(
                got, _np(jqm._fake_quant(jv, jnp.float32(s), recipe)))
    if recipe == "int8":
        # half to even: 2.5 → 2, -3.5 → -4, 0.5 → 0
        tv, _ = _pair(_fq_inputs(1, 2.0 ** -7, qmax), dtype)
        out = qm._fake_quant(tv, torch.tensor(2.0 ** -7), recipe)
        assert _np(out)[0, :4].tolist() == [2 / 128, -4 / 128, 0.0, 0.0]


def test_fake_quant_is_straight_through():
    v = torch.randn(16, 8, requires_grad=True)
    g = torch.randn(16, 8)
    (qm._fake_quant(v, torch.tensor(0.05), "fp8") * g).sum().backward()
    torch.testing.assert_close(v.grad, g, rtol=0, atol=0)


def _hist(seed, n=6, zero=False):
    h = np.random.default_rng(seed).uniform(0.5, 3.0, n).astype(np.float32)
    return np.zeros(n, np.float32) if zero else h


@pytest.mark.parametrize("zero_history", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("recipe", RECIPES)
def test_scaled_matmul_and_grad_match_jax(recipe, dtype, zero_history):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((40, 64)) * 2).astype(np.float32)
    w = (rng.standard_normal((64, 24)) * 0.05).astype(np.float32)
    g = rng.standard_normal((40, 24)).astype(np.float32)
    hx, hw = _hist(4, zero=zero_history), _hist(5, zero=zero_history)
    tx, jx = _pair(x, dtype)
    tw, jw = _pair(w, dtype)
    jy, jhx, jhw = jax.jit(lambda a, b: jqm.scaled_matmul(
        a, b, hx, hw, recipe))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y, nhx, nhw = qm.scaled_matmul(tx, tw, torch.from_numpy(hx),
                                   torch.from_numpy(hw), recipe)
    assert y.dtype == tx.dtype and not nhx.requires_grad
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(y), _np(jy), rtol=rtol,
                               atol=rtol * np.abs(_np(jy)).max())
    np.testing.assert_array_equal(nhx.numpy(), np.asarray(jhx))
    np.testing.assert_array_equal(nhw.numpy(), np.asarray(jhw))
    if dtype != "float32":
        return
    # the straight-through estimator: d/dx and d/dw of sum(y * g) are
    # the full-precision transposes with the quantized other operand
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jqm.scaled_matmul(
        a, b, hx, hw, recipe)[0] * g), argnums=(0, 1))(jx, jw)
    (y * torch.from_numpy(g)).sum().backward()
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(_np(want)).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("recipe", RECIPES)
def test_grouped_scaled_operands_match_jax(recipe, dtype):
    """A span-packed buffer whose dead rows are zeros (they count in the
    amax, as in JAX) and stacked expert weights."""
    rng = np.random.default_rng(6)
    buf = rng.standard_normal((3 * 16, 32)).astype(np.float32)
    buf[10:16] = 0.0
    buf[40:] = 0.0
    w = (rng.standard_normal((3, 32, 20)) * 0.1).astype(np.float32)
    hx, hw = _hist(7), np.zeros(6, np.float32)
    tb, jb = _pair(buf, dtype)
    tw, jw = _pair(w, dtype)
    want = jax.jit(jqm.grouped_scaled_operands, static_argnums=(4,))(
        jb, jw, hx, hw, recipe)
    got = qm.grouped_scaled_operands(tb, tw, torch.from_numpy(hx),
                                     torch.from_numpy(hw), recipe)
    _assert_ste_close(_np(got[0]), _np(want[0]), _np(tb), dtype)
    _assert_ste_close(_np(got[1]), _np(want[1]), _np(tw), dtype)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert got[0].dtype == tb.dtype and got[1].dtype == tw.dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("recipe", RECIPES)
def test_ffn_scaled_matmuls_match_jax(recipe, dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    w_in = (rng.standard_normal((48, 96)) * 0.1).astype(np.float32)
    b_in = (rng.standard_normal(96) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((96, 48)) * 0.1).astype(np.float32)
    row = np.stack([_hist(9), np.zeros(6, np.float32), _hist(10),
                    _hist(11)])
    tx, jx = _pair(x, dtype)
    jy, jrow = jax.jit(lambda a: jqm.ffn_scaled_matmuls(
        a, w_in, b_in, w_out, row, recipe))(jx)
    y, new_row = qm.ffn_scaled_matmuls(
        tx, torch.from_numpy(w_in), torch.from_numpy(b_in),
        torch.from_numpy(w_out), torch.from_numpy(row), recipe)
    assert y.dtype == tx.dtype and tuple(new_row.shape) == (4, 6)
    # bf16: an element of the gelu output one bf16 ulp apart can round to
    # the neighbouring fp8 / int8 value before the second product
    rtol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(y), _np(jy), rtol=rtol,
                               atol=rtol * np.abs(_np(jy)).max())
    jrow = np.asarray(jrow)
    # rows in-x, in-w and out-w take the amax of the inputs: bit-equal;
    # out-x takes it of gelu(x_q @ w_q + b), one product apart in fp32
    np.testing.assert_array_equal(new_row.numpy()[[0, 1, 3]],
                                  jrow[[0, 1, 3]])
    np.testing.assert_allclose(new_row.numpy()[2], jrow[2],
                               rtol=1e-6 if dtype == "float32" else 2 ** -7)
    np.testing.assert_array_equal(new_row.numpy()[:, 1:], row[:, :-1])
