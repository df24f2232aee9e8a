"""The port's plain grouped matmul against the JAX package's Pallas
kernel (interpret mode, as `tests/test_grouped_matmul.py` runs it), on
the same numpy inputs in fp32 on the CPU: ragged sizes with an empty and
a full span, exact-zero tail rows, a LUT with several spans per weight,
dx and dW against `jax.vjp`, the argument errors, and `pick_span`.

The CUDA kernels run only on the card: `chip_smoke.py` holds them
against this plain version there (phase 3) and drives them through MoE
training (phases 11-12). Here the wrapper takes the plain version
because the tensors lie on the CPU."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul as jax_gmm, grouped_matmul_xla,
    pick_span as jax_pick_span)
from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
SPAN, K, N = 8, 16, 12


def _case(sizes, W=None, seed=0):
    G = len(sizes)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G * SPAN, K)).astype(np.float32)
    w = rng.standard_normal((W or G, K, N)).astype(np.float32)
    dy = rng.standard_normal((G * SPAN, N)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), dy


def _jax(x, w, sizes, lut, dy):
    """JAX Pallas kernel (interpret mode): y and the vjp's (dx, dw)."""
    def f(x, w):
        return jax_gmm(x, w, jnp.asarray(sizes), SPAN, lut=lut,
                       backend="pallas", block_m=4, block_n=4)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _port(x, w, sizes, lut, dy):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = gm.grouped_matmul(xt, wt, torch.from_numpy(sizes), SPAN, lut=lut)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


CASES = [
    ((8, 0, 5, 3), None, None),        # ragged, an empty expert, a full span
    ((8, 8, 8, 8), None, None),
    ((0, 0, 0, 0), None, None),
    ((2, 0, 8, 1), None, None),
    ((8, 3, 0, 6), 2, (0, 0, 1, 1)),   # several spans per weight
    ((5, 0, 0, 7, 8, 1), 3, (0, 0, 1, 1, 1, 2)),
]


@pytest.mark.parametrize("sizes,W,lut", CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_forward_and_grads_match_pallas(sizes, W, lut):
    x, w, sz, dy = _case(sizes, W)
    want = _jax(x, w, sz, lut, dy)
    got = _port(x, w, sz, lut, dy)
    for name, g, r in zip(("y", "dx", "dw"), got, want):
        np.testing.assert_allclose(g, r, err_msg=name, **TOL)
    lut_t = tuple(range(len(sizes))) if lut is None else lut
    dw = gm.grouped_matmul_dw_reference(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(sz),
        SPAN, lut_t, w.shape[0])
    assert dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), want[2], err_msg="dw plain", **TOL)
    # rows at or past each span's size: exactly 0 out, exactly 0 dx
    for g_i, s in enumerate(sizes):
        rows = slice(g_i * SPAN + s, (g_i + 1) * SPAN)
        assert np.all(got[0][rows] == 0.0) and np.all(got[1][rows] == 0.0)
        if s:
            assert np.abs(got[0][g_i * SPAN:g_i * SPAN + s]).max() > 0
    # a weight whose spans are all empty gets an exactly-zero dW
    for e in range(w.shape[0]):
        if all(s == 0 for s, l in zip(sizes, lut_t) if l == e):
            assert np.all(got[2][e] == 0.0) and np.all(dw[e].numpy() == 0.0)


def test_reference_matches_the_xla_fallback_in_bf16():
    x, w, sz, _ = _case((8, 0, 5, 3))
    ref = grouped_matmul_xla(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16), jnp.asarray(sz),
                             SPAN)
    got = gm.grouped_matmul(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w).bfloat16(),
                            torch.from_numpy(sz), SPAN)
    assert got.dtype == torch.bfloat16
    # both sum bf16 products in fp32 and round once
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


BAD = [
    (dict(span=7), "span"),
    (dict(lut=(1, 0, 2, 3)), "lut"),                 # decreasing
    (dict(lut=(0, 1)), "lut"),                       # wrong length
    (dict(lut=(0, 0, 2, 2), W=3), "lut"),            # gap: weight 1 unvisited
    (dict(sizes=2), "group_sizes"),
    (dict(K=4), "contraction"),
]


@pytest.mark.parametrize("bad,match", BAD, ids=[m + str(i) for i, (_, m)
                                                 in enumerate(BAD)])
def test_argument_errors_match_jax(bad, match):
    x, w, sz, _ = _case((8, 0, 5, 3))
    w = w[:bad.get("W", 4), :bad.get("K", K)]
    sz = sz[:bad.get("sizes", 4)]
    span = bad.get("span", SPAN)
    lut = bad.get("lut")
    with pytest.raises(ValueError, match=match) as ref:
        jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sz), span,
                lut=lut)
    with pytest.raises(ValueError) as ours:
        gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(sz), span, lut=lut)
    assert str(ours.value) == str(ref.value)


def test_pick_span_matches_jax():
    for cap in list(range(1, 300)) + [640, 1000, 1280, 2560, 2561, 5000,
                                      10240]:
        for bm in (None, 64, 128, 512):
            assert gm.pick_span(cap, bm) == jax_pick_span(cap, bm), (cap, bm)
    # the MoE training shape of chip_smoke.py phase 11
    assert gm.pick_span(int(1.25 * 2 * 8192 / 8)) == (2560, 256)


def test_cuda_path_needs_cuda_tensors():
    """A device that is neither CPU nor CUDA raises instead of taking the
    plain version."""
    sz = torch.tensor([8, 0, 5, 3])
    with pytest.raises(ValueError, match="no grouped matmul path"):
        gm.grouped_matmul(torch.empty((32, K), device="meta"),
                          torch.empty((4, K, N), device="meta"), sz, SPAN)


def _fake_library(monkeypatch):
    """A library whose entry points record their arguments and succeed,
    so the wrappers' checks and counters run on the CPU; the module's
    counters are put back afterwards."""
    calls = []
    lib = types.SimpleNamespace(
        ds_grouped_matmul=lambda *a: calls.append(("fwd",) + a) or 0,
        ds_grouped_matmul_dw=lambda *a: calls.append(("dw",) + a) or 0)
    monkeypatch.setattr(gm._build, "load_library", lambda: lib)
    monkeypatch.setattr(gm._build, "stream_ptr", lambda t: None)
    for name in ("launches", "dw_launches"):
        monkeypatch.setattr(gm, name, getattr(gm, name))
    for name in ("design_launches", "dw_design_launches"):
        monkeypatch.setattr(gm, name, dict(getattr(gm, name)))
    return calls


def test_launches_are_counted_by_design(monkeypatch):
    """bf16 forward and dx products count as the "wgmma" design, fp32 as
    "fma"; the dW kernel is counted apart."""
    calls = _fake_library(monkeypatch)
    gm.reset_design_launches()
    sz = torch.tensor([8, 0, 5, 3])
    x = torch.zeros(4 * SPAN, 16, dtype=torch.bfloat16)
    w = torch.zeros(4, 16, 24, dtype=torch.bfloat16)
    dy = torch.zeros(4 * SPAN, 24, dtype=torch.bfloat16)
    assert gm.grouped_matmul_cuda(x, w, sz, SPAN).shape == (4 * SPAN, 24)
    assert gm.grouped_matmul_cuda(dy, w, sz, SPAN, transpose_w=True).shape \
        == (4 * SPAN, 16)
    gm.grouped_matmul_cuda(x.float(), w.float(), sz, SPAN)
    gm.grouped_matmul_dw_cuda(x, dy, sz, SPAN, (0, 1, 2, 3), 4)
    assert gm.design_launches == {"wgmma": 2, "fma": 1}
    assert [c[0] for c in calls] == ["fwd", "fwd", "fwd", "dw"]
    # the number of weights and the span reach the library
    assert calls[0][8:14] == (4 * SPAN, 16, 24, 4, SPAN, 1)
    assert calls[1][4] == 1 and calls[1][8:11] == (4 * SPAN, 24, 16)
    gm.reset_design_launches()
    assert gm.design_launches == {"wgmma": 0, "fma": 0}


@pytest.mark.parametrize("case", ["x_pointer", "row_stride", "k", "n"])
def test_sixteen_byte_refusals_never_reach_the_library(case, monkeypatch):
    """bf16 inputs the TMA loads cannot read raise before the library is
    called, and nothing is counted."""
    calls = _fake_library(monkeypatch)
    K_, N_ = (12, 16) if case == "k" else (16, 12) if case == "n" else \
        (16, 16)
    sz = torch.tensor([8, 3])
    w = torch.zeros(2, K_, N_, dtype=torch.bfloat16)
    if case == "x_pointer":             # base 2 bytes past 16
        x = torch.zeros(2 * SPAN, K_ + 8, dtype=torch.bfloat16)[:, 1:K_ + 1]
    elif case == "row_stride":          # rows 20 elements apart
        x = torch.zeros(2 * SPAN, K_ + 4, dtype=torch.bfloat16)[:, :K_]
    else:
        x = torch.zeros(2 * SPAN, K_, dtype=torch.bfloat16)
    before = (gm.launches, dict(gm.design_launches))
    with pytest.raises(ValueError, match="16-byte"):
        gm.grouped_matmul_cuda(x, w, sz, SPAN)
    assert calls == [] and (gm.launches, gm.design_launches) == before


def test_span_no_tile_divides(monkeypatch):
    """A span that no 128-row tile divides (`pick_span` gives 8- and
    64-aligned spans) goes to the kernel as it is: the kernel bounds its
    stores by the span."""
    calls = _fake_library(monkeypatch)
    span, sizes = 200, torch.tensor([200, 57, 0])
    x = torch.zeros(3 * span, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 64, 96, dtype=torch.bfloat16)
    out = gm.grouped_matmul_cuda(x, w, sizes, span)
    assert out.shape == (3 * span, 96)
    assert calls[0][8:13] == (3 * span, 64, 96, 3, span)


def test_dw_launches_are_counted_by_design(monkeypatch):
    """bf16 dW launches count as the "wgmma" design, fp32 as "fma"; the
    forward counters stay apart, and the reset clears both."""
    calls = _fake_library(monkeypatch)
    gm.reset_design_launches()
    sz = torch.tensor([8, 0, 5, 3])
    x = torch.zeros(4 * SPAN, 16, dtype=torch.bfloat16)
    dy = torch.zeros(4 * SPAN, 24, dtype=torch.bfloat16)
    lut = (0, 0, 1, 1)
    dw = gm.grouped_matmul_dw_cuda(x, dy, sz, SPAN, lut, 2)
    assert dw.shape == (2, 16, 24) and dw.dtype == torch.float32
    gm.grouped_matmul_dw_cuda(x, dy, sz, SPAN, lut, 2)
    gm.grouped_matmul_dw_cuda(x.float(), dy.float(), sz, SPAN, lut, 2)
    assert gm.dw_design_launches == {"wgmma": 2, "fma": 1}
    assert gm.design_launches == {"wgmma": 0, "fma": 0}
    assert gm.dw_launches == 3
    # R, K, N, span, the number of weights and the dtype reach the library
    assert calls[0][6:12] == (4 * SPAN, 16, 24, SPAN, 2, 1)
    assert calls[2][11] == 0
    gm.reset_design_launches()
    assert gm.dw_design_launches == {"wgmma": 0, "fma": 0}


def test_bf16_dw_refuses_more_weights_than_it_ranks(monkeypatch):
    """The bf16 dW kernel ranks at most `DW_MAX_WEIGHTS` weights in shared
    memory: more raise before the library is called; fp32 takes any."""
    calls = _fake_library(monkeypatch)
    n = gm.DW_MAX_WEIGHTS + 1
    sz = torch.ones(n, dtype=torch.int32)
    x = torch.zeros(n * SPAN, 8, dtype=torch.bfloat16)
    dy = torch.zeros(n * SPAN, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most"):
        gm.grouped_matmul_dw_cuda(x, dy, sz, SPAN, tuple(range(n)), n)
    assert calls == [] and gm.dw_design_launches == {"wgmma": 0, "fma": 0}
    gm.grouped_matmul_dw_cuda(x.float(), dy.float(), sz, SPAN,
                              tuple(range(n)), n)
    assert [c[0] for c in calls] == ["dw"]


DW_MASK_CASES = [((8, 0, 5, 3), None, None),
                 ((8, 3, 0, 6), 2, (0, 0, 1, 1)),
                 ((5, 0, 0, 7, 8, 1), 3, (0, 0, 1, 1, 1, 2))]


def _dead_rows(sizes):
    return ~(np.arange(SPAN)[None] < np.asarray(sizes)[:, None]).reshape(-1)


@pytest.mark.parametrize("sizes,W,lut", DW_MASK_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_plain_dw_matches_pallas_with_garbage_dead_rows(sizes, W, lut):
    """Finite garbage in the dead rows of x and dy: the Pallas dW (which
    masks dy alone) and the plain dW (which masks both) agree."""
    x, w, sz, dy = _case(sizes, W, seed=3)
    dead = _dead_rows(sizes)
    rng = np.random.default_rng(4)
    x[dead] = 1e3 * rng.standard_normal((int(dead.sum()), K))
    dy[dead] = 1e3 * rng.standard_normal((int(dead.sum()), N))
    want = _jax(x, w, sz, lut, dy)[2]
    lut_t = tuple(range(len(sizes))) if lut is None else lut
    got = gm.grouped_matmul_dw_reference(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(sz),
        SPAN, lut_t, w.shape[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sizes,W,lut", DW_MASK_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_plain_dw_keeps_nan_dead_rows_out(sizes, W, lut):
    """The kernel's contract: dead rows cost no reads and give zeros. With
    NaN in the dead rows of both x and dy the plain dW equals the dW of
    the same inputs with those rows zeroed, bit for bit, and a weight
    with no live row gets exact zeros."""
    x, w, sz, dy = _case(sizes, W, seed=5)
    dead = _dead_rows(sizes)
    lut_t = tuple(range(len(sizes))) if lut is None else lut
    xz, dyz = x.copy(), dy.copy()
    xz[dead] = 0.0
    dyz[dead] = 0.0
    x[dead] = np.nan
    dy[dead] = np.nan
    args = (torch.from_numpy(sz), SPAN, lut_t, w.shape[0])
    got = gm.grouped_matmul_dw_reference(torch.from_numpy(x),
                                         torch.from_numpy(dy), *args)
    want = gm.grouped_matmul_dw_reference(torch.from_numpy(xz),
                                          torch.from_numpy(dyz), *args)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    for e in range(w.shape[0]):
        if all(s == 0 for s, l in zip(sizes, lut_t) if l == e):
            assert torch.all(got[e] == 0)
