"""The plain fp16 versions of the port's kernels against the JAX
package's functions in fp16, on the CPU, on the same numpy inputs.

- flash attention forward and backward (rows 1-5): the single-block and
  tiled Pallas kernels in interpret mode, causal, segmented, under a
  layout mask, with the key bias (a batch row all masked: exact zeros)
  and with dropout; both sides
  round P to fp16 before P·V and dS to fp16 before dQ and dK (an
  overflow past 65504 is inf in both);
- the fused BERT layer's materialized path in fp16 with an all-masked
  batch row: the -1e30 penalty is added to fp32 logits on both sides, so
  the row is a finite uniform average, not NaN;
- paged decode over fp16 pools (row 6): the Pallas kernel in interpret
  mode and the XLA path, P rounded to the pool dtype;
- the grouped matmul forward, dx and dW (row 9) in fp16;
- flat Adam (row 11): the classic fp16 variant (fp32 p, m, v, fp16 g,
  the fp16 recast) against `fused_adam_flat`, and the lean one (fp16 p,
  m, v) against the JAX `FusedAdam` with ``state_dtype`` float16.

Tolerances: fp16 outputs rounded once after fp32 sums in another order,
atol = rtol = 2e-3 (forward, decode, matmuls; an fp16 ulp at 1 is
9.8e-4) and 1e-2 for the flash gradients (dS rounded to fp16 on both
sides, then summed over S keys); the classic Adam in fp32 within 1e-6;
the lean Adam within one fp16 ulp. The CUDA fp16 kernels run only on the
card: `chip_smoke.py` holds them against these plain versions there."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.ops.adam.fused_adam import FusedAdam as JaxFusedAdam
from deeperspeed_tpu.ops.pallas import optimizer as jopt
from deeperspeed_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_paged_decode
from deeperspeed_tpu.ops.pallas.grouped_matmul import \
    grouped_matmul as jax_gmm
from deeperspeed_tpu.ops.transformer import transformer as jtr

from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
from deeperspeed_tpu_torch.ops.hopper import adam
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm
from deeperspeed_tpu_torch.ops.transformer import transformer as tr

jfa = importlib.import_module("deeperspeed_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

F16 = np.float16
FWD = dict(atol=2e-3, rtol=2e-3)
BWD = dict(atol=1e-2, rtol=1e-2)
B, H, D = 2, 2, 64


def _arrays(S, seed, n=4, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((B, S, H, D))).astype(F16)
            for _ in range(n)]


def _f32(x):
    return np.asarray(x, np.float32)


def _run_jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _run_port(fn, q, k, v, do):
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]


def _check(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == F16 and w.dtype == F16
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=str(i),
                                   **(FWD if i == 0 else BWD))


def _segments(S, seed):
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        end = int(rng.integers(S // 2, S - 8))
        cut = int(rng.integers(1, end))
        seg[b, :cut], seg[b, cut:end] = 1, 2
    return seg


# (S, block): the JAX single-block path and its tiled path
FLASH_CASES = [(128, 1024), (256, 128)]


@pytest.mark.parametrize("S,block", FLASH_CASES)
def test_flash_causal_fp16_matches_jax(S, block):
    q, k, v, do = _arrays(S, S)
    want = _run_jax(lambda q, k, v: jfa.flash_attention(
        q, k, v, True, None, block, block), q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_segmented(q, k, v),
                    q, k, v, do)
    _check(got, want)


def test_flash_segmented_fp16_matches_jax():
    S = 256
    q, k, v, do = _arrays(S, 3)
    seg = _segments(S, 4)
    do = do * (seg != 0)[:, :, None, None].astype(F16)
    want = _run_jax(lambda q, k, v: jfa.flash_attention_segmented(
        q, k, v, jnp.asarray(seg), True, None, 128, 128), q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_segmented(
        q, k, v, torch.from_numpy(seg)), q, k, v, do)
    _check(got, want)


def _kbias(S, seed):
    rng = np.random.default_rng(seed)
    kbias = np.zeros((B, S), np.float32)
    kbias[0, S - S // 4 - 3:] = -1e30           # ragged key padding
    kbias[0, :5] = rng.standard_normal(5)       # a finite bias
    kbias[1, :] = -1e30                         # every key masked
    return kbias


@pytest.mark.parametrize("S,block", FLASH_CASES)
def test_flash_kbias_fp16_all_masked_row_matches_jax(S, block):
    q, k, v, do = _arrays(S, 5)
    kbias = _kbias(S, 6)
    want = _run_jax(lambda q, k, v: jfa.flash_attention_kbias(
        q, k, v, jnp.asarray(kbias), False, None, block, block), q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_kbias(
        q, k, v, torch.from_numpy(kbias)), q, k, v, do)
    _check(got, want)
    for g, w in zip(got, want):          # the all-masked batch row
        assert not np.abs(_f32(g[1])).any() and not np.abs(_f32(w[1])).any()


def test_flash_layout_mask_fp16_matches_jax():
    """The layout-mask flag (row 5) in fp16: a 128-grain layout with an
    inactive off-diagonal block, causal, S = 256."""
    S = 256
    q, k, v, do = _arrays(S, 15)
    layout = np.ones((H, 2, 2), bool)
    layout[0, 1, 0] = False
    want = _run_jax(jfa.make_masked_flash_attention(layout, causal=True),
                    q, k, v, do)
    got = _run_port(fa.make_masked_flash_attention(layout, causal=True),
                    q, k, v, do)
    _check(got, want)


def test_flash_dropout_fp16_matches_jax():
    S = 128
    q, k, v, do = _arrays(S, 7)
    kbias = _kbias(S, 8)
    seed = np.array([4242], np.int32)
    want = _run_jax(lambda q, k, v: jfa.flash_attention_train(
        q, k, v, jnp.asarray(kbias), jnp.asarray(seed), False, None, 1024,
        1024, 0.1), q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_train(
        q, k, v, torch.from_numpy(kbias), torch.from_numpy(seed),
        dropout_rate=0.1), q, k, v, do)
    _check(got, want)


def test_flash_backward_overflow_fp16_matches_jax():
    """dO at fp16's full scale on batch row 0, head 0: dS passes 65504 on
    the early causal rows; both sides round it to fp16 (inf) before dQ
    and dK, so their gradients are non-finite at the same places (but
    where `fp16_overflow_undecided` says a value sits within 1e-3 of the
    threshold, where the two sides' last bits decide), and finite
    everywhere else."""
    S = 128
    q, k, v, do = _arrays(S, 9)
    v = (v.astype(np.float32) * 8).astype(F16)
    do = do.astype(np.float32)
    do[0, :, 0] = np.clip(do[0, :, 0] * 20000, -60000, 60000)
    do = do.astype(F16)
    want = _run_jax(lambda q, k, v: jfa.flash_attention(
        q, k, v, True, None, 1024, 1024), q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_segmented(q, k, v),
                    q, k, v, do)
    assert np.isfinite(_f32(got[0])).all()
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_segmented_reference(tq, tk, tv)
    undecided = fa.fp16_overflow_undecided(tq, tk, tv, out, lse, tdo)
    for g, w, u in zip(got[1:], want[1:], undecided):
        bad_g, bad_w = ~np.isfinite(_f32(g)), ~np.isfinite(_f32(w))
        u = u.numpy()
        assert u.mean() < 0.05
        np.testing.assert_array_equal(bad_g[~u], bad_w[~u])
        assert bad_g[0, :, 0].any() and not bad_g[1].any()
        assert not bad_g[0, :, 1].any()
        ok = ~bad_g & ~bad_w
        np.testing.assert_allclose(_f32(g)[ok], _f32(w)[ok], rtol=2e-2,
                                   atol=2e-2 * np.abs(_f32(w)[ok]).max())


def test_layer_materialized_fp16_all_masked_row_matches_jax(monkeypatch):
    """The fused layer below the flash threshold (S = 128 < 256) in fp16,
    a keep-mask whose second batch row keeps nothing: the -1e30 penalty
    meets fp32 logits on both sides, and the row is finite."""
    monkeypatch.delenv("DS_FLASH_MIN_SEQ", raising=False)
    S, HID = 128, 128
    cfg = dict(hidden_size=HID, intermediate_size=4 * HID, heads=2,
               attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
               num_hidden_layers=2, initializer_range=0.02,
               pre_layer_norm=True)
    jl = jtr.DeepSpeedTransformerLayer(jtr.DeepSpeedTransformerConfig(**cfg))
    jp = jax.device_get(jl.init(jax.random.PRNGKey(0)))
    tl = tr.DeepSpeedTransformerLayer(tr.DeepSpeedTransformerConfig(**cfg),
                                      device="cpu")
    tl.load_state_dict(state_dict_from_jax(jp))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, S, HID)).astype(F16)
    keep = np.ones((B, S), np.float32)
    keep[0, 90:] = 0.0
    keep[1, :] = 0.0
    want = np.asarray(jl.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                               jnp.asarray(x),
                               attention_mask=jnp.asarray(keep),
                               deterministic=True))
    with torch.no_grad():
        got = tl.apply(tl.params(), torch.from_numpy(x),
                       attention_mask=torch.from_numpy(keep),
                       deterministic=True).numpy()
    assert got.dtype == want.dtype == F16
    assert np.isfinite(_f32(got)).all() and np.isfinite(_f32(want)).all()
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-2, rtol=1e-2)


def _decode_case(seed, Bd=4, Hd=2, ps=16, NP=4, P=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bd, Hd, D)).astype(F16)
    kp = rng.standard_normal((P, Hd, ps, D)).astype(F16)
    vp = rng.standard_normal((P, Hd, ps, D)).astype(F16)
    table = rng.permutation(np.arange(1, P))[:Bd * NP].reshape(Bd, NP)
    lengths = np.array([37, 0, 32, NP * ps], np.int32)
    live = np.arange(NP)[None] * ps < lengths[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_decode_fp16_pools_match_jax(backend):
    q, kp, vp, table, lengths = _decode_case(11)
    ref = np.asarray(jax_paged_decode(
        *map(jnp.asarray, (q, kp, vp, table, lengths)), backend=backend))
    out = da.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, kp, vp, table, lengths)))
    assert out.dtype == torch.float16 and ref.dtype == F16
    np.testing.assert_allclose(_f32(out.numpy()), _f32(ref), **FWD)
    assert (out.numpy()[lengths == 0] == 0).all()


def test_decode_design_takes_the_cluster_for_fp16_pools():
    q = torch.zeros(16, 12, 64, dtype=torch.float16)
    for dtype, design in ((torch.float16, "cluster"),
                          (torch.bfloat16, "cluster"),
                          (torch.float32, "single")):
        assert da.kernel_design(q, torch.zeros(1, 12, 64, 64,
                                               dtype=dtype)) == design
    assert da.kernel_design(torch.zeros(2, 2, 256, dtype=torch.float16),
                            torch.zeros(1, 2, 16, 256,
                                        dtype=torch.float16)) == "single"


SPAN, KD, ND = 8, 16, 12


@pytest.mark.parametrize("sizes,W,lut", [((8, 0, 5, 3), None, None),
                                         ((8, 3, 0, 6), 2, (0, 0, 1, 1))])
def test_grouped_matmul_fp16_matches_jax(sizes, W, lut):
    G = len(sizes)
    rng = np.random.default_rng(12)
    x = (0.5 * rng.standard_normal((G * SPAN, KD))).astype(F16)
    w = (0.5 * rng.standard_normal((W or G, KD, ND))).astype(F16)
    dy = rng.standard_normal((G * SPAN, ND)).astype(F16)
    sz = np.asarray(sizes, np.int32)

    def f(x, w):
        return jax_gmm(x, w, jnp.asarray(sz), SPAN, lut=lut,
                       backend="pallas", block_m=4, block_n=4)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = gm.grouped_matmul(xt, wt, torch.from_numpy(sz), SPAN, lut=lut)
    yt.backward(torch.from_numpy(dy))
    for got, want in ((yt.detach(), y), (xt.grad, jdx), (wt.grad, jdw)):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(_f32(got.numpy()), _f32(want), **FWD)
    dead = ~(np.arange(SPAN)[None] < sz[:, None]).reshape(-1)
    assert not np.abs(_f32(yt.detach().numpy()[dead])).any()


HP = dict(beta1=0.9, beta2=0.95, eps=1e-8)


@pytest.mark.parametrize("adam_w", [True, False])
def test_adam_classic_fp16_matches_jax(adam_w):
    """fp32 masters and moments with an fp16 gradient, and the fp16
    recast of the new masters (the classic fp16 variant)."""
    rng = np.random.default_rng(13)
    n = 10_000
    p = rng.standard_normal(n).astype(np.float32)
    g = (1e-2 * rng.standard_normal(n)).astype(F16)
    m = (1e-3 * rng.standard_normal(n)).astype(np.float32)
    v = (1e-5 * rng.random(n)).astype(np.float32)
    kw = dict(HP, weight_decay=0.01, adam_w=adam_w)
    ours = adam.adam_flat_reference(*map(torch.from_numpy, (p, g, m, v)),
                                    1e-3, 3, **kw)
    ref = jopt.fused_adam_flat(*map(jnp.asarray, (p, g, m, v)), 1e-3, 3,
                               **kw)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-6)
    pt, gt, mt, vt = (torch.from_numpy(a.copy()) for a in (p, g, m, v))
    out = torch.empty(n, dtype=torch.float16)
    adam.fused_adam_flat_(pt, gt, mt, vt, 1e-3, 3, p_out=out, **kw)
    assert torch.equal(out, pt.to(torch.float16))
    np.testing.assert_allclose(_f32(out.numpy()),
                               _f32(np.asarray(ref[0]).astype(F16)),
                               atol=0, rtol=1e-3)


@pytest.mark.parametrize("g_dtype", [np.float16, np.float32])
def test_adam_lean_fp16_matches_jax(g_dtype):
    """fp16 parameters and fp16 moments (the lean fp16 state) against the
    JAX `FusedAdam` with ``state_dtype`` float16: within one fp16 ulp."""
    rng = np.random.default_rng(14)
    n = 4096
    p = rng.standard_normal(n).astype(F16)
    g = (1e-2 * rng.standard_normal(n)).astype(g_dtype)
    jopt_ = JaxFusedAdam(lr=1e-3, betas=(0.9, 0.95), eps=1e-4,
                         weight_decay=0.01, state_dtype="float16")
    jstate = jopt_.init_state({"p": jnp.asarray(p)})
    jp = {"p": jnp.asarray(p)}
    pt = torch.from_numpy(p.copy())
    mt = torch.zeros(n, dtype=torch.float16)
    vt = torch.zeros(n, dtype=torch.float16)
    for step in (1, 2, 3):
        jp, jstate = jopt_.update({"p": jnp.asarray(g)}, jstate, jp)
        jp = {"p": jp["p"].astype(jnp.float16)}
        adam.fused_adam_flat_(pt, torch.from_numpy(g), mt, vt, 1e-3, step,
                              beta1=0.9, beta2=0.95, eps=1e-4,
                              weight_decay=0.01)
        for ours, ref in ((pt, jp["p"]), (mt, jstate.exp_avg["p"]),
                          (vt, jstate.exp_avg_sq["p"])):
            ref = _f32(ref)
            assert ours.dtype == torch.float16
            ulp = np.spacing(np.abs(ref).astype(F16)).astype(np.float32)
            assert (np.abs(_f32(ours.numpy()) - ref) <= ulp).all()
