"""The port's int8 serving slice against the JAX package's, on the CPU.

- `quantize_weight` and `quantize_kv`: int8 values and scales bit-equal
  to JAX's, round-half-to-even ties and zero vectors included.
- `prepare_inference_params(weight_quant="int8")`: the same leaves as
  JAX's; only the ``blocks`` matmul weights are quantized.
- The plain weight-only int8 matmul and the plain int8 paged decode
  against the JAX functions, with the Pallas kernels in interpret mode
  and their XLA references; the error messages are JAX's.
- The whole slice: the port's `InferenceEngine(device="cpu")` and the
  JAX `InferenceEngine` (use_pallas=False) on the same weights give
  identical greedy tokens for int8 weights, int8 KV pages and both, and
  their int8 pools agree.

The CUDA kernels run only on the card: `chip_smoke.py` holds them
against these plain versions there.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.inference.kv_cache import PagedKVCache as JaxCache
from deeperspeed_tpu.inference.kv_cache import quantize_kv as jax_quantize_kv
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.module_inject.replace_module import \
    prepare_inference_params as jax_prepare
from deeperspeed_tpu.ops.pallas import quant_matmul as jqm
from deeperspeed_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_paged_decode
from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, InferenceEngine
from deeperspeed_tpu_torch.inference import (PagedKVCache, QuantizedPages,
                                             quantize_kv)
from deeperspeed_tpu_torch.models import gpt_neox as neox_mod
from deeperspeed_tpu_torch.module_inject.replace_module import \
    prepare_inference_params
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
RUNGS = {
    "int8w": ({}, {"quantization": {"weights": "int8"}}),
    "int8kv": ({"kv_cache_dtype": "int8"}, {}),
    "int8w_int8kv": ({"kv_cache_dtype": "int8"},
                     {"quantization": {"weights": "int8"}}),
}


def _config(rung, **kw):
    block = {"enabled": True, "page_size": 16, "num_pages": 40,
             "max_batch_size": 4, "token_budget": 256,
             "prefill_lengths": [16, 32, 64], "prefill_batch_sizes": [2],
             "decode_batch_sizes": [4]}
    inf, top = RUNGS[rung]
    block.update(inf)
    block.update(kw)
    return {"inference": block, **top}


@pytest.fixture(scope="module")
def models():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    jmodel = jneox.GPTNeoX(config=jcfg, use_pallas=False)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    model = GPTNeoX(GPTNeoXConfig(**SIZE), device="cpu")
    model.load_jax_params(jparams)
    return jmodel, jparams, model


def _with_ties(rng, shape, axis):
    """Random values plus exact round-half ties: along ``axis`` each
    vector's amax is 127 · 2^-7, so its scale is exactly 2^-7 and the
    planted entries land on k + 0.5; the first vector is all zero
    (scale 1). Every value is exact in bf16 too."""
    x = rng.uniform(-0.98, 0.98, shape).astype(np.float32)
    x = np.moveaxis(x, axis, -1)
    x[..., 0] = 127 / 128
    x[..., 1] = 2.5 / 128      # → 2 (half to even)
    x[..., 2] = -3.5 / 128     # → -4
    x[..., 3] = 0.5 / 128      # → 0
    x[(0,) * (x.ndim - 1)] = 0.0
    return np.ascontiguousarray(np.moveaxis(x, -1, axis))


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((64, 96), "float32"), ((128, 48), "bfloat16"), ((3, 32, 40), "float32"),
])
def test_quantize_weight_bit_equal(shape, dtype):
    w = _with_ties(np.random.default_rng(0), shape, axis=-2)
    ref = jqm.quantize_weight(jnp.asarray(w, getattr(jnp, dtype)))
    ours = qm.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert ours.qval.dtype == torch.int8 and ours.scale.dtype == torch.float32
    np.testing.assert_array_equal(ours.qval.numpy(), np.asarray(ref.qval))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    assert ours.scale.numpy().reshape(-1)[0] == 1.0     # the zero column
    assert (ours.qval.numpy()[..., 1:4, 1] == [2, -4, 0]).all()


@pytest.mark.parametrize("shape,dtype", [
    ((6, 2, 16, 64), "float32"), ((9, 4, 32), "bfloat16"),
])
def test_quantize_kv_bit_equal(shape, dtype):
    v = _with_ties(np.random.default_rng(1), shape, axis=-1)
    rq, rs = jax_quantize_kv(jnp.asarray(v, getattr(jnp, dtype)))
    q, s = quantize_kv(torch.from_numpy(v).to(getattr(torch, dtype)))
    assert s.numpy().reshape(-1)[0] == 1.0
    assert (q.numpy()[..., 1:4].reshape(-1, 3)[1:] == [2, -4, 0]).all()
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    # stored as bf16 after the fp32 rounding, as both engines do
    np.testing.assert_array_equal(
        s.to(torch.bfloat16).float().numpy(),
        np.asarray(rs.astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_inference_params_int8_matches_jax(models, dtype):
    _, jparams, model = models
    ref = jax_prepare(jparams, getattr(jnp, dtype), weight_quant="int8")
    ours = prepare_inference_params(dict(model.named_parameters()),
                                    getattr(torch, dtype),
                                    weight_quant="int8", device="cpu")
    quantized = {n for n, leaf in ours.items()
                 if isinstance(leaf, qm.QuantizedWeight)}
    assert quantized == {n for n in ours
                         if n.startswith("blocks.") and
                         "_w" in n.rsplit(".", 1)[-1]}
    assert len(quantized) == 4 * SIZE["num_layers"]
    for name, leaf in ours.items():
        node = ref
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        if name in quantized:
            assert isinstance(node, jqm.QuantizedWeight)
            np.testing.assert_array_equal(leaf.qval.numpy(),
                                          np.asarray(node.qval))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(node.scale))
        else:
            want = getattr(torch, dtype) if leaf.dim() >= 2 \
                else torch.float32
            assert leaf.dtype == want
            np.testing.assert_array_equal(
                leaf.float().numpy(), np.asarray(node, np.float32))


def test_prepare_inference_params_rejects_what_jax_rejects(models):
    _, jparams, model = models
    with pytest.raises(ValueError, match="weight_quant must be None or "
                                         "'int8'"):
        jax_prepare(jparams, jnp.float32, weight_quant="int4")
    with pytest.raises(ValueError, match="weight_quant must be None or "
                                         "'int8'"):
        prepare_inference_params(dict(model.named_parameters()),
                                 torch.float32, weight_quant="int4")
    with pytest.raises(ValueError, match="needs params with 'blocks."):
        prepare_inference_params({"w": torch.zeros(2, 2)}, torch.float32,
                                 weight_quant="int8")


# ---------------------------------------------------------------------------
# the plain weight-only int8 matmul
# ---------------------------------------------------------------------------

def _matmul_case(seed, lead, K=96, N=80):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("lead", [(24,), (3, 5)], ids=["2d", "3d"])
def test_quant_matmul_reference_matches_jax(backend, lead):
    x, w = _matmul_case(2, lead)
    jqw = jqm.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jqw, backend=backend))
    qw = qm.quantize_weight(torch.from_numpy(w))
    out = qm.quant_matmul(torch.from_numpy(x), qw)
    assert out.shape == lead + (w.shape[1],) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jqm.quant_matmul_xla(
            jnp.asarray(x).reshape(-1, x.shape[-1]), jqw)).reshape(ref.shape),
        atol=1e-5, rtol=0)


def test_quant_matmul_bf16_keeps_x_dtype():
    x, w = _matmul_case(3, (8,))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qw = qm.quantize_weight(torch.from_numpy(w))
    out = qm.quant_matmul(xb, qw)
    assert out.dtype == torch.bfloat16
    # fp32 accumulation of exact bf16·int8 products, one output rounding
    want = (xb.float() @ qw.dequant()).to(torch.bfloat16)
    torch.testing.assert_close(out.float(), want.float(), atol=1e-2,
                               rtol=1e-2)


def test_quant_matmul_errors_match_jax():
    x, w = _matmul_case(4, (4,))
    jqw = jqm.quantize_weight(jnp.asarray(w))
    qw = qm.quantize_weight(torch.from_numpy(w))
    for jx, tx in ((jnp.asarray(x[:, :-1]), torch.from_numpy(x[:, :-1])),):
        with pytest.raises(ValueError) as jerr:
            jqm.quant_matmul(jx, jqw)
        with pytest.raises(ValueError) as terr:
            qm.quant_matmul(tx, qw)
        assert str(terr.value) == str(jerr.value)
    bad_j = jqm.QuantizedWeight(jqw.qval, jqw.scale[:-1])
    bad_t = qm.QuantizedWeight(qw.qval, qw.scale[:-1])
    with pytest.raises(ValueError) as jerr:
        jqm.quant_matmul(jnp.asarray(x), bad_j)
    with pytest.raises(ValueError) as terr:
        qm.quant_matmul(torch.from_numpy(x), bad_t)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="backend"):
        qm.quant_matmul(torch.from_numpy(x), qw, backend="cuda")


def test_quant_matmul_backends_on_cpu_never_launch():
    x, w = _matmul_case(5, (6,))
    qw = qm.quantize_weight(torch.from_numpy(w))
    before = qm.launches
    outs = [qm.quant_matmul(torch.from_numpy(x), qw, backend=b)
            for b in (None, "auto", "pallas", "xla")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert qm.launches == before


def _unreadable(case):
    """Inputs the kernel cannot read, built on the CPU: the wrapper's
    checks run before the library is loaded, so they raise here as on
    the card. Returns (x, qw, message pattern)."""
    g = torch.Generator().manual_seed(7)
    contig = "contraction dim contiguous"
    chunks = "reads 16-byte chunks"
    if case == "one_row_strided":           # [1, K] with stride(1) 2
        x, K, N, dt, msg = torch.randn(1, 192, generator=g)[:, ::2], 96, \
            64, torch.float32, contig
    elif case == "rows_strided":
        x, K, N, dt, msg = torch.randn(5, 192, generator=g)[:, ::2], 96, \
            64, torch.float32, contig
    elif case == "bf16_unaligned":          # 6 bytes into the row
        x, K, N, dt, msg = torch.randn(4, 104, generator=g).to(
            torch.bfloat16)[:, 3:99], 96, 64, torch.bfloat16, chunks
    elif case == "bf16_row_stride":         # rows 100 elements apart
        x, K, N, dt, msg = torch.randn(4, 100, generator=g).to(
            torch.bfloat16)[:, :96], 96, 64, torch.bfloat16, chunks
    elif case == "bf16_k":
        x, K, N, dt, msg = torch.randn(4, 100, generator=g).to(
            torch.bfloat16), 100, 64, torch.bfloat16, chunks
    else:                                   # bf16, N % 16 != 0
        x, K, N, dt, msg = torch.randn(4, 96, generator=g).to(
            torch.bfloat16), 96, 24, torch.bfloat16, chunks
    qw = qm.quantize_weight(torch.randn(K, N, generator=g))
    return x.to(dt), qw, msg


@pytest.mark.parametrize("case", [
    "one_row_strided", "rows_strided", "bf16_unaligned", "bf16_row_stride",
    "bf16_k", "bf16_n"])
def test_quant_matmul_kernel_wrapper_refuses_unreadable_inputs(case):
    """The kernel wrapper raises on an x it cannot read instead of
    reading it wrongly or taking another path: a contraction dim with a
    stride (one row or many), and for bf16 anything the tensor-core
    path's 16-byte chunks cannot cover. The plain version takes them."""
    x, qw, msg = _unreadable(case)
    before = qm.launches
    with pytest.raises(ValueError, match=msg):
        qm.quant_matmul_cuda(x, qw)
    assert qm.launches == before
    out = qm.quant_matmul(x, qw)
    ref = (x.float() @ qw.dequant()).to(x.dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# the plain int8 paged decode
# ---------------------------------------------------------------------------

def _int8_decode_case(seed, B=4, H=2, D=64, ps=32, NP=3, P=16):
    """int8 pools with bf16 scales, a page permutation, lengths with 0, a
    partial page and an exact page edge, trash page 0 past every length."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.integers(-127, 128, (P, H, ps, D)).astype(np.int8)
    vp = rng.integers(-127, 128, (P, H, ps, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (P, H, ps)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (P, H, ps)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(B, NP)
    lengths = np.array([45, 0, 32, NP * ps][:B], np.int32)
    live = np.arange(NP)[None] * ps < lengths[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    return q, kp, vp, ks, vs, table, lengths


def _torch_args(case):
    q, kp, vp, ks, vs, table, lengths = case
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    scales = [torch.from_numpy(a).to(torch.bfloat16) for a in (ks, vs)]
    return t, scales


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_int8_decode_reference_matches_jax(backend):
    case = _int8_decode_case(0)
    q, kp, vp, ks, vs, table, lengths = case
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), backend=backend,
        k_scales=jnp.asarray(ks, jnp.bfloat16),
        v_scales=jnp.asarray(vs, jnp.bfloat16)))
    (tq, tkp, tvp, tt, tl), (tks, tvs) = _torch_args(case)
    out = da.paged_decode_attention_reference(tq, tkp, tvp, tt, tl,
                                              k_scales=tks, v_scales=tvs)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    assert (out.numpy()[lengths == 0] == 0.0).all()


def test_int8_decode_bf16_q_and_trash_page():
    """bf16 q gives a bf16 output; the trash page's contents and scales
    never reach a live row."""
    (tq, tkp, tvp, tt, tl), (tks, tvs) = _torch_args(_int8_decode_case(1))
    out = da.paged_decode_attention(tq.to(torch.bfloat16), tkp, tvp, tt, tl,
                                    k_scales=tks, v_scales=tvs)
    assert out.dtype == torch.bfloat16
    tkp, tvp, tks, tvs = (t.clone() for t in (tkp, tvp, tks, tvs))
    tkp[0], tvp[0], tks[0], tvs[0] = 127, -127, 1e3, 1e3
    out2 = da.paged_decode_attention(tq.to(torch.bfloat16), tkp, tvp, tt,
                                     tl, k_scales=tks, v_scales=tvs)
    live = tl > 0
    assert torch.equal(out[live], out2[live])


def test_int8_decode_scale_errors_match_jax():
    case = _int8_decode_case(2)
    q, kp, vp, ks, vs, table, lengths = case
    (tq, tkp, tvp, tt, tl), (tks, tvs) = _torch_args(case)
    for jk, jv, tk, tv in (
            (jnp.asarray(ks[:, :1]), jnp.asarray(vs), tks[:, :1], tvs),
            (jnp.asarray(ks), None, tks, None),
            (jnp.asarray(ks), jnp.asarray(vs[..., :8]), tks, tvs[..., :8])):
        with pytest.raises(ValueError) as jerr:
            jax_paged_decode(*map(jnp.asarray, (q, kp, vp, table, lengths)),
                             k_scales=jk, v_scales=jv)
        with pytest.raises(ValueError) as terr:
            da.paged_decode_attention(tq, tkp, tvp, tt, tl, k_scales=tk,
                                      v_scales=tv)
        assert str(terr.value) == str(jerr.value)


def test_int8_decode_backends_on_cpu_never_launch():
    (tq, tkp, tvp, tt, tl), (tks, tvs) = _torch_args(_int8_decode_case(3))
    before = (da.launches, da.launches_int8)
    outs = [da.paged_decode_attention(tq, tkp, tvp, tt, tl, backend=b,
                                      k_scales=tks, v_scales=tvs)
            for b in (None, "auto", "pallas", "xla")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert (da.launches, da.launches_int8) == before


# ---------------------------------------------------------------------------
# the int8 cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tdtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                           (torch.int8, jnp.int8)])
def test_cache_layout_and_capacity_match_jax(tdtype, jdtype):
    kw = dict(num_layers=3, num_pages=5, num_heads=2, page_size=16,
              head_dim=64)
    ours, ref = PagedKVCache(dtype=tdtype, **kw), JaxCache(dtype=jdtype, **kw)
    assert ours.bytes_per_token() == ref.bytes_per_token()
    assert ours.tokens_capacity == ref.tokens_capacity
    assert ours.quantized == ref.quantized
    if ours.quantized:
        assert isinstance(ours.k, QuantizedPages)
        assert ours.k.data.dtype == torch.int8 and \
            ours.k.scale.dtype == torch.bfloat16
        assert tuple(ours.k.scale.shape) == tuple(ref.k.scale.shape)
        assert (ours.k.scale == 1).all()
        layer = ours.k[1]
        assert layer.data.data_ptr() == ours.k.data[1].data_ptr()
        assert ours.data_array(ours.k) is ours.k.data
    else:
        assert ours.data_array(ours.k) is ours.k
    # the capacity ratio of the serving-quant benchmark at D = 64
    if ours.quantized:
        bf16 = PagedKVCache(dtype=torch.bfloat16, **kw).bytes_per_token()
        assert bf16 / ours.bytes_per_token() == pytest.approx(128 / 66)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def _bf16_ulps(a, b):
    """|bit distance| of two bf16 tensors of positive values."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.parametrize("rung", list(RUNGS))
def test_greedy_tokens_and_pools_match_the_jax_engine(models, rung):
    jmodel, jparams, model = models
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (5, 17, 33, 60)]
    conf = _config(rung)
    jeng = JaxEngine(jmodel, config=conf, params=jparams)
    ref = jeng.generate(prompts, max_new_tokens=12)
    eng = InferenceEngine(model, config=conf, device="cpu")
    out = eng.generate(prompts, max_new_tokens=12)
    assert out == ref
    assert {k: v.replace("torch.", "") for k, v in eng.dtypes.items()} == \
        jeng.dtypes
    assert eng.cache.num_free == eng.cache.num_pages - 1
    if not eng.kv_quant:
        return
    # the pools after the stream (page 0, the trash page, is written by
    # padding rows in an unspecified order and left out). K/V reach the
    # quantizer after fp32 matmuls summed in another order than XLA's, so
    # a value a rounding step away from a half-integer may round to its
    # neighbour, and an amax may differ in its last bit: rare, and never
    # by more than one int8 unit or one bf16 ulp of the scale
    written = 0
    for ours, theirs in ((eng.cache.k, jeng.cache.k),
                         (eng.cache.v, jeng.cache.v)):
        d = ours.data[:, 1:].int()
        dj = torch.from_numpy(np.array(theirs.data)[:, 1:]).int()
        s = ours.scale[:, 1:]
        sj = torch.from_numpy(np.array(
            theirs.scale.astype(jnp.float32))[:, 1:]).to(torch.bfloat16)
        assert (d == dj).float().mean() >= 0.999
        assert ((d - dj).abs() <= 1).all()
        assert (s == sj).float().mean() >= 0.999
        assert (_bf16_ulps(s, sj) <= 1).all()
        written += int((s != 1).sum())
    assert written > 1000


def test_int8_engine_dtypes_and_no_launch(models):
    _, _, model = models
    counts = (qm.launches, da.launches, da.launches_int8, fa.launches)
    eng = InferenceEngine(model, config=_config("int8w_int8kv"),
                          device="cpu")
    assert eng.dtypes == {"weight": "int8", "compute": "torch.float32",
                          "kv_cache": "int8"}
    assert eng.kv_quant and eng.weight_quant == "int8"
    qkv = eng.params["blocks"][0]["attn"]["qkv_w"]
    assert isinstance(qkv, qm.QuantizedWeight)
    assert eng.params["embed"]["wte"].dtype == torch.float32
    assert eng.params["blocks"][0]["attn"]["qkv_b"].dtype == torch.float32
    assert isinstance(eng.cache.k, QuantizedPages)
    (out,) = eng.generate([[1, 2, 3, 4, 5]], max_new_tokens=4)
    assert len(out) == 4 and all(0 <= t < 512 for t in out)
    assert (qm.launches, da.launches, da.launches_int8,
            fa.launches) == counts


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("rung", list(RUNGS))
def test_int8_rungs_agree_across_kernel_choices(models, rung, kernel,
                                                monkeypatch):
    """On CPU tensors every ``inference.kernel`` choice takes the plain
    versions, so the tokens equal the plain-path engine's (``xla`` with
    ``use_kernels=False``); the choice reaches each quantized matmul.
    (32-slot pages: the schema refuses "pallas" with int8 pages of 16.)"""
    _, _, model = models
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (7, 30)]
    pages = dict(page_size=32, prefill_lengths=[32, 64])
    eng = InferenceEngine(model, config=_config(rung, kernel=kernel,
                                                **pages), device="cpu")
    seen = []

    def spy(x, w, backend=None):
        seen.append(backend)
        return qm.quant_matmul(x, w, backend=backend)
    monkeypatch.setattr(neox_mod, "quant_matmul", spy)
    out = eng.generate(prompts, max_new_tokens=5)
    monkeypatch.undo()
    model.use_kernels = False
    try:
        plain = InferenceEngine(
            model, config=_config(rung, kernel="xla", **pages),
            device="cpu").generate(prompts, max_new_tokens=5)
    finally:
        model.use_kernels = True
    assert out == plain
    assert set(seen) == ({kernel} if eng.weight_quant else set())


@pytest.mark.parametrize("rung", list(RUNGS))
def test_int8_rungs_serve_bf16(models, rung):
    _, _, model = models
    params = {k: (v.to(torch.bfloat16) if v.dim() >= 2 else v)
              for k, v in model.state_dict().items()}
    eng = InferenceEngine(model, config=_config(rung), params=params,
                          device="cpu")
    assert eng.compute_dtype == torch.bfloat16
    outs = eng.generate([[1, 2, 3], list(range(1, 40))], max_new_tokens=4)
    assert all(len(o) == 4 and all(0 <= t < 512 for t in o) for o in outs)
    assert eng.dtypes["compute"] == "torch.bfloat16"
    assert eng.cache.num_free == eng.cache.num_pages - 1


@pytest.mark.parametrize("M,K,N", [
    (16, 768, 2304), (16, 768, 768), (16, 768, 3072), (16, 3072, 768),
    (256, 768, 3072), (4096, 768, 3072), (4096, 3072, 768), (7, 104, 80),
])
def test_launch_plan(M, K, N):
    """The bf16 kernel's plan (computed in Python, passed to its one
    launch): the least token tile of 16-128 rows that holds M, 256-row
    tiles only where 128-row tiles alone would fill the card; a cluster
    of 1, 2, 4 or 8 CTAs, each keeping at least 2 of the K tiles, that
    stops growing only where the 8-CTA limit, the K tiles or the card's
    SMs stop it; every decode-row output tile split at least 4 ways."""
    tile, cluster, grid = qm.launch_plan(M, N, K)
    n_tiles = -(-N // qm.WGMMA_WN)
    least = min([t for t in (16, 32, 64, 128) if t >= M] or [128])
    assert tile == (256 if n_tiles * -(-M // least) > qm.SMS else least)
    assert cluster in (1, 2, 4, 8)
    assert tile < 256 or cluster == 1   # the kernel's 256-row tile is lone
    tiles = n_tiles * -(-M // tile)
    k_tiles = -(-K // qm.WGMMA_BK)
    assert grid == tiles * cluster
    assert cluster == 1 or (k_tiles >= qm.MIN_K_TILES * cluster
                            and grid <= qm.SMS)
    assert cluster == qm.MAX_CLUSTER or 2 * grid > qm.SMS or \
        k_tiles < qm.MIN_K_TILES * 2 * cluster
    k_per_rank = -(-k_tiles // cluster)
    assert (cluster - 1) * k_per_rank < k_tiles      # no rank left idle
    if M <= 16 and K >= 768:
        assert cluster >= 4


def _fake_library(monkeypatch):
    """A library whose int8 matmul entry records its arguments and
    succeeds, so the wrapper's plan, checks and counters run on the CPU;
    the module's counters are put back afterwards."""
    calls = []
    lib = types.SimpleNamespace(
        ds_quant_matmul=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(qm._build, "load_library", lambda: lib)
    monkeypatch.setattr(qm._build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(qm, "launches", qm.launches)
    monkeypatch.setattr(qm, "design_launches", dict(qm.design_launches))
    return calls


@pytest.mark.parametrize("M,K,N", [(16, 768, 3072), (256, 3072, 768),
                                   (4096, 768, 2304)])
def test_one_launch_a_call_counted_by_design(M, K, N, monkeypatch):
    """Every call is one library call that carries `launch_plan`'s token
    tile and cluster; bf16 counts as the "wgmma" design, fp32 as "fma"."""
    calls = _fake_library(monkeypatch)
    qm.reset_design_launches()
    g = torch.Generator().manual_seed(3)
    qw = qm.quantize_weight(torch.randn(K, N, generator=g))
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    out = qm.quant_matmul_cuda(x, qw)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    tile, cluster, _ = qm.launch_plan(M, N, K)
    assert len(calls) == 1 and calls[0][5:11] == (M, N, K, tile, cluster, 1)
    qm.quant_matmul_cuda(x.float(), qw)
    assert len(calls) == 2 and calls[1][10] == 0
    assert qm.design_launches == {"wgmma": 1, "fma": 1}
    qm.reset_design_launches()
    assert qm.design_launches == {"wgmma": 0, "fma": 0}


@pytest.mark.parametrize("case", [
    "bf16_unaligned", "bf16_row_stride", "bf16_k", "bf16_n"])
def test_sixteen_byte_refusals_never_reach_the_library(case, monkeypatch):
    """What the TMA loads cannot read raises before the library is
    called, and nothing is counted; the aligned x of the same shape
    launches once."""
    calls = _fake_library(monkeypatch)
    x, qw, msg = _unreadable(case)
    before = dict(qm.design_launches)
    with pytest.raises(ValueError, match="16-byte"):
        qm.quant_matmul_cuda(x, qw)
    assert calls == [] and qm.design_launches == before
    if case in ("bf16_unaligned", "bf16_row_stride"):
        qm.quant_matmul_cuda(x.contiguous(), qw)
        assert len(calls) == 1
