"""The flash kernels' key-bias and dropout flags, and the fused layer's
hash dropout, against the JAX package on the CPU.

- `dropout_keep` is bit-equal to `_dropout_keep` and the layer's
  `_dropout` to the JAX layer's, at several seeds, rates, pids and tile
  offsets (int32 products wrap and ``>>`` is arithmetic in both);
- the plain versions of `flash_attention_kbias` and
  `flash_attention_train` (rate 0.1) against the JAX functions, forward
  and `jax.vjp`, causal and not, on the single-block Pallas kernels and
  on the tiled ones (blocks of 128 at S = 256: other tile origins for
  the hash), in interpret mode, with a ragged key mask, a finite bias
  row and a batch row whose keys are all masked (zeros, zero grads):
  fp32, rtol 1e-5 with an absolute floor of 1e-5 × max|ref| (the two
  sum the same products in other orders);
- the dropout-rate refusals (same messages), the dispatch rule
  `flash_attention_supported`, and the key bias's zero gradient;
- `chip_smoke.dropout_readout`, the probe that reads the keep-mask out
  of the bf16 kernels on the card, gives back `dropout_keep` bit for bit
  through the plain flagged forward and backward, so a mismatch there is
  the kernel's;
- the wrapper's choice of tile design by dtype and head dim (as the C
  dispatch's `takes_mma` makes it), its 16-byte alignment check on the
  tensor-core design, and its launch counts by design.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.ops.transformer import transformer as jtr

from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.transformer import transformer as tr

# the module, not the function the package re-exports under its name
jfa = importlib.import_module("deeperspeed_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

B, H, D = 2, 2, 64
SEED = 987654321


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the keep-masks, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,pid,row0,col0,rate", [
    (0, 0, 0, 0, 0.1),
    (12345, 3, 0, 0, 0.1),
    (2 ** 31 - 2, 77, 128, 256, 0.5),
    (987654321, 31, 1024, 0, 0.9),
    (7, 4095, 64, 1984, 0.25),
])
def test_dropout_keep_bit_equal(seed, pid, row0, col0, rate):
    want = np.asarray(jfa._dropout_keep(jnp.int32(seed), jnp.int32(pid),
                                        row0, col0, (64, 96), rate))
    got = fa.dropout_keep(seed, pid, row0, col0, (64, 96), rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


def test_dropout_keep_broadcasts_pids():
    pid = torch.arange(6, dtype=torch.int32).reshape(2, 3, 1, 1)
    got = fa.dropout_keep(torch.tensor([SEED], dtype=torch.int32), pid,
                          0, 0, (32, 48), 0.1)
    assert got.shape == (2, 3, 32, 48)
    for b in range(2):
        for h in range(3):
            want = np.asarray(jfa._dropout_keep(
                jnp.int32(SEED), jnp.int32(b * 3 + h), 0, 0, (32, 48), 0.1))
            np.testing.assert_array_equal(got[b, h].numpy(), want)


@pytest.mark.parametrize("key,rate,shape,dtype", [
    (0, 0.1, (2, 128, 64), "float32"),
    (1, 0.1, (3, 17, 5), "float32"),
    (2, 0.5, (2, 2, 128, 128), "float32"),
    (3, 0.1, (2, 64, 32), "bfloat16"),
])
def test_hidden_dropout_bit_equal(key, rate, shape, dtype):
    """The layer's `_dropout` at JAX's seed (one `randint` of the key, as
    the JAX `_dropout` draws it) against the JAX `_dropout`."""
    x = np.random.default_rng(key).standard_normal(shape).astype(np.float32)
    rng = jax.random.PRNGKey(key)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jtr._dropout(jx, rate, rng, False)
    seed = jax.random.randint(rng, (), 0, 2 ** 31 - 1, dtype=jnp.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tr._dropout(tx, rate, torch.tensor(int(seed), dtype=torch.int32),
                      False)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert tr._dropout(tx, rate, None, False) is tx
    assert tr._dropout(tx, rate, torch.tensor(1), True) is tx


# ---------------------------------------------------------------------------
# the plain flash versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    kbias = np.zeros((B, S), np.float32)
    kbias[0, S - S // 4 - 3:] = -1e30           # ragged key padding
    kbias[0, :5] = rng.standard_normal(5)       # a finite bias
    kbias[1, :] = -1e30                         # every key masked
    return q, k, v, do, kbias


def _run_jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _run_port(fn, q, k, v, do):
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]


CASES = [(128, 1024, False), (128, 1024, True), (256, 128, False),
         (256, 128, True)]


@pytest.mark.parametrize("S,block,causal", CASES)
def test_flash_kbias_matches_jax(S, block, causal):
    q, k, v, do, kbias = _inputs(S)
    want = _run_jax(lambda q, k, v: jfa.flash_attention_kbias(
        q, k, v, jnp.asarray(kbias), causal, None, block, block),
        q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_kbias(
        q, k, v, torch.from_numpy(kbias), causal), q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)
    for g in got:                      # the all-masked batch row
        assert not np.abs(g[1]).any()


@pytest.mark.parametrize("S,block,causal", CASES)
def test_flash_train_matches_jax(S, block, causal):
    q, k, v, do, kbias = _inputs(S, seed=1)
    seed = np.array([SEED], np.int32)
    want = _run_jax(lambda q, k, v: jfa.flash_attention_train(
        q, k, v, jnp.asarray(kbias), jnp.asarray(seed), causal, None, block,
        block, 0.1), q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_train(
        q, k, v, torch.from_numpy(kbias), torch.from_numpy(seed), causal,
        dropout_rate=0.1), q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)
    for g in got:
        assert not np.abs(g[1]).any()


def test_flash_train_without_bias_matches_jax():
    q, k, v, do, _ = _inputs(128, seed=2)
    seed = np.array([12345], np.int32)
    want = _run_jax(lambda q, k, v: jfa.flash_attention_train(
        q, k, v, None, jnp.asarray(seed), False, None, 1024, 1024, 0.25),
        q, k, v, do)
    got = _run_port(lambda q, k, v: fa.flash_attention_train(
        q, k, v, None, torch.from_numpy(seed), dropout_rate=0.25),
        q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)


def test_kbias_takes_a_zero_gradient():
    q, k, v, do, kbias = _inputs(128)
    tkb = torch.tensor(kbias, requires_grad=True)
    out = fa.flash_attention_kbias(*(torch.from_numpy(t) for t in (q, k, v)),
                                   tkb)
    out.backward(torch.from_numpy(do))
    assert tkb.grad is not None and not tkb.grad.any()


@pytest.mark.parametrize("rate", [-0.1, 1.0, 1.5])
def test_dropout_rate_refusals_match_jax(rate):
    q = jnp.zeros((1, 128, 1, 64))
    seed = jnp.zeros((1,), jnp.int32)
    with pytest.raises(ValueError) as jerr:
        jfa.flash_attention_train(q, q, q, None, seed, dropout_rate=rate)
    tq = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError) as terr:
        fa.flash_attention_train(tq, tq, tq, None,
                                 torch.zeros(1, dtype=torch.int32),
                                 dropout_rate=rate)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("rate_name", ["attn_dropout_ratio",
                                       "hidden_dropout_ratio"])
def test_layer_rate_refusal_matches_jax(rate_name):
    kw = dict(hidden_size=128, heads=2, num_hidden_layers=1,
              **{rate_name: 1.0})
    with pytest.raises(ValueError) as jerr:
        jtr.DeepSpeedTransformerLayer(jtr.DeepSpeedTransformerConfig(**kw))
    with pytest.raises(ValueError) as terr:
        tr.DeepSpeedTransformerLayer(tr.DeepSpeedTransformerConfig(**kw),
                                     device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shape", [(2, 128, 2, 64), (2, 512, 16, 64),
                                   (1, 200, 2, 64), (1, 256, 2, 32),
                                   (1, 64, 2, 64), (1, 2048, 2, 256)])
def test_flash_attention_supported_matches_jax(shape):
    assert fa.flash_attention_supported(shape) == \
        jfa.flash_attention_supported(shape)


def test_kbias_shape_is_checked():
    t = torch.zeros(2, 128, 2, 64)
    with pytest.raises(ValueError, match=r"kbias shape"):
        fa.flash_attention_kbias(t, t, t, torch.zeros(2, 64))


# ---------------------------------------------------------------------------
# the chip's mask readout, the tile design and its alignment check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_readout_probe_gives_keep_mask(dtype, rate):
    import chip_smoke
    S = 128
    seed = torch.tensor([SEED], dtype=torch.int32)
    fwd_mask, dv_mask = chip_smoke.dropout_readout(
        *chip_smoke.readout_plain(fa), B, S, H, D, rate, seed, dtype, "cpu")
    want = fa._keep_mask(seed, B, H, S, rate, "cpu")
    assert 0 < int(want.sum()) < want.numel()
    assert torch.equal(fwd_mask, want)
    assert torch.equal(dv_mask, want)


@pytest.mark.parametrize("dtype,head_dim,design", [
    (torch.bfloat16, 64, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 256, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma")])
def test_flash_design_by_dtype_and_head_dim(dtype, head_dim, design):
    assert fa.flash_design(dtype, head_dim) == design


def test_flash_design_matches_the_c_dispatch():
    import pathlib
    import re
    src = (pathlib.Path(fa.__file__).resolve().parents[2] / "csrc" /
           "attention_mma.cuh").read_text()
    body = src[src.index("constexpr bool takes_mma()"):]
    body = body[:body.index("}")]
    assert "bf16" in body
    assert tuple(int(d) for d in re.findall(r"D == (\d+)", body)) == \
        fa.MMA_HEAD_DIMS


def _fake_library(monkeypatch):
    """A library whose entry points launch nothing and succeed, so the
    wrappers' checks and counters run on the CPU; the module's launch
    counters are put back afterwards."""
    lib = types.SimpleNamespace(ds_flash_fwd=lambda *a: 0,
                                ds_flash_bwd_dkv=lambda *a: 0,
                                ds_flash_bwd_dq=lambda *a: 0)
    monkeypatch.setattr(fa._build, "load_library", lambda: lib)
    monkeypatch.setattr(fa._build, "stream_ptr", lambda t: None)
    for name in ("launches", "bwd_dkv_launches", "bwd_dq_launches",
                 "masked_launches", "masked_bwd_dkv_launches",
                 "masked_bwd_dq_launches"):
        monkeypatch.setattr(fa, name, getattr(fa, name))
    for name in ("flag_launches", "design_launches"):
        monkeypatch.setattr(fa, name, {k: dict(v) for k, v in
                                       getattr(fa, name).items()})


@pytest.mark.parametrize("case", ["pointer", "head_stride", "seq_stride"])
def test_tensor_core_design_refuses_misaligned_bf16(case, monkeypatch):
    _fake_library(monkeypatch)
    S = 64
    if case == "pointer":           # base 2 bytes past a 16-byte boundary
        q = torch.zeros(1, S, 2, D + 8, dtype=torch.bfloat16)[..., 1:D + 1]
    elif case == "head_stride":     # heads 68 elements (136 bytes) apart
        q = torch.zeros(1, S, 2, D + 4, dtype=torch.bfloat16)[..., :D]
    else:                           # rows 2·68 elements apart
        q = torch.zeros(1, S, 2 * D + 4, dtype=torch.bfloat16)[
            ..., :2 * D].unflatten(-1, (2, D))
    ok = torch.zeros(1, S, 2, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_alignment((("q", q),), "test")
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(q, ok, ok)
    lse = torch.zeros(2, S)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_cuda(ok, q, ok, lse, ok, lse)
    # fp32 takes the FMA steps, which read element by element
    fa.flash_attention_cuda(q.float(), ok.float(), ok.float())


def test_launches_are_counted_by_design(monkeypatch):
    _fake_library(monkeypatch)
    fa.reset_design_launches()
    S = 64
    # the split QKV views of the main paths are aligned
    qkv = torch.zeros(1, S, 2, 3 * D, dtype=torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    out, lse = fa.flash_attention_cuda(q, k, v)
    fa.flash_attention_bwd_cuda(q, k, v, lse, out, lse)
    big = torch.zeros(1, S, 1, 256, dtype=torch.bfloat16)
    fa.flash_attention_cuda(big, big, big)
    f32 = q.float()
    fa.flash_attention_bwd_cuda(f32, f32, f32, lse, f32, lse)
    assert fa.design_launches == {"fwd": {"mma": 1, "fma": 1},
                                  "dkv": {"mma": 1, "fma": 1},
                                  "dq": {"mma": 1, "fma": 1}}
    fa.reset_design_launches()
    assert all(n == 0 for c in fa.design_launches.values()
               for n in c.values())


# ---------------------------------------------------------------------------
# HF injection and BERT sparse attention
# ---------------------------------------------------------------------------

@pytest.fixture(params=["flash", "materialized"])
def path(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("DS_FLASH_MIN_SEQ", "0")
    else:
        monkeypatch.delenv("DS_FLASH_MIN_SEQ", raising=False)
    return request.param


def test_replace_transformer_layer_matches_hf_and_jax(path):
    """A random HF `BertLayer` stack (post-LN, eval) through the port's
    fused layers: the extracted weights equal the JAX extraction's, and
    the encoder's output matches the HF encoder and the JAX encoder_fn
    (fp32, rtol 1e-4 with a floor of 1e-4 × max|ref|)."""
    transformers = pytest.importorskip("transformers")
    from deeperspeed_tpu.module_inject import replace_module as jrm
    from deeperspeed_tpu_torch.module_inject import replace_module as rm
    cfg = transformers.BertConfig(
        vocab_size=64, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=512,
        max_position_embeddings=128, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertModel(cfg).eval()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    keep = np.ones((2, 128), np.float32)
    keep[0, 90:] = 0.0
    ext = hf.get_extended_attention_mask(torch.from_numpy(keep), (2, 128))
    with torch.no_grad():
        want = hf.encoder(torch.from_numpy(x),
                          attention_mask=ext).last_hidden_state.numpy()
    layers, params, enc = rm.replace_transformer_layer(
        None, hf, bert_config=cfg, device="cpu")
    jlayers, jparams, jenc = jrm.replace_transformer_layer(
        None, hf, bert_config=cfg)
    assert len(layers) == len(params) == 2
    for p, jp in zip(params, jparams):
        for name, t in p.items():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(jp[name]), name)
    with torch.no_grad():
        got = enc(params, torch.from_numpy(x), attention_mask=ext).numpy()
    jgot = np.asarray(jenc(jparams, jnp.asarray(x),
                           attention_mask=jnp.asarray(ext.numpy())))
    _close(got, want, rtol=1e-4)
    _close(got, jgot, rtol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_sparse_self_attention_matches_jax(masked):
    from deeperspeed_tpu.ops.sparse_attention import (
        BertSparseSelfAttention as JBertSparse,
        FixedSparsityConfig as JFixed)
    from deeperspeed_tpu_torch.ops.sparse_attention import (
        BertSparseSelfAttention, FixedSparsityConfig, SparseAttentionUtils)
    from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
    cfg = types.SimpleNamespace(hidden_size=128, num_attention_heads=2,
                                num_hidden_layers=2)
    jm = JBertSparse(cfg, JFixed(num_heads=2, block=16))
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    tm = BertSparseSelfAttention(cfg, FixedSparsityConfig(num_heads=2,
                                                          block=16),
                                 device="cpu")
    tm.load_state_dict(state_dict_from_jax(jp))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 256, 128)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 256), np.float32)
        mask[1, 200:] = 0.0
    want = np.asarray(jm.apply(jp, jnp.asarray(x), mask if mask is None
                               else jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if mask is None
                 else torch.from_numpy(mask)).numpy()
    _close(got, want, rtol=1e-4)
    layers = SparseAttentionUtils \
        .replace_model_self_attention_with_sparse_self_attention(
            cfg, FixedSparsityConfig(num_heads=2), device="cpu")
    assert len(layers) == 2
    tm.init_params(3)
    assert not tm.query.bias.any()


def test_sparse_attention_utils_match_jax():
    from deeperspeed_tpu.ops.sparse_attention import \
        SparseAttentionUtils as JUtils
    from deeperspeed_tpu_torch.ops.sparse_attention import \
        SparseAttentionUtils
    rng = np.random.default_rng(2)
    pe = rng.standard_normal((5, 4)).astype(np.float32)
    for n in (3, 12):
        np.testing.assert_array_equal(
            SparseAttentionUtils.extend_position_embedding(
                torch.from_numpy(pe), n).numpy(),
            np.asarray(JUtils.extend_position_embedding(pe, n)))
    ids = rng.integers(1, 50, (2, 21)).astype(np.int64)
    mask = np.ones((2, 21), np.int64)
    pos = np.broadcast_to(np.arange(21), (2, 21)).copy()
    emb = rng.standard_normal((2, 21, 4)).astype(np.float32)
    table = rng.standard_normal((50, 4)).astype(np.float32)
    want = JUtils.pad_to_block_size(16, ids, mask, mask, pos, emb, 0, table)
    got = SparseAttentionUtils.pad_to_block_size(
        16, *(torch.from_numpy(t) for t in (ids, mask, mask, pos, emb)), 0,
        torch.from_numpy(table))
    assert got[0] == want[0] == 11
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = SparseAttentionUtils.unpad_sequence_output(11, got[5])
    assert out.shape == (2, 21, 4)
