"""The port's document packing against the JAX package's, on the CPU.

- every function of `runtime/packing.py` against the JAX module on the
  same numpy inputs, bit for bit (numpy in both; torch tensors in the
  port against jnp arrays in JAX);
- the "packing" block's parse and its errors against the JAX
  `DeepSpeedConfig` (the same messages);
- the packed-vs-padded pins of the JAX `tests/test_packing.py`: a packed
  row's per-document loss and hidden states equal each document run
  alone (rtol 1e-5);
- the segmented GPT-NeoX loss and gradients against `jax.value_and_grad`
  of the JAX model on the same weights (fp32, atol 1e-6, rtol 1e-5);
- BERT `encode(segment_ids=)` against the JAX encoder at S = 128, on the
  materialized path and, with ``DS_FLASH_MIN_SEQ=0``, on the non-causal
  segmented flash path (Pallas in interpret mode), and with a key mask;
- `pack_dataset` takes the block's knobs; a packed model refuses a batch
  without segment ids, with the JAX message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import bert as jbert
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.runtime import packing as jpk
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import bert
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.runtime import packing as pk
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

SIZE = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=128)


def _docs(seed=0, n=24, vocab=97, mean_len=40.0, max_len=None):
    return jpk.synthetic_doc_mixture(seed, n, vocab, mean_len=mean_len,
                                     max_len=max_len)


# ---------------------------------------------------------------------------
# the module against the JAX one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,mean_len,sigma,max_len", [
    (0, 600.0, 1.0, None), (7, 2048.0, 1.2, 16384), (3, 40.0, 0.5, 64)])
def test_synthetic_doc_mixture_is_jax_bit_for_bit(seed, mean_len, sigma,
                                                  max_len):
    got = pk.synthetic_doc_mixture(seed, 32, 8192, mean_len=mean_len,
                                   sigma=sigma, max_len=max_len)
    want = jpk.synthetic_doc_mixture(seed, 32, 8192, mean_len=mean_len,
                                     sigma=sigma, max_len=max_len)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad_id,drop_tail", [(0, False), (5, True)])
def test_pack_documents_is_jax_bit_for_bit(pad_id, drop_tail):
    # long documents split into pieces, an empty one skipped, equal
    # lengths keep their order
    docs = _docs(1, 30, max_len=300) + [np.zeros((0,), np.int32),
                                        np.arange(10, dtype=np.int64)]
    got = pk.pack_documents(docs, 128, pad_id=pad_id, drop_tail=drop_tail)
    want = jpk.pack_documents(docs, 128, pad_id=pad_id, drop_tail=drop_tail)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    empty = pk.pack_documents([], 16)
    assert [a.shape for a in empty] == [(0, 16), (0, 16)]


def test_packed_dataset_matches_jax():
    docs = _docs(2)
    ours, ref = pk.PackedDataset(docs, 64), jpk.PackedDataset(docs, 64)
    assert len(ours) == len(ref) and ours.seq_len == ref.seq_len
    assert ours.occupancy() == ref.occupancy()
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    assert pk.PackedDataset([], 8).occupancy() == 0.0
    assert pk.PAD_SEGMENT_ID == jpk.PAD_SEGMENT_ID == 0


def _segments():
    tok, seg = jpk.pack_documents(_docs(4, 40), 96)
    return tok, seg


def test_label_masking_and_positions_match_jax():
    tok, seg = _segments()
    labels = tok.astype(np.int64)
    # numpy against numpy
    np.testing.assert_array_equal(
        pk.mask_cross_document_labels(labels, seg),
        jpk.mask_cross_document_labels(labels, seg))
    np.testing.assert_array_equal(pk.segment_relative_positions(seg),
                                  jpk.segment_relative_positions(seg))
    assert pk.segment_relative_positions(seg).dtype == np.int32
    # torch against jnp
    got = pk.mask_cross_document_labels(torch.from_numpy(labels),
                                        torch.from_numpy(seg),
                                        ignore_index=-7)
    want = jpk.mask_cross_document_labels(jnp.asarray(tok),
                                          jnp.asarray(seg), ignore_index=-7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = pk.segment_relative_positions(torch.from_numpy(seg))
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jpk.segment_relative_positions(
            jnp.asarray(seg))))


def test_token_counts_match_jax():
    tok, seg = _segments()
    assert pk.count_effective_targets(seg) == \
        jpk.count_effective_targets(seg)
    stacked = (tok[None], tok[None], seg[None])
    assert pk.packed_batch_token_stats(stacked) == \
        jpk.packed_batch_token_stats(stacked)
    assert pk.packed_batch_token_stats(
        (torch.from_numpy(tok), None, torch.from_numpy(seg))) == \
        jpk.packed_batch_token_stats((tok, None, seg))
    for batch in ((tok, tok), tok, (tok, tok, seg[:, :1]),
                  (tok, tok, seg[0])):
        assert pk.packed_batch_token_stats(batch) is None
        assert jpk.packed_batch_token_stats(batch) is None


# ---------------------------------------------------------------------------
# the "packing" block against the JAX parser
# ---------------------------------------------------------------------------

def _conf(**extra):
    return {"train_batch_size": 2, **extra}


@pytest.mark.parametrize("block,extra", [
    ({"enabled": True, "pad_len": 3}, {}),
    ({"enabled": "yes"}, {}),
    ({"enabled": True, "pad_id": -1}, {}),
    ({"enabled": True, "pad_id": 1.5}, {}),
    ({"enabled": True, "drop_tail": 1}, {}),
    ({"enabled": True}, {"sparse_attention": {"mode": "fixed"}}),
])
def test_packing_block_errors_match_jax(block, extra):
    conf = _conf(packing=block, **extra)
    with pytest.raises(JaxConfigError) as want:
        JaxConfig(conf, world_size=1)
    with pytest.raises(DeepSpeedConfigError) as got:
        DeepSpeedConfig(conf)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("block", [
    None, {"enabled": False}, {"enabled": True},
    {"enabled": True, "pad_id": 3, "drop_tail": True}])
def test_packing_block_parses_as_jax(block):
    conf = _conf() if block is None else _conf(packing=block)
    ours, ref = DeepSpeedConfig(conf), JaxConfig(conf, world_size=1)
    assert ours.packing_params == ref.packing_params
    assert getattr(ours, "packing_enabled", False) == \
        getattr(ref, "packing_enabled", False)


# ---------------------------------------------------------------------------
# packed vs padded, and the segmented model against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def neox_weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jax.device_get(jneox.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(neox_weights):
    return neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(neox_weights)


def test_packed_vs_padded_loss_pin(model):
    """The same documents packed into one row and padded one a row give
    the same loss over the identical target set: packing changes the
    loss only through the cross-document attention it removes."""
    S = 128
    rng = np.random.default_rng(2)
    docs = [rng.integers(1, 97, n, dtype=np.int32) for n in (50, 40, 30)]
    tok_p, seg_p = pk.pack_documents(docs, S)
    assert tok_p.shape[0] == 1
    tok_d = np.zeros((3, S), np.int32)
    seg_d = np.zeros((3, S), np.int32)
    for i, d in enumerate(docs):
        tok_d[i, :d.size] = d
        seg_d[i, :d.size] = 1
    assert pk.count_effective_targets(seg_p) == \
        pk.count_effective_targets(seg_d)
    with torch.no_grad():
        packed = model.loss_fn(model.params_tree(), tuple(
            torch.from_numpy(a) for a in (tok_p, tok_p, seg_p)))
        padded = model.loss_fn(model.params_tree(), tuple(
            torch.from_numpy(a) for a in (tok_d, tok_d, seg_d)))
    np.testing.assert_allclose(float(packed), float(padded), rtol=1e-5,
                               atol=1e-5)


def test_packed_vs_padded_hidden_pin(model):
    """Per-position hidden states of a packed document equal the same
    document's padded alone (intra-document rotary positions)."""
    S = 128
    rng = np.random.default_rng(3)
    d1 = rng.integers(1, 97, 48, dtype=np.int32)
    d2 = rng.integers(1, 97, 40, dtype=np.int32)
    tok_p, seg_p = pk.pack_documents([d1, d2], S)
    placed = {}
    for s in (1, 2):
        cols = np.flatnonzero(seg_p[0] == s)
        placed[s] = (cols, tok_p[0, cols])
    params = model.params_tree()
    with torch.no_grad():
        hid_p = neox.forward_hidden(model.config, params,
                                    torch.from_numpy(tok_p).long(),
                                    segment_ids=torch.from_numpy(seg_p))
        for cols, doc in placed.values():
            tok_a = np.zeros((1, S), np.int32)
            seg_a = np.zeros((1, S), np.int32)
            tok_a[0, :doc.size] = doc
            seg_a[0, :doc.size] = 1
            hid_a = neox.forward_hidden(model.config, params,
                                        torch.from_numpy(tok_a).long(),
                                        segment_ids=torch.from_numpy(seg_a))
            np.testing.assert_allclose(hid_p[0, cols].numpy(),
                                       hid_a[0, :doc.size].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_segmented_loss_and_grads_match_jax(model, neox_weights):
    tok, seg = jpk.pack_documents(_docs(5, 30, max_len=128), 128)
    tok, seg = tok[:2], seg[:2]
    labels = tok.copy()
    labels[1, 100:] = -100
    jcfg = jneox.GPTNeoXConfig(**SIZE, use_segment_ids=True)
    jmodel = jneox.GPTNeoX(jcfg, use_pallas=False)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, (jnp.asarray(tok), jnp.asarray(labels), jnp.asarray(seg)))))(
            neox_weights)
    for p in model.parameters():
        p.grad = None
    loss = model.loss_fn(model.params_tree(), tuple(
        torch.from_numpy(a) for a in (tok, labels, seg)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5,
                               atol=1e-6)
    flat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat.items()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_missing_segment_ids_raise_as_jax(neox_weights):
    jmodel = jneox.GPTNeoX(jneox.GPTNeoXConfig(**SIZE, use_segment_ids=True),
                           use_pallas=False)
    tok = np.ones((1, 16), np.int32)
    with pytest.raises(ValueError) as want:
        jmodel.loss_fn(neox_weights, (tok, tok))
    m = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE, use_segment_ids=True),
                     device="cpu").load_jax_params(neox_weights)
    with pytest.raises(ValueError) as got:
        m.loss_fn(m.params_tree(), (torch.ones(1, 16, dtype=torch.long),) * 2)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# BERT's packed encoder against JAX
# ---------------------------------------------------------------------------

BERT_SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                 intermediate_size=256, max_position_embeddings=128,
                 hidden_dropout=0.0, attn_dropout=0.0)


@pytest.fixture(scope="module")
def bert_weights():
    jm = jbert.BertModel(jbert.BertConfig(**BERT_SIZE))
    return jax.device_get(jm.init_params(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("flash,masked", [(False, False), (True, False),
                                          (True, True)],
                         ids=["materialized", "segmented_flash",
                              "key_mask"])
def test_bert_encode_segments_match_jax(bert_weights, monkeypatch, flash,
                                        masked):
    """S = 128: below DS_FLASH_MIN_SEQ (the pairwise -1e30 penalty) and,
    with it set to 0, above it (the non-causal segmented flash kernels;
    a key mask sends the packed row back to the materialized path)."""
    if flash:
        monkeypatch.setenv("DS_FLASH_MIN_SEQ", "0")
    else:
        monkeypatch.delenv("DS_FLASH_MIN_SEQ", raising=False)
    S = 128
    tok, seg = jpk.pack_documents(_docs(6, 12, vocab=512, max_len=S), S)
    ids, seg = tok[:2], seg[:2]
    mask = (seg != 0).astype(np.int32) if masked else None
    jm = jbert.BertModel(jbert.BertConfig(**BERT_SIZE))
    want = jm.encode(bert_weights, jnp.asarray(ids),
                     attention_mask=None if mask is None
                     else jnp.asarray(mask),
                     segment_ids=jnp.asarray(seg))
    m = bert.BertModel(bert.BertConfig(**BERT_SIZE), device="cpu") \
        .load_jax_params(bert_weights)
    with torch.no_grad():
        got = m.encode(m.params_tree(), torch.from_numpy(ids),
                       attention_mask=None if mask is None
                       else torch.from_numpy(mask),
                       segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bert_refuses_the_packing_block_as_jax():
    conf = {"train_batch_size": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "packing": {"enabled": True}}
    jm = jbert.BertForPreTraining(jbert.BertConfig.tiny())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(NotImplementedError) as want:
        deeperspeed_tpu.initialize(
            model=jm, model_parameters=jm.init_params(jax.random.PRNGKey(0)),
            config_params=conf, mesh=mesh)
    m = bert.BertForPreTraining(bert.BertConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError) as got:
        dst.initialize(model=m.init_params(0), config_params=conf)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the engine's pack_dataset
# ---------------------------------------------------------------------------

def test_pack_dataset_takes_the_block_knobs(neox_weights):
    docs = _docs(8, 40)
    base = {"train_batch_size": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    m = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(neox_weights)
    eng, *_ = dst.initialize(model=m, config_params=dict(
        base, packing={"enabled": True, "pad_id": 7, "drop_tail": True}))
    assert m.config.use_segment_ids
    ds = eng.pack_dataset(docs)
    want = jpk.PackedDataset(docs, SIZE["max_seq_len"], pad_id=7,
                             drop_tail=True)
    np.testing.assert_array_equal(ds.tokens, want.tokens)
    np.testing.assert_array_equal(ds.segment_ids, want.segment_ids)
    assert eng.pack_dataset(docs, seq_len=64).seq_len == 64
    # a step from the loader of packed triples
    loader = iter(eng.deepspeed_io(ds))
    assert np.isfinite(eng.train_batch(data_iter=loader))
    plain, *_ = dst.initialize(
        model=neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
        .init_params(0), config_params=base)
    with pytest.raises(DeepSpeedConfigError, match="requires the 'packing'"):
        plain.pack_dataset(docs)
