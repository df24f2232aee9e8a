"""Long-context training with the port against the JAX package's, on
the CPU: `initialize()` → `train_batch` on packed rows under a remat
policy, from the same JAX-made weights and the same numpy batches.

- a tiny GPT-NeoX with the "packing" block and
  ``"activation_checkpointing": {"policy": "attn_residuals"}``: three
  fp32 steps (gas 2 × micro 2 packed rows of 128) and an `eval_batch`
  against the JAX engine on a 1-device mesh (losses rtol 1e-5, masters
  and Adam moments atol = rtol = 1e-4, as `test_torch_train_engine.py`);
  the same steps with the port's policy off are bit-identical to it;
- BERT with ``"activation_checkpointing": {"number_checkpoints": 2}``:
  three fp32 steps against the JAX engine (dropout 0, a ragged mask).
"""

import numpy as np
import pytest
import torch

import jax

import deeperspeed_tpu
from deeperspeed_tpu.models import bert as jbert
from deeperspeed_tpu.models import gpt_neox as jneox

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import bert
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import (adam_state_from_jax,
                                                  flat_from_jax)
from deeperspeed_tpu_torch.runtime.packing import (pack_documents,
                                                   synthetic_doc_mixture)

SIZE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=128)
GAS, MICRO, S = 2, 2, 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Bit-for-bit comparisons between runs need one CPU thread: with
    more, MKL may pick another thread count (and summation order) from
    run to run under load."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(**blocks):
    return {
        "train_batch_size": GAS * MICRO,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 2},
        **blocks,
    }


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _assert_state_close(eng, jeng):
    masters = flat_from_jax(jax.device_get(jeng.state.master),
                            eng.param_names)
    np.testing.assert_allclose(eng._master.numpy(), masters.numpy(),
                               atol=1e-4, rtol=1e-4)
    moments = adam_state_from_jax(jax.device_get(jeng.state.opt_state),
                                  eng.param_names)
    for ours, ref in ((eng.opt_state.exp_avg, moments.exp_avg),
                      (eng.opt_state.exp_avg_sq, moments.exp_avg_sq)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-4)


@pytest.fixture(scope="module")
def packed_batch():
    docs = synthetic_doc_mixture(11, 48, SIZE["vocab_size"], mean_len=40.0,
                                 sigma=1.0, max_len=S)
    tok, seg = pack_documents(docs, S)
    n = GAS * MICRO
    assert tok.shape[0] >= n and (seg[:n] == 0).any()
    tok = tok[:n].reshape(GAS, MICRO, S)
    return tok, tok.copy(), seg[:n].reshape(GAS, MICRO, S)


def test_packed_attn_residuals_steps_match_jax(packed_batch):
    conf = _config(packing={"enabled": True},
                   activation_checkpointing={"policy": "attn_residuals"})
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    jparams = jax.device_get(jneox.init_params(jcfg, jax.random.PRNGKey(0)))
    jmodel = jneox.GPTNeoX(jcfg, use_pallas=False)
    jeng, *_ = deeperspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config_params=conf,
        mesh=_mesh())
    assert jmodel.remat_policy == "attn_residuals"

    def port(conf):
        m = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
            .load_jax_params(jparams)
        return m, dst.initialize(model=m, config_params=conf)[0]

    model, eng = port(conf)
    assert model.config.use_segment_ids
    assert model.remat_policy == "attn_residuals"
    losses = np.array([(float(jeng.train_batch(batch=packed_batch)),
                        eng.train_batch(batch=packed_batch))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    _assert_state_close(eng, jeng)
    ev = tuple(a[0] for a in packed_batch)
    np.testing.assert_allclose(eng.eval_batch(ev),
                               float(jeng.eval_batch(ev)), rtol=1e-5)
    # the policy changes no number: the same steps without remat
    _, plain = port(_config(packing={"enabled": True}))
    again = [plain.train_batch(batch=packed_batch) for _ in range(3)]
    assert again == list(losses[:, 1])
    assert torch.equal(plain._master, eng._master)


BERT_SIZE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                 intermediate_size=128, max_position_embeddings=S,
                 hidden_dropout=0.0, attn_dropout=0.0)


def _bert_batch():
    rng = np.random.default_rng(3)
    lead = (GAS, MICRO)
    ids = rng.integers(0, 512, lead + (S,)).astype(np.int32)
    tt = np.broadcast_to((np.arange(S) >= S // 2).astype(np.int32),
                         lead + (S,)).copy()
    mask = np.ones(lead + (S,), np.float32)
    mask[..., 0, 90:] = 0.0
    labels = np.full(lead + (S,), -1, np.int32)
    labels[..., ::7] = rng.integers(0, 512, lead + (len(range(0, S, 7)),))
    nsp = rng.integers(0, 2, lead).astype(np.int32)
    return ids, tt, mask, labels, nsp


def test_bert_number_checkpoints_steps_match_jax():
    conf = _config(activation_checkpointing={"number_checkpoints": 2})
    jmodel = jbert.BertForPreTraining(jbert.BertConfig(**BERT_SIZE))
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(2)))
    jeng, *_ = deeperspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config_params=conf,
        mesh=_mesh())
    model = bert.BertForPreTraining(bert.BertConfig(**BERT_SIZE),
                                    device="cpu").load_jax_params(jparams)
    eng, *_ = dst.initialize(model=model, config_params=conf)
    assert (model.remat_policy, model.number_checkpoints) == \
        (jmodel.bert.remat_policy, jmodel.bert.number_checkpoints) == \
        ("full", 2)
    batch = _bert_batch()
    losses = np.array([(float(jeng.train_batch(batch=batch)),
                        eng.train_batch(batch=batch)) for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    _assert_state_close(eng, jeng)
