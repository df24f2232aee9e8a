"""The port's activation checkpointing, on the CPU.

- every named policy gives the port's no-remat loss and gradients bit for
  bit (`torch.equal`, on one CPU thread): GPT-NeoX dense and packed, MoE with gate jitter
  (the generator's draws replay in the recompute), BERT with dropout 0.1
  inside and beside the fused layer's own checkpoint knobs;
- every policy against the JAX model (`tests/test_remat_policy.py`'s
  `_loss_and_grads` set-up: 4 layers, the XLA attention) at that file's
  tolerances (loss rtol 1e-6, grads atol 1e-6 / rtol 1e-5);
- `number_checkpoints` spans, even and ragged, against no remat;
- the JAX errors with their messages: an unknown policy, a bad or too
  large `number_checkpoints`, `cpu_checkpointing` with a policy that
  cannot offload, MoE with `number_checkpoints`;
- the bytes each policy keeps for the backward: full < dots < none;
  attn_residuals keeps the flash forward's outputs, so the recompute
  does not run the forward again;
- the module API (`configure` / `checkpoint`) and the RNG tracker.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.runtime.activation_checkpointing import (
    checkpointing as jck)
from deeperspeed_tpu.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig as JaxACConfig)
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import bert
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing as ck)
from deeperspeed_tpu_torch.runtime.activation_checkpointing.config import (
    REMAT_POLICY_CHOICES, DeepSpeedActivationCheckpointingConfig)
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.packing import pack_documents

POLICIES = REMAT_POLICY_CHOICES
# tests/test_remat_policy.py's model and tokens
CFG = dataclasses.replace(jneox.GPTNeoXConfig.tiny(), num_layers=4)
TOKS = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 32),
                                         np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Bit-for-bit comparisons between runs need one CPU thread: with
    more, MKL may pick another thread count (and summation order) from
    run to run under load."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cfg(**kw):
    return neox.GPTNeoXConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        num_layers=CFG.num_layers, num_heads=CFG.num_heads,
        max_seq_len=CFG.max_seq_len, **kw)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jneox.init_params(CFG, jax.random.PRNGKey(0)))


def _loss_and_grads(model, batch, rng_seed=None):
    """(loss, [grad of every parameter]) of one backward; the model's
    parameters' grads are cleared first."""
    for p in model.parameters():
        p.grad = None
    rng = None if rng_seed is None else \
        torch.Generator().manual_seed(rng_seed)
    loss = model.loss_fn(model.params_tree(), batch, rng=rng)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def _port_lg(jparams, batch, rng_seed=None, cfg_kw=None, **knobs):
    m = neox.GPTNeoX(_port_cfg(**(cfg_kw or {})), device="cpu", **knobs)
    if cfg_kw:
        m.init_params(3)        # MoE: the JAX weights are dense
    else:
        m.load_jax_params(jparams)
    return _loss_and_grads(m, batch, rng_seed)


def _baseline(jparams, batch, **kw):
    return _port_lg(jparams, batch, **kw)


# ---------------------------------------------------------------------------
# bit-for-bit against the port's own no-remat run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_base(jparams):
    batch = (torch.from_numpy(TOKS),) * 2
    return batch, _baseline(jparams, batch)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bit_exact_dense(policy, jparams, dense_base):
    batch, base = dense_base
    _assert_equal(_port_lg(jparams, batch, remat_policy=policy), base)


@pytest.fixture(scope="module")
def packed_base(jparams):
    rng = np.random.default_rng(1)
    docs = [rng.integers(1, CFG.vocab_size, n, dtype=np.int32)
            for n in (50, 9, 31, 70, 20, 40)]
    tok, seg = pack_documents(docs, 128)
    batch = (torch.from_numpy(tok), torch.from_numpy(tok),
             torch.from_numpy(seg))
    return batch, _baseline(jparams, batch)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bit_exact_packed(policy, jparams, packed_base):
    batch, base = packed_base
    _assert_equal(_port_lg(jparams, batch, remat_policy=policy), base)


MOE = dict(moe_num_experts=4, moe_top_k=2, moe_jitter_eps=0.1,
           moe_dispatch="sort")


@pytest.fixture(scope="module")
def moe_base(jparams):
    batch = (torch.from_numpy(TOKS),) * 2
    return batch, _baseline(jparams, batch, rng_seed=9, cfg_kw=MOE)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bit_exact_moe_jitter(policy, jparams, moe_base):
    """The gate jitter draws inside every block: the recompute replays
    the generator's draws, so it routes the same tokens."""
    batch, base = moe_base
    _assert_equal(_port_lg(jparams, batch, rng_seed=9, cfg_kw=MOE,
                           remat_policy=policy), base)


def test_moe_replay_is_what_keeps_it_exact(jparams, moe_base, monkeypatch):
    """Without the replay the recompute draws other jitter: the
    gradients move (the check above would catch a lost replay)."""
    batch, base = moe_base
    monkeypatch.setattr(ck, "_replaying", lambda fn, gens: fn)
    got = _port_lg(jparams, batch, rng_seed=9, cfg_kw=MOE,
                   remat_policy="full")
    assert torch.equal(got[0], base[0])
    assert not all(torch.equal(a, b) for a, b in zip(got[1], base[1]))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_number_checkpoints_is_bit_exact(k, jparams, dense_base):
    """k spans over 4 layers: one span, even, ragged (2 + 1 + 1) and one
    a layer."""
    batch, base = dense_base
    _assert_equal(_port_lg(jparams, batch, number_checkpoints=k), base)
    _assert_equal(_port_lg(jparams, batch, remat_policy="dots",
                           number_checkpoints=k), base)


def test_segment_sizes_match_jax():
    for L in range(1, 9):
        for n in range(1, 11):
            assert neox.segment_sizes(L, n) == jneox.segment_sizes(L, n)


# BERT: dropout 0.1 on attention and hidden states, 3 layers
BERT_SIZE = dict(vocab_size=512, hidden_size=64, num_layers=3, num_heads=2,
                 intermediate_size=128, max_position_embeddings=128)


def _bert_batch():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 512, (2, 128))
    mask = np.ones((2, 128), np.float32)
    mask[1, 100:] = 0
    labels = np.full((2, 128), -1)
    labels[:, ::5] = rng.integers(0, 512, (2, 26))
    return tuple(torch.from_numpy(a) for a in (
        ids, np.zeros_like(ids), mask, labels, np.array([0, 1])))


def _bert_lg(layer_knobs=None, **knobs):
    cfg = bert.BertConfig(**BERT_SIZE)
    m = bert.BertForPreTraining(cfg, device="cpu", **knobs).init_params(0)
    for layer in m.layers:
        for name, on in (layer_knobs or {}).items():
            setattr(layer.config, name, on)
    return _loss_and_grads(m, _bert_batch(), rng_seed=11)


@pytest.fixture(scope="module")
def bert_base():
    return _bert_lg()


@pytest.mark.parametrize("knobs", [
    dict(remat_policy="full"), dict(remat_policy="dots"),
    dict(remat_policy="attn_residuals", number_checkpoints=2),
    dict(remat_policy="offload_dots"), dict(number_checkpoints=1)],
    ids=["full", "dots", "attn_residuals_2", "offload_dots", "one_span"])
@pytest.mark.parametrize("layer_knobs", [
    None, dict(gelu_checkpoint=True, attn_dropout_checkpoint=True)],
    ids=["plain_layer", "layer_checkpoints"])
def test_bert_policy_is_bit_exact_with_dropout(knobs, layer_knobs,
                                               bert_base):
    """Dropout seeds are drawn before the layers and ride into each span;
    the layer's own checkpoint spans nest inside the encoder's."""
    _assert_equal(_bert_lg(layer_knobs, **knobs), bert_base)


def test_bert_layer_checkpoints_beside_no_remat(bert_base):
    _assert_equal(_bert_lg(dict(gelu_checkpoint=True,
                                attn_dropout_checkpoint=True)), bert_base)


# ---------------------------------------------------------------------------
# against the JAX model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_base(jparams):
    model = jneox.GPTNeoX(CFG, use_pallas=False)
    return jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, (TOKS, TOKS))))(jparams)


def _jax_named(grads):
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("knobs", [
    dict(remat_policy=p) for p in POLICIES] + [
    dict(remat_policy="dots", number_checkpoints=3)],
    ids=list(POLICIES) + ["dots_3_spans"])
def test_policy_matches_jax(knobs, jparams, jax_base):
    jl, jg = jax_base
    want = _jax_named(jg)
    m = neox.GPTNeoX(_port_cfg(), device="cpu", **knobs) \
        .load_jax_params(jparams)
    loss, grads = _loss_and_grads(m, (torch.from_numpy(TOKS),) * 2)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for (name, _), g in zip(m.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-6,
                                   rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the JAX errors
# ---------------------------------------------------------------------------

def _both_raise(block, jexc=JaxConfigError, exc=DeepSpeedConfigError):
    d = {"activation_checkpointing": block}
    with pytest.raises(jexc) as want:
        JaxACConfig.from_dict(d)
    with pytest.raises(exc) as got:
        DeepSpeedActivationCheckpointingConfig.from_dict(d)
    assert str(got.value) == str(want.value)


def test_unknown_policy_raises_as_jax():
    _both_raise({"policy": "bogus"})
    with pytest.raises(ValueError) as want:
        jck.make_remat_policy("bogus")
    with pytest.raises(ValueError) as got:
        ck.make_remat_policy("bogus")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [0, -3, "two", 1.5, True])
def test_bad_number_checkpoints_raise_as_jax(bad):
    _both_raise({"number_checkpoints": bad})


@pytest.mark.parametrize("policy", ["none", "full", "attn_residuals"])
def test_cpu_checkpointing_conflict_raises_as_jax(policy):
    _both_raise({"policy": policy, "cpu_checkpointing": True})


def test_parsed_blocks_match_jax():
    for block in ({}, {"policy": "dots", "cpu_checkpointing": True},
                  {"number_checkpoints": 2, "partition_activations": True,
                   "contiguous_memory_optimization": True,
                   "synchronize_checkpoint_boundary": True,
                   "profile": True}):
        d = {"activation_checkpointing": block}
        ours = DeepSpeedActivationCheckpointingConfig.from_dict(d)
        assert dataclasses.asdict(ours) == \
            dataclasses.asdict(JaxACConfig.from_dict(d))
        assert ours.active == JaxACConfig.from_dict(d).active


def _conf(block):
    return {"train_batch_size": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "activation_checkpointing": block}


def test_too_many_checkpoints_raise_as_jax(jparams):
    conf = _conf({"number_checkpoints": CFG.num_layers + 1})
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(JaxConfigError) as want:
        deeperspeed_tpu.initialize(
            model=jneox.GPTNeoX(CFG, use_pallas=False),
            model_parameters=jparams, config_params=conf, mesh=mesh)
    with pytest.raises(DeepSpeedConfigError) as got:
        dst.initialize(model=neox.GPTNeoX(_port_cfg(), device="cpu")
                       .load_jax_params(jparams), config_params=conf)
    assert str(got.value) == str(want.value)


def test_moe_with_number_checkpoints_raises_as_jax(jparams):
    jcfg = dataclasses.replace(CFG, moe_num_experts=4, moe_top_k=2)
    jm = jneox.GPTNeoX(jcfg, use_pallas=False, number_checkpoints=2)
    with pytest.raises(ValueError) as want:
        jm.loss_fn(jneox.init_params(jcfg, jax.random.PRNGKey(0)),
                   (TOKS, TOKS))
    m = neox.GPTNeoX(_port_cfg(moe_num_experts=4, moe_top_k=2),
                     device="cpu", number_checkpoints=2).init_params(0)
    with pytest.raises(ValueError) as got:
        m.loss_fn(m.params_tree(), (torch.from_numpy(TOKS),) * 2)
    assert str(got.value) == str(want.value)


def test_config_block_reaches_the_model(jparams):
    m = neox.GPTNeoX(_port_cfg(), device="cpu").load_jax_params(jparams)
    dst.initialize(model=m, config_params=_conf(
        {"policy": "dots", "number_checkpoints": 2}))
    assert (m.remat_policy, m.number_checkpoints) == ("dots", 2)
    m = neox.GPTNeoX(_port_cfg(), device="cpu").load_jax_params(jparams)
    dst.initialize(model=m, config_params=_conf(
        {"policy": "dots", "cpu_checkpointing": True}))
    assert m.remat_policy == "offload_dots"
    m = neox.GPTNeoX(_port_cfg(), device="cpu").load_jax_params(jparams)
    dst.initialize(model=m, config_params=_conf(
        {"partition_activations": True}))
    assert (m.remat_policy, m.number_checkpoints) == ("full", None)
    b = bert.BertForPreTraining(bert.BertConfig.tiny(), device="cpu")
    dst.initialize(model=b.init_params(0), config_params=_conf(
        {"number_checkpoints": 2}))
    assert (b.remat_policy, b.number_checkpoints) == ("full", 2)


# ---------------------------------------------------------------------------
# what each policy keeps
# ---------------------------------------------------------------------------

class _LiveOutputs(TorchDispatchMode):
    """Weak references to the storage of every op output, to sum the
    bytes still alive once the forward is done: what autograd and the
    policy keep for the backward."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs.setdefault(st._cdata,
                                     (StorageWeakRef(st), st.nbytes()))
        return out


def _kept_bytes(policy, jparams):
    m = neox.GPTNeoX(_port_cfg(), device="cpu", remat_policy=policy) \
        .load_jax_params(jparams)
    params = {p.untyped_storage()._cdata for p in m.parameters()}
    with _LiveOutputs() as live:
        loss = m.loss_fn(m.params_tree(), (torch.from_numpy(TOKS),) * 2)
    kept = sum(n for key, (ref, n) in live.refs.items()
               if not ref.expired() and key not in params)
    loss.backward()
    return kept


def test_kept_bytes_are_ordered(jparams):
    kept = {p: _kept_bytes(p, jparams) for p in POLICIES}
    assert kept["full"] < kept["attn_residuals"] < kept["dots"] < \
        kept["none"]
    # on the CPU the parked dots stay in (host) memory: dots' set
    assert kept["offload_dots"] == kept["dots"]


def test_attn_residuals_skips_the_forward_in_the_recompute(
        jparams, monkeypatch):
    calls = []
    ref = fa.flash_attention_segmented_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return ref(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_segmented_reference", counted)
    runs = {}
    for policy in POLICIES:
        calls.clear()
        _port_lg(jparams, (torch.from_numpy(TOKS),) * 2,
                 remat_policy=policy)
        runs[policy] = len(calls)
    L = CFG.num_layers
    assert runs == {"none": L, "full": 2 * L, "dots": 2 * L,
                    "attn_residuals": L, "offload_dots": 2 * L}


def test_no_span_without_grad(jparams):
    """eval: nothing is kept, the span runs once."""
    m = neox.GPTNeoX(_port_cfg(), device="cpu", remat_policy="full") \
        .load_jax_params(jparams)
    with torch.no_grad():
        a = m.loss_fn(m.params_tree(), (torch.from_numpy(TOKS),) * 2)
    m.remat_policy = None
    with torch.no_grad():
        b = m.loss_fn(m.params_tree(), (torch.from_numpy(TOKS),) * 2)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the module API and the RNG tracker
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_config():
    saved = (ck._config, ck._mpu, ck._configured)
    yield
    ck._config, ck._mpu, ck._configured = saved


@pytest.mark.parametrize("block", [{"policy": "none"}, {"policy": "full"},
                                   {"policy": "dots",
                                    "cpu_checkpointing": True}])
def test_module_checkpoint_api(block, restore_config):
    ck.configure(deepspeed_config={"activation_checkpointing": block})
    assert ck.is_configured()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=gen, requires_grad=True)
    w = torch.randn(8, 8, generator=gen, requires_grad=True)

    def fn(x):
        return torch.tanh(x @ w) * torch.rand(x.shape, generator=gen)

    gen_state = gen.get_state()
    ck.checkpoint_wrapper(fn)(x).sum().backward(inputs=[x, w])
    got = (x.grad.clone(), w.grad.clone())
    x.grad = w.grad = None
    gen.set_state(gen_state)
    fn(x).sum().backward(inputs=[x, w])
    if block["policy"] == "none":
        assert torch.equal(got[0], x.grad) and torch.equal(got[1], w.grad)
    else:
        # the module API replays only the generators it is given
        x.grad = w.grad = None
        gen.set_state(gen_state)
        ck.checkpoint(fn, x, generators=(gen,)).sum().backward(
            inputs=[x, w])
        g2 = (x.grad.clone(), w.grad.clone())
        x.grad = w.grad = None
        gen.set_state(gen_state)
        fn(x).sum().backward(inputs=[x, w])
        assert torch.equal(g2[0], x.grad) and torch.equal(g2[1], w.grad)
    ck.configure(num_checkpoints=3, checkpoint_in_cpu=True)
    assert ck._config.number_checkpoints == 3 and ck._config.cpu_checkpointing
    ck.partition_activations_in_checkpoint(True)
    assert ck._config.partition_activations
    assert ck.resolve_policy_name(None, True) == \
        jck.resolve_policy_name(None, True) == "offload_dots"
    assert ck.resolve_policy_name("full", False) == "full"


def test_rng_tracker(monkeypatch):
    tr = ck.CudaRNGStatesTracker()
    tr.add("a", 5, device="cpu")
    with pytest.raises(Exception, match="already present"):
        tr.add("b", 5, device="cpu")
    with pytest.raises(Exception, match="already present"):
        tr.add("a", 6, device="cpu")
    with pytest.raises(Exception, match="is not added"):
        with tr.fork("zzz"):
            pass
    states = tr.get_states()
    with tr.fork("a") as g1:
        d1 = torch.rand(4, generator=g1)
    with tr.fork("a") as g2:
        d2 = torch.rand(4, generator=g2)
    assert not torch.equal(d1, d2)       # successive forks differ
    tr.set_states(states)
    with tr.fork("a") as g3:
        assert torch.equal(torch.rand(4, generator=g3), d1)
    with pytest.raises(Exception, match="is not added"):
        tr.set_states({"zzz": states["a"]})
    tr.reset()
    assert tr.get_states() == {}
    g = ck.model_parallel_cuda_manual_seed(42, device="cpu")
    assert g.initial_seed() == 42
    assert set(ck.get_cuda_rng_tracker().get_states()) == \
        {"model-parallel-rng"}
    assert ck.get_cuda_rng_tracker() is ck._CUDA_RNG_STATE_TRACKER
    ck.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.CudaRNGStatesTracker().add("x", 1)
