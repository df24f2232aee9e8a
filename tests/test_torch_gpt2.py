"""The port's GPT-2 family against the JAX package's, on the CPU.

Both sides take the same JAX-made weights (`gpt2.init_params` →
`jax.device_get` → `load_jax_params` / `model_parameters=`) and the same
numpy batches; the JAX model runs its Pallas flash kernels in interpret
mode (head dim 64, S 128; the engine and serving comparisons take their
XLA references), the port the kernels' plain versions:

- the presets' parameter counts, the seeded tree `gpt2.init_params`
  makes and the module's `init_params` (the same draws), and the
  zero-width rotary cache GPT-2 gives the shared block (a no-op);
- logits, loss and gradients against `gpt2.forward` / `jax.value_and_
  grad` (fp32: logits and loss rtol 1e-5, gradients atol = rtol = 1e-4);
- the packed loss (intra-document ``wpe`` rows, cross-document targets
  masked) against the JAX model with ``use_segment_ids`` (rtol 1e-5);
- every remat policy and ``number_checkpoints`` bit-equal to no remat
  (one thread: MKL may change its thread count between runs);
- three fp32 `train_batch` steps through `initialize(model=,
  model_parameters=)` and `eval_batch(return_logits=True)` against the
  JAX engine on a 1-device mesh (losses rtol 1e-5, logits atol 1e-4);
- the blocks GPT-2 refuses, with the JAX package's errors;
- greedy tokens of the port's `InferenceEngine` against the JAX
  engine's (exact).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deeperspeed_tpu.models import gpt2 as jgpt2
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch import InferenceEngine
from deeperspeed_tpu_torch.models import gpt2, gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
from deeperspeed_tpu_torch.runtime.activation_checkpointing.config import \
    REMAT_POLICY_CHOICES
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig

torch.set_num_threads(2)

SIZE = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
S = 128


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jgpt2.init_params(jgpt2.GPT2Config(**SIZE),
                                            jax.random.PRNGKey(0)))


def _model(jparams, **kw):
    return gpt2.GPT2(gpt2.GPT2Config(**SIZE), device="cpu", **kw) \
        .load_jax_params(jparams)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=shape).astype(np.int32)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["small", "megatron_345m",
                                    "megatron_1_5b", "tiny"])
def test_presets_and_counts_match_jax(preset):
    ours = getattr(gpt2.GPT2Config, preset)()
    ref = getattr(jgpt2.GPT2Config, preset)()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_seq_len", "intermediate_mult", "layernorm_eps",
              "use_parallel_residual"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.num_params() == ref.num_params()
    assert sum(n for _, n in (
        (name, int(np.prod(shape))) for name, shape in
        gpt2.param_shapes(ours))) == ours.num_params()
    if preset == "megatron_1_5b":
        assert ours.num_params() == 1_557_686_400


def test_init_tree_is_the_module_init_and_the_jax_layout(jparams):
    cfg = gpt2.GPT2Config(**SIZE)
    tree = gpt2.init_params(cfg, torch.Generator().manual_seed(5))
    model = gpt2.GPT2(cfg, device="cpu").init_params(5)
    flat = state_dict_from_jax(tree)
    assert list(flat) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert torch.equal(flat[name], p.detach()), name
    # the JAX tree's paths and shapes: embed.wpe, no embed_out
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        jparams).items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert "embed.wpe" in want and not any(k.startswith("embed_out")
                                           for k in want)
    # the draws follow JAX's rule: wpe at 0.01, out-projections smaller
    assert float(flat["embed.wpe"].std()) == pytest.approx(0.01, rel=0.1)
    assert float(flat["blocks.0.attn.out_w"].std()) == pytest.approx(
        0.02 / np.sqrt(4), rel=0.1)
    assert torch.equal(flat["blocks.1.ln_mlp.scale"], torch.ones(128))


def test_zero_width_rotary_is_a_no_op():
    q, k = torch.randn(2, 8, 2, 64), torch.randn(2, 8, 2, 64)
    cos, sin, rot = neox._rotary_cache(
        neox.GPTNeoXConfig(**SIZE, rotary_pct=0.0), 8)
    assert rot == 0 and cos.shape == (8, 0)
    for c, sn in ((cos, sin), (cos[None].expand(2, 8, 0),
                               sin[None].expand(2, 8, 0))):
        q2, k2 = neox.apply_rotary(q, k, c, sn, rot)
        assert q2 is q and k2 is k


def test_logits_loss_and_grads_match_jax(jparams):
    toks = _tokens(1, (2, S))
    labels = toks.copy()
    labels[0, 100:] = -100
    jcfg = jgpt2.GPT2Config(**SIZE)
    jmodel = jgpt2.GPT2(jcfg, use_pallas=True)
    jlogits = jax.jit(lambda p, t: jgpt2.forward(jcfg, p, t))(
        jparams, jnp.asarray(toks))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, (jnp.asarray(toks), jnp.asarray(labels)))
    model = _model(jparams)
    with torch.no_grad():
        logits = model(torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    loss = model.loss_fn(model.params_tree(), (torch.from_numpy(toks),
                                               torch.from_numpy(labels)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def _packed_batch(seed):
    toks = _tokens(seed, (2, S))
    seg = np.zeros((2, S), np.int32)
    seg[0, :50], seg[0, 50:120] = 1, 2          # two documents, then pad
    seg[1, :S] = 1
    seg[1, 70:] = 2
    return toks, seg


def test_packed_loss_matches_jax(jparams):
    toks, seg = _packed_batch(2)
    jcfg = jgpt2.GPT2Config(**SIZE, use_segment_ids=True)
    jloss = jax.jit(jgpt2.GPT2(jcfg, use_pallas=True).loss_fn)(
        jparams, tuple(map(jnp.asarray, (toks, toks, seg))))
    model = _model(jparams)
    ds_conf = DeepSpeedConfig({"train_batch_size": 2,
                               "packing": {"enabled": True}})
    model.apply_ds_config(ds_conf)
    assert model.config.use_segment_ids
    batch = tuple(map(torch.from_numpy, (toks, toks, seg)))
    loss = model.loss_fn(model.params_tree(), batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="no segment_ids"):
        model.loss_fn(model.params_tree(), batch[:2])
    # the second document's first token sees wpe[0], as alone
    hidden = model.hidden_states(model.params_tree(), batch)
    e = model.params_tree()["embed"]
    want = e["wte"][int(toks[0, 50])] + e["wpe"][0]
    torch.testing.assert_close(hidden[0][0, 50], want, rtol=0, atol=0)


def _loss_grads(jparams, batch, **kw):
    model = _model(jparams, **kw)
    loss = model.loss_fn(model.params_tree(), batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("knobs", [{"remat_policy": p}
                                   for p in REMAT_POLICY_CHOICES] +
                         [{"remat_blocks": True},
                          {"remat_policy": "dots", "number_checkpoints": 1}],
                         ids=lambda k: "-".join(f"{v}" for v in k.values()))
def test_remat_is_bit_exact(jparams, knobs, one_thread):
    toks = torch.from_numpy(_tokens(3, (2, S)))
    base = _loss_grads(jparams, (toks, toks))
    got = _loss_grads(jparams, (toks, toks), **knobs)
    assert got[0] == base[0]
    for name in base[1]:
        assert torch.equal(got[1][name], base[1][name]), name


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _conf(**extra):
    conf = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
                "weight_decay": 0.01}},
            "gradient_clipping": 1.0}
    conf.update(extra)
    return conf


def _jax_engine(jparams, conf, use_pallas=False):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    eng, *_ = deeperspeed_tpu.initialize(
        model=jgpt2.GPT2(jgpt2.GPT2Config(**SIZE), use_pallas=use_pallas),
        model_parameters=jparams, config_params=conf, mesh=mesh)
    return eng


def test_fp32_steps_and_eval_logits_match_jax(jparams):
    conf = _conf()
    toks = _tokens(4, (2, 2, S))
    jeng = _jax_engine(jparams, conf)
    model = gpt2.GPT2(gpt2.GPT2Config(**SIZE), device="cpu")
    eng, *_ = dst.initialize(model=model, model_parameters=jparams,
                             config_params=conf)
    losses = np.array([(float(jeng.train_batch(batch=(toks, toks))),
                        eng.train_batch(batch=(toks, toks)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    ev = _tokens(5, (2, S))
    jloss, jlogits = jeng.eval_batch((ev, ev), return_logits=True)
    loss, logits = eng.eval_batch((ev, ev), return_logits=True)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert logits.shape == (2, S, SIZE["vocab_size"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert loss == eng.eval_batch((ev, ev))


def test_model_parameters_load_what_load_jax_params_loads(jparams):
    conf = _conf()
    a, *_ = dst.initialize(model=gpt2.GPT2(gpt2.GPT2Config(**SIZE),
                                           device="cpu"),
                           model_parameters=jparams, config_params=conf)
    b, *_ = dst.initialize(model=_model(jparams), config_params=conf)
    assert torch.equal(a._master, b._master)
    # the same on GPT-NeoX, with a JAX-made NeoX tree
    from deeperspeed_tpu.models import gpt_neox as jneox
    ncfg = dict(SIZE, max_seq_len=S)
    nparams = jax.device_get(jneox.init_params(
        jneox.GPTNeoXConfig(**ncfg), jax.random.PRNGKey(1)))
    c, *_ = dst.initialize(model=neox.GPTNeoX(neox.GPTNeoXConfig(**ncfg),
                                              device="cpu"),
                           model_parameters=nparams, config_params=conf)
    d = neox.GPTNeoX(neox.GPTNeoXConfig(**ncfg), device="cpu") \
        .load_jax_params(nparams)
    for name, p in d.named_parameters():
        assert torch.equal(dict(c.module.named_parameters())[name], p), name
    with pytest.raises(RuntimeError, match="Missing key.*embed.wpe"):
        dst.initialize(model=gpt2.GPT2(gpt2.GPT2Config(**SIZE),
                                       device="cpu"),
                       model_parameters=nparams, config_params=conf)


def _jax_message(block):
    jm = jgpt2.GPT2(jgpt2.GPT2Config(**SIZE))
    with pytest.raises(NotImplementedError) as e:
        jm.apply_ds_config(block)
    return str(e.value)


@pytest.mark.parametrize("block", ["moe", "sparse_attention",
                                   "sequence_parallel"])
def test_refused_blocks_match_jax(block, jparams):
    if block == "sequence_parallel":
        # the port's config refuses the block itself ("not ported"); the
        # model's own refusal is reached by a config that carries it
        stub = types.SimpleNamespace(sequence_parallel_params={"size": 2})
        want = _jax_message(stub)
        with pytest.raises(NotImplementedError) as e:
            _model(jparams).apply_ds_config(stub)
        assert str(e.value) == want
        return
    conf = _conf(**{block: {"num_experts": 2} if block == "moe" else
                    {"mode": "fixed", "block": 16}})
    want = _jax_message(JaxConfig(conf, world_size=1))
    with pytest.raises(NotImplementedError) as e:
        dst.initialize(model=_model(jparams), config_params=conf)
    assert str(e.value) == want


def test_scan_blocks_is_accepted_and_inert(jparams):
    toks = torch.from_numpy(_tokens(6, (1, S)))
    a = _model(jparams)
    b = _model(jparams, scan_blocks=True)
    assert b.scan_blocks
    with torch.no_grad():
        assert torch.equal(a(toks), b(toks))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_greedy_tokens_match_the_jax_engine(jparams):
    conf = {"inference": {
        "enabled": True, "page_size": 16, "num_pages": 20,
        "max_batch_size": 4, "token_budget": 128,
        "prefill_lengths": [16, 32, 64, 128], "prefill_batch_sizes": [1, 2],
        "decode_batch_sizes": [2, 4]}}
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(1, SIZE["vocab_size"], size=n))
               for n in (5, 16, 17, 40, 64, 90)]
    jeng = JaxEngine(jgpt2.GPT2(jgpt2.GPT2Config(**SIZE), use_pallas=False),
                     config=conf, params=jparams)
    ref = jeng.generate(prompts, max_new_tokens=12)
    eng = InferenceEngine(_model(jparams), config=conf, device="cpu")
    assert eng.family.kind == "gpt2" and eng.family.rot_dim == 0
    assert eng.generate(prompts, max_new_tokens=12) == ref
    assert eng.cache.num_free == eng.cache.num_pages - 1
