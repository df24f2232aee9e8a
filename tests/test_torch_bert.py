"""The port's BERT slice against the JAX package's, on the CPU.

Both sides start from the same JAX-made weights (`init` / `init_params`
→ `jax.device_get` → `load_state_dict` / `load_jax_params`) and take the
same numpy inputs, fp32:

- `DeepSpeedTransformerLayer` pre-LN and post-LN, with no mask, a [B, S]
  keep-mask and a [B, 1, 1, S] additive mask, on the flash path
  (``DS_FLASH_MIN_SEQ=0``; Pallas in interpret mode) and on the
  materialized path (S = 128 below the default 256): output and
  gradients of x and every parameter, rtol 1e-4 with an absolute floor
  of 1e-4 × max|ref| (and 1e-7, see `_close`);
- the layer with dropout 0.1 on both paths at JAX's seeds (derived as
  the JAX layer draws them), the same tolerance;
- the checkpoint knobs leave output and gradients unchanged;
- `BertForPreTraining` and `BertForQuestionAnswering` loss and
  gradients, ragged mask, both paths;
- three fp32 `train_batch` steps and one `eval_batch` of
  `initialize()` engines at dropout 0 with a ragged mask (losses rtol
  1e-5, masters and Adam moments atol = rtol = 1e-4);
- the config blocks BERT refuses, the parameter names and count, the
  GPU default.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import bert as jbert
from deeperspeed_tpu.ops.transformer import transformer as jtr

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import bert
from deeperspeed_tpu_torch.models.convert import (adam_state_from_jax,
                                                  flat_from_jax,
                                                  state_dict_from_jax)
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.transformer import transformer as tr

torch.set_num_threads(2)

B, S, HID, HEADS, INTER = 2, 128, 128, 2, 512
SIZE = dict(vocab_size=512, hidden_size=HID, num_layers=2, num_heads=HEADS,
            intermediate_size=INTER, max_position_embeddings=S)
GAS, MICRO = 2, 2


def _close(got, want, rtol=1e-4, msg=""):
    """rtol with an absolute floor of rtol × max|want| and 1e-7: a
    gradient that is zero in exact arithmetic (the QA head's last-layer
    output bias: softmax cotangents sum to zero over the positions) is
    rounding noise on both sides."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=max(rtol * np.abs(want).max(), 1e-7),
                               err_msg=msg)


@pytest.fixture(params=["flash", "materialized"])
def path(request, monkeypatch):
    """The attention dispatch: the flash kernels (threshold pinned to 0,
    as tests/test_transformer_kernel.py does) or the materialized path
    (the default threshold 256 is above S = 128)."""
    if request.param == "flash":
        monkeypatch.setenv("DS_FLASH_MIN_SEQ", "0")
    else:
        monkeypatch.delenv("DS_FLASH_MIN_SEQ", raising=False)
    return request.param


def _mask(kind):
    keep = np.ones((B, S), np.float32)
    keep[0, 100:] = 0.0
    keep[1, 48:] = 0.0
    if kind == "none":
        return None
    if kind == "keep":
        return keep
    return np.where(keep > 0, 0.0, -10000.0).astype(
        np.float32)[:, None, None, :]


def _tcfg(pre_ln, dropout=0.0, **kw):
    return dict(hidden_size=HID, intermediate_size=INTER, heads=HEADS,
                attn_dropout_ratio=dropout, hidden_dropout_ratio=dropout,
                num_hidden_layers=2, initializer_range=0.02,
                pre_layer_norm=pre_ln, **kw)


def _layers(pre_ln, dropout=0.0, **kw):
    jl = jtr.DeepSpeedTransformerLayer(
        jtr.DeepSpeedTransformerConfig(**_tcfg(pre_ln, dropout)))
    jp = jax.device_get(jl.init(jax.random.PRNGKey(0)))
    tl = tr.DeepSpeedTransformerLayer(
        tr.DeepSpeedTransformerConfig(**_tcfg(pre_ln, dropout, **kw)),
        device="cpu")
    tl.load_state_dict(state_dict_from_jax(jp))
    return jl, jp, tl


def _layer_both(jl, jp, tl, x, mask, g, jax_kw, port_kw):
    """Output and gradients (x, then the parameters in JAX's order) of
    one layer call on each side."""
    jm = None if mask is None else jnp.asarray(mask)

    def jf(p, x):
        return jl.apply(p, x, attention_mask=jm, **jax_kw)

    out, vjp = jax.vjp(jf, jax.tree_util.tree_map(jnp.asarray, jp),
                       jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    names = sorted(jp)
    want = [np.asarray(out), np.asarray(jgx)] + \
        [np.asarray(jgp[n]) for n in names]
    tx = torch.tensor(x, requires_grad=True)
    params = tl.params()
    tm = None if mask is None else torch.from_numpy(mask)
    tout = tl.apply(params, tx, attention_mask=tm, **port_kw)
    tout.backward(torch.from_numpy(g))
    got = [tout.detach().numpy(), tx.grad.numpy()] + \
        [params[n].grad.numpy() for n in names]
    return got, want, ["out", "dx"] + names


def _xg(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, HID)).astype(np.float32),
            rng.standard_normal((B, S, HID)).astype(np.float32))


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "keep", "additive"])
def test_layer_matches_jax(path, pre_ln, mask_kind):
    jl, jp, tl = _layers(pre_ln)
    x, g = _xg()
    before = dict(fa.flag_launches["fwd"])
    got, want, names = _layer_both(jl, jp, tl, x, _mask(mask_kind), g,
                                   dict(deterministic=True),
                                   dict(deterministic=True))
    for a, b, n in zip(got, want, names):
        _close(a, b, msg=n)
    # CPU tensors: the wrappers took their plain versions, no launches
    assert fa.flag_launches["fwd"] == before


def _jax_seeds(rng, flash):
    """The seeds the JAX layer draws from ``rng``: split three ways, the
    attention's as `flash_attention_train`'s [1] seed or `_dropout`'s
    scalar, the other two as `_dropout`'s."""
    r = jax.random.split(rng, 3)
    first = jax.random.randint(r[0], (1,) if flash else (), 0, 2 ** 31 - 1,
                               dtype=jnp.int32).reshape(())
    rest = [jax.random.randint(k, (), 0, 2 ** 31 - 1, dtype=jnp.int32)
            for k in r[1:]]
    return torch.tensor([int(first)] + [int(s) for s in rest],
                        dtype=torch.int32)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_dropout_matches_jax_seeds(path, pre_ln):
    jl, jp, tl = _layers(pre_ln, dropout=0.1)
    x, g = _xg(1)
    rng = jax.random.PRNGKey(11)
    got, want, names = _layer_both(
        jl, jp, tl, x, _mask("keep"), g,
        dict(rng=rng, deterministic=False),
        dict(seeds=_jax_seeds(rng, path == "flash"), deterministic=False))
    for a, b, n in zip(got, want, names):
        _close(a, b, msg=n)
    # dropout really ran: another seed gives another output
    other = tl.apply(tl.params(), torch.from_numpy(x),
                     attention_mask=torch.from_numpy(_mask("keep")),
                     seeds=torch.tensor([1, 2, 3], dtype=torch.int32),
                     deterministic=False)
    assert not np.allclose(other.detach().numpy(), want[0])


@pytest.mark.parametrize("knob", ["attn_dropout_checkpoint",
                                  "gelu_checkpoint", "normalize_invertible"])
def test_checkpoint_knobs_leave_results_unchanged(path, knob):
    _, _, plain = _layers(True, dropout=0.1)
    _, jp, ckpt = _layers(True, dropout=0.1, **{knob: True})
    x, g = _xg(2)
    seeds = torch.tensor([5, 6, 7], dtype=torch.int32)
    results = []
    for layer in (plain, ckpt):
        tx = torch.tensor(x, requires_grad=True)
        params = layer.params()
        out = layer.apply(params, tx,
                          attention_mask=torch.from_numpy(_mask("keep")),
                          seeds=seeds, deterministic=False)
        out.backward(torch.from_numpy(g))
        results.append([out.detach(), tx.grad] +
                       [params[n].grad for n in sorted(params)])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layer_init_and_initial_weights():
    cfg = tr.DeepSpeedTransformerConfig(**_tcfg(True))
    layer = tr.DeepSpeedTransformerLayer(cfg, device="cpu").init(3)
    p = layer.params()
    assert {n: tuple(t.shape) for n, t in p.items()} == \
        tr.layer_param_shapes(HID, INTER)
    assert float(p["attn_qkvw"].detach().std()) == \
        pytest.approx(0.02, rel=0.05)
    assert float(p["output_w"].detach().std()) == \
        pytest.approx(0.01, rel=0.05)
    assert p["norm_w"].eq(1).all() and not p["inter_b"].any()
    # HF [out, in] weights and biases, as the JAX init takes them
    rng = np.random.default_rng(0)
    shapes = [(HID, HID)] * 4 + [(HID,), (INTER, HID), (HID, INTER), (HID,)]
    w = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    b = [rng.standard_normal(s[:1]).astype(np.float32) for s in shapes]
    jl = jtr.DeepSpeedTransformerLayer(
        jtr.DeepSpeedTransformerConfig(**_tcfg(True)), initial_weights=w,
        initial_biases=b)
    want = jax.device_get(jl.init(jax.random.PRNGKey(0)))
    tl = tr.DeepSpeedTransformerLayer(
        tr.DeepSpeedTransformerConfig(**_tcfg(True)),
        initial_weights=[torch.from_numpy(t) for t in w],
        initial_biases=[torch.from_numpy(t) for t in b],
        device="cpu").init(0)
    for name, t in tl.params().items():
        np.testing.assert_array_equal(t.detach().numpy(), want[name],
                                      err_msg=name)


def test_transformer_config_dict_and_json(tmp_path):
    d = dict(hidden_size=HID, heads=HEADS, attn_dropout_ratio=0.1,
             pre_layer_norm=False, gelu_checkpoint=True)
    path = tmp_path / "cfg.json"
    path.write_text(__import__("json").dumps(d))
    for cfg, jcfg in ((tr.DeepSpeedTransformerConfig.from_dict(d),
                       jtr.DeepSpeedTransformerConfig.from_dict(d)),
                      (tr.DeepSpeedTransformerConfig.from_json_file(path),
                       jtr.DeepSpeedTransformerConfig.from_json_file(path))):
        assert vars(cfg) == vars(jcfg)
    assert vars(tr.DeepSpeedTransformerConfig()) == \
        vars(jtr.DeepSpeedTransformerConfig())


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _pretrain_batch(lead=(B,), seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZE["vocab_size"], lead + (S,)).astype(np.int32)
    tt = np.broadcast_to((np.arange(S) >= S // 2).astype(np.int32),
                         lead + (S,)).copy()
    mask = np.ones(lead + (S,), np.float32)
    mask[..., 0, 90:] = 0.0                       # ragged padding
    labels = np.full(lead + (S,), -1, np.int32)
    labels[..., ::7] = rng.integers(0, SIZE["vocab_size"],
                                    lead + (len(range(0, S, 7)),))
    nsp = rng.integers(0, 2, lead).astype(np.int32)
    return dict(input_ids=ids, token_type_ids=tt, attention_mask=mask,
                masked_lm_labels=labels, next_sentence_label=nsp)


def _tuple(batch):
    return tuple(batch[k] for k in ("input_ids", "token_type_ids",
                                    "attention_mask", "masked_lm_labels",
                                    "next_sentence_label"))


@pytest.fixture(scope="module")
def pretrain_weights():
    cfg = jbert.BertConfig(**SIZE)
    model = jbert.BertForPreTraining(cfg)
    return cfg, jax.device_get(model.init_params(jax.random.PRNGKey(0)))


def test_pretraining_loss_and_grads_match_jax(path, pretrain_weights):
    jcfg, jparams = pretrain_weights
    batch = _pretrain_batch()
    jloss, jgrads = jax.value_and_grad(jbert.BertForPreTraining(
        jcfg).loss_fn)(jparams, _tuple(batch))
    model = bert.BertForPreTraining(bert.BertConfig(**SIZE), device="cpu") \
        .load_jax_params(jparams)
    loss = model.loss_fn(model.params_tree(),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    _close(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), msg=name)


def test_question_answering_loss_and_grads_match_jax(path):
    cfg = jbert.BertConfig(**SIZE)
    jm = jbert.BertForQuestionAnswering(cfg)
    jparams = jax.device_get(jm.init_params(jax.random.PRNGKey(1)))
    pb = _pretrain_batch(seed=1)
    rng = np.random.default_rng(2)
    start, end = (rng.integers(0, S, (B,)).astype(np.int32)
                  for _ in range(2))
    batch = (pb["input_ids"], pb["token_type_ids"], pb["attention_mask"],
             start, end)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jparams, batch)
    model = bert.BertForQuestionAnswering(bert.BertConfig(**SIZE),
                                          device="cpu") \
        .load_jax_params(jparams)
    loss = model.loss_fn(model.params_tree(),
                         tuple(torch.from_numpy(t) for t in batch))
    loss.backward()
    _close(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        # the span head leaves the pooler out: no gradient, JAX's zeros
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got.numpy(), want[name].numpy(), msg=name)


def test_hidden_states_and_layer_names(pretrain_weights):
    jcfg, jparams = pretrain_weights
    batch = _pretrain_batch()
    want = jbert.BertForPreTraining(jcfg).hidden_states(jparams,
                                                        _tuple(batch))
    model = bert.BertForPreTraining(bert.BertConfig(**SIZE), device="cpu") \
        .load_jax_params(jparams)
    with torch.no_grad():
        got = model.hidden_states(
            model.params_tree(),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert model.layer_names() == \
        jbert.BertForPreTraining(jcfg).layer_names()
    assert len(got) == len(want) == SIZE["num_layers"] + 1
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def test_names_count_and_strict_load(pretrain_weights):
    jcfg, jparams = pretrain_weights
    model = bert.BertForPreTraining(bert.BertConfig(**SIZE), device="cpu")
    assert set(dict(model.named_parameters())) == \
        set(state_dict_from_jax(jparams))
    assert sum(p.numel() for p in model.parameters()) == \
        bert.BertConfig(**SIZE).num_params() == jcfg.num_params()
    assert bert.BertConfig.large().num_params() == 336_232_258
    assert model.bert is model
    model.init_params(4)
    assert model.cls.ln_scale.eq(1).all()
    assert float(model.embeddings.word.detach().std()) == \
        pytest.approx(0.02, rel=0.05)


def test_models_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.BertForPreTraining(bert.BertConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.DeepSpeedTransformerLayer(tr.DeepSpeedTransformerConfig(
            hidden_size=64, heads=2))


# ---------------------------------------------------------------------------
# train_batch against the JAX engine
# ---------------------------------------------------------------------------

def _config():
    return {
        "train_batch_size": GAS * MICRO,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-3, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
            "warmup_num_steps": 5}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 2},
    }


def test_fp32_steps_match_jax():
    size = dict(SIZE, hidden_dropout=0.0, attn_dropout=0.0)
    jcfg = jbert.BertConfig(**size)
    jmodel = jbert.BertForPreTraining(jcfg)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(2)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jeng, *_ = deeperspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config_params=_config(),
        mesh=mesh)
    model = bert.BertForPreTraining(bert.BertConfig(**size), device="cpu") \
        .load_jax_params(jparams)
    eng, *_ = dst.initialize(model=model, config_params=_config())
    batch = _pretrain_batch(lead=(GAS, MICRO), seed=3)
    losses = np.array([(float(jeng.train_batch(batch=_tuple(batch))),
                        eng.train_batch(batch=batch)) for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
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
    assert eng.global_steps == jeng.global_steps == 3
    # one micro-batch, as a dict and as a tuple
    ev = {k: v[0] for k, v in batch.items()}
    jev = float(jeng.eval_batch(_tuple(ev)))
    np.testing.assert_allclose(eng.eval_batch(ev), jev, rtol=1e-5)
    assert eng.eval_batch(_tuple(ev)) == eng.eval_batch(ev)
    assert eng.tput_timer.total_tokens == GAS * MICRO * S


def test_dropout_runs_in_train_and_eval():
    """With dropout on, the engine's generator feeds the seeds: steps
    differ from the dropout-free loss, and the eval loss (a generator
    seeded 0, like the JAX engine's PRNGKey(0)) includes dropout and is
    the same on every call."""
    model = bert.BertForPreTraining(bert.BertConfig(**SIZE), device="cpu") \
        .init_params(0)
    eng, *_ = dst.initialize(model=model, config_params=_config())
    batch = _pretrain_batch(lead=(GAS, MICRO), seed=4)
    ev = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    with torch.no_grad():
        clean = float(model.loss_fn(model.params_tree(), ev))
    e1, e2 = eng.eval_batch(ev), eng.eval_batch(ev)
    assert e1 == e2 and e1 != clean
    assert np.isfinite(eng.train_batch(batch=batch))


def test_unsupported_blocks_refused_as_jax_refuses():
    conf = dict(_config(), moe={"num_experts": 4, "top_k": 2})
    model = bert.BertForPreTraining(bert.BertConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError) as terr:
        dst.initialize(model=model, config_params=conf)
    jerr = pytest.raises(NotImplementedError, jbert.BertModel(
        jbert.BertConfig.tiny()).apply_ds_config,
        types.SimpleNamespace(moe_params={"num_experts": 4}))
    assert str(terr.value) == str(jerr.value)
    conf = dict(_config(), sparse_attention={"mode": "fixed"})
    with pytest.raises(NotImplementedError) as terr:
        dst.initialize(model=model, config_params=conf)
    jerr = pytest.raises(NotImplementedError, jbert.BertModel(
        jbert.BertConfig.tiny()).apply_ds_config,
        types.SimpleNamespace(sparse_attention={"mode": "fixed"}))
    assert str(terr.value) == str(jerr.value)
    # "packing": BERT refuses the block with the JAX message, from the
    # model and through the engine
    packed = types.SimpleNamespace(packing_params={"enabled": True})
    jerr = pytest.raises(NotImplementedError, jbert.BertModel(
        jbert.BertConfig.tiny()).apply_ds_config, packed)
    with pytest.raises(NotImplementedError) as terr:
        model.apply_ds_config(packed)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError) as terr:
        dst.initialize(model=model, config_params=dict(
            _config(), packing={"enabled": True}))
    assert str(terr.value) == str(jerr.value)
    # the remat knobs are ported (tests/test_torch_remat.py)
    assert bert.BertModel(bert.BertConfig.tiny(), remat_policy="full",
                          device="cpu").remat_policy == "full"
