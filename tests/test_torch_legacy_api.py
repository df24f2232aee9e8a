"""The legacy training loop and the fork's debugging features, on the CPU.

- `forward` / `backward` / `step` (Megatron's loop: `engine(batch)`,
  `engine.backward(loss)`, `engine.step()`) takes the same steps as
  `train_batch` bit for bit (fp32, bf16 with fp32 masters, and the lean
  state on GPT-2; one thread, since MKL may change its thread count
  between runs), and the same steps as the JAX engine's loop (fp32,
  losses rtol 1e-5);
- `eval_batch(return_logits=True)` on GPT-NeoX against the JAX engine
  (loss rtol 1e-5, logits atol = rtol = 1e-4);
- `set_layers_to_hook` / `get_hooked_activations` and
  `train_batch(layers_to_hook=)` against the JAX engine's capture on
  GPT-NeoX and BERT, and against the JAX GPT-2's block-by-block forward
  (ints and case-insensitive regexes over `layer_names()`, one shot;
  atol = rtol = 1e-5);
- ``store_gradients`` (on the device and on the host) against the JAX
  engine's stored gradients (atol = rtol = 1e-5);
- `GradientNoiseScale` against the JAX class on the same gradients, and
  the engine's estimator fed by `backward` against the JAX engine's
  (rtol 1e-4: fp32 sums in another order);
- `add_config_arguments` / `add_tuning_arguments` against the JAX
  package's parsers.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import bert as jbert
from deeperspeed_tpu.models import gpt2 as jgpt2
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.runtime import lr_schedules as jsched
from deeperspeed_tpu.runtime.utils import GradientNoiseScale as JaxGNS

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import bert, gpt2
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import _flatten
from deeperspeed_tpu_torch.runtime import lr_schedules as sched
from deeperspeed_tpu_torch.runtime.utils import GradientNoiseScale
from deeperspeed_tpu_torch.utils import logging as port_logging

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
GAS, MICRO, S = 2, 2, 128
FP32 = {"enabled": False}
BF16 = {"enabled": True, "type": "bfloat16"}
LEAN = {"enabled": True, "type": "bfloat16",
        "fp16_master_weights_and_grads": True}


def _config(fp16=FP32, **extra):
    conf = {"train_batch_size": GAS * MICRO,
            "train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
                "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
                "warmup_num_steps": 5}},
            "gradient_clipping": 1.0, "fp16": fp16}
    if fp16.get("fp16_master_weights_and_grads"):
        conf["optimizer"]["params"]["state_dtype"] = "bfloat16"
    conf.update(extra)
    return conf


@pytest.fixture(scope="module")
def weights():
    return {
        "neox": jax.device_get(jneox.init_params(
            jneox.GPTNeoXConfig(**SIZE), jax.random.PRNGKey(0))),
        "gpt2": jax.device_get(jgpt2.init_params(
            jgpt2.GPT2Config(**SIZE), jax.random.PRNGKey(1)))}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(family, params):
    if family == "neox":
        return neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
            .load_jax_params(params)
    return gpt2.GPT2(gpt2.GPT2Config(**SIZE), device="cpu") \
        .load_jax_params(params)


def _jax_engine(family, params, conf):
    model = jneox.GPTNeoX(jneox.GPTNeoXConfig(**SIZE), use_pallas=False) \
        if family == "neox" else \
        jgpt2.GPT2(jgpt2.GPT2Config(**SIZE), use_pallas=False)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return deeperspeed_tpu.initialize(model=model, model_parameters=params,
                                      config_params=conf, mesh=mesh)[0]


def _tokens(seed, lead=(GAS, MICRO)):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=lead + (S,)).astype(np.int32)


def _legacy_steps(eng, tokens, steps=3):
    out = []
    for _ in range(steps):
        for i in range(GAS):
            assert not eng.is_gradient_accumulation_boundary()
            loss = eng((tokens[i], tokens[i]))
            assert eng.backward(loss) is loss
            got = eng.step()
            assert (got is None) == (i < GAS - 1)
        out.append(got)
    return out


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,fp16", [("neox", FP32), ("neox", BF16),
                                         ("gpt2", LEAN)],
                         ids=["neox-fp32", "neox-bf16", "gpt2-lean"])
def test_legacy_loop_equals_train_batch(weights, family, fp16, one_thread):
    conf = _config(fp16)
    tokens = _tokens(0)
    a, *_ = dst.initialize(model=_port_model(family, weights[family]),
                           config_params=conf)
    b, *_ = dst.initialize(model=_port_model(family, weights[family]),
                           config_params=conf)
    fused = [a.train_batch(batch=(tokens, tokens)) for _ in range(3)]
    assert _legacy_steps(b, tokens) == fused
    assert torch.equal(a._master, b._master)
    assert torch.equal(a._params_flat, b._params_flat)
    assert torch.equal(a.opt_state.exp_avg, b.opt_state.exp_avg)
    assert torch.equal(a.opt_state.exp_avg_sq, b.opt_state.exp_avg_sq)
    for counter in ("global_steps", "micro_steps", "global_samples"):
        assert getattr(a, counter) == getattr(b, counter), counter
    assert a.get_lr() == b.get_lr()


def test_legacy_loop_matches_jax(weights):
    """Three steps of the loop on both engines, with the gradient noise
    scale on and the gradients stored on the host: the losses, the
    estimates and the last micro-batch's stored gradients."""
    conf = _config(store_gradients=True, store_gradients_cpu=True)
    tokens = _tokens(1)
    jeng = _jax_engine("neox", weights["neox"], conf)
    jgns = jeng.enable_gradient_noise_scale(n_batches=2, beta=0.9)
    jlosses = []
    for _ in range(3):
        for i in range(GAS):
            jeng.backward(jeng((tokens[i], tokens[i])))
            metrics = jeng.step()
        jlosses.append(float(metrics.loss))
    eng, *_ = dst.initialize(model=_port_model("neox", weights["neox"]),
                             config_params=conf)
    gns = eng.enable_gradient_noise_scale(n_batches=2, beta=0.9)
    np.testing.assert_allclose(_legacy_steps(eng, tokens), jlosses,
                               rtol=1e-5)
    assert eng.global_steps == jeng.global_steps == 3
    assert eng.micro_steps == jeng.micro_steps == 6
    assert gns.n_updates == jgns.n_updates == 6
    for f in ("scale", "noise", "noise_scale"):
        np.testing.assert_allclose(getattr(gns, f), getattr(jgns, f),
                                   rtol=1e-4, err_msg=f)
    want = _flatten(jax.device_get(jeng.stored_gradients), "", {})
    got = _flatten(eng.stored_gradients, "", {})
    assert set(got) == set(want)
    for name, g in got.items():
        assert isinstance(g, np.ndarray), name
        np.testing.assert_allclose(g, np.asarray(want[name]), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # train_batch does not feed the estimator, and says so once
    warned = []
    logger = port_logging.logger
    orig = logger.warning
    logger.warning = warned.append
    try:
        eng.train_batch(batch=(tokens, tokens))
        eng.train_batch(batch=(tokens, tokens))
    finally:
        logger.warning = orig
    assert len(warned) == 1 and "only updates under the forward()" in \
        warned[0]
    assert gns.n_updates == 6


def test_loop_errors(weights):
    eng, *_ = dst.initialize(model=_port_model("neox", weights["neox"]),
                             config_params=_config())
    with pytest.raises(RuntimeError, match="backward\\(\\) called before "
                                           "forward\\(\\)"):
        eng.backward()
    tokens = _tokens(2)
    loss = eng((tokens[0], tokens[0]))
    eng.backward()                      # the last forward's loss
    assert eng.step() is None
    with pytest.raises(RuntimeError, match="not yet stepped"):
        eng.train_batch(batch=(tokens, tokens))
    eng.backward(eng((tokens[1], tokens[1])))
    assert eng.step() is not None and loss.requires_grad


# ---------------------------------------------------------------------------
# layer-activation capture
# ---------------------------------------------------------------------------

HOOKS = [[0, "transformerlayer"], ["FINAL_LN"], [1, "^embed"]]


@pytest.fixture(scope="module")
def hook_engines(weights):
    """A JAX and a port engine from the same weights; the hook cases
    train both in lockstep."""
    conf = _config()
    return (_jax_engine("neox", weights["neox"], conf),
            dst.initialize(model=_port_model("neox", weights["neox"]),
                           config_params=conf)[0])


@pytest.mark.parametrize("items", HOOKS, ids=lambda i: "-".join(map(str, i)))
def test_hooked_activations_match_jax_neox(hook_engines, items):
    jeng, eng = hook_engines
    tokens = _tokens(3)
    jeng.train_batch(batch=(tokens, tokens), layers_to_hook=items)
    want = jeng.get_hooked_activations()
    eng.train_batch(batch=(tokens, tokens), layers_to_hook=items)
    got = eng.get_hooked_activations()
    assert sorted(got) == sorted(want) and got
    for i in got:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=1e-5, rtol=1e-5, err_msg=str(i))
    # one shot: the next batch captures nothing new
    jeng.train_batch(batch=(tokens, tokens))
    eng.train_batch(batch=(tokens, tokens))
    assert eng.get_hooked_activations() is got


def test_neox_eval_logits_match_jax(hook_engines):
    """`eval_batch(return_logits=True)` through GPT-NeoX's
    `loss_and_logits` (one forward), against the JAX engine's."""
    jeng, eng = hook_engines
    ev = _tokens(9, (MICRO,))
    jloss, jlogits = jeng.eval_batch((ev, ev), return_logits=True)
    loss, logits = eng.eval_batch((ev, ev), return_logits=True)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert loss == eng.eval_batch((ev, ev))


def test_hooked_activations_gpt2_match_the_jax_blocks(weights):
    """The JAX GPT-2 has no capture of its own; its forward, block by
    block, is the reference (the same embedding, blocks and final
    norm)."""
    jparams = weights["gpt2"]
    jcfg = jgpt2.GPT2Config(**SIZE)
    tokens = _tokens(4)
    x = jparams["embed"]["wte"][tokens[0]] + jparams["embed"]["wpe"][:S][None]
    want = [np.asarray(x)]
    for bp in jparams["blocks"]:
        x = jgpt2.block_forward(jcfg, bp, x, use_pallas=False)
        want.append(np.asarray(x))
    want.append(np.asarray(jneox.layer_norm(
        x, jparams["final_ln"]["scale"], jparams["final_ln"]["bias"],
        jcfg.layernorm_eps)))
    eng, *_ = dst.initialize(model=_port_model("gpt2", jparams),
                             config_params=_config())
    assert eng.module.layer_names() == \
        ["embedding", "transformerlayer", "transformerlayer", "final_ln"]
    eng.set_layers_to_hook([0, "Transformer", 3])
    eng((tokens[0], tokens[0]))          # the legacy forward captures too
    got = eng.get_hooked_activations()
    assert sorted(got) == [0, 1, 2, 3]
    for i, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[i], atol=1e-5, rtol=1e-5,
                                   err_msg=str(i))
    assert eng._layers_to_hook == []


def test_hooked_activations_match_jax_bert():
    """BERT's capture is the JAX engine's: the model's deterministic
    `hidden_states` of the first micro-batch, picked by `layer_names`."""
    size = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                intermediate_size=256, max_position_embeddings=S)
    jmodel = jbert.BertForPreTraining(jbert.BertConfig(**size))
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, (GAS, MICRO, S)).astype(np.int32)
    labels = np.full_like(ids, -1)
    labels[..., ::9] = ids[..., ::9]
    mask = np.ones(ids.shape, np.float32)
    mask[:, 0, 100:] = 0.0
    batch = dict(input_ids=ids, token_type_ids=np.zeros_like(ids),
                 attention_mask=mask, masked_lm_labels=labels,
                 next_sentence_label=np.zeros((GAS, MICRO), np.int32))
    keys = ("input_ids", "token_type_ids", "attention_mask",
            "masked_lm_labels", "next_sentence_label")
    outs = jmodel.hidden_states(jparams, tuple(jnp.asarray(batch[k][0])
                                               for k in keys))
    names = jmodel.layer_names()
    conf = _config()
    del conf["gradient_clipping"]
    model = bert.BertForPreTraining(bert.BertConfig(**size), device="cpu") \
        .load_jax_params(jparams)
    assert model.layer_names() == names
    eng, *_ = dst.initialize(model=model, config_params=conf)
    eng.train_batch(batch=batch, layers_to_hook=["TransformerLayer", 0])
    got = eng.get_hooked_activations()
    assert sorted(got) == [0, 1, 2] and len(names) == 3
    for i in got:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(outs[i]),
                                   atol=1e-5, rtol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("family", ["neox", "gpt2", "bert"])
def test_capture_forward_builds_no_graph(family):
    """The capture forward (`hidden_states`) of every family runs
    without autograd, so it holds no layer's activations past the
    capture."""
    if family == "bert":
        model = bert.BertForPreTraining(bert.BertConfig(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=S),
            device="cpu").init_params(0)
        ids = torch.from_numpy(_tokens(6, (MICRO,)).astype(np.int64))
        batch = (ids, torch.zeros_like(ids), torch.ones(ids.shape),
                 torch.full_like(ids, -1), torch.zeros(MICRO, dtype=torch.long))
    else:
        model = (neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
                 if family == "neox" else
                 gpt2.GPT2(gpt2.GPT2Config(**SIZE), device="cpu")).init_params(0)
        tokens = torch.from_numpy(_tokens(6, (MICRO,)).astype(np.int64))
        batch = (tokens, tokens)
    outs = model.hidden_states(model.params_tree(), batch)
    assert len(outs) == len(model.layer_names())
    assert not any(t.requires_grad or t.grad_fn is not None for t in outs)


# ---------------------------------------------------------------------------
# stored gradients and the gradient noise scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fp16", [FP32, BF16], ids=["fp32", "bf16"])
def test_stored_gradients_on_device_and_host(weights, fp16, one_thread):
    """Each micro-batch's own gradients (in the compute dtype, not the
    running sum), the same on the device as on the host; the host copy
    does not change when training goes on."""
    tokens = _tokens(6)
    engines = {}
    for cpu in (True, False):
        engines[cpu], *_ = dst.initialize(
            model=_port_model("neox", weights["neox"]),
            config_params=_config(fp16, store_gradients=True,
                                  store_gradients_cpu=cpu))
    stored = {True: [], False: []}
    for cpu, eng in engines.items():
        for i in range(GAS):
            eng.backward(eng((tokens[i], tokens[i])))
            stored[cpu].append(eng.stored_gradients)
        eng.step()
    for i in range(GAS):
        host = _flatten(stored[True][i], "", {})
        dev = _flatten(stored[False][i], "", {})
        for name, g in dev.items():
            assert isinstance(g, torch.Tensor) and \
                isinstance(host[name], np.ndarray)
            assert g.dtype == engines[False].compute_dtype
            np.testing.assert_array_equal(g.float().numpy(), host[name])
    first, second = (_flatten(stored[True][i], "", {})["embed.wte"]
                     for i in range(GAS))
    assert not np.array_equal(first, second)
    # a fresh engine's first micro-batch gives the first stored gradients
    eng, *_ = dst.initialize(model=_port_model("neox", weights["neox"]),
                             config_params=_config(fp16))
    eng.backward(eng((tokens[0], tokens[0])))
    np.testing.assert_array_equal(
        eng._natural_tree(eng._grad_acc.float())["embed"]["wte"].numpy(),
        first)


def test_gradient_noise_scale_matches_the_jax_class():
    rng = np.random.default_rng(7)
    ours, ref = GradientNoiseScale(4, 3, beta=0.9), JaxGNS(4, 3, beta=0.9)
    for k in range(7):
        tree = {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
                "b": [rng.standard_normal(11).astype(np.float32) * (k + 1)]}
        if k == 4:
            tree["a"]["w"][0, 0] = np.nan       # skipped on both sides
        ref.update(jax.tree_util.tree_map(jnp.asarray, tree))
        ours.update(jax.tree_util.tree_map(torch.from_numpy, tree))
        for f in ("scale", "noise", "noise_scale"):
            a, b = getattr(ours, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f)
        assert (ours.n_updates, ours.skipped_nonfinite) == \
            (ref.n_updates, ref.skipped_nonfinite)
    assert ours.noise_scale is not None and ours.skipped_nonfinite == 1


# ---------------------------------------------------------------------------
# argparse helpers
# ---------------------------------------------------------------------------

def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.help, a.const,
             a.nargs) for a in parser._actions if a.dest != "help"]


@pytest.mark.parametrize("helper", ["config", "tuning"])
def test_argument_helpers_match_jax(helper):
    ours, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    if helper == "config":
        assert dst.add_config_arguments(ours) is ours
        deeperspeed_tpu.add_config_arguments(ref)
        argv = ["--deepspeed", "--deepspeed_config", "ds.json"]
    else:
        assert sched.add_tuning_arguments(ours) is ours
        jsched.add_tuning_arguments(ref)
        argv = ["--lr_schedule", "WarmupLR", "--warmup_num_steps", "7",
                "--cycle_momentum"]
    assert _actions(ours) == _actions(ref)
    assert [(g.title, g.description) for g in ours._action_groups] == \
        [(g.title, g.description) for g in ref._action_groups]
    assert vars(ours.parse_args(argv)) == vars(ref.parse_args(argv))
    assert vars(ours.parse_args([])) == vars(ref.parse_args([]))
