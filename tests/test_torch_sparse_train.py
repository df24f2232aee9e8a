"""The port's sparse-attention training slice against the JAX package's,
on the CPU.

- the JSON "sparse_attention" block: the same parsed dict and the same
  errors as the JAX `_parse_sparse_attention`, `DeepSpeedConfig` and the
  engine accessor;
- `make_sparse_attention`: the JAX errors on a bidirectional pattern and
  on segment ids;
- a sparse GPT-NeoX (hidden 128, 2 heads of 64, 2 layers) on JAX-made
  weights carried by `state_dict_from_jax`: loss and gradients against
  `jax.value_and_grad` of the JAX model, and three fp32 `train_batch`
  steps of `initialize()` engines driven by the JSON block against the
  JAX engine on a one-device mesh, on the masked flash arm (fixed, 4
  local + 1 global, S = 512) and the block-sparse arm (variable, window 1
  and global block 0, S = 1024). The JAX sparse kernels run in Pallas
  interpret mode; on CPU tensors the port takes their plain versions;
- a sparse model built from the config alone trains; serving refuses it.

Tolerances are those of `test_torch_train_engine.py` (fp32: losses rtol
1e-5, gradients and masters atol = rtol = 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.ops.sparse_attention import \
    SparseSelfAttention as JaxSparseSelfAttention
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config import \
    _parse_sparse_attention as jax_parse
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import (flat_from_jax,
                                                  state_dict_from_jax)
from deeperspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                  _parse_sparse_attention)
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

SIZE = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=1024)
# arm → (the JSON block, sequence length)
ARMS = {
    "masked_flash": ({"mode": "fixed", "block": 128, "num_local_blocks": 4,
                      "num_global_blocks": 1}, 512),
    "block_sparse": ({"mode": "variable", "block": 128,
                      "local_window_blocks": [1],
                      "global_block_indices": [0]}, 1024),
}


def _config(block, **extra):
    conf = {
        "train_batch_size": 1,
        "train_micro_batch_size_per_gpu": 1,
        "gradient_accumulation_steps": 1,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 2},
        "sparse_attention": block,
    }
    conf.update(extra)
    return conf


# ---------------------------------------------------------------------------
# the JSON block
# ---------------------------------------------------------------------------

BLOCKS = [
    {},
    {"mode": "dense", "block": 32},
    {"mode": "fixed", "block": 128, "num_local_blocks": 16,
     "num_global_blocks": 1, "attention": "unidirectional"},
    {"mode": "variable", "num_random_blocks": 1,
     "local_window_blocks": [2, 4], "global_block_indices": [0, 9],
     "global_block_end_indices": [1, 11], "horizontal_global_attention": True},
    {"mode": "bigbird", "num_sliding_window_blocks": 5},
    {"mode": "bslongformer", "global_block_indices": [2]},
]


@pytest.mark.parametrize("block", BLOCKS,
                         ids=lambda b: b.get("mode", "defaults"))
def test_sparse_block_parses_like_jax(block):
    d = {"sparse_attention": block}
    assert _parse_sparse_attention(d) == jax_parse(d)
    conf = {"train_batch_size": 2, **d}
    assert DeepSpeedConfig(conf).sparse_attention == \
        JaxConfig(conf, world_size=1).sparse_attention
    assert _parse_sparse_attention({}) is None


def test_unknown_mode_raises_like_jax():
    d = {"sparse_attention": {"mode": "strided"}}
    with pytest.raises(JaxConfigError) as want:
        jax_parse(d)
    with pytest.raises(DeepSpeedConfigError, match=str(want.value)):
        DeepSpeedConfig({"train_batch_size": 2, **d})


@pytest.mark.parametrize("block", [
    {"mode": "bigbird", "attention": "bidirectional"},
    {"mode": "fixed", "attention": "bidirectional"},
    {"mode": "dense"}], ids=["bigbird", "fixed", "dense"])
def test_bidirectional_patterns_raise_like_jax(block):
    """An explicit bidirectional pattern, and the dense mode (which has
    no direction), leak future tokens into a causal LM: ValueError."""
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    with pytest.raises(ValueError, match="unidirectional sparsity") as want:
        jneox.make_sparse_attention(jcfg, block)
    with pytest.raises(ValueError) as got:
        neox.make_sparse_attention(neox.GPTNeoXConfig(**SIZE), block)
    assert str(got.value) == str(want.value)


def test_segment_ids_and_engines_raise():
    attn = neox.make_sparse_attention(neox.GPTNeoXConfig(**SIZE), {})
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(NotImplementedError, match="segment-aware"):
        attn(q, q, q, segment_ids=torch.zeros(1, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="'dense' or 'sparse'"):
        neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE, attention_engine="ring"),
                     device="cpu")


# ---------------------------------------------------------------------------
# the sparse GPT-NeoX against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jcfg, jax.device_get(jneox.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=(1, 1, S)).astype(np.int32)


def _eager_layout(jmodel, S):
    """Build the JAX model's sparse layout (and its masked-flash kernel)
    outside any trace. Built lazily inside `jit`, the masked arm keeps a
    tracer of its layout map (`make_masked_flash_attention` makes a
    `jnp` array of it), and the next trace fails on the leak
    (ROADMAP.md §C)."""
    sp = next(c.cell_contents for c in jmodel._attn_fn.__closure__
              if isinstance(c.cell_contents, JaxSparseSelfAttention))
    sp._cache.clear()
    sp.get_layout(S)


def _port_model(jparams, block):
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
    model.load_jax_params(jparams)
    model.apply_ds_config(DeepSpeedConfig(_config(block)))
    return model


@pytest.mark.parametrize("arm", list(ARMS))
def test_sparse_loss_and_grads_match_jax(weights, arm):
    jcfg, jparams = weights
    block, S = ARMS[arm]
    toks = _tokens(S, 1)[0]
    jmodel = jneox.GPTNeoX(jcfg, use_pallas=False)
    jmodel.apply_ds_config(JaxConfig(_config(block), world_size=1))
    _eager_layout(jmodel, S)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, (jnp.asarray(toks), jnp.asarray(toks)))
    model = _port_model(jparams, block)
    assert model.config.attention_engine == "sparse"
    assert model.sparse_self_attention.arm(S, 64) == arm
    loss = model.loss_fn(model.params_tree(), (torch.from_numpy(toks),
                                               torch.from_numpy(toks)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arm", list(ARMS))
def test_sparse_fp32_steps_match_jax(weights, arm):
    """Three steps of engines built from the JSON block alone: the block
    reaches the model through `apply_ds_config` on both sides."""
    _, jparams = weights
    block, S = ARMS[arm]
    conf = _config(block)
    toks = _tokens(S, 2)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jmodel = jneox.GPTNeoX(jneox.GPTNeoXConfig(**SIZE), use_pallas=False)
    jeng, *_ = deeperspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config_params=conf,
        mesh=mesh)
    _eager_layout(jmodel, S)
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
    eng, *_ = dst.initialize(model=model.load_jax_params(jparams),
                             config_params=conf)
    assert model.config.attention_engine == "sparse"
    assert eng.sparse_attention_config() == jeng.sparse_attention_config()
    losses = np.array([(float(jeng.train_batch(batch=(toks, toks))),
                        eng.train_batch(batch=(toks, toks)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    masters = flat_from_jax(jax.device_get(jeng.state.master),
                            eng.param_names)
    np.testing.assert_allclose(eng._master.numpy(), masters.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_sparse_engine_set_on_the_config_trains():
    """`attention_engine="sparse"` on the config without a JSON block
    builds the engine lazily with the defaults (fixed, block 128,
    unidirectional) and trains; the serving engine refuses the model,
    as the JAX one does."""
    cfg = neox.GPTNeoXConfig(**dict(SIZE, hidden_size=64, num_layers=1),
                             attention_engine="sparse")
    model = neox.GPTNeoX(cfg, device="cpu").init_params(0)
    eng, *_ = dst.initialize(model=model, config_params={
        "train_batch_size": 1, "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2}}})
    sp = model.sparse_self_attention
    assert sp.block == 128 and sp.sparsity_config.attention == \
        "unidirectional"
    toks = _tokens(512, 3)
    losses = [eng.train_batch(batch=(toks, toks)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.isfinite(eng.eval_batch((toks[0], toks[0])))
    with pytest.raises(DeepSpeedConfigError, match="attention_engine"):
        dst.InferenceEngine(model, config={"inference": {
            "enabled": True, "page_size": 16}}, device="cpu")
