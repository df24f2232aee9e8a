"""The port's MoE slice against the JAX package's, on the CPU.

- `moe_ffn_dense` (both engines, top-1 and top-2, groups 1 and auto, a
  capacity overflow, renormalized top-2 on and off): outputs, aux loss
  and the grads of x and of the five expert leaves against `jax.grad`,
  on the same numpy inputs and weights (fp32, 1e-5);
- sort vs einsum inside the port, with gate jitter drawn from one
  `torch.Generator` seed (the JAX invariant of
  `test_sort_matches_einsum_with_jitter`; the noise is not JAX's);
- a tiny MoE GPT-NeoX: loss and grads against the JAX model on JAX-made
  weights, and three `train_batch` steps driven by the JSON "moe" block
  (sort dispatch, fp32 and bf16) against the JAX engine on a 1-device
  mesh, at the tolerances of `test_torch_train_engine.py`;
- the JSON block turning a dense model into an MoE one, the refusals
  (serving an MoE model, a mesh, expert parallelism, the quantized FFN,
  routing statistics).

The grouped matmul's CUDA kernels run only on the card (`chip_smoke.py`
phases 3, 11 and 12); on CPU tensors the sort engine takes their plain
version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.moe import MoELayer as JaxMoELayer
from deeperspeed_tpu.moe import moe_ffn_dense as jax_moe
from deeperspeed_tpu.moe.layer import _resolve_groups as jax_resolve_groups

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import (flat_from_jax,
                                                  state_dict_from_jax)
from deeperspeed_tpu_torch.moe import (MoELayer, moe_ffn_dense,
                                       moe_ffn_expert_parallel)
from deeperspeed_tpu_torch.moe.layer import _resolve_groups
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

H, I, E = 16, 32, 8
LEAVES = ("gate", "w_in", "b_in", "w_out", "b_out")


@pytest.fixture(scope="module")
def layer_params():
    jp = jax.device_get(JaxMoELayer(H, I, E).init(jax.random.PRNGKey(0)))
    # non-zero biases, so their grads and the bias paths are compared too
    rng = np.random.default_rng(5)
    jp["b_in"] = (0.1 * rng.standard_normal((E, I))).astype(np.float32)
    jp["b_out"] = (0.1 * rng.standard_normal((E, H))).astype(np.float32)
    return jp


def _x(T, seed=1):
    return np.random.default_rng(seed).standard_normal((T, H)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the layer against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("top_k,groups,renorm", [
    (1, 1, False), (2, 1, False), (2, 1, True), (2, 0, False), (1, 0, True)])
def test_moe_ffn_matches_jax(layer_params, dispatch, top_k, groups, renorm):
    """T = 256 tokens (auto groups: 2 of 128); capacity factor 0.75 makes
    experts overflow, so dropped copies and (with renorm) the moved mass
    are on the path."""
    x = _x(256)
    kw = dict(top_k=top_k, groups=groups, dispatch=dispatch,
              renorm_kept_choices=renorm, capacity_factor=0.75)

    def jloss(p, xx):
        y, aux = jax_moe(p, xx, **kw)
        return jnp.sum(jnp.sin(y)) + 0.1 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in layer_params.items()},
            jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in layer_params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe_ffn_dense(tp, tx, **kw)
    (torch.sin(y).sum() + 0.1 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for k in LEAVES:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_capacity_overflow_drops_like_jax(layer_params, dispatch):
    """All tokens forced to expert 0 at capacity 1: only the first token
    keeps an output."""
    p = dict(layer_params)
    p["gate"] = np.zeros_like(p["gate"])
    p["gate"][:, 0] = 1.0
    x = np.ones((16, H), np.float32)
    jy, _ = jax_moe({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), capacity_factor=E / 16,
                    dispatch=dispatch)
    y, _ = moe_ffn_dense({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}, torch.from_numpy(x),
                         capacity_factor=E / 16, dispatch=dispatch)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    norms = np.linalg.norm(y.numpy(), axis=-1)
    assert norms[0] > 1e-3 and np.all(norms[1:] == 0.0)


def test_resolve_groups_matches_jax():
    for tokens in (128, 256, 1000, 2048, 2 * 1031, 4096, 8192, 3 * 1024):
        for groups in (0, 1, 2):
            assert _resolve_groups(groups, tokens) == \
                jax_resolve_groups(groups, tokens), (groups, tokens)
    with pytest.raises(ValueError, match="divide"):
        _resolve_groups(3, 128)


# ---------------------------------------------------------------------------
# sort vs einsum inside the port
# ---------------------------------------------------------------------------

def _port_params(layer_params):
    return {k: torch.from_numpy(np.array(v)).requires_grad_()
            for k, v in layer_params.items()}


def test_sort_matches_einsum_with_jitter(layer_params):
    """Both engines draw their noise from the same generator state at the
    same point, so they route identically under jitter; the noise moves
    the routing away from the noiseless one."""
    x = torch.from_numpy(_x(64, seed=3))
    out = {}
    for dispatch in ("einsum", "sort"):
        gen = torch.Generator().manual_seed(7)
        out[dispatch] = moe_ffn_dense(
            _port_params(layer_params), x, top_k=2, groups=2, rng=gen,
            jitter_eps=0.3, dispatch=dispatch)
    (ye, ae), (ys, as_) = out["einsum"], out["sort"]
    torch.testing.assert_close(ys, ye, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(as_, ae, rtol=1e-6, atol=1e-7)
    y0, _ = moe_ffn_dense(_port_params(layer_params), x, top_k=2, groups=2,
                          dispatch="sort")
    assert not torch.allclose(ys, y0)


def test_jitter_draws_only_with_rng_and_eps(layer_params):
    x = torch.from_numpy(_x(32))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    moe_ffn_dense(_port_params(layer_params), x, rng=gen, jitter_eps=0.0,
                  dispatch="sort")
    assert torch.equal(gen.get_state(), state)
    moe_ffn_dense(_port_params(layer_params), x, rng=gen, jitter_eps=0.1,
                  dispatch="sort")
    assert not torch.equal(gen.get_state(), state)


def test_sort_grads_match_einsum(layer_params):
    x = torch.from_numpy(_x(48, seed=4))
    grads = {}
    for dispatch in ("einsum", "sort"):
        p = _port_params(layer_params)
        y, aux = moe_ffn_dense(p, x, top_k=2, dispatch=dispatch)
        ((y ** 2).sum() + 0.01 * aux).backward()
        grads[dispatch] = {k: p[k].grad for k in LEAVES}
    for k in LEAVES:
        torch.testing.assert_close(grads["sort"][k], grads["einsum"][k],
                                   rtol=2e-5, atol=2e-5)


def test_layer_protocol_and_refusals():
    layer = MoELayer(H, I, E, top_k=2, dispatch="sort", device="cpu")
    params = layer.init(0)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "gate": (H, E), "w_in": (E, H, I), "b_in": (E, I),
        "w_out": (E, I, H), "b_out": (E, H)}
    y, aux = layer.apply(params, torch.randn(2, 16, H))
    assert y.shape == (2, 16, H) and aux.dim() == 0
    with pytest.raises(ValueError, match="dispatch"):
        MoELayer(H, I, E, dispatch="scatter", device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        moe_ffn_dense(params, torch.randn(8, H), dispatch="scatter")
    # a mesh without an "expert" dimension: the one-card layer (expert
    # parallelism on gloo ranks: test_torch_moe_ep_layer.py)
    assert MoELayer(H, I, E, mesh=object(), device="cpu").ep == 1
    with pytest.raises(RuntimeError, match="init_distributed"):
        moe_ffn_expert_parallel(params, torch.randn(8, H), None, 2)
    with pytest.raises(TypeError, match="axis name"):
        moe_ffn_expert_parallel(params, torch.randn(8, H), "expert", 2)
    # the quantized FFN runs on the sort engine only (the JAX refusal)
    with pytest.raises(ValueError, match="requires dispatch='sort'"):
        moe_ffn_dense(params, torch.randn(8, H), dispatch="einsum",
                      ffn_quant=("int8", 1.0, torch.zeros(4, 2)))


# ---------------------------------------------------------------------------
# the MoE GPT-NeoX and the training engine against the JAX package
# ---------------------------------------------------------------------------

SIZE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=64)
MOE = dict(num_experts=4, top_k=2, capacity_factor=1.25, dispatch="sort")
MOE_CFG = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
               moe_dispatch="sort")
GAS, MICRO, S = 2, 2, 64


@pytest.fixture(scope="module")
def moe_weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE, **MOE_CFG)
    return jcfg, jax.device_get(jneox.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S)).astype(np.int32)


def _port_moe_model(jparams, dispatch="sort"):
    cfg = neox.GPTNeoXConfig(**SIZE, **dict(MOE_CFG, moe_dispatch=dispatch))
    return neox.GPTNeoX(cfg, device="cpu").load_jax_params(jparams)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_model_loss_and_grads_match_jax(moe_weights, dispatch):
    jcfg, jparams = moe_weights
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "moe_dispatch": dispatch})
    toks = np.random.default_rng(1).integers(0, 512, size=(2, S)).astype(
        np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        jneox.GPTNeoX(jcfg, use_pallas=False).loss_fn))(
            jparams, (jnp.asarray(toks), jnp.asarray(toks)))
    model = _port_moe_model(jparams, dispatch)
    assert {n for n, _ in model.named_parameters()} == \
        set(state_dict_from_jax(jparams))
    loss = model.loss_fn(model.params_tree(), (torch.from_numpy(toks),
                                               torch.from_numpy(toks)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def _config(fp16):
    return {
        "train_batch_size": GAS * MICRO,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
            "warmup_num_steps": 5}},
        "gradient_clipping": 1.0,
        "fp16": fp16,
        "zero_optimization": {"stage": 2},
        "moe": MOE,
    }


def _run_both(moe_weights, tokens, conf, steps=3):
    _, jparams = moe_weights
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jmodel = jneox.GPTNeoX(jneox.GPTNeoXConfig(**SIZE), use_pallas=False)
    jeng, *_ = deeperspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config_params=conf,
        mesh=mesh)
    assert jmodel.config.moe_dispatch == "sort"
    eng, *_ = dst.initialize(model=_port_moe_model(jparams),
                             config_params=conf)
    assert eng.module.config.moe_num_experts == MOE["num_experts"]
    losses = np.array([(float(jeng.train_batch(batch=(tokens, tokens))),
                        eng.train_batch(batch=(tokens, tokens)))
                       for _ in range(steps)])
    return jeng, eng, losses


def test_moe_fp32_steps_match_jax(moe_weights, tokens):
    jeng, eng, losses = _run_both(moe_weights, tokens,
                                  _config({"enabled": False}))
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    assert losses[-1, 1] < losses[0, 1]
    masters = flat_from_jax(jax.device_get(jeng.state.master),
                            eng.param_names)
    np.testing.assert_allclose(eng._master.numpy(), masters.numpy(),
                               atol=1e-4, rtol=1e-4)
    assert eng._grads_checked      # dW landed in the flat gradient views


def test_moe_bf16_steps_match_jax(moe_weights, tokens):
    _, eng, losses = _run_both(moe_weights, tokens, _config(
        {"enabled": True, "type": "bfloat16"}))
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=2e-2)
    assert eng.module.blocks[0].mlp.w_in.dtype == torch.bfloat16


def test_moe_json_block_makes_a_dense_model_moe(tokens):
    """The JSON path of chip_smoke.py phase 11: a dense model, the "moe"
    block, and the engine's flat state holds the expert weights."""
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
    model.init_params(3)
    dense = {n: p.detach().clone() for n, p in model.named_parameters()}
    conf = _config({"enabled": False})
    eng, *_ = dst.initialize(model=model, config_params=conf)
    cfg = model.config
    assert cfg.moe_num_experts == 4 and cfg.moe_dispatch == "sort"
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert names["blocks.1.mlp.w_in"] == (4, 64, 256)
    assert names["blocks.1.mlp.gate"] == (64, 4)
    assert "blocks.0.mlp.in_w" not in names
    assert eng.num_params == cfg.num_params() == sum(
        int(np.prod(s)) for s in names.values())
    # the trunk keeps its weights; the expert leaves follow init_params'
    # rule (0.02, w_out at 0.02 / sqrt(2L), zero biases)
    assert torch.equal(model.embed.wte, dense["embed.wte"])
    w_out = model.blocks[0].mlp.w_out
    assert abs(float(w_out.detach().std()) - 0.01) < 2e-3
    assert torch.all(model.blocks[0].mlp.b_in == 0)
    losses = [eng.train_batch(batch=(tokens, tokens)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert eng._grads_checked
    assert np.isfinite(eng.eval_batch((tokens[0], tokens[0])))


def test_moe_refusals(moe_weights):
    _, jparams = moe_weights
    with pytest.raises(DeepSpeedConfigError, match="MoE"):
        dst.InferenceEngine(_port_moe_model(jparams), config={
            "inference": {"enabled": True, "page_size": 16}}, device="cpu")
    # moe_observability is ported since: it builds, and a forward on the
    # einsum engine raises the JAX model's ValueError (sort only)
    model = neox.GPTNeoX(neox.GPTNeoXConfig(
        **SIZE, **dict(MOE_CFG, moe_dispatch="einsum"),
        moe_observability=True), device="cpu").init_params(0)
    with pytest.raises(ValueError, match="observe=True"):
        model(torch.zeros((1, 8), dtype=torch.long))
