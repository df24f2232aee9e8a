"""The port's GPT-NeoX against the JAX package's, on the same weights
(made in JAX and carried across with `state_dict_from_jax`): full-
sequence logits, and layer_norm / apply_rotary / _block_qkv one by one,
in fp32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    jparams = jax.device_get(jneox.init_params(jcfg, jax.random.PRNGKey(0)))
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
    model.load_jax_params(jparams)
    return jcfg, jparams, model


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_state_dict_names_and_layout(weights):
    _, jparams, model = weights
    sd = state_dict_from_jax(jparams)
    assert set(sd) == set(model.state_dict())
    assert "blocks.1.attn.qkv_w" in sd and "embed_out.wte" in sd
    # [in, out]: carried across without a transpose
    np.testing.assert_array_equal(sd["blocks.0.attn.qkv_w"].numpy(),
                                  np.asarray(jparams["blocks"][0]["attn"]
                                             ["qkv_w"]))
    assert tuple(sd["blocks.0.mlp.in_w"].shape) == (128, 512)


def test_full_sequence_logits(weights):
    jcfg, jparams, model = weights
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 128))
    ref = jneox.forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                        use_pallas=False)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and out.shape == (2, 128, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_layer_norm():
    x, scale, bias = _x((3, 5, 128), 2), _x((128,), 3), _x((128,), 4)
    ref = jneox.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias), 1e-5)
    out = neox.layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rotary(per_row):
    cfg = neox.GPTNeoXConfig(**SIZE)
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    q, k = _x((2, 16, 2, 64), 5), _x((2, 16, 2, 64), 6)
    jcos, jsin, jrot = jneox._rotary_cache(jcfg, 128)
    cos, sin, rot = neox._rotary_cache(cfg, 128)
    assert rot == jrot == 16
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    if per_row:            # the decode form: [B, S, rot] rows
        pos = np.array([[3] * 16, list(range(100, 116))])
        jcos, jsin = jcos[pos], jsin[pos]
        cos, sin = cos[torch.from_numpy(pos)], sin[torch.from_numpy(pos)]
    else:
        jcos, jsin, cos, sin = jcos[:16], jsin[:16], cos[:16], sin[:16]
    rq, rk = jneox.apply_rotary(jnp.asarray(q), jnp.asarray(k), jcos, jsin,
                                jrot)
    oq, ok = neox.apply_rotary(torch.from_numpy(q), torch.from_numpy(k),
                               cos, sin, rot)
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), **TOL)
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), **TOL)


def test_block_qkv(weights):
    jcfg, jparams, model = weights
    x = _x((2, 16, 128), 7)
    jcos, jsin, rot = jneox._rotary_cache(jcfg, 16)
    ref = jneox._block_qkv(jcfg, jparams["blocks"][1], jnp.asarray(x),
                           jcos, jsin, rot, 2)
    cos, sin, _ = neox._rotary_cache(model.config, 16)
    tree = model.params_tree()
    out = neox._block_qkv(model.config, tree["blocks"][1],
                          torch.from_numpy(x), cos, sin, rot, 2)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **TOL)


def test_block_post_attn(weights):
    jcfg, jparams, model = weights
    x, attn = _x((2, 16, 128), 8), _x((2, 16, 128), 9)
    ref = jneox._block_post_attn(jcfg, jparams["blocks"][0],
                                 jnp.asarray(x), jnp.asarray(attn),
                                 reduce_fn=lambda t: t)
    out = neox._block_post_attn(model.config, model.params_tree()["blocks"][0],
                                torch.from_numpy(x), torch.from_numpy(attn))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_init_params_is_seeded():
    cfg = neox.GPTNeoXConfig(**SIZE)
    a = neox.GPTNeoX(cfg, device="cpu").init_params(3).state_dict()
    b = neox.GPTNeoX(cfg, device="cpu").init_params(3).state_dict()
    c = neox.GPTNeoX(cfg, device="cpu").init_params(4).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.wte"], c["embed.wte"])
    assert torch.all(a["blocks.0.ln_attn.scale"] == 1)
    assert torch.all(a["blocks.0.attn.qkv_b"] == 0)
    # the out-projections draw at 0.02 / sqrt(2L), the rest at 0.02
    assert abs(float(a["blocks.0.mlp.out_w"].std()) - 0.01) < 2e-3
    assert abs(float(a["blocks.0.mlp.in_w"].std()) - 0.02) < 2e-3


def test_presets_match_the_jax_config():
    for name in ("tiny", "small", "xl_1_5b", "neox_20b"):
        ours = getattr(neox.GPTNeoXConfig, name)()
        ref = getattr(jneox.GPTNeoXConfig, name)()
        assert (ours.vocab_size, ours.hidden_size, ours.num_layers,
                ours.num_heads, ours.head_dim, ours.num_params()) == \
            (ref.vocab_size, ref.hidden_size, ref.num_layers,
             ref.num_heads, ref.head_dim, ref.num_params())
