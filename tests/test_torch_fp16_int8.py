"""fp16 with int8 weights and int8 KV pages: the port's plain versions
and serving engine against the JAX package's, on the CPU.

- the plain int8 matmul with fp16 activations against `_wq_kernel`
  (`quant_matmul_pallas`, interpret mode) and its XLA reference: fp16
  out, within one fp16 ulp of the fp32 sum (the two sum in another
  order, then scale in fp32 and round once to fp16, JAX's order); an
  fp16 output past 65504 is inf on both sides;
- the plain int8 paged decode with fp16 q against `_decode_kernel_quant`
  (interpret mode) and the XLA path: fp16 out within 2e-3 (P stays fp32
  on both sides, the scales bf16);
- `quantize_kv` on fp16 K/V bit-equal to the JAX function, ties and zero
  vectors included;
- an fp16 `InferenceEngine` serving int8 weights and int8 KV pages
  against the JAX engine on the same fp16 weights (carried across by
  `models.convert.state_dict_from_jax`): the first greedy token of every
  request identical, and the streams agreeing on at least 90% of their
  tokens (fp16 activations round apart between XLA and torch, so a
  near-tie may flip a later token); the port's pools int8 with bf16
  scales, every page returned.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.inference.kv_cache import quantize_kv as jax_quantize_kv
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.ops.pallas import quant_matmul as jqm
from deeperspeed_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_paged_decode

from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, InferenceEngine
from deeperspeed_tpu_torch.inference import quantize_kv
from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm

torch.set_num_threads(2)

F16 = np.float16


def _fp16_ulp(x):
    return np.spacing(np.abs(x).astype(F16)).astype(np.float32)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("M,K,N", [(16, 256, 128), (40, 96, 80)])
def test_fp16_quant_matmul_matches_jax(backend, M, K, N):
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, K)).astype(F16)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    jqw = jqm.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jqw, backend=backend))
    qw = qm.quantize_weight(torch.from_numpy(w))
    out = qm.quant_matmul(torch.from_numpy(x), qw)
    assert out.dtype == torch.float16 and ref.dtype == F16
    got = out.float().numpy()
    np.testing.assert_array_less(np.abs(got - ref.astype(np.float32)),
                                 _fp16_ulp(ref) + 1e-7)


def test_fp16_quant_matmul_overflows_to_inf_like_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 128)).astype(F16)
    w = (0.05 * rng.standard_normal((128, 64))).astype(np.float32)
    w[:, ::4] *= 2e5
    jqw = jqm.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jqm.quant_matmul_pallas(jnp.asarray(x), jqw))
    out = qm.quant_matmul(torch.from_numpy(x), qm.quantize_weight(
        torch.from_numpy(w))).float().numpy()
    assert np.isinf(ref).sum() > 0
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(np.sign(out[np.isinf(out)]),
                                  np.sign(ref[np.isinf(ref)]))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_fp16_int8_decode_matches_jax(backend):
    rng = np.random.default_rng(0)
    B, H, D, ps, NP, P = 4, 2, 64, 32, 3, 16
    q = rng.standard_normal((B, H, D)).astype(F16)
    kp, vp = (rng.integers(-127, 128, (P, H, ps, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.02, (P, H, ps)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(B, NP)
    lengths = np.array([45, 0, 32, NP * ps], np.int32)
    live = np.arange(NP)[None] * ps < lengths[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), backend=backend,
        k_scales=jnp.asarray(ks, jnp.bfloat16),
        v_scales=jnp.asarray(vs, jnp.bfloat16)))
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    out = da.paged_decode_attention(
        *t, k_scales=torch.from_numpy(ks).to(torch.bfloat16),
        v_scales=torch.from_numpy(vs).to(torch.bfloat16))
    assert out.dtype == torch.float16 and ref.dtype == F16
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                               atol=2e-3, rtol=0)
    assert (out.numpy()[lengths == 0] == 0).all()


def test_fp16_quantize_kv_bit_equal():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((6, 2, 16, 64)).astype(np.float32)
    v[0, 0, 0] = 0.0                       # a zero vector keeps scale 1
    # exact ties: 127 · k/2 over an amax of 127 (fp16 holds them)
    v[1, 0, 0, :4] = [127.0, 1.5, -2.5, 0.5]
    v = v.astype(F16)
    rq, rs = jax_quantize_kv(jnp.asarray(v))
    q, s = quantize_kv(torch.from_numpy(v))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert s.numpy()[0, 0, 0] == 1.0
    assert (q.numpy()[1, 0, 0, 1:4] == [2, -2, 0]).all()


SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
CONF = {"inference": {"enabled": True, "page_size": 16, "num_pages": 40,
                      "max_batch_size": 4, "token_budget": 256,
                      "prefill_lengths": [16, 32, 64],
                      "prefill_batch_sizes": [2], "decode_batch_sizes": [4],
                      "kv_cache_dtype": "int8"},
        "quantization": {"weights": "int8"}}


def test_fp16_int8_engine_stream_matches_jax():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    jmodel = jneox.GPTNeoX(config=jcfg, use_pallas=False)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(F16),
        jax.device_get(jmodel.init_params(jax.random.PRNGKey(0))))
    sd = state_dict_from_jax(jparams)
    assert all(t.dtype == torch.float16 for t in sd.values())
    model = GPTNeoX(GPTNeoXConfig(param_dtype=torch.float16, **SIZE),
                    device="cpu")
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (5, 17, 33, 60)]
    jeng = JaxEngine(jmodel, config=CONF, params=jparams)
    ref = jeng.generate(prompts, max_new_tokens=12)
    eng = InferenceEngine(model, config=CONF, device="cpu")
    assert eng.compute_dtype == torch.float16
    assert eng.dtypes["weight"] == "int8" == jeng.dtypes["weight"]
    assert eng.dtypes["kv_cache"] == "int8" == jeng.dtypes["kv_cache"]
    out = eng.generate(prompts, max_new_tokens=12)
    assert [o[0] for o in out] == [r[0] for r in ref]
    same = np.mean([a == b for o, r in zip(out, ref) for a, b in zip(o, r)])
    assert same >= 0.9, (out, ref)
    assert eng.cache.k.data.dtype == torch.int8
    assert eng.cache.k.scale.dtype == torch.bfloat16
    assert eng.cache.num_free == eng.cache.num_pages - 1
