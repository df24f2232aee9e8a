"""The port's flash-prefill plain version against the JAX package's
segmented flash-attention forward (the Pallas `_fwd_kernel`, run in
interpret mode on the CPU) and its XLA `causal_attention` branch.

The CUDA kernel itself runs only on the card: `chip_smoke.py` holds it
against this plain version there."""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.models.gpt_neox import \
    causal_attention as jax_causal_attention
from deeperspeed_tpu_torch.models.gpt_neox import causal_attention
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa

# the package re-exports a `flash_attention` function under the module's
# name, so reach the module itself through importlib
jfa = importlib.import_module("deeperspeed_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)


def _inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _packed_segments(B, S, seed):
    """Ragged packed documents (ids 1, 2, ...) followed by a pad tail of
    id 0, a different split per row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        end = int(rng.integers(S // 2, S))
        cuts = np.sort(rng.choice(np.arange(1, end), size=2, replace=False))
        bounds = [0, *cuts.tolist(), end]
        for i in range(3):
            seg[b, bounds[i]:bounds[i + 1]] = i + 1
    return seg


def test_reference_matches_pallas_segmented_kernel():
    B, S, H, D = 2, 256, 2, 64
    q, k, v = _inputs(B, S, H, D, 0)
    seg = _packed_segments(B, S, 1)
    scale = 1.0 / math.sqrt(D)
    out_j, res = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          True, scale, 128, 128,
                          seg=jnp.asarray(seg).reshape(B, 1, S))
    lse_j = np.asarray(res[4])
    out_t, lse_t = fa.flash_attention_segmented_reference(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(seg))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=2e-5, rtol=2e-5)
    # the public JAX entry gives the same output
    out_pub = jfa.flash_attention_segmented(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        True, None, 128, 128)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_pub),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("with_seg", [True, False])
def test_causal_attention_matches_xla_branch(with_seg):
    B, S, H, D = 2, 64, 2, 64
    q, k, v = _inputs(B, S, H, D, 2)
    lens = np.array([S, 37])
    seg = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ref = jax_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=False,
        segment_ids=jnp.asarray(seg) if with_seg else None)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tseg = torch.from_numpy(seg) if with_seg else None
    for use_kernels in (True, False):
        out = causal_attention(tq, tk, tv, use_kernels=use_kernels,
                               segment_ids=tseg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=2e-5)


def test_row_alone_in_its_segment_sees_only_itself():
    """Segment equality is ANDed into the causal mask: a token whose
    segment holds no earlier token attends to itself alone, so its
    output is its own value row and its lse its own scaled score."""
    B, S, H, D = 1, 8, 1, 64
    q, k, v = map(torch.from_numpy, _inputs(B, S, H, D, 3))
    seg = torch.zeros(B, S, dtype=torch.int32)
    seg[0, 3] = 7
    out, lse = fa.flash_attention_segmented_reference(q, k, v, seg)
    np.testing.assert_allclose(out[0, 3].numpy(), v[0, 3].numpy(),
                               atol=1e-6)
    own = float((q[0, 3, 0] * k[0, 3, 0]).sum()) / math.sqrt(D)
    assert abs(float(lse[0, 3]) - own) < 1e-5


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _inputs(2, 64, 2, 64, 4))
    seg = torch.ones(2, 64, dtype=torch.int32)
    out = fa.flash_attention_segmented(q, k, v, seg)
    ref_out, _ = fa.flash_attention_segmented_reference(q, k, v, seg)
    assert torch.equal(out, ref_out)
    assert fa.launches == 0


def test_shape_checks():
    q, k, v = map(torch.from_numpy, _inputs(1, 16, 2, 64, 5))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_segmented(q, k[:, :8], v)
    with pytest.raises(ValueError, match="segment_ids"):
        fa.flash_attention_segmented(q, k, v, torch.ones(1, 8))
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_segmented(q.to("meta"), k.to("meta"),
                                     v.to("meta"))
