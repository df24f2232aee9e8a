"""The port's paged-decode plain version against the JAX package's
`paged_decode_attention`: the Pallas `_decode_kernel` in interpret mode
and the XLA fallback.

The CUDA kernel itself runs only on the card: `chip_smoke.py` holds it
against this plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_paged_decode
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da

torch.set_num_threads(2)


def _case(seed, B=4, H=2, D=64, ps=16, NP=4, P=24):
    """Random pools, a page permutation, lengths with 0, a partial page
    and an exact page edge, and trash page 0 past every length."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, H, ps, D)).astype(np.float32)
    vp = rng.standard_normal((P, H, ps, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(B, NP)
    lengths = np.array([37, 0, 32, NP * ps][:B], np.int32)
    live = np.arange(NP)[None] * ps < lengths[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reference_matches_jax(backend):
    q, kp, vp, table, lengths = _case(0)
    ref = np.asarray(jax_paged_decode(
        *map(jnp.asarray, (q, kp, vp, table, lengths)), backend=backend))
    out = da.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, kp, vp, table, lengths)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert (out.numpy()[lengths == 0] == 0.0).all()


def test_trash_entries_are_never_read():
    """Pages past a sequence's length do not change its output, whatever
    finite values the trash page holds."""
    q, kp, vp, table, lengths = _case(1)
    args = list(map(torch.from_numpy, (q, kp, vp, table, lengths)))
    out = da.paged_decode_attention(*args)
    args[1] = args[1].clone()
    args[2] = args[2].clone()
    args[1][0] = 1e4          # the trash page
    args[2][0] = -1e4
    out2 = da.paged_decode_attention(*args)
    live = lengths > 0
    torch.testing.assert_close(out[live], out2[live], atol=0, rtol=0)


def test_single_token_sequence_is_its_value_row():
    q, kp, vp, table, _ = _case(2)
    lengths = np.array([1, 1, 1, 1], np.int32)
    out = da.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, table, lengths)))
    np.testing.assert_allclose(out.numpy(), vp[table[:, 0], :, 0, :],
                               atol=1e-6)


def test_backends_and_launch_counter_on_cpu():
    args = list(map(torch.from_numpy, _case(3)))
    before = da.launches
    outs = [da.paged_decode_attention(*args, backend=b)
            for b in (None, "auto", "pallas", "xla")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert da.launches == before
    with pytest.raises(ValueError, match="backend"):
        da.paged_decode_attention(*args, backend="cuda")


def test_shape_checks():
    q, kp, vp, table, lengths = map(torch.from_numpy, _case(4))
    with pytest.raises(ValueError, match="v_pages"):
        da.paged_decode_attention(q, kp, vp[:, :1], table, lengths)
    with pytest.raises(ValueError, match="page_table"):
        da.paged_decode_attention(q, kp, vp, table[:2], lengths)
    with pytest.raises(ValueError, match="lengths"):
        da.paged_decode_attention(q, kp, vp, table, lengths[:2])
