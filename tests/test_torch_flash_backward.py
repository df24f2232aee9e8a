"""The port's flash-attention backward (its plain version, and the
autograd Function that takes it on CPU tensors) against `jax.vjp` of the
JAX package's `flash_attention` / `flash_attention_segmented`, whose
Pallas backward kernels run in interpret mode on the CPU: the
single-block `_bwd_single_kernel` (S = 128) and the tiled
`_bwd_dkv_kernel` / `_bwd_dq_kernel` (S = 256 in 128-row blocks, and
every segmented call).

The CUDA backward itself runs only on the card: `chip_smoke.py` holds it
against this plain version there. fp32 throughout, atol = rtol = 1e-4:
the two sides sum the same products in another order."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa

# the package re-exports a `flash_attention` function under the module's
# name, so reach the module itself through importlib
jfa = importlib.import_module("deeperspeed_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _arrays(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _ragged_segments(B, S, seed):
    """Packed documents 1, 2, 3 of random lengths, then a pad tail of
    segment 0, a different split per row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        end = int(rng.integers(S // 2, S - 8))
        cuts = np.sort(rng.choice(np.arange(1, end), size=2, replace=False))
        bounds = [0, *cuts.tolist(), end]
        for i in range(3):
            seg[b, bounds[i]:bounds[i + 1]] = i + 1
    return seg


def _jax_grads(q, k, v, do, seg, block):
    args = tuple(map(jnp.asarray, (q, k, v)))
    if seg is None:
        fn = lambda q, k, v: jfa.flash_attention(  # noqa: E731
            q, k, v, True, None, block, block)
    else:
        fn = lambda q, k, v: jfa.flash_attention_segmented(  # noqa: E731
            q, k, v, jnp.asarray(seg), True, None, block, block)
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


# (S, block, segmented): the JAX single-block path, its tiled path, and a
# segmented (tiled) call
CASES = [(128, 1024, False), (256, 128, False), (256, 128, True)]


@pytest.fixture(scope="module", params=CASES,
                ids=["single_S128", "tiled_S256", "segmented_S256"])
def case(request):
    S, block, segmented = request.param
    B, H, D = 2, 2, 64
    q, k, v, do = _arrays(B, S, H, D, S + segmented)
    seg = _ragged_segments(B, S, 7) if segmented else None
    if seg is not None:
        do = do * (seg != 0)[:, :, None, None]   # the loss skips pad rows
    out_j, grads_j = _jax_grads(q, k, v, do, seg, block)
    return (q, k, v, do, seg), out_j, grads_j


def test_plain_backward_matches_jax(case):
    (q, k, v, do, seg), _, grads_j = case
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tseg = torch.from_numpy(seg) if seg is not None else None
    out, lse = fa.flash_attention_segmented_reference(tq, tk, tv, tseg)
    grads = fa.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                             tseg)
    for name, g, gj in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(g.numpy(), gj, err_msg=f"d{name}", **TOL)
    if seg is not None:
        pad = torch.from_numpy(seg == 0)
        for g, gj in zip(grads, grads_j):
            assert bool((g[pad] == 0).all())
            assert not np.any(gj[seg == 0])


def test_autograd_function_matches_jax(case):
    (q, k, v, do, seg), out_j, grads_j = case
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tseg = torch.from_numpy(seg) if seg is not None else None
    out = fa.flash_attention_segmented(*leaves, tseg)
    np.testing.assert_allclose(out.detach().numpy(), out_j, **TOL)
    out.backward(torch.from_numpy(do))
    for name, t, gj in zip("qkv", leaves, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), gj, err_msg=f"d{name}",
                                   **TOL)
    assert fa.bwd_dkv_launches == fa.bwd_dq_launches == 0


def test_gradcheck_float64():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 7, 2, 4)))
               .requires_grad_() for _ in range(3))
    seg = torch.tensor([[1, 1, 1, 2, 2, 0, 0], [1] * 7], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention_segmented(q, k, v, seg),
        (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention_segmented(q, k, v, None, 0.3),
        (q, k, v))


def test_dead_rows_get_zero_grads():
    """The poisoned-lse convention: a row whose lse is +1e30 (no live
    key in the forward) contributes nothing, so its dq is 0 and dk/dv
    see no term from it."""
    q, k, v, do = map(torch.from_numpy, _arrays(1, 8, 1, 64, 5))
    out, lse = fa.flash_attention_segmented_reference(q, k, v)
    dead = lse.clone()
    dead[0, 5] = -fa.NEG_INF
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, out, dead, do)
    assert bool((dq[0, 5] == 0).all())
    # key 5 and later are seen only by rows >= 5; with row 5 dead, key 7
    # is seen by row 7 alone, exactly as when row 5's dO is zero
    do0 = do.clone()
    do0[0, 5] = 0
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do0)
    torch.testing.assert_close(dv[0, 7], ref[2][0, 7])
