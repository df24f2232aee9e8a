"""The port's sparse-attention ops against the JAX package's, on the CPU.

- sparsity layouts: bit-equal for all six config classes, uni- and
  bidirectional, with and without a layout per head (the random blocks
  of `variable` and `bigbird` from `random` seeded alike on both sides),
  and the same constructor errors; `sparsity_config_from_dict`;
- `MatMul` (sdd, dsd, dds, every trans_a / trans_b) and `Softmax` (rpe,
  key-padding and attention masks in add / mul mode): outputs and
  `jax.vjp` cotangents;
- the plain block-sparse version and the plain masked flash version
  (the plain versions of the CUDA kernels) against `BlockSparseAttention`
  and `make_masked_flash_attention`, whose Pallas kernels run in
  interpret mode: output and the vjp, causal and not, with a dead row;
- `SparseSelfAttention`: the same arm as the JAX module on each of its
  three arms, and the same output;
- the wrappers' argument errors and the refusals of the CUDA entry
  points (raised before any launch).

fp32 throughout; each tolerance is stated where it is used. The CUDA
kernels themselves run only on the card (`chip_smoke.py` phase 3 holds
them against these plain versions there).
"""

import importlib
import inspect
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deeperspeed_tpu.ops.sparse_attention import matmul as jmm
from deeperspeed_tpu.ops.sparse_attention import softmax as jsm
from deeperspeed_tpu.ops.sparse_attention import sparse_self_attention as jssa
from deeperspeed_tpu.ops.sparse_attention import sparsity_config as jsc

from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.sparse_attention import matmul as mm
from deeperspeed_tpu_torch.ops.sparse_attention import softmax as sm
from deeperspeed_tpu_torch.ops.sparse_attention import \
    sparse_self_attention as ssa
from deeperspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

# the package re-exports a `flash_attention` function under the module's
# name, so reach the module itself through importlib
jfa = importlib.import_module("deeperspeed_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

# fp32, the two sides sum the same products in another order
TOL = dict(atol=1e-5, rtol=1e-5)
# gradients through a softmax over up to 2048 keys: a few ulps more
TOL_GRAD = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

CLASSES = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=2,
                                 num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(num_local_blocks=3, num_global_blocks=1,
                                 horizontal_global_attention=True)),
    ("VariableSparsityConfig", dict(
        num_random_blocks=2, local_window_blocks=[2, 3],
        global_block_indices=[0, 5], global_block_end_indices=[2, 7])),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1)),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                        global_block_indices=[1, 9])),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=5)),
]


def _build(module, name, kwargs):
    """(layout, None) or (None, (type, message)) from one package."""
    cls = getattr(module, name)
    valid = set(inspect.signature(cls.__init__).parameters)
    random.seed(1234)
    try:
        cfg = cls(num_heads=3, block=16,
                  **{k: v for k, v in kwargs.items() if k in valid})
        return cfg.make_layout(16 * 22), None
    except (ValueError, NotImplementedError) as e:
        return None, (type(e), str(e))


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
@pytest.mark.parametrize("attention", ["unidirectional", "bidirectional"])
@pytest.mark.parametrize("name,kwargs", CLASSES,
                         ids=[f"{n[:-14]}{i}" for i, (n, _) in
                              enumerate(CLASSES)])
def test_layouts_bit_equal(name, kwargs, attention, per_head):
    """22 blocks: a short trailing window for `fixed`; constructor errors
    (horizontal globals under unidirectional, several global patterns on
    one shared layout) must be the JAX package's."""
    kwargs = dict(kwargs, attention=attention,
                  different_layout_per_head=per_head)
    want, want_err = _build(jsc, name, kwargs)
    got, got_err = _build(sc, name, kwargs)
    assert got_err == want_err
    if want is not None:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [
    {"mode": "fixed", "num_local_blocks": 2, "attention": "unidirectional"},
    {"mode": "bigbird", "num_random_blocks": 1, "block": 32},
    {"mode": "variable", "global_block_indices": [3], "attention": None},
    {"mode": "nope"}])
def test_sparsity_config_from_dict(block):
    random.seed(7)
    try:
        want = jsc.sparsity_config_from_dict(block).make_layout(256)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            sc.sparsity_config_from_dict(block)
        return
    random.seed(7)
    got = sc.sparsity_config_from_dict(block).make_layout(256)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# MatMul and Softmax
# ---------------------------------------------------------------------------

BLK, NB, Z, H = 16, 4, 2, 2


def _layout(seed=0, dead_row=False):
    rng = np.random.default_rng(seed)
    layout = (rng.random((H, NB, NB)) < 0.5).astype(np.int64)
    layout[:, np.arange(NB), np.arange(NB)] = 1
    if dead_row:
        layout[1, 2] = 0
    return layout


def _operands(mode, trans_a, trans_b, layout, seed):
    """Random a, b in the shapes the mode takes (sparse operands in the
    [Z, nnz, B, B] format)."""
    rng = np.random.default_rng(seed)
    nnz, S, K = int(layout.sum()), NB * BLK, 24

    def dense(rows, cols, trans):
        shape = (Z, H, cols, rows) if trans else (Z, H, rows, cols)
        return rng.standard_normal(shape).astype(np.float32)

    sparse = rng.standard_normal((Z, nnz, BLK, BLK)).astype(np.float32)
    if mode == "sdd":
        return dense(S, K, trans_a), dense(K, S, trans_b)
    if mode == "dsd":
        return sparse, dense(S, K, trans_b)
    return dense(K, S, trans_a), sparse


@pytest.mark.parametrize("trans_b", [False, True], ids=["b", "bT"])
@pytest.mark.parametrize("trans_a", [False, True], ids=["a", "aT"])
@pytest.mark.parametrize("mode", ["sdd", "dsd", "dds"])
def test_matmul_matches_jax(mode, trans_a, trans_b):
    layout = _layout(1)
    a, b = _operands(mode, trans_a, trans_b, layout, 2)
    jop = jmm.MatMul(layout, BLK, mode, trans_a=trans_a, trans_b=trans_b)
    op = mm.MatMul(layout, BLK, mode, trans_a=trans_a, trans_b=trans_b)
    want, vjp = jax.vjp(jop, jnp.asarray(a), jnp.asarray(b))
    ct = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    want_ga, want_gb = vjp(jnp.asarray(ct))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = op(ta, tb)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_ga), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_gb), **TOL)


def test_dense_sparse_round_trip_matches_jax():
    layout = _layout(4)
    x = np.random.default_rng(5).standard_normal(
        (Z, H, NB * BLK, NB * BLK)).astype(np.float32)
    sp = mm.dense_to_sparse(torch.from_numpy(x), layout, BLK)
    np.testing.assert_array_equal(
        sp.numpy(), np.asarray(jmm.dense_to_sparse(x, layout, BLK)))
    np.testing.assert_array_equal(
        mm.sparse_to_dense(sp, layout, BLK, fill=-1.0).numpy(),
        np.asarray(jmm.sparse_to_dense(sp.numpy(), layout, BLK,
                                       fill=-1.0)))


SOFTMAX_CASES = {
    "plain": {},
    "rpe": {"rpe": True},
    "kpm_add": {"kpm": "add"},
    "kpm_mul": {"kpm": "mul"},
    "am_add": {"am": "add"},
    "am_mul_dead_rows": {"am": "mul"},
    "all": {"rpe": True, "kpm": "mul", "am": "add"},
}


@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_softmax_matches_jax(case):
    """The "mul" attention mask zeroes whole rows: they must come out 0,
    as in the JAX op."""
    opts = SOFTMAX_CASES[case]
    layout = _layout(6, dead_row=True)
    S = NB * BLK
    rng = np.random.default_rng(7)
    x = rng.standard_normal((Z, int(layout.sum()), BLK, BLK)).astype(
        np.float32)
    kw, tkw = {"scale": 0.7}, {"scale": 0.7}
    if opts.get("rpe"):
        rpe = rng.standard_normal((1, H, S, S)).astype(np.float32)
        kw["rpe"], tkw["rpe"] = jnp.asarray(rpe), torch.from_numpy(rpe)
    if "kpm" in opts:
        mode = opts["kpm"]
        kpm = (rng.random((Z, S)) < 0.8).astype(np.float32) if \
            mode == "mul" else -3.0 * rng.random((Z, S)).astype(np.float32)
        kw.update(key_padding_mask=jnp.asarray(kpm),
                  key_padding_mask_mode=mode)
        tkw.update(key_padding_mask=torch.from_numpy(kpm),
                   key_padding_mask_mode=mode)
    if "am" in opts:
        mode = opts["am"]
        if mode == "mul":
            am = (rng.random((S, S)) < 0.7).astype(np.float32)
            am[5] = 0.0     # a dead row
            am[40] = 0.0
        else:
            am = -2.0 * rng.random((S, S)).astype(np.float32)
        kw.update(attn_mask=jnp.asarray(am), attn_mask_mode=mode)
        tkw.update(attn_mask=torch.from_numpy(am), attn_mask_mode=mode)
    jop, op = jsm.Softmax(layout, BLK), sm.Softmax(layout, BLK)
    want, vjp = jax.vjp(lambda t: jop(t, **kw), jnp.asarray(x))
    ct = rng.standard_normal(x.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = op(tx, **tkw)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g), **TOL)
    if case == "am_mul_dead_rows":
        dense = mm.sparse_to_dense(got.detach(), layout, BLK)
        assert torch.all(dense[:, :, 5] == 0)


# ---------------------------------------------------------------------------
# the plain versions of the kernels against the Pallas kernels
# ---------------------------------------------------------------------------

def _qkv(S, seed, heads=2, D=64):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((1, S, heads, D))).astype(np.float32)
            for _ in range(4)]


def _sparse_layout(S, causal, seed, dead_row):
    rng = np.random.default_rng(seed)
    n = S // 128
    layout = (rng.random((2, n, n)) < 0.15).astype(np.int64)
    layout[:, np.arange(n), np.arange(n)] = 1
    layout[:, :, 0] = 1
    if causal:
        layout = np.tril(layout)
    if dead_row:
        layout[1, 3] = 0
    return layout


def _vjp_both(jfn, tfn, q, k, v, do):
    out_j, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfn(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    return (out, [t.grad for t in (tq, tk, tv)],
            np.asarray(out_j), [np.asarray(g) for g in grads_j])


@pytest.mark.parametrize("causal,S,dead_row", [
    (True, 1024, False), (False, 1024, True), (True, 2048, True)],
    ids=["causal_S1024", "bidir_S1024_dead_row", "causal_S2048_dead_row"])
def test_plain_block_sparse_matches_pallas(causal, S, dead_row):
    """The plain block-sparse version, through the port's autograd
    Function, against the Pallas forward and backward kernels (interpret
    mode); a dead row gives zeros, lse = +1e30 and zero gradients."""
    layout = _sparse_layout(S, causal, S, dead_row)
    q, k, v, do = _qkv(S, S + dead_row)
    jatt = jbsa.BlockSparseAttention(layout, block=128, causal=causal)
    att = bsa.BlockSparseAttention(layout, block=128, causal=causal)
    out, grads, out_j, grads_j = _vjp_both(jatt, att, q, k, v, do)
    np.testing.assert_allclose(_np(out), out_j, **TOL)
    for name, g, gj in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(g.numpy(), gj, **TOL_GRAD,
                                   err_msg=f"d{name}")
    if dead_row:
        rows = slice(3 * 128, 4 * 128)
        _, lse = bsa.block_sparse_attention_reference(
            *map(torch.from_numpy, (q, k, v)), att.luts, causal)
        assert torch.all(out[0, rows, 1] == 0)
        assert torch.all(lse[1, rows] == 1e30)
        assert torch.all(grads[0][0, rows, 1] == 0)


@pytest.mark.parametrize("causal,S", [(True, 1024), (False, 512)],
                         ids=["causal_S1024", "bidir_S512_dead_row"])
def test_plain_masked_flash_matches_pallas(causal, S):
    """The plain masked flash version against
    `make_masked_flash_attention` (Pallas, interpret mode), forward and
    vjp; the bidirectional case has a dead row."""
    if causal:
        layout = sc.FixedSparsityConfig(
            num_heads=2, block=128, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional").make_layout(S)
    else:
        layout = _sparse_layout(S, False, 9, dead_row=True)
    q, k, v, do = _qkv(S, 11)
    jfn = jfa.make_masked_flash_attention(layout, causal=causal)
    fn = fa.make_masked_flash_attention(layout, causal=causal)
    out, grads, out_j, grads_j = _vjp_both(jfn, fn, q, k, v, do)
    np.testing.assert_allclose(_np(out), out_j, **TOL)
    for name, g, gj in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(g.numpy(), gj, **TOL_GRAD,
                                   err_msg=f"d{name}")


def test_plain_versions_agree_with_dense_masked_attention():
    """Both plain versions are `dense_masked_attention` on the token mask
    (the block-sparse one computed per active block)."""
    S = 512
    layout = _sparse_layout(S, True, 3, dead_row=True)
    q, k, v, _ = map(torch.from_numpy, _qkv(S, 3))
    want = ssa.dense_masked_attention(
        q, k, v, ssa.layout_to_token_mask(layout, 128), True)
    got_bs, _ = bsa.block_sparse_attention_reference(
        q, k, v, bsa.LayoutLuts(layout), True)
    got_mf, _ = fa.flash_attention_segmented_reference(
        q, k, v, layout=torch.as_tensor(layout), causal=True)
    np.testing.assert_allclose(got_bs.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got_mf.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jssa.dense_masked_attention(
            *map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
            jssa.layout_to_token_mask(layout, 128), True)), **TOL)


def test_plain_block_sparse_chunks(monkeypatch):
    """A scores budget of one query block a chunk gives the same results
    as one chunk for all (the memory bound phase 14 relies on)."""
    S = 512
    layout = _sparse_layout(S, True, 5, dead_row=False)
    q, k, v, do = map(torch.from_numpy, _qkv(S, 5))
    luts = bsa.LayoutLuts(layout)
    out, lse = bsa.block_sparse_attention_reference(q, k, v, luts, True)
    g = bsa.block_sparse_attention_bwd_reference(q, k, v, out, lse, do,
                                                 luts, True)
    monkeypatch.setattr(bsa, "PLAIN_CHUNK_BYTES", 1)
    out1, lse1 = bsa.block_sparse_attention_reference(q, k, v, luts, True)
    g1 = bsa.block_sparse_attention_bwd_reference(q, k, v, out, lse, do,
                                                  luts, True)
    torch.testing.assert_close(out1, out, **TOL)
    torch.testing.assert_close(lse1, lse, **TOL)
    for a, b in zip(g1, g):
        torch.testing.assert_close(a, b, **TOL)


def test_build_lut():
    layout = np.array([[[1, 0, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0],
                        [1, 0, 1, 1]]])
    lut, counts, order = bsa.build_lut(layout)
    assert counts.tolist() == [[1, 2, 0, 3]]
    assert lut[0, 3].tolist() == [0, 2, 3] and lut[0, 1, :2].tolist() == \
        [0, 1]
    assert order.tolist() == [3, 1, 0, 2]
    lut_t, counts_t, _ = bsa.build_lut(layout.transpose(0, 2, 1))
    assert counts_t.tolist() == [[3, 1, 1, 1]]
    assert lut_t[0, 0].tolist() == [0, 1, 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_lut_lists_columns_in_ascending_order(seed):
    """The FMA forward and dq kernels (fp32, D = 256) stop a row's walk
    at its first key tile wholly after the q tile under causal, which is
    right only because each LUT row lists its columns in ascending
    order (the tensor-core kernels skip tile by tile and need no order):
    random layouts of three heads, both LUTs, each row strictly
    ascending and exactly the layout row's active columns."""
    rng = np.random.default_rng(seed)
    n = 9
    layout = (rng.random((3, n, n)) < 0.4).astype(np.int32)
    layout[:, 4] = 0                               # an empty row
    for lay in (layout, layout.transpose(0, 2, 1)):
        lut, counts, _ = bsa.build_lut(lay)
        for h, i in np.ndindex(counts.shape):
            cols = lut[h, i, :counts[h, i]]
            assert np.all(np.diff(cols) > 0)
            assert cols.tolist() == np.nonzero(lay[h, i])[0].tolist()


# ---------------------------------------------------------------------------
# SparseSelfAttention: the JAX module's arm and output
# ---------------------------------------------------------------------------

ROUTES = {
    # density 0.375 >= 0.25, map 8 x 8 x 4 bytes: the masked flash arm
    "masked_flash": ("FixedSparsityConfig", dict(
        block=128, num_local_blocks=4, num_global_blocks=1,
        attention="unidirectional"), 1024),
    # density 0.121: the block-sparse arm
    "block_sparse": ("VariableSparsityConfig", dict(
        block=128, local_window_blocks=[1], global_block_indices=[0],
        attention="unidirectional"), 2048),
    # blocks no multiple of 128: the three-op arm
    "three_op_16": ("FixedSparsityConfig", dict(
        block=16, num_local_blocks=4, attention="unidirectional"), 256),
    "three_op_64": ("BSLongformerSparsityConfig", dict(
        block=64, num_sliding_window_blocks=3), 256),
}


def _jax_arm(kernel):
    if kernel is None:
        return "three_op"
    return "block_sparse" if isinstance(kernel, jbsa.BlockSparseAttention) \
        else "masked_flash"


@pytest.mark.parametrize("arm", list(ROUTES))
def test_sparse_self_attention_routes_like_jax(arm):
    name, kwargs, S = ROUTES[arm]
    jmod = jssa.SparseSelfAttention(getattr(jsc, name)(num_heads=2,
                                                       **kwargs))
    mod = ssa.SparseSelfAttention(getattr(sc, name)(num_heads=2, **kwargs))
    q, k, v, _ = _qkv(S, 13)
    want = jmod(*map(jnp.asarray, (q, k, v)))
    expected = "three_op" if arm.startswith("three_op") else arm
    assert _jax_arm(jmod.get_layout(S)[1]) == expected
    assert mod.arm(S, 64) == expected
    got = mod(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_self_attention_masks_take_the_three_op_path():
    """An attention mask sends a kernel-shaped call down the three-op
    path on both sides; the bool keep-mask in add mode raises."""
    name, kwargs, S = ROUTES["masked_flash"]
    jmod = jssa.SparseSelfAttention(getattr(jsc, name)(num_heads=2,
                                                       **kwargs))
    mod = ssa.SparseSelfAttention(getattr(sc, name)(num_heads=2, **kwargs))
    q, k, v, _ = _qkv(S, 14)
    am = (np.random.default_rng(1).random((S, S)) < 0.9).astype(np.float32)
    want = jmod(*map(jnp.asarray, (q, k, v)), attn_mask=jnp.asarray(am))
    assert mod.arm(S, 64, masked=True) == "three_op"
    got = mod(*map(torch.from_numpy, (q, k, v)),
              attn_mask=torch.from_numpy(am))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="keep-mask"):
        mod(*map(torch.from_numpy, (q, k, v)),
            key_padding_mask=torch.ones(1, S, dtype=torch.bool))


# ---------------------------------------------------------------------------
# argument errors and refusals
# ---------------------------------------------------------------------------

def test_kernel_callables_raise_like_jax():
    layout = np.ones((2, 4, 4), np.int64)
    q = np.zeros((1, 512, 3, 64), np.float32)
    for jfn, fn in ((jbsa.BlockSparseAttention(layout),
                     bsa.BlockSparseAttention(layout)),
                    (jfa.make_masked_flash_attention(layout),
                     fa.make_masked_flash_attention(layout))):
        with pytest.raises(ValueError) as want:
            jfn(*[jnp.asarray(q)] * 3)
        t = torch.from_numpy(q)
        with pytest.raises(ValueError, match=str(want.value)):
            fn(t, t, t)
        q2 = np.zeros((1, 384, 2, 64), np.float32)
        with pytest.raises(ValueError) as want:
            jfn(*[jnp.asarray(q2)] * 3)
        t = torch.from_numpy(q2)
        with pytest.raises(ValueError, match=str(want.value)):
            fn(t, t, t)


@pytest.mark.parametrize("what", ["fp16", "head_dim", "seq", "layout",
                                  "layout_heads"])
def test_cuda_entries_refuse_before_launch(what, monkeypatch):
    """What the kernels cannot take raises in the wrapper, before the
    library is loaded or a launch is counted: a dtype (float64; fp16,
    which the kernels are built for, reaches the library), head dim or
    length the kernels are not built for, a flash layout map of the
    wrong shape, a block-sparse layout of other heads than q's (which
    the plain version refuses too)."""
    S, D, dtype = 256, 64, torch.float32
    if what == "fp16":
        class Reached(Exception):
            pass

        def reached():
            raise Reached
        monkeypatch.setattr(bsa._build, "load_library", reached)
        monkeypatch.setattr(bsa._build, "stream_ptr", lambda t: None)
        q16 = torch.zeros(1, S, 2, D, dtype=torch.float16)
        luts16 = bsa.LayoutLuts(np.ones((2, 2, 2)))
        with pytest.raises(Reached):
            bsa.block_sparse_attention_cuda(q16, q16, q16, luts16, True)
        with pytest.raises(Reached):
            bsa.block_sparse_attention_bwd_cuda(
                q16, q16, q16, torch.zeros(2, S), q16, torch.zeros(2, S),
                luts16, True)
        dtype = torch.float64
    if what == "head_dim":
        D = 32
    if what == "seq":
        S = 200
    q = torch.zeros(1, S, 2, D, dtype=dtype)
    row = torch.zeros(2, S)
    before = (bsa.launches, bsa.dkv_launches, bsa.dq_launches,
              fa.masked_launches, fa.masked_bwd_dkv_launches)
    if what == "layout":
        lay = torch.ones(2, 3, 2, dtype=torch.int32)
        with pytest.raises(ValueError, match="layout"):
            fa.flash_attention_cuda(q, q, q, layout=lay, causal=True)
        with pytest.raises(ValueError, match="layout"):
            fa.flash_attention_bwd_cuda(q, q, q, row, q, row, layout=lay)
    else:
        luts = bsa.LayoutLuts(np.ones((3 if what == "layout_heads" else 2,
                                       2, 2)))
        with pytest.raises((TypeError, ValueError)):
            bsa.block_sparse_attention_cuda(q, q, q, luts, True)
        with pytest.raises((TypeError, ValueError)):
            bsa.block_sparse_attention_bwd_cuda(q, q, q, row, q, row, luts,
                                                True)
        if what == "layout_heads":
            with pytest.raises(ValueError, match="layout"):
                bsa.block_sparse_attention_reference(q, q, q, luts, True)
    assert (bsa.launches, bsa.dkv_launches, bsa.dq_launches,
            fa.masked_launches, fa.masked_bwd_dkv_launches) == before


def test_block_sparse_block_refines_to_128():
    """A 256 block is refined to the kernels' 128 grain: the same
    pattern, so the same result as the token mask."""
    layout = np.array([[[1, 0], [1, 1]], [[1, 1], [0, 1]]])
    att = bsa.BlockSparseAttention(layout, block=256, causal=True)
    assert att.luts.layout.shape == (2, 4, 4)
    q, k, v, _ = map(torch.from_numpy, _qkv(512, 2))
    want = ssa.dense_masked_attention(
        q, k, v, ssa.layout_to_token_mask(layout, 256), True)
    np.testing.assert_allclose(att(q, k, v).numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="multiple of 128"):
        bsa.BlockSparseAttention(layout, block=64)


# ---------------------------------------------------------------------------
# the plain backward against `sparse_attention_bwd`; launches by design
# ---------------------------------------------------------------------------

def test_plain_backward_matches_sparse_attention_bwd():
    """The plain backward against the JAX backward kernels called as
    `sparse_attention_bwd` (interpret mode) on the same residuals (q, k,
    v, out, lse from `sparse_attention_fwd`) and dO: a causal fixed
    layout with a global column and, on head 1, a key block that no
    query attends, whose dK and dV are exact zeros."""
    S = 1024
    layout = sc.FixedSparsityConfig(
        num_heads=2, block=128, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional").make_layout(S)
    layout[1, :, 2] = 0
    q, k, v, do = _qkv(S, 21)
    jatt = jbsa.BlockSparseAttention(layout, block=128, causal=True)
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, res = jbsa.sparse_attention_fwd(
        *map(jnp.asarray, (q, k, v)), jatt.lut, jatt.bits, jatt.sentinel,
        True, scale, 128, jatt.group, jatt.fanout)
    want = jbsa.sparse_attention_bwd(
        res, jnp.asarray(do), jatt.lut, jatt.bits, jatt.lut_t, jatt.bits_t,
        jatt.sentinel, True, scale, 128, jatt.group, jatt.fanout)
    luts = bsa.LayoutLuts(layout)
    got = bsa.block_sparse_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, np.array(out), np.array(res[4]),
                                do)), luts, True)
    # the first window's global column (key block 1) lists every query
    # block from its own on in its transposed LUT row
    assert luts.bwd[1][0, 1] == S // 128 - 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD,
                                   err_msg=name)
    for g in got[1:]:
        assert torch.all(g[0, 256:384, 1] == 0)


@pytest.mark.parametrize("part", ["fwd", "dkv", "dq"])
def test_launches_are_counted_by_design(part, monkeypatch):
    """Each block-sparse kernel (forward, dk/dv, dq) in bf16 at D = 64 and
    128 counts as the tensor-core ("mma") design and needs 16-byte rows;
    fp32 and D = 256 count as "fma" and take any row stride; the reset
    clears every kernel's counts."""
    entry = {"fwd": "ds_block_sparse_fwd", "dkv": "ds_block_sparse_bwd_dkv",
             "dq": "ds_block_sparse_bwd_dq"}[part]
    calls = []
    lib = type("Lib", (), {entry: staticmethod(
        lambda *a: calls.append(a) or 0)})()
    monkeypatch.setattr(bsa._build, "load_library", lambda: lib)
    monkeypatch.setattr(bsa._build, "stream_ptr", lambda t: None)
    for name in ("launches", "dkv_launches", "dq_launches"):
        monkeypatch.setattr(bsa, name, getattr(bsa, name))
    monkeypatch.setattr(bsa, "design_launches",
                        {p: dict(c) for p, c in bsa.design_launches.items()})
    S, H = 256, 2
    luts = bsa.LayoutLuts(np.tril(np.ones((H, 2, 2))))
    row = torch.zeros(H, S)

    def call(q, do=None):
        if part == "fwd":
            return bsa.block_sparse_attention_cuda(q, q, q, luts, True)
        do = q.contiguous() if do is None else do
        if part == "dkv":
            return bsa.block_sparse_attention_dkv_cuda(q, q, q, row, do, row,
                                                       luts, True)
        return (bsa.block_sparse_attention_dq_cuda(q, q, q, row, do, row,
                                                   luts, True),)

    bsa.reset_design_launches()
    for dtype, D in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                     (torch.float32, 64), (torch.bfloat16, 256)):
        q = torch.zeros(1, S, H, D, dtype=dtype)
        outs = call(q)
        assert all(o.shape == q.shape for o in outs[:1 if part == "fwd"
                                                    else None])
    want = {p: {"mma": 2 if p == part else 0, "fma": 2 if p == part else 0}
            for p in bsa.PARTS}
    assert bsa.design_launches == want
    # B, S, H, D follow the pointers, the LUT's four arguments and outputs
    first = {"fwd": 9, "dkv": 12, "dq": 11}[part]
    assert len(calls) == 4 and calls[0][first:first + 4] == (1, S, H, 64)
    # a row stride off 16 bytes is refused before the library (mma only)
    q = torch.zeros(1, S, H, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        call(q)
    assert len(calls) == 4
    q = torch.zeros(1, S, H, 66, dtype=torch.float32)[..., :64]
    call(q)
    assert len(calls) == 5 and bsa.design_launches[part]["fma"] == 3
    bsa.reset_design_launches()
    assert bsa.design_launches == {p: {"mma": 0, "fma": 0}
                                   for p in bsa.PARTS}
