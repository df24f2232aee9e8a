"""fp16 block-sparse attention: the port's plain versions against the JAX
package's, on the CPU.

- the plain fp16 forward and backward (dq, dk, dv through the autograd
  Function) against the Pallas forward and backward kernels run in fp16
  (interpret mode), causal and bidirectional with a dead row: out within
  atol = rtol = 1e-2 (chip_smoke's TOL_FP16 "out": the Pallas kernel
  rounds P to fp16 before P·V, the plain version keeps it in fp32; both
  round once to fp16 at the end), dq, dk, dv within 3e-2 (TOL_FP16
  "bwd": dS rounded to fp16 on both sides, P·dO summed from fp32 P on
  the plain side);
- an overflowing loss-scaled backward (dO at fp16's full scale on one
  head): the plain backward's non-finite dq, dk, dv sit where the JAX
  backward kernels' do, leaving out what `fp16_overflow_undecided`
  marks; and the rule itself (nothing undecided off the overflowing
  head, the marked set a superset of where a last bit could decide);
- fp16 launches counted as the tensor-core ("mma") design, through a
  stand-in library;
- an fp16 sparse GPT-NeoX (4 layers, hidden 64, one head of 64, the
  block-sparse arm at S 1024) through `initialize()` → `train_batch`
  against the JAX engine from the same JAX-made weights
  (`models/convert`): the loss scale, the skipped steps and the losses
  (rtol 2e-2, as `test_torch_fp16_engine.py`) after every step, from a
  scale that overflows first.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.ops.pallas import block_sparse_attention as jbsa

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

torch.set_num_threads(2)

TOL_OUT = dict(atol=1e-2, rtol=1e-2)
TOL_BWD = dict(atol=3e-2, rtol=3e-2)


def _layout(S, causal, dead_row):
    layout = sc.FixedSparsityConfig(
        num_heads=2, block=128, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional",
    ).make_layout(S)
    if dead_row:
        layout[1, 3] = 0
    return layout


def _qkv(S, seed, H=2, D=64, do_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((1, S, H, D)).astype(np.float32)
                   for _ in range(4))
    do[:, :, 0] *= do_scale
    return [np.clip(x, -60000, 60000).astype(np.float16)
            for x in (q, k, v, do)]


def _both(layout, causal, q, k, v, do):
    """(out, (dq, dk, dv)) of the Pallas kernels and of the port's plain
    versions, as fp32 numpy."""
    jatt = jbsa.BlockSparseAttention(layout, block=128, causal=causal)
    out_j, vjp = jax.vjp(jatt, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    att = bsa.BlockSparseAttention(layout, block=128, causal=causal)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = att(*leaves)
    out.backward(torch.from_numpy(do))
    assert out.dtype == torch.float16
    assert all(t.grad.dtype == torch.float16 for t in leaves)
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return ((f(out_j), [f(g) for g in grads_j]),
            (f(out.detach()), [f(t.grad) for t in leaves]))


@pytest.mark.parametrize("causal,dead_row", [(True, False), (False, True)],
                         ids=["causal", "bidir_dead_row"])
def test_plain_fp16_block_sparse_matches_pallas(causal, dead_row):
    S = 1024
    layout = _layout(S, causal, dead_row)
    (out_j, grads_j), (out, grads) = _both(layout, causal, *_qkv(S, 1))
    np.testing.assert_allclose(out, out_j, **TOL_OUT)
    for name, g, gj in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(g, gj, **TOL_BWD, err_msg=name)
    if dead_row:
        rows = slice(3 * 128, 4 * 128)
        assert (out[0, rows, 1] == 0).all() and (out_j[0, rows, 1] == 0).all()
        assert (grads[0][0, rows, 1] == 0).all()


def test_fp16_overflow_sits_where_pallas_puts_it():
    """dO at 2e4 x N(0, 1) on head 0 and v at 8x: dS passes 65504 on head
    0, so dq and dk overflow there (inf) on both sides, at the same
    elements outside the undecided set; head 1 stays finite."""
    S = 512
    layout = _layout(S, True, False)
    q, k, v, do = _qkv(S, 2, do_scale=2e4)
    v = (v.astype(np.float32) * 8).astype(np.float16)
    (out_j, grads_j), (out, grads) = _both(layout, True, q, k, v, do)
    assert np.isfinite(out).all() and np.isfinite(out_j).all()
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    luts = bsa.LayoutLuts(layout)
    o, lse = bsa.block_sparse_attention_reference(*t[:3], luts, True)
    undecided = fa.fp16_overflow_undecided(
        t[0], t[1], t[2], o, lse, t[3], layout=torch.as_tensor(layout))
    for name, g, gj, u in zip(("dq", "dk", "dv"), grads, grads_j,
                              undecided):
        bad, bad_j = ~np.isfinite(g), ~np.isfinite(gj)
        assert not (bad != bad_j)[~u.numpy()].any(), name
        assert not bad[:, :, 1].any() and not u[:, :, 1].any(), name
    assert (~np.isfinite(grads[0])).sum() > 0
    assert (~np.isfinite(grads[1])).sum() > 0


def test_undecided_rule_marks_only_the_threshold():
    """With no value near 65520 nothing is undecided; with dO scaled so
    that dS reaches it, the marked elements lie on the scaled head."""
    S = 256
    layout = _layout(S, True, False)
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(S, 3))
    luts = bsa.LayoutLuts(layout)
    o, lse = bsa.block_sparse_attention_reference(q, k, v, luts, True)
    lay = torch.as_tensor(layout)
    assert not any(u.any() for u in fa.fp16_overflow_undecided(
        q, k, v, o, lse, do, layout=lay))
    do_big = do.clone()
    do_big[:, :, 0] = (do[:, :, 0].float() * 3e4).clamp(
        -60000, 60000).half()
    u = fa.fp16_overflow_undecided(q, k, v, o, lse, do_big, layout=lay)
    assert not any(x[:, :, 1].any() for x in u)


def test_fp16_launches_count_as_mma(monkeypatch):
    calls = []
    lib = type("Lib", (), {name: staticmethod(
        lambda *a: calls.append(a) or 0) for name in (
        "ds_block_sparse_fwd", "ds_block_sparse_bwd_dkv",
        "ds_block_sparse_bwd_dq")})()
    monkeypatch.setattr(bsa._build, "load_library", lambda: lib)
    monkeypatch.setattr(bsa._build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(bsa, "design_launches",
                        {p: dict(c) for p, c in bsa.design_launches.items()})
    bsa.reset_design_launches()
    S, H = 256, 2
    luts = bsa.LayoutLuts(np.tril(np.ones((H, 2, 2))))
    row = torch.zeros(H, S)
    for D in (64, 128, 256):
        q = torch.zeros(1, S, H, D, dtype=torch.float16)
        out, _ = bsa.block_sparse_attention_cuda(q, q, q, luts, True)
        assert out.dtype == torch.float16
        bsa.block_sparse_attention_bwd_cuda(q, q, q, row, q, row, luts, True)
    assert bsa.design_launches == {p: {"mma": 2, "fma": 1}
                                   for p in bsa.PARTS}
    # the dtype code is fp16's (2), after sm_scale and causal
    assert {c[-2] for c in calls} == {2}


# ---------------------------------------------------------------------------
# the fp16 sparse GPT-NeoX against the JAX engine
# ---------------------------------------------------------------------------

SIZE = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=1,
            max_seq_len=1024)
BLOCK = {"mode": "variable", "block": 128, "local_window_blocks": [1],
         "global_block_indices": [0]}
FP16 = {"enabled": True, "type": "float16", "initial_scale_power": 20,
        "hysteresis": 1, "loss_scale_window": 2, "min_loss_scale": 1}


def test_fp16_sparse_train_batch_matches_jax():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    jparams = jax.device_get(jneox.init_params(jcfg, jax.random.PRNGKey(0)))
    conf = {"train_batch_size": 1, "train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
                "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "fp16": FP16,
            "zero_optimization": {"stage": 2}, "sparse_attention": BLOCK}
    toks = np.random.default_rng(4).integers(
        0, SIZE["vocab_size"], size=(1, 1, 1024)).astype(np.int32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jeng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jcfg, use_pallas=False), model_parameters=jparams,
        config_params=conf, mesh=mesh)
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
    eng, *_ = dst.initialize(model=model.load_jax_params(jparams),
                             config_params=conf)
    assert eng.compute_dtype == torch.float16
    assert model.sparse_self_attention.arm(1024, 64) == "block_sparse"
    rows = []
    for _ in range(3):
        rows.append((float(jeng.train_batch(batch=(toks, toks))),
                     eng.train_batch(batch=(toks, toks))))
        assert eng.loss_scale == float(jeng.state.scale.cur_scale)
        assert eng.skipped_steps == int(jeng.skipped_steps)
    rows = np.array(rows)
    assert eng.skipped_steps >= 1 and eng.global_steps >= 1
    taken = np.isfinite(rows[:, 0])
    np.testing.assert_allclose(rows[taken, 1], rows[taken, 0], rtol=2e-2)
