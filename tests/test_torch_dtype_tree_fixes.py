"""Two faults of the port held to the JAX package on the CPU:

- a bf16 input on fp32 parameters in `TiledLinear` and
  `memory_efficient_linear`: the JAX layers promote and compute in fp32
  (`TiledLinear.apply` casts its fp32 sum back to the input's dtype
  before the fp32 bias add, so the result is fp32 with a bias, bf16
  without); the port computes in `torch.result_type` the same way. The
  output and its dtype match JAX's (atol = rtol = 1e-2 for a bf16
  result, whose last bit may round apart; 1e-5 for fp32, where only the
  summation order differs), and the gradients come back in each input's
  dtype;
- ``None`` leaves in the fp16 optimizer wrappers: `jax.tree_util` drops
  ``None``, so ``{"a": fp16[4], "b": None}`` gives a master of 4
  elements; the port's `tree_leaves` now skips ``None`` and
  `tree_unflatten` keeps it, and a step through `FP16_Optimizer` and
  `FP16_UnfusedOptimizer` matches JAX's (the master bit for bit, the
  parameters within 2 fp16 ulps, as `test_torch_fp16_optimizer.py`
  holds them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deeperspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb
from deeperspeed_tpu.runtime.fp16 import FP16_Optimizer as JFP16
from deeperspeed_tpu.runtime.fp16 import FP16_UnfusedOptimizer as JFP16U
from deeperspeed_tpu.runtime.zero import TiledLinear as JaxTiledLinear
from deeperspeed_tpu.runtime.zero import \
    memory_efficient_linear as jax_memory_efficient_linear
from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deeperspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deeperspeed_tpu_torch.runtime.fp16 import (FP16_Optimizer,
                                                FP16_UnfusedOptimizer)
from deeperspeed_tpu_torch.runtime.fp16.fused_optimizer import (
    tree_leaves, tree_unflatten)
from deeperspeed_tpu_torch.runtime.zero import (TiledLinear,
                                                memory_efficient_linear)

torch.set_num_threads(2)

TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
       torch.float32: dict(atol=1e-5, rtol=1e-5)}


def _bf16_input(rng, shape):
    """A bf16 input on both sides from one fp32 draw."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), \
        jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("bias", [True, False])
def test_tiled_linear_promotes_bf16_input(bias):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((33, 47)).astype(np.float32)
    b = rng.standard_normal(47).astype(np.float32) if bias else None
    jlayer = JaxTiledLinear(33, 47, in_splits=4, out_splits=3,
                            bias=bias)
    jparams = jlayer.from_dense(jnp.asarray(w),
                                None if b is None else jnp.asarray(b))
    layer = TiledLinear(33, 47, in_splits=4, out_splits=3,
                        bias=bias).from_dense(
        torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    x, jx = _bf16_input(rng, (5, 33))
    want = jlayer.apply(jparams, jx)
    got = layer(x)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               **TOL[got.dtype])
    x.requires_grad_(True)
    layer(x).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert layer.weight.grad.dtype == torch.float32


@pytest.mark.parametrize("bias", [True, False])
def test_memory_efficient_linear_promotes_bf16_input(bias):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x, jx = _bf16_input(rng, (3, 5, 16))
    jparams = {"weight": jnp.asarray(w)}
    params = {"weight": torch.from_numpy(w).requires_grad_(True)}
    if bias:
        jparams["bias"] = jnp.asarray(b)
        params["bias"] = torch.from_numpy(b).requires_grad_(True)
    want = jax_memory_efficient_linear(jparams, jx)
    x.requires_grad_(True)
    got = memory_efficient_linear(params, x)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL[torch.float32])
    # the gradients against jax.grad of the same function, each in its
    # input's dtype
    jg = jax.grad(lambda p, x: jax_memory_efficient_linear(p, x).sum(),
                  argnums=(0, 1))(jparams, jx)
    got.sum().backward()
    assert x.grad.dtype == torch.bfloat16 and jg[1].dtype == jnp.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(jg[1], np.float32),
                               **TOL[torch.bfloat16])
    assert params["weight"].grad.dtype == torch.float32
    np.testing.assert_allclose(params["weight"].grad.numpy(),
                               np.asarray(jg[0]["weight"]), rtol=1e-5,
                               atol=1e-4)


def test_tree_helpers_skip_none_like_jax():
    tree = {"b": None, "a": torch.ones(4), "c": [torch.zeros(2), None]}
    jtree = {"b": None, "a": jnp.ones(4), "c": [jnp.zeros(2), None]}
    leaves = tree_leaves(tree)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]
    back = tree_unflatten(tree, leaves)
    assert back["b"] is None and back["c"][1] is None
    assert back["a"] is leaves[0] and back["c"][0] is leaves[1]


PAIRS = [(FP16_Optimizer, FusedAdam, JFP16, JFusedAdam),
         (FP16_UnfusedOptimizer, FusedLamb, JFP16U, JFusedLamb)]


@pytest.mark.parametrize("wrapper,base,jwrapper,jbase", PAIRS,
                         ids=["fused_adam", "unfused_lamb"])
def test_fp16_optimizer_none_leaf_matches_jax(wrapper, base, jwrapper,
                                              jbase):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4).astype(np.float16)
    g = rng.standard_normal(4).astype(np.float16)
    opt = wrapper(base(lr=1e-2), static_loss_scale=1.0)
    jopt = jwrapper(jbase(lr=1e-2), static_loss_scale=1.0)
    state = opt.init_state({"a": torch.tensor(a), "b": None})
    jstate = jopt.init_state({"a": jnp.asarray(a), "b": None})
    assert state.flat_master.numel() == 4
    state, info = opt.step(state, {"a": torch.tensor(g), "b": None})
    jstate, jinfo = jopt.step(jstate, {"a": jnp.asarray(g), "b": None})
    assert not info.overflow and not bool(jinfo.overflow)
    assert state.params["b"] is None and jstate.params["b"] is None
    jmaster = np.asarray(jax.tree_util.tree_leaves(
        jstate.master if hasattr(jstate, "master")
        else jstate.flat_master)[0]).reshape(-1)
    np.testing.assert_array_equal(state.flat_master.numpy(), jmaster)
    ulp = np.spacing(np.abs(np.asarray(jstate.params["a"])).astype(
        np.float16)).astype(np.float32)
    diff = np.abs(state.params["a"].float().numpy() -
                  np.asarray(jstate.params["a"], np.float32))
    assert (diff <= 2 * ulp).all()
