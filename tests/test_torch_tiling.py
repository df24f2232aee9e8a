"""`TiledLinear`, `memory_efficient_linear` and client optimizers: the
port against the JAX package, on the CPU.

- `TiledLinear` against `tests/test_zero_tiled.py`'s cases (one tile,
  4 x 3 tiles, ragged 33 x 47 in 4 x 3, 1 x 1 tiles): the output against
  the dense product and the JAX layer's `apply` on the same tiles
  (atol = rtol = 1e-5, fp32: the sums run in another order), `from_dense`
  giving the JAX layer's tiles bit for bit, `to_dense` round trips, the
  padding exactly zero and its gradient exactly zero, the gradients
  against `jax.grad` of the JAX layer (1e-5); the JAX params carried in
  by `models.convert.tiled_linear_from_jax`;
- `memory_efficient_linear` against the plain linear (value and
  gradients) and its autograd node saving x and the weight as it rests
  (no weight-sized copy);
- a client SGD with momentum, written for both engines (the JAX
  engine's protocol: ``param_groups``, ``init_state``, ``update``
  returning ``(new_master, new_state)``), stepping a `TiledLinear` head
  through `initialize()` → `train_batch` with gradient clipping and
  WarmupLR: losses (rtol 1e-5), the masters and the momentum (atol =
  rtol = 1e-5) against the JAX engine after every step; a client that
  writes the masters in place and takes ``compute_out``; an fp16 overflow
  skipping the client's update; a checkpoint round trip (the state
  through the client's `state_dict` / `load_state_dict`, keyed as the JAX
  checkpoint keys its state) resuming bit for bit; the typed errors of
  a client without `update` or without `state_dict`.
"""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.runtime.zero import TiledLinear as JaxTiledLinear
from deeperspeed_tpu.runtime.zero import \
    memory_efficient_linear as jax_memory_efficient_linear

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models.convert import (flat_from_jax,
                                                  tiled_linear_from_jax)
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.zero import (TiledLinear,
                                                memory_efficient_linear)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("in_f,out_f,in_splits,out_splits", [
    (32, 48, 1, 1),
    (32, 48, 4, 3),
    (33, 47, 4, 3),    # ragged: padding must not leak
    (16, 16, 16, 16),  # 1x1 tiles
])
def test_tiled_linear_matches_dense_and_jax(in_f, out_f, in_splits,
                                            out_splits):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((in_f, out_f)).astype(np.float32)
    b = rng.standard_normal(out_f).astype(np.float32)
    x = rng.standard_normal((5, in_f)).astype(np.float32)
    jlayer = JaxTiledLinear(in_f, out_f, in_splits=in_splits,
                            out_splits=out_splits)
    jparams = jax.device_get(jlayer.from_dense(jnp.asarray(w),
                                               jnp.asarray(b)))
    layer = TiledLinear(in_f, out_f, in_splits=in_splits,
                        out_splits=out_splits).from_dense(
        torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(layer.weight.detach().numpy(),
                                  np.asarray(jparams["weight"]))
    carried = tiled_linear_from_jax(
        TiledLinear(in_f, out_f, in_splits=in_splits, out_splits=out_splits),
        jparams)
    assert torch.equal(carried.weight, layer.weight)
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, x @ w + b, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jlayer.apply(jparams, jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(layer.to_dense().detach().numpy(), w)
    assert not layer.weight[layer.padding_mask()].any()


def test_tiled_linear_padding_gets_no_gradient():
    """Ragged 10 x 7 in 3 x 2 tiles, initialized by the JAX law (padding
    zero): the gradient of a loss through a 3-D input is exactly zero on
    the padding and equals `jax.grad` of the JAX layer elsewhere."""
    layer = TiledLinear(10, 7, in_splits=3, out_splits=2).init_params(
        torch.Generator().manual_seed(0))
    pad = layer.padding_mask()
    assert pad.sum() == layer.weight.numel() - 70
    assert not layer.weight[pad].any()
    x = np.random.default_rng(1).standard_normal((2, 4, 10)).astype(
        np.float32)
    (layer(torch.from_numpy(x)) ** 2).sum().backward()
    assert torch.all(layer.weight.grad[pad] == 0)
    jlayer = JaxTiledLinear(10, 7, in_splits=3, out_splits=2)
    jparams = {"weight": jnp.asarray(layer.weight.detach().numpy()),
               "bias": jnp.asarray(layer.bias.detach().numpy())}
    g = jax.grad(lambda p: jnp.sum(jlayer.apply(p, jnp.asarray(x)) ** 2))(
        jparams)
    np.testing.assert_allclose(layer.weight.grad.numpy(),
                               np.asarray(g["weight"]), **TOL)
    np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(g["bias"]),
                               **TOL)


def test_memory_efficient_linear_matches_plain_and_saves_no_copy():
    rng = np.random.default_rng(2)
    w, x = (rng.standard_normal(s).astype(np.float32)
            for s in ((12, 8), (3, 5, 12)))
    b = np.ones(8, np.float32)
    jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    jloss, jg = jax.value_and_grad(lambda p: jnp.sum(
        jax_memory_efficient_linear(p, jnp.asarray(x)) ** 2))(jp)
    params = {"weight": torch.from_numpy(w).requires_grad_(),
              "bias": torch.from_numpy(b).requires_grad_()}
    xt = torch.from_numpy(x).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = memory_efficient_linear(params, xt)
    loss = (y ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    for k in ("weight", "bias"):
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jg[k]), **TOL)
    plain = torch.from_numpy(x).requires_grad_()
    ((plain @ params["weight"].detach() + params["bias"].detach()) ** 2) \
        .sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), plain.grad.numpy(), **TOL)
    # the linear's node saved x and the weight parameter itself
    mine = saved[:2]
    assert mine[0] is xt and mine[1] is params["weight"]


# ---------------------------------------------------------------------------
# client optimizers: a TiledLinear head on both engines
# ---------------------------------------------------------------------------

IN, OUT, T = 24, 40, 6
GAS, MICRO = 2, 2


class SGDState(NamedTuple):
    step: object
    momentum: object


class JaxSGD:
    """SGD with momentum for the JAX engine: ``init_state`` / ``update``
    over the master pytree, ``update`` returning (new masters, state)."""

    def __init__(self, lr, momentum):
        self.param_groups = [{"lr": lr, "momentum": momentum}]

    def init_state(self, master):
        return SGDState(jnp.zeros((), jnp.int32),
                        jax.tree_util.tree_map(jnp.zeros_like, master))

    def update(self, grads, state, master, lr=None):
        mu = self.param_groups[0]["momentum"]
        buf = jax.tree_util.tree_map(lambda m, g: mu * m + g,
                                     state.momentum, grads)
        new = jax.tree_util.tree_map(lambda p, m: p - lr * m, master, buf)
        return new, SGDState(state.step + 1, buf)


class TorchSGD:
    """The same rule over the port engine's flat fp32 masters."""

    def __init__(self, lr, momentum, with_state_dict=True):
        self.param_groups = [{"lr": lr, "momentum": momentum}]
        if not with_state_dict:
            self.state_dict = None

    def init_state(self, master):
        return SGDState(0, torch.zeros_like(master, dtype=torch.float32))

    def update(self, grads, state, master, lr=None):
        buf = self.param_groups[0]["momentum"] * state.momentum + \
            grads.float()
        return master - lr * buf, SGDState(state.step + 1, buf)

    def state_dict(self, state):
        return {"step": int(state.step), "momentum": state.momentum.clone(),
                "param_groups": [dict(g) for g in self.param_groups]}

    def load_state_dict(self, sd):
        return SGDState(int(sd["step"]), sd["momentum"].float())


class TiledHead(torch.nn.Module):
    """A client module: a TiledLinear head over given features, mean
    cross-entropy against labels."""

    def __init__(self, in_splits=2, out_splits=3, dtype=torch.float32):
        super().__init__()
        self.head = TiledLinear(IN, OUT, in_splits=in_splits,
                                out_splits=out_splits, dtype=dtype)

    def params_tree(self):
        return dict(self.named_parameters())

    def loss_fn(self, params, batch, rng=None):
        x, y = batch
        logits = self.head(x.to(self.head.weight.dtype)).float()
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, OUT), y.reshape(-1).long())


def _jax_loss(jlayer):
    def loss_fn(params, batch, rng=None):
        x, y = batch
        logits = jlayer.apply(params["head"], x).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1))
    return loss_fn


def _conf(**extra):
    conf = {"train_batch_size": GAS * MICRO,
            "train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS, "steps_per_print": 1000,
            "gradient_clipping": 1.0,
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.05, "warmup_max_lr": 0.5,
                "warmup_num_steps": 3}}}
    conf.update(extra)
    return conf


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((GAS, MICRO, T, IN)).astype(np.float32),
            rng.integers(0, OUT, (GAS, MICRO, T)).astype(np.int32))


def _port_engine(jparams, conf, opt=None):
    model = TiledHead()
    tiled_linear_from_jax(model.head, jparams["head"])
    eng, *_ = dst.initialize(model=model, optimizer=opt or TorchSGD(0.5, 0.9),
                             config_params=conf)
    return eng


@pytest.fixture(scope="module")
def jparams():
    jlayer = JaxTiledLinear(IN, OUT, in_splits=2, out_splits=3)
    return {"head": jax.device_get(jlayer.init_params(
        jax.random.PRNGKey(0)))}


def test_client_sgd_steps_like_the_jax_engine(jparams):
    conf = _conf()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jlayer = JaxTiledLinear(IN, OUT, in_splits=2, out_splits=3)
    jeng, *_ = deeperspeed_tpu.initialize(
        model=_jax_loss(jlayer), model_parameters=jparams,
        optimizer=JaxSGD(0.5, 0.9), config_params=conf, mesh=mesh)
    eng = _port_engine(jparams, conf)
    for step in range(4):
        batch = _batch(step)
        jl = float(jeng.train_batch(batch=batch))
        pl = eng.train_batch(batch=tuple(map(torch.from_numpy, batch)))
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        assert eng.get_lr() == [float(g["lr"]) for g in
                                jeng.optimizer.param_groups]
        jmaster = jeng.state.master if jeng.state.master is not None \
            else jeng.state.params
        masters = flat_from_jax(jax.device_get(jmaster), eng.param_names)
        np.testing.assert_allclose(eng._master.numpy(), masters.numpy(),
                                   **TOL)
        mom = flat_from_jax(jax.device_get(jeng.state.opt_state.momentum),
                            eng.param_names)
        np.testing.assert_allclose(eng.opt_state.momentum.numpy(),
                                   mom.numpy(), **TOL)
        assert eng.opt_state.step == int(jeng.state.opt_state.step) == \
            step + 1
    pad = eng.module.head.padding_mask()
    assert not eng.module.head.weight[pad].any()


def test_client_update_skipped_on_fp16_overflow(jparams):
    """From a loss scale of 2^40 the first fp16 step overflows: the
    client's update is not called, masters and momentum stay bit-equal;
    the scale halves until steps are taken, which write the fp16 copy."""
    conf = _conf(fp16={"enabled": True, "initial_scale_power": 40,
                       "hysteresis": 1})
    calls = []
    opt = TorchSGD(0.5, 0.9)
    inner = opt.update
    opt.update = lambda *a, **k: calls.append(1) or inner(*a, **k)
    eng = _port_engine(jparams, conf, opt)
    assert eng.compute_dtype == torch.float16
    before = (eng._master.clone(), eng.opt_state.momentum.clone())
    eng.train_batch(batch=tuple(map(torch.from_numpy, _batch(0))))
    assert eng.skipped_steps == 1 and not calls
    assert torch.equal(eng._master, before[0])
    assert torch.equal(eng.opt_state.momentum, before[1])
    for step in range(1, 40):
        eng.train_batch(batch=tuple(map(torch.from_numpy, _batch(step))))
        if calls:
            break
    assert calls and eng.global_steps == 1
    assert torch.equal(eng._params_flat, eng._master.to(torch.float16))


def test_client_checkpoint_round_trip(jparams, tmp_path):
    """Save after 2 steps, load into an engine built from other weights,
    take 2 more: the same losses, masters and momentum bit for bit as 4
    uninterrupted steps; the checkpoint keys the momentum per parameter
    ("momentum/head/weight"), as the JAX checkpoint keys its state."""
    from deeperspeed_tpu_torch.checkpoint.serialization import load_obj
    conf = _conf()
    torch.set_num_threads(1)
    try:
        a = _port_engine(jparams, conf)
        full = [a.train_batch(batch=tuple(map(torch.from_numpy,
                                              _batch(s)))) for s in range(4)]
        b = _port_engine(jparams, conf)
        for s in range(2):
            b.train_batch(batch=tuple(map(torch.from_numpy, _batch(s))))
        b.save_checkpoint(str(tmp_path))
        other = {"head": {k: v * 0.5 for k, v in jparams["head"].items()}}
        c = _port_engine(other, conf)
        c.load_checkpoint(str(tmp_path))
        assert c.opt_state.step == 2 and c.global_steps == 2
        resumed = [c.train_batch(batch=tuple(map(torch.from_numpy,
                                                 _batch(s))))
                   for s in range(2, 4)]
    finally:
        torch.set_num_threads(2)
    assert resumed == full[2:]
    assert torch.equal(c._master, a._master)
    assert torch.equal(c.opt_state.momentum, a.opt_state.momentum)
    tag = open(os.path.join(tmp_path, "latest")).read().strip()
    ms = load_obj(os.path.join(tmp_path, tag, "mp_rank_00_model_states.pt"))
    keys = set(ms["optimizer"]["state"]["arrays"])
    assert keys == {"step", "momentum/head/weight", "momentum/head/bias"}


def test_client_writing_in_place_and_the_compute_copy(jparams):
    """A client whose ``update`` writes the masters in place and takes
    ``compute_out`` (bf16 compute): the engine hands it the compute
    buffer and copies nothing; the result equals `TorchSGD`'s step."""
    seen = {}

    class InPlaceSGD(TorchSGD):
        def update(self, grads, state, master, lr=None, compute_out=None):
            new, state = super().update(grads, state, master, lr=lr)
            master.copy_(new)
            compute_out.copy_(master)
            seen["compute_out"] = compute_out
            return master, state

    conf = _conf(fp16={"enabled": True, "type": "bfloat16"})
    a = _port_engine(jparams, conf, InPlaceSGD(0.5, 0.9))
    b = _port_engine(jparams, conf)
    batch = tuple(map(torch.from_numpy, _batch(0)))
    assert a.train_batch(batch=batch) == b.train_batch(batch=batch)
    assert seen["compute_out"] is a._params_flat
    assert a._params_flat.dtype == torch.bfloat16
    assert torch.equal(a._master, b._master)
    assert torch.equal(a._params_flat, b._params_flat)
    assert torch.equal(a._params_flat, a._master.to(torch.bfloat16))


def test_client_optimizer_errors(jparams, tmp_path):
    class NoUpdate:
        param_groups = [{"lr": 0.1}]

        def init_state(self, master):
            return ()
    with pytest.raises(DeepSpeedConfigError, match="update"):
        dst.initialize(model=TiledHead(), optimizer=NoUpdate(),
                       config_params=_conf())
    eng = _port_engine(jparams, _conf(),
                       TorchSGD(0.5, 0.9, with_state_dict=False))
    eng.train_batch(batch=tuple(map(torch.from_numpy, _batch(0))))
    with pytest.raises(DeepSpeedConfigError, match="state_dict"):
        eng.save_checkpoint(str(tmp_path))
