"""The port's explicit expert-parallel MoE layer on gloo ranks against the
JAX package's under `shard_map`, on the CPU.

`moe_ffn_expert_parallel` (and `MoELayer(mesh=)`, which runs it) on 2 and
4 gloo ranks (`tests/torch_dp_worker.py`, "moe_fn") against the JAX
function under `shard_map` on a 2- and 4-device ``("expert",)`` mesh:
8 experts (4 or 2 a rank), both dispatch engines, top-1 and top-2,
``groups`` 1 and 2, the top-2 renormalization on, capacity binding
(capacity factor 1.0 and a gate that favours some experts). Each rank
routes its own 32 tokens. Outputs and the aux loss within atol = rtol =
1e-5 (the JAX test's own), and the gradients of sum(y · w) + aux with
respect to x and the rank's expert weights against `jax.grad` (the
gate's: the ranks' shares summed) within the same. The sort engine's
pipelined exchange (``a2a_overlap_chunks`` 2) is bit-equal to one chunk.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deeperspeed_tpu.compat import shard_map
from deeperspeed_tpu.moe.layer import moe_ffn_expert_parallel as jax_ep

import torch_dp as T

WORLDS = (2, 4)
E, H, I, T_LOCAL = 8, 16, 32, 32
TOL = dict(atol=1e-5, rtol=1e-5)
GRID = [dict(dispatch=d, top_k=k, groups=g)
        for d in ("einsum", "sort") for k in (1, 2) for g in (1, 2)]


def _inputs(world):
    rng = np.random.default_rng(world)
    gate = rng.standard_normal((H, E)).astype(np.float32)
    gate[:, :3] *= 2.5         # some experts take more than their capacity
    params = {
        "gate": gate,
        "w_in": (rng.standard_normal((E, H, I)) * 0.2).astype(np.float32),
        "b_in": (rng.standard_normal((E, I)) * 0.1).astype(np.float32),
        "w_out": (rng.standard_normal((E, I, H)) * 0.2).astype(np.float32),
        "b_out": (rng.standard_normal((E, H)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((world * T_LOCAL, H)).astype(np.float32)
    w = rng.standard_normal((world * T_LOCAL, H)).astype(np.float32)
    return params, x, w


def _kw(cfg):
    return dict(cfg, capacity_factor=1.0, renorm_kept_choices=True)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """{world: (the ranks' handle, inputs)}: the ranks of both worlds
    start before the JAX references compile."""
    handles = {}
    for world in WORLDS:
        params, x, w = _inputs(world)
        runs_ = [dict(fn="ep", **_kw(c)) for c in GRID]
        runs_ += [dict(fn="ep", a2a_overlap_chunks=2, **_kw(GRID[-1])),
                  dict(fn="layer", a2a_overlap_chunks=2, **_kw(GRID[-1]))]
        handles[world] = (T.start_ranks(world, [
            dict(kind="moe_fn", name="moe", params=params, x=x, w=w,
                 runs=runs_)], tmp_path_factory.mktemp(f"w{world}")),
            (params, x, w))
    return handles


@pytest.fixture(scope="module")
def refs(started):
    """{(world, grid index): (y, aux, grads of the params, dx)} of the
    JAX function under shard_map."""
    out = {}
    for world in WORLDS:
        params, x, w = _inputs(world)
        mesh = Mesh(np.asarray(jax.devices()[:world]), ("expert",))
        specs = {"gate": P(), "w_in": P("expert"), "b_in": P("expert"),
                 "w_out": P("expert"), "b_out": P("expert")}
        for i, cfg in enumerate(GRID):
            fn = shard_map(
                lambda p, x, cfg=cfg: jax_ep(p, x, "expert", world,
                                             **_kw(cfg)),
                mesh=mesh, in_specs=(specs, P("expert")),
                out_specs=(P("expert"), P()), check_vma=False)

            def loss(p, x, fn=fn):
                y, aux = fn(p, x)
                return jnp.sum(y * w) + aux, (y, aux)
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
            out[world, i] = (np.asarray(y), float(aux),
                             {k: np.asarray(v) for k, v in gp.items()},
                             np.asarray(gx))
    return out


@pytest.fixture(scope="module")
def runs(started, refs):
    """{world: (port results by rank, inputs)}: the ranks of both worlds
    ran while the JAX references compiled (`refs` first)."""
    return {world: (T.wait_ranks(h), inp) for world, (h, inp) in
            started.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(GRID)),
                         ids=["{dispatch}-top{top_k}-g{groups}".format(**c)
                              for c in GRID])
def test_expert_parallel_matches_jax_shard_map(runs, refs, world, case):
    port, _ = runs[world]
    y, aux, gp, gx = refs[world, case]
    e_local = E // world
    gate = 0
    for rank in range(world):
        got = port[rank]["moe"][case]
        rows = slice(rank * T_LOCAL, (rank + 1) * T_LOCAL)
        np.testing.assert_allclose(got["y"], y[rows], **TOL)
        np.testing.assert_allclose(got["aux"], aux, **TOL)
        np.testing.assert_allclose(got["dx"], gx[rows], **TOL)
        for k in ("w_in", "b_in", "w_out", "b_out"):
            np.testing.assert_allclose(
                got["grads"][k], gp[k][rank * e_local:(rank + 1) * e_local],
                err_msg=k, **TOL)
        gate = gate + got["grads"]["gate"]
    np.testing.assert_allclose(gate, gp["gate"], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_overlap_chunks_and_layer_bit_equal_one_chunk(runs, world):
    """a2a_overlap_chunks 2 (the pipelined exchange, chunk i+1's
    all-to-all in flight during chunk i's FFN) and `MoELayer(mesh=)`
    give the single-chunk result bit for bit, gradients too."""
    port, _ = runs[world]
    for rank in range(world):
        one, chunked, layer = (port[rank]["moe"][i] for i in
                               (len(GRID) - 1, len(GRID), len(GRID) + 1))
        for other in (chunked, layer):
            np.testing.assert_array_equal(other["y"], one["y"])
            np.testing.assert_array_equal(other["dx"], one["dx"])
            assert other["aux"] == one["aux"]
            for k, v in one["grads"].items():
                np.testing.assert_array_equal(other["grads"][k], v)


def test_layer_specs_and_shards_on_one_process():
    """`MoELayer`'s specs and shards without a process group: all
    replicated at ep 1; `expert_shard` and `models.convert`'s slice and
    merge of a whole tree."""
    import torch

    from deeperspeed_tpu_torch.models.convert import (expert_slice,
                                                      merge_expert_slices)
    from deeperspeed_tpu_torch.moe import MoELayer, expert_shard
    layer = MoELayer(H, I, E, device="cpu")
    assert layer.ep == 1
    assert set(layer.param_specs().values()) == {()}
    params = layer.init(0)
    assert layer.shard_params(params) is params
    shard = expert_shard(params, 1, 4)
    assert shard["gate"] is params["gate"]
    assert torch.equal(shard["w_in"], params["w_in"][2:4])
    tree = {"blocks": [{"mlp": {k: v.numpy() for k, v in params.items()}}]}
    parts = [expert_slice(tree, r, 4) for r in range(4)]
    assert parts[3]["blocks"][0]["mlp"]["b_out"].shape == (2, H)
    whole = merge_expert_slices(parts)["blocks"][0]["mlp"]
    for k, v in params.items():
        np.testing.assert_array_equal(whole[k], v.numpy())


def test_gpt_neox_param_specs_match_jax():
    """`GPTNeoX.param_specs(mesh)` is the JAX model's `param_specs` on a
    2-device ("expert",) mesh leaf for leaf (the experts' leaves over
    "expert", the gate and every other leaf replicated), and replicates
    everything on a mesh without an "expert" dimension."""
    from deeperspeed_tpu.models import gpt_neox as jneox

    from deeperspeed_tpu_torch.checkpoint.serialization import path_key
    from deeperspeed_tpu_torch.models.gpt_neox import (GPTNeoX,
                                                       GPTNeoXConfig)

    class Mesh_:
        """A stand-in `DeviceMesh` of one named dimension."""

        def __init__(self, name, n):
            self.mesh_dim_names, self._n = (name,), n

        def size(self, dim=None):
            return self._n

    size = dict(T.SIZE, **T.MOE_CFG)
    model = GPTNeoX(GPTNeoXConfig(**size), device="cpu")
    got = {path_key(k): v for k, v in
           model.param_specs(Mesh_("expert", 2)).items()}
    jcfg = jneox.GPTNeoXConfig(**size)
    shapes = jax.eval_shape(lambda k: jneox.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("expert",))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jneox.GPTNeoX(jcfg).param_specs(shapes, mesh),
        is_leaf=lambda x: isinstance(x, P))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}
    assert got == want
    assert sum(v == ("expert",) for v in got.values()) == \
        4 * size["num_layers"]
    assert all(v == () for v in model.param_specs(
        Mesh_("data", 2)).values())
