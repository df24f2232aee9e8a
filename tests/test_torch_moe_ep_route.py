"""GShard routing over the whole data-parallel group: the port's
`moe_ffn_dense(..., group=)` on gloo ranks against the JAX package's
`moe_ffn_dense` over the global batch, on the CPU.

On 2 and 4 gloo ranks (`tests/torch_dp_worker.py`, "moe_fn"), each rank
routes its 32 rows of one global batch (rank-major, as JAX splits the
batch dimension) with the experts whole, and the JAX function routes the
global batch on one device: 8 experts, both dispatch engines, top-1 and
top-2, the top-2 renormalization on, capacity binding (capacity factor
1.0 and a gate that favours some experts), and groups that span every
rank (``groups`` 1), span two ranks (``groups`` 2 at world 4) or lie
whole on each rank (2 a rank). Outputs and the aux loss (where each rank
holds whole groups: the ranks' mean) within atol = rtol = 1e-5; the
gradients of sum(y · w) + aux with respect to x and the parameters (the
ranks' shares summed) against `jax.grad` within the same. The sort
engine's routing statistics (``observe``) are the global route's, equal
to one process routing the global batch. A group that straddles the
ranks' shards is refused, naming A.6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.moe.layer import moe_ffn_dense as jax_dense

from deeperspeed_tpu_torch.moe import layer as ml

import torch_dp as T

WORLDS = (2, 4)
E, H, I, T_LOCAL = 8, 16, 32, 32
TOL = dict(atol=1e-5, rtol=1e-5)
# groups: spanning every rank, spanning two ranks (world 4), two whole
# groups a rank
GROUPS = {2: (1, 4), 4: (1, 2, 8)}
GRID = {world: [dict(dispatch=d, top_k=k, groups=g) for d in
                ("einsum", "sort") for k in (1, 2) for g in GROUPS[world]]
        for world in WORLDS}


def _inputs(world):
    rng = np.random.default_rng(10 + world)
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
    return dict(cfg, capacity_factor=1.0, renorm_kept_choices=True,
                observe=cfg["dispatch"] == "sort")


def _ids(world):
    return ["{dispatch}-top{top_k}-g{groups}".format(**c)
            for c in GRID[world]]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """{world: the ranks' handle}: they start before the JAX references
    compile."""
    handles = {}
    for world in WORLDS:
        params, x, w = _inputs(world)
        runs_ = [dict(fn="dense", **_kw(c)) for c in GRID[world]]
        if world == 2:
            # 24 rows a rank, 3 groups of 16 over 48 tokens: the middle
            # group straddles the ranks' shards
            runs_.append(dict(fn="dense", t_local=24, groups=3,
                              dispatch="sort", top_k=2))
        handles[world] = T.start_ranks(world, [
            dict(kind="moe_fn", name="moe", params=params, x=x, w=w,
                 runs=runs_)], tmp_path_factory.mktemp(f"w{world}"))
    return handles


@pytest.fixture(scope="module")
def refs(started):
    out = {}
    for world in WORLDS:
        params, x, w = _inputs(world)
        for i, cfg in enumerate(GRID[world]):
            kw = {k: v for k, v in _kw(cfg).items() if k != "observe"}

            def loss(p, x, kw=kw):
                y, aux = jax_dense(p, x, **kw)
                return jnp.sum(y * w) + aux, (y, aux)
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
            out[world, i] = (np.asarray(y), float(aux),
                             {k: np.asarray(v) for k, v in gp.items()},
                             np.asarray(gx))
    return out


@pytest.fixture(scope="module")
def runs(started, refs):
    """{world: port results by rank}: the ranks of both worlds ran while
    the JAX references compiled (`refs` first)."""
    return {world: T.wait_ranks(h) for world, h in started.items()}


def _check(port, ref, world, cfg):
    y, aux, gp, gx = ref
    T_ = y.shape[0]
    tg = T_ // cfg["groups"]
    auxes, grads = [], None
    for rank in range(world):
        got = port[rank]
        rows = slice(rank * T_LOCAL, (rank + 1) * T_LOCAL)
        np.testing.assert_allclose(got["y"], y[rows], **TOL)
        np.testing.assert_allclose(got["dx"], gx[rows], **TOL)
        auxes.append(got["aux"])
        grads = dict(got["grads"]) if grads is None else \
            {k: grads[k] + v for k, v in got["grads"].items()}
    if tg > T_LOCAL:
        # a group spanning ranks: every rank holds the global aux
        np.testing.assert_allclose(auxes, [aux] * world, **TOL)
    else:
        np.testing.assert_allclose(np.mean(auxes), aux, **TOL)
    for k, v in gp.items():
        np.testing.assert_allclose(grads[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("case", range(len(GRID[2])), ids=_ids(2))
def test_global_route_on_two_ranks_matches_jax(runs, refs, case):
    _check([r["moe"][case] for r in runs[2]], refs[2, case], 2,
           GRID[2][case])


@pytest.mark.parametrize("case", range(len(GRID[4])), ids=_ids(4))
def test_global_route_on_four_ranks_matches_jax(runs, refs, case):
    _check([r["moe"][case] for r in runs[4]], refs[4, case], 4,
           GRID[4][case])


@pytest.mark.parametrize("world", WORLDS)
def test_routing_statistics_are_the_global_routes(runs, world):
    """Every rank's drained statistics equal those of one process
    routing the global batch (sort engine, observe on)."""
    params, x, _ = _inputs(world)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    for i, cfg in enumerate(GRID[world]):
        if cfg["dispatch"] != "sort":
            continue
        ml.ROUTING_STATS.drain()
        ml.moe_ffn_dense(pt, torch.from_numpy(x), **_kw(cfg))
        want = {k: float(v) for k, v in ml.ROUTING_STATS.drain().items()}
        assert want["Train/MoE/capacity_drop_fraction"] > 0   # binding
        for rank in range(world):
            got = runs[world][rank]["moe"][i]["stats"]
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-6,
                                           err_msg=f"{cfg} {k}")


def test_group_straddling_ranks_is_refused(runs):
    for rank in range(2):
        msg = runs[2][rank]["moe"][-1]["error"]
        assert "straddle" in msg and "A.6" in msg
