"""The port's data-parallel engine on gloo ranks against the JAX engine
on a data mesh, on the CPU.

The port runs as 2 and 4 gloo ranks (child processes, one thread each,
`tests/torch_dp_worker.py`), each on its own micro-batches: columns of
one global batch [gas 2, 4, S] that the JAX engine takes whole on its
mesh. Both worlds share that global batch (micro 2 a rank at world 2,
1 at world 4), so the JAX engine on a 4-device mesh is the fp32
reference and the JAX engine on a 2-device mesh the bf16 one, for both
worlds. Every run: ZeRO stage 0, 1 or 2, gradient accumulation 2,
clipping at 1.0, ``prescale_gradients`` with a predivide factor of 2,
and a tiny GPT-NeoX whose 47,565 parameters need padding to the
partition alignment at both worlds.

Tolerances after 3 steps: fp32 losses rtol 1e-5, masters atol = rtol =
1e-4 (Adam's eps is 1e-3, so the update is smooth in the gradients;
only the summation order differs); bf16 losses rtol 1e-3, masters atol
1e-2 (bf16 gradients round apart: one Adam step of lr 1e-2 flips with
the sign of a tiny gradient).

Also: the ranks end bit-identical; the state bytes a rank are the
partition formula's; the legacy forward / backward / step loop equals
`train_batch` bit for bit; ``sparse_gradients`` (the token embedding's
rows all-gathered as a CSRTensor) equals the dense all-reduce; what
stays refused across ranks, and what stays refused everywhere.
"""

import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

import torch_dp as T

STEPS = 3
WORLDS = (2, 4)
STAGES = (0, 1, 2)
DTYPES = ("fp32", "bf16")
GLOBAL_MICRO = 4
JAX_WORLD = {"fp32": 4, "bf16": 2}
TOL = {"fp32": dict(loss=1e-5, atol=1e-4, rtol=1e-4),
       "bf16": dict(loss=1e-3, atol=1e-2, rtol=0.0)}


def _conf(world, dtype, stage, **extra):
    return T.config(world, dtype, stage, micro=GLOBAL_MICRO // world,
                    prescale_gradients=True, gradient_predivide_factor=2.0,
                    **extra)


@pytest.fixture(scope="module")
def weights():
    return T.jax_weights()


@pytest.fixture(scope="module")
def toks():
    return T.tokens(1, micro=GLOBAL_MICRO)


def _train(name, world, weights, toks, conf, **kw):
    return dict(kind="train", name=name, size=T.SIZE, weights=weights,
                conf=conf, tokens=toks, steps=STEPS, **kw)


@pytest.fixture(scope="module")
def runs(weights, toks, tmp_path_factory):
    """(the port's results by world, the JAX references by dtype): the
    ranks of both worlds train while the JAX engines compile."""
    handles = {}
    for world in WORLDS:
        cases = [_train(f"s{stage}_{dtype}", world, weights, toks,
                        _conf(world, dtype, stage))
                 for stage in STAGES for dtype in DTYPES]
        if world == 2:
            cases += [
                _train("legacy", world, weights, toks,
                       _conf(world, "fp32", 2), legacy=True),
                _train("sparse", world, weights, toks,
                       _conf(world, "fp32", 0, sparse_gradients=True)),
                dict(kind="refuse", name="refuse", size=T.SIZE, confs={
                    "lamb": dict(_conf(world, "fp32", 1), optimizer={
                        "type": "Lamb", "params": {"lr": 1e-2}}),
                    "adam": _conf(world, "fp32", 1)})]
        handles[world] = T.start_ranks(world, cases,
                                       tmp_path_factory.mktemp(f"w{world}"))
    ref = {}
    for dtype, world in JAX_WORLD.items():
        eng = T.jax_engine(world, weights, _conf(world, dtype, 2))
        ref[dtype] = (T.jax_steps(eng, toks, STEPS), T.jax_masters(eng))
    return {w: T.wait_ranks(h) for w, h in handles.items()}, ref


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_steps_match_jax(port, jax_ref, world, stage, dtype):
    got = port[world][0][f"s{stage}_{dtype}"]
    want_losses, want_master = jax_ref[dtype]
    tol = TOL[dtype]
    assert got["dp_world_size"] == world
    np.testing.assert_allclose(got["losses"], want_losses, rtol=tol["loss"])
    assert set(got["master"]) == set(want_master)
    for key, want in want_master.items():
        np.testing.assert_allclose(got["master"][key], want,
                                   atol=tol["atol"], rtol=tol["rtol"],
                                   err_msg=key)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(port, world):
    """Every rank ends with the same losses, masters and compute
    parameters, bit for bit."""
    first = port[world][0]
    for other in port[world][1:]:
        for name, got in first.items():
            if "losses" not in got:
                continue
            assert other[name]["losses"] == got["losses"], name
            for field in ("master", "params"):
                for key, value in got[field].items():
                    np.testing.assert_array_equal(
                        other[name][field][key], value,
                        err_msg=f"{name} {field} {key}")


def _formula(stage, dtype, n, world):
    """A rank's state bytes from the partition layout: compute params and
    grads, the fp32 masters (none apart from the fp32 parameters), the two
    moments, the fp32 accumulator (whole at stages 0-1) and stage 1's
    partition it is reduce-scattered into."""
    c = 4 if dtype == "fp32" else 2
    if stage == 0:
        out = {"params": c * n, "grads": c * n, "exp_avg": 4 * n,
               "exp_avg_sq": 4 * n}
        if dtype != "fp32":
            out.update(master=4 * n, grad_acc=4 * n)
        return out
    padded = -(-n // (world * 8)) * world * 8
    part = padded // world
    out = {"params": c * padded, "grads": c * padded, "exp_avg": 4 * part,
           "exp_avg_sq": 4 * part}
    if dtype != "fp32":
        out["master"] = 4 * part
    if stage == 1:
        out["grad_part"] = 4 * part
        if dtype != "fp32":
            out["grad_acc"] = 4 * padded
    else:
        out["grad_acc"] = 4 * part
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", STAGES)
def test_state_bytes_are_the_partition_formula(port, stage, dtype):
    """At world 2 the masters and moments of a rank are half the padded
    flat buffer from stage 1 on, and stage 2 holds no whole fp32
    gradient."""
    for rank, res in enumerate(port[2]):
        got = res[f"s{stage}_{dtype}"]
        n = got["num_params"]
        assert got["state_bytes"] == _formula(stage, dtype, n, 2)
        if stage:
            numel, padded, world, r = got["part"]
            assert (numel, world, r) == (n, 2, rank)
            assert padded % 16 == 0 and 0 < padded - n < 16
    if stage == 2:
        sb = port[2][0][f"s2_{dtype}"]["state_bytes"]
        assert max(v for k, v in sb.items()
                   if k not in ("params", "grads")) < 4 * n


def test_legacy_loop_equals_train_batch(port):
    legacy, fused = port[2][0]["legacy"], port[2][0]["s2_fp32"]
    assert legacy["losses"] == fused["losses"]
    for key, value in fused["master"].items():
        np.testing.assert_array_equal(legacy["master"][key], value,
                                      err_msg=key)


def test_sparse_gradients_equal_the_dense_reduction(port):
    sparse, dense = port[2][0]["sparse"], port[2][0]["s0_fp32"]
    np.testing.assert_allclose(sparse["losses"], dense["losses"], rtol=1e-6)
    for key, value in dense["master"].items():
        np.testing.assert_allclose(sparse["master"][key], value, rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_partitioned_refusals_across_ranks(port):
    msgs = port[2][0]["refuse"]
    assert msgs["adam"] is None
    assert "not ported" in msgs["lamb"] and "FusedLamb" in msgs["lamb"] \
        and "ZeRO stage 1" in msgs["lamb"]


@pytest.mark.parametrize("what", ["zero3", "offload", "mpu", "onebit",
                                  "pipeline", "pipeline_module"])
def test_still_refused(what):
    """What stays refused everywhere raises "not ported"; ZeRO stage 3,
    ported since, builds its partitioned engine (one rank here)."""
    conf = _conf(1, "fp32", 2)
    kw = {}
    if what == "zero3":
        conf["zero_optimization"] = {"stage": 3}
    elif what == "offload":
        conf["zero_optimization"] = {"stage": 2, "offload_optimizer": {
            "device": "cpu"}}
    elif what == "mpu":
        kw["mpu"] = object()
    elif what == "onebit":
        conf["optimizer"] = {"type": "OneBitAdam", "params": {"lr": 1e-3}}
    elif what == "pipeline":
        conf["pipeline"] = {"stages": 2}
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**T.SIZE), device="cpu")
    if what == "pipeline_module":
        model = type("PipelineModule", (torch.nn.Module,), {})()
    if what == "zero3":
        eng, *_ = dst.initialize(model=model, config_params=conf, **kw)
        assert eng.zero_optimization_stage() == 3 and eng._z3 is not None
        assert eng._z3.layout.part_size * eng.dp_world_size >= \
            eng.num_params
        return
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        dst.initialize(model=model, config_params=conf, **kw)


class _Mesh:
    """A stand-in `DeviceMesh` (no process group can be formed in the
    test process): its dim names and sizes."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)
        self.ndim = len(shape)

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]


@pytest.mark.parametrize("mesh, match", [
    (_Mesh(("expert",), (2,)), "init_distributed first"),
    (_Mesh(("data", "expert"), (2, 2)), "2-D mesh"),
    (_Mesh(("model",), (2,)), "axis named 'model'")])
def test_engine_mesh_refusals(mesh, match):
    """Expert parallelism is ported (`test_torch_moe_ep_engine.py` trains
    it on gloo ranks); a mesh without the process group it spans, a 2-D
    mesh and a model axis stay refused."""
    conf = _conf(1, "fp32", 0, moe={"num_experts": 4, "top_k": 2,
                                    "dispatch": "sort"})
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**T.SIZE), device="cpu")
    with pytest.raises(DeepSpeedConfigError, match=match) as e:
        dst.initialize(model=model, config_params=conf, mesh=mesh)
    assert "init_distributed" in str(e.value) or "A.6" in str(e.value)


def test_moe_layer_without_expert_axis_is_one_card():
    """`MoELayer` whose mesh has no "expert" dimension (or none) runs the
    one-card FFN; one with experts that do not divide over the expert
    ranks raises, as in JAX."""
    from deeperspeed_tpu_torch.moe.layer import MoELayer
    layer = MoELayer(8, 16, 4, mesh=_Mesh(("data",), (2,)), device="cpu",
                     dispatch="sort", top_k=2)
    assert layer.ep == 1 and layer.group is None
    params = layer.init(0)
    y, aux = layer.apply(params, torch.randn(2, 16, 8))
    assert y.shape == (2, 16, 8) and torch.isfinite(aux)
    with pytest.raises(ValueError, match="must divide"):
        MoELayer(8, 16, 3, mesh=_Mesh(("expert",), (2,)), device="cpu")
