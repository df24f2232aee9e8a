"""The port's engine on a 1-D "expert" mesh of 2 gloo ranks against the
JAX engine on a 2-device ``("expert",)`` mesh, on the CPU.

The JAX engine shards the MoE blocks' expert leaves over the "expert"
axis (`GPTNeoX.param_specs`) and lets XLA insert the exchange: the math
of one device over the global batch, whose last (only) axis is the data
axis, so ``dp_world_size`` is 2. The port's ranks (`tests/
torch_dp_worker.py`, ``mesh="expert"``) each keep 2 of the 4 experts,
route the global micro-batch (`moe_ffn_dense(..., group=,
expert_parallel=True)`) and exchange the sort engine's buffer with the
experts' owners by two all-to-alls. Micro 2 a rank, ZeRO stage 0, fp32,
capacity factor 1.25 on weights that make it bind
(`torch_moe_ep.moe_weights`), aux loss coefficient 0.01, 2 steps with
clipping at 1.0 (the norm counts every expert once), without remat and
with "full" remat (the recompute issues the collectives again): losses
within rtol 1e-5, the masters (experts gathered over the ranks) within
atol = rtol = 1e-4; the ranks' gathered masters equal bit for bit; a
rank holds half the experts. Then what the expert mesh refuses, each
with its reason: ZeRO stages 1-3, a 2-D mesh, the einsum engine,
quantization.ffn, sparse_gradients and the flops count.
"""

import numpy as np
import pytest

from deeperspeed_tpu_torch.models.gpt_neox import GPTNeoX, GPTNeoXConfig

import torch_dp as T
import torch_moe_ep as M

WORLD = 2
REMAT = {"none": {}, "full": {"activation_checkpointing": {"policy": "full"}}}


def _conf(stage=0, remat="none", **moe):
    return M.config(WORLD, "fp32", stage, moe=M.moe_block(**moe),
                    **REMAT[remat])


REFUSALS = {
    "zero1": (dict(conf=_conf(stage=1)), "DuplicateSpecError"),
    "zero2": (dict(conf=_conf(stage=2)), "DuplicateSpecError"),
    "zero3": (dict(conf=_conf(stage=3)), "DuplicateSpecError"),
    "mesh_2d": (dict(conf=_conf(), mesh="data,expert"), "2-D mesh"),
    "einsum": (dict(conf=_conf(dispatch="einsum")), "einsum"),
    "quant_ffn": (dict(conf=dict(_conf(), quantization={
        "ffn": {"recipe": "int8"}})), "quantization.ffn"),
    "sparse_gradients": (dict(conf=dict(_conf(), sparse_gradients=True)),
                         "sparse_gradients"),
    "telemetry": (dict(conf=dict(_conf(), telemetry={"enabled": True})),
                  "flops count"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = M.moe_weights()
    toks = M.tokens(WORLD)
    cases = [dict(kind="train", name=remat, size=M.MOE_SIZE,
                  weights=weights, conf=_conf(remat=remat), tokens=toks,
                  steps=M.STEPS, mesh="expert") for remat in REMAT]
    refuse = {}
    for name, (case, _) in REFUSALS.items():
        refuse[name] = dict(case["conf"], mesh=case.get("mesh", "expert"))
    cases.append(dict(kind="refuse", name="refuse", size=M.MOE_SIZE,
                      confs=refuse))
    handle = T.start_ranks(WORLD, cases, tmp_path_factory.mktemp("w"))
    ref = {}
    for remat in REMAT:
        eng = M.jax_engine(WORLD, weights, _conf(remat=remat), "expert")
        ref[remat] = dict(losses=T.jax_steps(eng, toks, M.STEPS),
                          master=T.jax_masters(eng))
    return T.wait_ranks(handle), ref


@pytest.mark.parametrize("remat", list(REMAT))
def test_expert_mesh_trains_to_the_jax_engine(runs, remat):
    port, ref = runs
    want = ref[remat]
    got = port[0][remat]
    assert got["ep"] == WORLD and got["dp_world_size"] == WORLD
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert set(got["master"]) == set(want["master"])
    for key, value in want["master"].items():
        np.testing.assert_allclose(got["master"][key], value, atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    # the ranks gathered the same whole model
    for key, value in got["master"].items():
        np.testing.assert_array_equal(port[1][remat]["master"][key], value,
                                      err_msg=key)


def test_a_rank_holds_its_experts_only(runs):
    """Each rank's flat state holds the dense leaves and half the
    experts: the expert leaves' bytes halve."""
    port, _ = runs
    dense = GPTNeoX(GPTNeoXConfig(**T.SIZE), device="cpu")
    n_dense_ffn = sum(p.numel() for n, p in dense.named_parameters()
                      if ".mlp." in n)
    n_dense = sum(p.numel() for p in dense.parameters()) - n_dense_ffn
    moe = GPTNeoX(GPTNeoXConfig(**M.MOE_SIZE), device="cpu")
    gate = sum(p.numel() for n, p in moe.named_parameters()
               if n.endswith("mlp.gate"))
    experts = sum(p.numel() for n, p in moe.named_parameters()
                  if ".mlp." in n) - gate
    for rank in range(WORLD):
        assert port[rank]["none"]["num_params"] == \
            n_dense + gate + experts // WORLD


@pytest.mark.parametrize("name", list(REFUSALS))
def test_expert_mesh_refusals(runs, name):
    port, _ = runs
    msg = port[0]["refuse"][name]
    assert msg is not None and msg.startswith("DeepSpeedConfigError"), msg
    assert REFUSALS[name][1] in msg, msg
    assert name.startswith("zero") or "A.6" in msg, msg
