"""Checkpoints across data-parallel ranks: the port on 2 gloo ranks and
the JAX engine on 2- and 4-device data meshes read each other's files,
on the CPU.

fp32, ZeRO stage 2, gradient accumulation 2, one global batch [2, 4, S]
(micro 2 a rank at world 2, 1 at world 4, 4 on one rank). The port's
ranks (`tests/torch_dp_worker.py`) train 4 steps and save after the
2nd; the JAX engine at dp 2 trains 2 steps, saves, trains 2 more, then
loads the port's checkpoint and trains 2 steps; the JAX engine at dp 4
trains a step, saves and trains one more. Then the port's ranks resume
from both JAX checkpoints, and one port process without a group resumes
from the port's world-2 checkpoint (the elastic 2 → 1). Each resumed run
takes the steps of the run it resumes: losses rtol 1e-5, masters atol =
rtol = 1e-4 (only the summation order differs).

The port's files are the JAX layout of a dp-2 engine: the same keys,
slice dims and slice shapes as the JAX engine's at dp 2 (the odd width
makes ragged "flat" leaves), each rank writes only its own zero file,
and `zero_to_fp32` merges the port's 2 ranks into its masters bit for
bit.
"""

import os

import numpy as np
import pytest

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu.utils import zero_to_fp32 as jax_z2f
from deeperspeed_tpu_torch.checkpoint.serialization import load_obj
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.utils import zero_to_fp32 as z2f

import torch_dp as T

GLOBAL_MICRO = 4
SAVE_AT = 2
TAG = f"global_step{SAVE_AT}"


def _conf(world):
    return T.config(world, "fp32", 2, micro=GLOBAL_MICRO // world)


def _masters_close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-4, rtol=1e-4,
                                   err_msg=key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_ckpt")
    dirs = {k: str(root / k) for k in ("port2", "jax2", "jax4")}
    w = T.jax_weights()
    toks = T.tokens(1, micro=GLOBAL_MICRO)
    out = {"dirs": dirs, "toks": toks, "weights": w}

    def train(name, steps, **kw):
        return dict(kind="train", name=name, size=T.SIZE, weights=w,
                    conf=_conf(2), tokens=toks, steps=steps, **kw)

    first = T.start_ranks(2, [train("port2", 4, save=dirs["port2"],
                                    save_at=SAVE_AT,
                                    masters_each_step=True)],
                          root / "first")
    j2 = T.jax_engine(2, w, _conf(2))
    out["jax2_first"] = T.jax_steps(j2, toks, SAVE_AT)
    j2.save_checkpoint(dirs["jax2"])
    out["jax2_cont"] = (T.jax_steps(j2, toks, 2), T.jax_masters(j2))
    j4 = T.jax_engine(4, w, _conf(4))
    T.jax_steps(j4, toks, 1)
    j4.save_checkpoint(dirs["jax4"])
    out["jax4_cont"] = (T.jax_steps(j4, toks, 1), T.jax_masters(j4))
    out["first"] = T.wait_ranks(first)

    second = T.start_ranks(2, [train("from_jax2", 2, load=dirs["jax2"]),
                               train("from_jax4", 1, load=dirs["jax4"])],
                           root / "second")
    j2.load_checkpoint(dirs["port2"])
    T.pin_scalars(j2)
    assert j2.global_steps == SAVE_AT
    out["jax2_from_port"] = (T.jax_steps(j2, toks, 2), T.jax_masters(j2))
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**T.SIZE), device="cpu")
    eng, *_ = dst.initialize(model=model, config_params=_conf(1),
                             model_parameters=w)
    eng.load_checkpoint(dirs["port2"])
    assert eng.dp_world_size == 1 and eng.global_steps == SAVE_AT
    losses = [eng.train_batch(batch=(toks, toks)) for _ in range(2)]
    out["port1_from_port2"] = (losses, {
        k.replace(".", "/"): eng._master[lo:hi].reshape(shape).numpy()
        for k, lo, hi, shape in eng.param_slices})
    out["second"] = T.wait_ranks(second)
    return out


def test_port_files_are_the_jax_dp2_layout(runs):
    port_dir = os.path.join(runs["dirs"]["port2"], TAG)
    jax_dir = os.path.join(runs["dirs"]["jax2"], TAG)
    names = sorted(os.listdir(port_dir))
    assert [n for n in names if n.startswith("zero_pp_rank_")] == [
        "zero_pp_rank_0_mp_rank_00_optim_states.pt",
        "zero_pp_rank_1_mp_rank_00_optim_states.pt"]
    flat_keys = 0
    for rank in range(2):
        name = f"zero_pp_rank_{rank}_mp_rank_00_optim_states.pt"
        ours = load_obj(os.path.join(port_dir, name))
        theirs = load_obj(os.path.join(jax_dir, name))
        assert (ours["partition_count"], ours["dp_rank"],
                ours["zero_stage"]) == (2, rank, 2)
        for o, t in ((ours["fp32_master"], theirs["fp32_master"]),
                     (ours["optimizer_state_dict"]["state"],
                      theirs["optimizer_state_dict"]["state"])):
            assert set(o) == set(t)
            for key in t:
                assert np.shape(o[key]) == np.shape(t[key]), key
        assert ours["fp32_master_dims"] == theirs["fp32_master_dims"]
        assert ours["optimizer_state_dict"]["shard_dims"] == \
            theirs["optimizer_state_dict"]["shard_dims"]
        assert ours["fp32_master_flat_shapes"] == {
            k: tuple(v) for k, v in
            theirs["fp32_master_flat_shapes"].items()}
        flat_keys = sum(v == "flat" for v in
                        ours["fp32_master_dims"].values())
    assert flat_keys >= 3


def test_each_rank_writes_only_its_own_file(runs):
    written = [r["port2"]["written"] for r in runs["first"]]
    assert written[0] == ["mp_rank_00_model_states.pt",
                          "zero_pp_rank_0_mp_rank_00_optim_states.pt"]
    assert written[1] == ["zero_pp_rank_1_mp_rank_00_optim_states.pt"]


def test_port_and_jax_take_the_same_first_steps(runs):
    port = runs["first"][0]["port2"]
    np.testing.assert_allclose(port["losses"][:SAVE_AT], runs["jax2_first"],
                               rtol=1e-5)


def test_jax_dp2_resumes_the_port_checkpoint(runs):
    port = runs["first"][0]["port2"]
    losses, masters = runs["jax2_from_port"]
    np.testing.assert_allclose(losses, port["losses"][SAVE_AT:], rtol=1e-5)
    _masters_close(masters, port["master"])


def test_port_resumes_the_jax_dp2_checkpoint(runs):
    losses, masters = runs["jax2_cont"]
    for rank in range(2):
        got = runs["second"][rank]["from_jax2"]
        assert got["global_steps"] == 2 * SAVE_AT
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _masters_close(got["master"], masters)


def test_elastic_port2_to_port1(runs):
    port = runs["first"][0]["port2"]
    losses, masters = runs["port1_from_port2"]
    np.testing.assert_allclose(losses, port["losses"][SAVE_AT:], rtol=1e-5)
    _masters_close(masters, port["master"])


def test_elastic_jax4_to_port2(runs):
    losses, masters = runs["jax4_cont"]
    for rank in range(2):
        got = runs["second"][rank]["from_jax4"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _masters_close(got["master"], masters)


@pytest.mark.parametrize("tool", ["port", "jax"])
def test_zero_to_fp32_merges_the_port_ranks(runs, tool):
    want = runs["first"][0]["port2"]["masters_each_step"][SAVE_AT - 1]
    ckpt = os.path.join(runs["dirs"]["port2"], TAG)
    fn = (z2f if tool == "port" else jax_z2f) \
        .get_fp32_state_dict_from_zero_checkpoint
    got = fn(ckpt)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), value,
                                      err_msg=key)
