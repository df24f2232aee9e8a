"""ZeRO-3 checkpoints and whole-model access of the port on four gloo
ranks, against the JAX stage-3 engine, on the CPU.

The port runs as one set of 4 gloo ranks (`tests/torch_dp_worker.py`)
on the three-layer GPT-NeoX of `torch_zero3`, the checkpoints in fp32,
the runs held to the JAX engine on 4 devices in bf16. Each rank writes
its own zero file in the JAX layout of a dp-4 engine with
``"zero_stage": 3`` (the stage-2 layout: masters and moments sliced
along the dimension the JAX rules shard, ragged leaves "flat"), and
model_states holds the gathered natural parameters. The JAX references
(two engines): stage 3 "explicit" without remat on 4 devices in bf16
(the ranks' bf16 steps in both modes, within 2e-2, and the consolidated
state dict in bf16), and stage 3 "gspmd" on 2 devices in fp32, which
loads the ranks' checkpoint of step 2 (4 → 2), saves it again in its own
writing, and takes step 3, which the ranks take from that checkpoint
(2 → 4). Also:
stage 2 ↔ 3 resumes, `zero_to_fp32` on the stage-3 directory,
`gathered_parameters` write-back (the JAX package's
`test_engine_gathered_parameters_updates_training_state`), and
`zero.Init` / `GatheredParameters` standalone over the group (the
cases of `tests/test_zero_context.py`).

Tolerances: a resumed step against the run that was never stopped, fp32
losses rtol 1e-5 and masters atol = rtol = 1e-4 (a resume at another
stage or world sums in another order); bf16 against JAX after 3 steps,
losses rtol 2e-2 and masters atol 2e-2; a checkpoint's leaves exact."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

import torch_dp as T
import torch_zero3 as Z

WORLD = 4
EDIT_LEAF = "blocks/1/attn/qkv_w"
API_TREE = {"w": np.arange(64 * 64, dtype=np.float32).reshape(64, 64) / 7,
            "tiny": np.array([1.0, -2.0, 3.0, 0.5], np.float32)}


@pytest.fixture(scope="module")
def weights():
    return T.jax_weights(Z.SIZE)


@pytest.fixture(scope="module")
def toks():
    return T.tokens(1, micro=Z.GLOBAL_MICRO)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("z3ckpt")
    return {k: str(root / k) for k in ("port3", "port2", "jax2")}


def _wait_for(path, timeout=T.CHILD_TIMEOUT):
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(weights, toks, dirs, tmp_path_factory):
    """(the ranks' results, the JAX runs): J1 runs while the ranks
    train; J2 loads their step-2 checkpoint and saves it again for their
    last resume."""
    c3, c2 = Z.conf(WORLD), Z.conf(WORLD, stage=2)
    edit = {"leaf": EDIT_LEAF, "value": 3.25}
    cases = [
        Z.train("z3g", weights, toks, c3, save=dirs["port3"], save_at=2,
                masters_each_step=True),
        Z.train("g_bf16", weights, toks, Z.conf(WORLD, "bf16"),
                consolidated=True),
        Z.train("n_bf16", weights, toks,
                Z.conf(WORLD, "bf16", schedule=Z.EXPLICIT_NO_REMAT)),
        Z.train("z2", weights, toks, c2, save=dirs["port2"], save_at=2),
        Z.train("z3_from_z2", weights, toks, c3, steps=1,
                load=dirs["port2"]),
        Z.train("z2_from_z3", weights, toks, c2, steps=1,
                load=dirs["port3"]),
        Z.train("edit0", weights, toks, c3, steps=0, edit=edit),
        Z.train("edit1", weights, toks, c3, steps=1, edit=edit),
        dict(kind="zero_api", name="zero_api", tree=API_TREE),
        Z.train("z3_from_jax2", weights, toks, c3, steps=1,
                load=dirs["jax2"],
                wait_for=os.path.join(dirs["jax2"], "latest"))]
    handle = T.start_ranks(WORLD, cases, tmp_path_factory.mktemp("z3w"))

    def j1():
        """Stage 3 "explicit" without remat on 4 devices in bf16, 3
        steps."""
        eng = T.jax_engine(WORLD, weights,
                           Z.conf(WORLD, "bf16",
                                  schedule=Z.EXPLICIT_NO_REMAT),
                           size=Z.SIZE)
        return (T.jax_steps(eng, toks, Z.STEPS), T.jax_masters(eng),
                jax.device_get(eng._zero3_consolidated_fp16_state_dict()))

    def j2():
        """Stage 3 on 2 devices from the ranks' step-2 checkpoint: a
        save, step 3."""
        eng = T.jax_engine(2, weights, Z.conf(2), size=Z.SIZE)
        _wait_for(os.path.join(dirs["port3"], "latest"))
        eng.load_checkpoint(dirs["port3"])
        loaded = T.jax_masters(eng)
        eng.save_checkpoint(dirs["jax2"])
        return loaded, T.jax_steps(eng, toks, 1), T.jax_masters(eng)
    # the two JAX engines compile side by side (XLA releases the GIL)
    with ThreadPoolExecutor(2) as pool:
        first, second = pool.submit(j1), pool.submit(j2)
        jax_runs = {"j1": first.result(), "j2": second.result()}
    return T.wait_ranks(handle), jax_runs


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _close(got_losses, got_master, want_losses, want_master,
           dtype="fp32"):
    tol = Z.TOL[dtype]
    np.testing.assert_allclose(got_losses, want_losses, rtol=tol["loss"])
    assert set(got_master) == set(want_master)
    for key, want in want_master.items():
        np.testing.assert_allclose(got_master[key], want, atol=tol["atol"],
                                   rtol=tol["rtol"], err_msg=key)


@pytest.mark.parametrize("run", ["g_bf16", "n_bf16"])
def test_four_ranks_match_jax_in_both_modes(port, jax_runs, run):
    losses, master, _ = jax_runs["j1"]
    got = port[0][run]
    assert got["dp_world_size"] == WORLD
    _close(got["losses"], got["master"], losses, master, "bf16")
    assert got["losses"][-1] < got["losses"][0]


def test_four_ranks_stage3_equals_stage2(port):
    got, want = port[0]["z3g"], port[0]["z2"]
    _close(got["losses"], got["master"], want["losses"], want["master"])


def test_each_rank_writes_its_stage3_zero_file(port, dirs):
    from deeperspeed_tpu_torch.checkpoint.serialization import load_obj
    tag = os.path.join(dirs["port3"], "global_step2")
    for rank in range(WORLD):
        name = f"zero_pp_rank_{rank}_mp_rank_00_optim_states.pt"
        assert name in port[rank]["z3g"]["written"]
        sd = load_obj(os.path.join(tag, name))
        assert (sd["zero_stage"], sd["partition_count"], sd["dp_rank"]) == \
            (3, WORLD, rank)
    assert "mp_rank_00_model_states.pt" in port[0]["z3g"]["written"]
    assert "mp_rank_00_model_states.pt" not in port[1]["z3g"]["written"]


def test_model_states_hold_the_gathered_parameters(port, dirs):
    from deeperspeed_tpu_torch.checkpoint.serialization import load_obj
    ms = load_obj(os.path.join(dirs["port3"], "global_step2",
                               "mp_rank_00_model_states.pt"))
    arrays = ms["module"]["arrays"]
    want = port[0]["z3g"]["masters_each_step"][1]
    assert set(arrays) == set(want)
    for key, value in want.items():
        # fp32 compute: the parameters are the masters
        np.testing.assert_array_equal(np.asarray(arrays[key]), value,
                                      err_msg=key)


def test_jax_loads_the_four_ranks_checkpoint_on_two_devices(port, jax_runs):
    """4 → 2: the JAX stage-3 engine merges the ranks' files exactly and
    takes the step the ranks took after the save."""
    loaded, losses, master = jax_runs["j2"]
    saved = port[0]["z3g"]["masters_each_step"][1]
    for key, value in saved.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)
    _close(losses, master, port[0]["z3g"]["losses"][2:],
           port[0]["z3g"]["master"])


def test_four_ranks_load_the_jax_two_device_checkpoint(port, jax_runs):
    """2 → 4: the ranks resume from the JAX engine's checkpoint and take
    the step it took."""
    _, losses, master = jax_runs["j2"]
    got = port[0]["z3_from_jax2"]
    _close(got["losses"], got["master"], losses, master)
    for other in port[1:]:
        assert other["z3_from_jax2"]["losses"] == got["losses"]


@pytest.mark.parametrize("resumed,run", [("z3_from_z2", "z2"),
                                         ("z2_from_z3", "z3g")])
def test_stage2_and_stage3_resume_each_other(port, resumed, run):
    got, want = port[0][resumed], port[0][run]
    _close(got["losses"], got["master"], want["losses"][2:], want["master"])


def test_zero_to_fp32_reads_a_stage3_directory(port, dirs):
    from deeperspeed_tpu_torch.utils import zero_to_fp32
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        os.path.join(dirs["port3"], "global_step2"))
    want = port[0]["z3g"]["masters_each_step"][1]
    assert set(sd) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(sd[key]), value,
                                      err_msg=key)


def test_consolidated_state_dict_matches_jax(port, jax_runs):
    _, _, want = jax_runs["j1"]
    flat = {}

    def walk(node, prefix=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (i,))
        else:
            flat["/".join(map(str, prefix))] = np.asarray(node)
    walk(want)
    got = port[0]["g_bf16"]["consolidated"]
    assert set(got) == set(flat)
    tol = Z.TOL["bf16"]
    for key, (dtype, value) in got.items():
        # the compute dtype: bf16 on both sides
        assert dtype == "torch.bfloat16" and flat[key].dtype.name == \
            "bfloat16"
        np.testing.assert_allclose(value, flat[key].astype(np.float32),
                                   atol=tol["atol"], rtol=tol["rtol"],
                                   err_msg=key)


def test_gathered_parameters_write_back(port, weights):
    """Mutating under `engine.gathered_parameters` edits the live
    partitioned state, masters AND compute parameters (the persisted
    row and every rank's shard), and training goes on from the edit."""
    before = np.asarray(weights["blocks"][1]["attn"]["qkv_w"])
    for res in port:
        got = res["edit0"]
        for field in ("master", "params"):
            leaf = got[field][EDIT_LEAF]
            np.testing.assert_array_equal(leaf[0], 3.25)
            np.testing.assert_array_equal(leaf[1:], before[1:])
        moved = res["edit1"]["master"][EDIT_LEAF][0]
        assert np.allclose(moved, 3.25, atol=0.02)
        assert not np.array_equal(moved, np.full_like(moved, 3.25))


def test_init_and_gathered_parameters_standalone(port):
    """`zero.Init` partitions each leaf at or above the persistence
    threshold 1/world a rank (the small one whole), `GatheredParameters`
    gathers every leaf whole, drops read-only mutations, writes rank
    0's back with the partition kept, and passes through when
    disabled."""
    w = API_TREE["w"]
    for rank, res in enumerate(port):
        got = res["zero_api"]
        assert got["current"] and got["after"]
        assert got["local"] == {"w": ((w.size // WORLD,), False),
                                "tiny": ((4,), True)}
        assert got["disabled_local"] == {"w": w.shape, "tiny": (4,)}
        for key, value in API_TREE.items():
            np.testing.assert_array_equal(got["gathered"][key], value)
        assert got["read_only_kept"]
        assert got["updated_local"] == (w.size // WORLD,)
        np.testing.assert_array_equal(got["updated"][0], 7.0)
        np.testing.assert_array_equal(got["updated"][1:], w[1:])
        assert got["passthrough"]


def test_init_on_one_rank_without_a_group():
    """Without a process group `Init` sees one rank: every leaf whole in
    one slice, the gather a copy."""
    from deeperspeed_tpu_torch.runtime import zero
    with zero.Init(stage=3, param_persistence_threshold=16) as ctx:
        params = ctx.materialize(lambda: {
            k: torch.as_tensor(v) for k, v in API_TREE.items()})
    assert params["w"].local.numel() == API_TREE["w"].size
    with zero.GatheredParameters(params, modifier_rank=0) as full:
        full["tiny"][:] = 9.0
    gp = zero.GatheredParameters(params, modifier_rank=0,
                                 select=lambda p: p == "tiny")
    with gp as full:
        assert isinstance(full["w"], zero.PartitionedParameter)
        full["tiny"][0] = 4.0
    np.testing.assert_array_equal(gp.updated["tiny"].full().numpy(),
                                  [4.0, -2.0, 3.0, 0.5])
    assert gp.updated["w"] is params["w"]
