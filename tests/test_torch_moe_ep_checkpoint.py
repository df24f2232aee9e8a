"""Checkpoints of the port's engine on a 1-D "expert" mesh, both ways
with the JAX engine on a 2-device ``("expert",)`` mesh, on the CPU.

bf16 compute at ZeRO stage 0 (fp32 masters apart from the parameters,
so the JAX engine writes its one zero file, whole leaves: the layout of
its dp-1 writer at stage 0). The port's 2 gloo ranks
(`tests/torch_dp_worker.py`) each hold 2 of the 4 experts; rank 0 writes
the model states and the zero file with every expert leaf whole
(gathered over the ranks at save, sliced at load). Checked:

- the port's checkpoint after 2 steps loads into the JAX engine with the
  masters bit-equal to the port's at the save, and the JAX engine's next
  step's loss within bf16's rtol 1e-3 of the port's;
- the JAX engine's checkpoint after 2 steps loads into the port (masters
  bit-equal to the JAX engine's at the save), and the port's next step's
  loss within rtol 1e-3 of the JAX engine's, its masters within atol
  1e-2;
- a fresh port engine resumed from its own checkpoint takes the step the
  saving run took, bit for bit (loss and masters);
- an elastic resume (the 2-rank checkpoint on 1 rank of an "expert"
  mesh) is refused, naming A.6.
"""

import os
import time

import numpy as np
import pytest

import torch_dp as T
import torch_moe_ep as M

WORLD = 2


def _conf():
    return M.config(WORLD, "bf16", 0, moe=M.moe_block())


def _wait(path, timeout=150):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    port_dir, jax_dir = str(tmp / "port"), str(tmp / "jax")
    marker = str(tmp / "jax_saved")
    weights = M.moe_weights()
    toks = M.tokens(WORLD)
    base = dict(kind="train", size=M.MOE_SIZE, weights=weights,
                conf=_conf(), tokens=toks, mesh="expert")
    handle = T.start_ranks(WORLD, [
        dict(base, name="save", steps=3, save=port_dir, save_at=2,
             masters_each_step=True),
        dict(base, name="resume", steps=1, load=port_dir),
        dict(base, name="from_jax", steps=1, load=jax_dir,
             wait_for=marker)], tmp / "ranks")
    ref = {}
    eng = M.jax_engine(WORLD, weights, _conf(), "expert")
    ref["losses"] = T.jax_steps(eng, toks, 2)
    eng.save_checkpoint(jax_dir)
    ref["saved_master"] = T.jax_masters(eng)
    open(marker, "w").close()
    ref["losses"] += T.jax_steps(eng, toks, 1)
    ref["master"] = T.jax_masters(eng)
    # the port's checkpoint into a fresh JAX engine
    _wait(os.path.join(port_dir, "latest"))
    eng = M.jax_engine(WORLD, weights, _conf(), "expert")
    eng.load_checkpoint(port_dir)
    ref["loaded_port_master"] = T.jax_masters(eng)
    ref["after_port"] = T.jax_steps(eng, toks, 1)
    port = T.wait_ranks(handle)
    one = M.config(1, "bf16", 0, micro=WORLD * M.MICRO, moe=M.moe_block())
    elastic = T.run_ranks(1, [dict(base, name="elastic", conf=one, steps=1,
                                   load=port_dir, load_error=True)],
                          tmp / "one")
    return port, ref, elastic


def test_port_checkpoint_loads_into_the_jax_engine(runs):
    port, ref, _ = runs
    saved = port[0]["save"]["masters_each_step"][1]
    assert set(saved) == set(ref["loaded_port_master"])
    for key, value in saved.items():
        np.testing.assert_array_equal(ref["loaded_port_master"][key], value,
                                      err_msg=key)
    np.testing.assert_allclose(ref["after_port"][0],
                               port[0]["save"]["losses"][2], rtol=1e-3)


def test_jax_checkpoint_loads_into_the_port(runs):
    port, ref, _ = runs
    for rank in range(WORLD):
        got = port[rank]["from_jax"]
        for key, value in ref["saved_master"].items():
            np.testing.assert_array_equal(got["loaded_master"][key], value,
                                          err_msg=key)
        np.testing.assert_allclose(got["losses"][0], ref["losses"][2],
                                   rtol=1e-3)
        for key, value in ref["master"].items():
            np.testing.assert_allclose(got["master"][key], value, atol=1e-2,
                                       rtol=0, err_msg=key)


def test_resume_at_the_same_world_is_bit_identical(runs):
    port, _, _ = runs
    for rank in range(WORLD):
        saved, resumed = port[rank]["save"], port[rank]["resume"]
        assert resumed["losses"][0] == saved["losses"][2]
        for key, value in saved["master"].items():
            np.testing.assert_array_equal(resumed["master"][key], value,
                                          err_msg=key)


def test_elastic_resume_with_experts_is_refused(runs):
    _, _, elastic = runs
    msg = elastic[0]["elastic"]["load_error"]
    assert "elastic" in msg and "A.6" in msg and "world 2" in msg
