"""The port's online-RL driver across a kill and a restart, on the CPU:

- a mid-iteration kill (`os._exit` in the reward callback) and a resume
  replay the killed iteration bit for bit (`tests/torch_rl_worker.py`,
  the counterpart of `tests/rl_worker.py`, in subprocesses);
- `resume()` restores the counters, the prompt cursor, the sampler and
  the buffer; returns False with no checkpoint; refuses a checkpoint
  without "rl" state with the JAX driver's words;
- the frozen-reference snapshot is written once and reloaded (never the
  trained weights), in the JAX driver's layout (the natural tree of
  numpy arrays, bf16 leaves as bf16): a snapshot the JAX driver wrote
  (fp32 and bf16) loads in the port bit for bit, and the port's loads in
  the JAX driver with the dtypes and reference logprobs of its own.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.checkpoint.serialization import load_obj as load_jax_obj
from deeperspeed_tpu.rl import RLDriver as JaxDriver
from deeperspeed_tpu.rl.driver import REF_SNAPSHOT as JAX_REF_SNAPSHOT
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

from deeperspeed_tpu_torch.checkpoint.serialization import load_obj
from deeperspeed_tpu_torch.models.convert import _flatten
from deeperspeed_tpu_torch.rl import RLDriver
from deeperspeed_tpu_torch.rl.driver import REF_SNAPSHOT
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

from tests.torch_rl import (ds_config, jax_engine, jax_weights,
                            port_engine, prompts, reward, serve_config)

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = {"enabled": True, "type": "bfloat16"}


@pytest.fixture(scope="module")
def jparams():
    return jax_weights(0)[1]


# ---------------------------------------------------------------------------
# mid-iteration kill -> bit-exact replay (subprocesses)
# ---------------------------------------------------------------------------

def _run_worker(workdir, total, kill):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "NODE_RANK",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    worker = os.path.join(REPO_ROOT, "tests", "torch_rl_worker.py")
    return subprocess.run(
        [sys.executable, worker, str(workdir), "log.txt", str(total),
         str(kill)], env=env, capture_output=True, text=True, timeout=300)


def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_mid_iteration_kill_resumes_bit_exact(tmp_path):
    ref_dir, kill_dir = tmp_path / "ref", tmp_path / "kill"
    ref_dir.mkdir()
    kill_dir.mkdir()
    ref = _run_worker(ref_dir, total=3, kill=0)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_rows = _read_log(ref_dir / "log.txt")
    assert [r["iteration"] for r in ref_rows] == [1, 2, 3]

    # incarnation 0: os._exit(9) inside iteration 2's reward pass, after
    # the rollouts, before the update, nothing committed for it
    first = _run_worker(kill_dir, total=3, kill=2)
    assert first.returncode == 9, first.stderr[-2000:]
    assert [r["iteration"] for r in _read_log(kill_dir / "log.txt")] == [1]

    # incarnation 1: resume from the iteration-1 boundary and replay
    second = _run_worker(kill_dir, total=3, kill=0)
    assert second.returncode == 0, second.stderr[-2000:]
    rows = _read_log(kill_dir / "log.txt")
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    # bit-exact: losses AND every sampled token match the run that was
    # never stopped, across the kill point too
    assert rows == ref_rows
    assert len({json.dumps(r["responses"]) for r in rows}) == 3


# ---------------------------------------------------------------------------
# resume()
# ---------------------------------------------------------------------------

def test_resume_restores_counters_and_sampler(jparams, tmp_path):
    ps = prompts(seed=14)
    drv = RLDriver(port_engine(jparams, ds_config()), ps, reward,
                   serve_config(), checkpoint_dir=str(tmp_path))
    drv.train(2)
    snap = drv.serve.sampler_state()
    assert snap["steps"] > 0

    fresh = RLDriver(port_engine(jparams, ds_config()), ps, reward,
                     serve_config(), checkpoint_dir=str(tmp_path))
    assert fresh.resume() is True
    assert (fresh.iteration, fresh.cursor) == (2, drv.cursor)
    assert fresh.serve.sampler_state() == snap
    assert fresh.buffer.consumed == drv.buffer.consumed == 16
    assert fresh.engine.global_steps == 2
    # both sides resume from the same policy: the restored weights were
    # swapped into the serving engine
    assert torch.equal(fresh.serve.params["embed"]["wte"],
                       drv.serve.params["embed"]["wte"])
    assert torch.equal(fresh.engine._params_flat, drv.engine._params_flat)
    # and the next iteration is the one the first driver would run
    got, want = fresh.run_iteration(), drv.run_iteration()
    for key in ("iteration", "loss", "mean_reward", "mean_kl",
                "rollout_tokens"):
        assert got[key] == want[key], key


def test_resume_without_checkpoint_returns_false(jparams, tmp_path):
    drv = RLDriver(port_engine(jparams, ds_config()), prompts(seed=15),
                   reward, serve_config(), checkpoint_dir=str(tmp_path))
    assert drv.resume() is False
    assert drv.iteration == 0


def test_resume_refuses_checkpoint_without_rl_state(jparams, tmp_path):
    drv = RLDriver(port_engine(jparams, ds_config()), prompts(seed=15),
                   reward, serve_config(), checkpoint_dir=str(tmp_path))
    drv.engine.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    with pytest.raises(DeepSpeedConfigError) as got:
        drv.resume()
    # the JAX driver's words for the same path
    path = got.value.args[0].split(" has no")[0][len("checkpoint "):]
    jdrv = object.__new__(JaxDriver)
    jdrv.checkpoint_dir = str(tmp_path)
    jdrv.engine = types.SimpleNamespace(
        load_checkpoint=lambda d, tag=None: (path, {"epoch": 3}))
    with pytest.raises(JaxConfigError) as want:
        jdrv.resume()
    assert str(got.value) == str(want.value)


def test_checkpoint_without_dir_raises_like_jax(jparams):
    drv = RLDriver(port_engine(jparams, ds_config()), prompts(seed=15),
                   reward, serve_config())
    jdrv = object.__new__(JaxDriver)
    jdrv.checkpoint_dir = None
    for call in ("resume", "save_checkpoint"):
        with pytest.raises(DeepSpeedConfigError) as got:
            getattr(drv, call)()
        with pytest.raises(JaxConfigError) as want:
            getattr(jdrv, call)()
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the frozen-reference snapshot
# ---------------------------------------------------------------------------

def test_ref_snapshot_written_once_and_reloaded(jparams, tmp_path):
    assert REF_SNAPSHOT == JAX_REF_SNAPSHOT
    ps = prompts(seed=16)
    drv = RLDriver(port_engine(jparams, ds_config()), ps, reward,
                   serve_config(), checkpoint_dir=str(tmp_path))
    ref_path = tmp_path / REF_SNAPSHOT
    assert ref_path.exists()
    before = ref_path.stat().st_mtime_ns
    initial = _flatten(drv.buffer._ref_params, "", {})
    drv.train(1)

    fresh = RLDriver(port_engine(jparams, ds_config()), ps, reward,
                     serve_config(), checkpoint_dir=str(tmp_path))
    assert fresh.resume()
    # the trained weights are NOT re-snapshotted as "reference"
    assert ref_path.stat().st_mtime_ns == before
    reloaded = _flatten(fresh.buffer._ref_params, "", {})
    assert not torch.equal(fresh.engine.params_to_natural()["embed.wte"],
                           initial["embed.wte"])
    for name, leaf in initial.items():
        assert torch.equal(reloaded[name], leaf), name


def test_snapshot_layout_is_the_jax_drivers(jparams, tmp_path):
    """The natural tree of numpy arrays; bf16 leaves as bf16 arrays (the
    port reads them as their uint16 words)."""
    RLDriver(port_engine(jparams, ds_config(fp16=BF16)), prompts(), reward,
             serve_config(), checkpoint_dir=str(tmp_path))
    tree = load_obj(str(tmp_path / REF_SNAPSHOT))
    assert isinstance(tree["blocks"], list) and isinstance(tree, dict)
    flat = _flatten(tree, "", {})
    want = _flatten(jparams, "", {})
    assert set(flat) == set(want)
    for name, leaf in flat.items():
        assert isinstance(leaf, np.ndarray) and leaf.dtype == np.uint16
        bf = torch.tensor(np.asarray(want[name], np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(leaf, bf, err_msg=name)
    jtree = _flatten(load_jax_obj(str(tmp_path / REF_SNAPSHOT)), "", {})
    for name, leaf in jtree.items():
        assert isinstance(leaf, np.ndarray) and \
            leaf.dtype == jax.numpy.bfloat16, name


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_jax_snapshot_loads_in_port(tmp_path, precision):
    """The JAX driver's snapshot of the seed-0 weights; the port's engine
    holds other weights (seed 1) and must take the file's."""
    extra = {"fp16": BF16} if precision == "bf16" else {}
    j0 = jax_weights(0)[1]
    JaxDriver(jax_engine(j0, ds_config(**extra)), prompts(), reward,
              serve_config(), checkpoint_dir=str(tmp_path))
    before = (tmp_path / REF_SNAPSHOT).stat().st_mtime_ns
    drv = RLDriver(port_engine(jax_weights(1)[1], ds_config(**extra)),
                   prompts(), reward, serve_config(),
                   checkpoint_dir=str(tmp_path))
    assert (tmp_path / REF_SNAPSHOT).stat().st_mtime_ns == before
    ref = _flatten(drv.buffer._ref_params, "", {})
    want = _flatten(j0, "", {})
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    for name, leaf in want.items():
        assert ref[name].dtype == dtype
        assert torch.equal(ref[name], torch.tensor(
            np.asarray(leaf, np.float32)).to(dtype)), name


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_port_snapshot_loads_in_jax(tmp_path, precision):
    """The port's snapshot of the seed-1 weights; the JAX engine holds
    the seed-0 weights and must take the file's: the seed-1 leaves in the
    dtypes of the JAX engine's natural tree (what the JAX driver
    snapshots), and so the reference logprobs a JAX-written snapshot
    gives."""
    extra = {"fp16": BF16} if precision == "bf16" else {}
    j1 = jax_weights(1)[1]
    RLDriver(port_engine(j1, ds_config(**extra)), prompts(), reward,
             serve_config(), checkpoint_dir=str(tmp_path))
    jdrv = JaxDriver(jax_engine(jax_weights(0)[1], ds_config(**extra)),
                     prompts(), reward, serve_config(),
                     checkpoint_dir=str(tmp_path))
    eng = jdrv.engine
    own = jax.tree_util.tree_map(
        lambda leaf, like: jax.numpy.asarray(leaf).astype(like.dtype), j1,
        eng.params_to_natural(eng.state.params))
    want = _flatten(jax.device_get(own), "", {})
    ref = _flatten(jax.device_get(jdrv.buffer._ref_params), "", {})
    assert set(ref) == set(want)
    for name, leaf in want.items():
        got = np.asarray(ref[name])
        assert got.dtype == leaf.dtype, name
        np.testing.assert_array_equal(got, leaf, err_msg=name)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (4, 16), 1,
                                           512), np.int32)
    own_logp = np.asarray(jdrv.buffer._ref_logp(own, tokens))
    np.testing.assert_array_equal(jdrv.buffer.ref_logprobs(tokens), own_logp)
