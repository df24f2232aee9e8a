"""Checkpoints between the JAX package and the port, on the CPU.

Both engines train a tiny GPT-NeoX (2 layers, hidden 64) from the same
JAX-made weights on the same numpy batches; one saves, the other loads:

- JAX → port and port → JAX, bf16 with ZeRO-2 (a zero file) and fp32
  without ZeRO (the Adam state in the model-states file): the loaded
  masters, moments and parameters equal the saved ones bit for bit, and
  so do the Adam step, the LR, the loss-scale state and the four
  counters; then both take two more steps, the losses within
  `test_torch_train_engine.py`'s tolerances (bf16 rtol 2e-2, fp32 1e-5);
- a JAX checkpoint written on the 8-device CPU mesh (eight zero files
  of sliced leaves) merges onto the port's one card, bit for bit;
- the port's `zero_to_fp32.py`, shipped in the checkpoint, reads a JAX
  bf16 checkpoint's masters;
- a process where `import ml_dtypes` fails loads a JAX bf16 checkpoint
  through the port.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import (adam_state_from_jax,
                                                  flat_from_jax)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=64)
GAS, MICRO, S = 2, 2, 64
BF16 = {"enabled": True, "type": "bfloat16"}
FP32 = {"enabled": False}
ZERO2 = {"stage": 2}
NO_ZERO = {"stage": 0}
LOSS_RTOL = {"bf16": 2e-2, "fp32": 1e-5}
MODEL_STATES = "mp_rank_00_model_states.pt"
ZERO_FILE = "zero_pp_rank_{}_mp_rank_00_optim_states.pt"


def _config(fp16, zero, dp=1):
    return {
        "train_batch_size": GAS * MICRO * dp,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
            "warmup_num_steps": 5}},
        "gradient_clipping": 1.0,
        "fp16": fp16,
        "zero_optimization": zero,
    }


CASES = {"bf16": (BF16, ZERO2), "fp32": (FP32, NO_ZERO)}


@pytest.fixture(scope="module")
def weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jcfg, {seed: jax.device_get(jneox.init_params(
        jcfg, jax.random.PRNGKey(seed))) for seed in (0, 1)}


def _tokens(seed, dp=1):
    return np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO * dp, S)).astype(np.int32)


def _jax_engine(weights, conf, seed=0, devices=1):
    jcfg, params = weights
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:devices]), ("data",))
    eng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jcfg, use_pallas=False),
        model_parameters=params[seed], config_params=conf, mesh=mesh)
    return eng


def _port_engine(weights, conf, seed=0):
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(weights[1][seed])
    return dst.initialize(model=model, config_params=conf)[0]


def _jax_flats(jeng, names):
    """The JAX engine's masters (its fp32 parameters when it keeps
    none), compute parameters and Adam state as the port's flat
    tensors."""
    state = jax.device_get(jeng.state)
    params = flat_from_jax(jeng.params_to_natural(state.params), names)
    master = params if state.master is None else flat_from_jax(
        jax.device_get(jeng.layout_to_natural(jeng.state.master)), names)
    adam = adam_state_from_jax(jax.device_get(
        jeng.opt_layout_to_natural(jeng.state.opt_state)), names)
    return master, params, adam


def _assert_same_state(eng, jeng):
    """Every field a checkpoint carries, bit for bit."""
    master, params, adam = _jax_flats(jeng, eng.param_names)
    assert torch.equal(eng._master, master)
    assert torch.equal(eng._params_flat.float(), params)
    assert torch.equal(eng.opt_state.exp_avg, adam.exp_avg)
    assert torch.equal(eng.opt_state.exp_avg_sq, adam.exp_avg_sq)
    assert eng.opt_state.step == adam.step
    assert eng.get_lr() == jeng.get_lr()
    assert eng.optimizer.param_groups == jeng.optimizer.param_groups
    assert eng.lr_scheduler.last_batch_iteration == \
        jeng.lr_scheduler.last_batch_iteration
    scale = jax.device_get(jeng.state.scale)
    assert tuple(eng.scale_state) == (float(scale.cur_scale),
                                      int(scale.cur_iter),
                                      int(scale.last_overflow_iter),
                                      int(scale.cur_hysteresis))
    for counter in ("global_steps", "global_samples", "micro_steps",
                    "skipped_steps"):
        assert getattr(eng, counter) == getattr(jeng, counter), counter


def _files(ckpt_dir, zero):
    want = {MODEL_STATES, "manifest.json", "zero_to_fp32.py"}
    if zero:
        want.add(ZERO_FILE.format(0))
    assert set(os.listdir(ckpt_dir)) == want


def _steps(eng, tokens, n=2):
    return [float(eng.train_batch(batch=(tokens, tokens))) for _ in range(n)]


NAMES = [n for n, _ in neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE),
                                    device="cpu").named_parameters()]


@pytest.fixture(scope="module")
def jax_saves(weights, tmp_path_factory):
    """Per case: a JAX engine that trained 2 steps, its checkpoint
    directory, and its masters, parameters and Adam state at the save
    (the engine trains on in the tests)."""
    out = {}
    for kind, (fp16, zero) in CASES.items():
        jeng = _jax_engine(weights, _config(fp16, zero))
        _steps(jeng, _tokens(0))
        save_dir = str(tmp_path_factory.mktemp(f"jax_{kind}"))
        jeng.save_checkpoint(save_dir)
        out[kind] = (jeng, save_dir, _jax_flats(jeng, NAMES))
    return out


@pytest.mark.parametrize("kind", sorted(CASES))
def test_jax_checkpoint_loads_into_the_port(weights, jax_saves, kind):
    jeng, save_dir, _ = jax_saves[kind]
    _files(os.path.join(save_dir, "global_step2"), zero=kind == "bf16")
    eng = _port_engine(weights, _config(*CASES[kind]), seed=1)
    path, client = eng.load_checkpoint(save_dir)
    assert path == os.path.join(save_dir, "global_step2")
    assert client["ds_version"] == "0.3.15+tpu"
    _assert_same_state(eng, jeng)
    tokens = _tokens(1)
    np.testing.assert_allclose(_steps(eng, tokens), _steps(jeng, tokens),
                               rtol=LOSS_RTOL[kind])


@pytest.mark.parametrize("kind", sorted(CASES))
def test_port_checkpoint_loads_into_jax(weights, tmp_path, kind):
    conf = _config(*CASES[kind])
    eng = _port_engine(weights, conf)
    _steps(eng, _tokens(0))
    eng.save_checkpoint(str(tmp_path))
    _files(tmp_path / "global_step2", zero=kind == "bf16")
    jeng = _jax_engine(weights, conf, seed=1)
    path, _ = jeng.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step2")
    _assert_same_state(eng, jeng)
    tokens = _tokens(1)
    np.testing.assert_allclose(_steps(eng, tokens), _steps(jeng, tokens),
                               rtol=LOSS_RTOL[kind])


def test_dp8_jax_checkpoint_merges_onto_one_card(weights, tmp_path):
    """ZeRO-2 on the 8-device mesh writes eight zero files of leaf
    slices; the port merges them (the JAX package's elastic resume)."""
    jeng = _jax_engine(weights, _config(BF16, ZERO2, dp=8), devices=8)
    assert jeng.dp_world_size == 8
    _steps(jeng, _tokens(0, dp=8))
    jeng.save_checkpoint(str(tmp_path))
    ckpt = tmp_path / "global_step2"
    assert {ZERO_FILE.format(r) for r in range(8)} <= set(os.listdir(ckpt))
    shard = torch.load(ckpt / ZERO_FILE.format(0), weights_only=False)
    assert shard["partition_count"] == 8
    assert any(d is not None for d in shard["fp32_master_dims"].values())
    eng = _port_engine(weights, _config(BF16, ZERO2), seed=1)
    eng.load_checkpoint(str(tmp_path))
    _assert_same_state(eng, jeng)


def test_port_zero_to_fp32_reads_a_jax_checkpoint(weights, jax_saves,
                                                  tmp_path):
    """The port's script (numpy and torch only) widens nothing here: it
    returns the JAX engine's fp32 masters."""
    _, save_dir, (master, _, _) = jax_saves["bf16"]
    ckpt = os.path.join(save_dir, "global_step2")
    out = tmp_path / "fp32.pt"
    script = ROOT / "deeperspeed_tpu_torch" / "utils" / "zero_to_fp32.py"
    res = subprocess.run([sys.executable, str(script), ckpt, str(out)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    sd = torch.load(out, weights_only=False)
    assert sorted(sd) == sorted(n.replace(".", "/") for n in NAMES)
    got = torch.cat([torch.from_numpy(sd[n.replace(".", "/")]).reshape(-1)
                     for n in NAMES])
    assert torch.equal(got, master)


BLOCK_ML_DTYPES = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Block())
"""


def test_jax_bf16_checkpoint_loads_without_ml_dtypes(weights, jax_saves,
                                                     tmp_path):
    _, save_dir, (master, params, _) = jax_saves["bf16"]
    torch.save({"master": master, "params": params}, tmp_path / "want.pt")
    code = BLOCK_ML_DTYPES + f"""
import numpy as np, torch
import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models.gpt_neox import GPTNeoX, GPTNeoXConfig
try:
    import ml_dtypes
    raise SystemExit("ml_dtypes imported")
except ImportError:
    pass
m = GPTNeoX(GPTNeoXConfig(**{SIZE!r}), device="cpu").init_params(3)
eng = dst.initialize(model=m, config_params={_config(BF16, ZERO2)!r})[0]
eng.load_checkpoint({save_dir!r})
want = torch.load({str(tmp_path / "want.pt")!r})
assert torch.equal(eng._master, want["master"])
assert eng._params_flat.dtype == torch.bfloat16
assert torch.equal(eng._params_flat.float(), want["params"])
assert not any(n.split(".")[0] in ("ml_dtypes", "jax", "deeperspeed_tpu")
               for n in sys.modules)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
