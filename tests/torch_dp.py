"""Shared set-up of the data-parallel tests: the JAX engine on a
``world``-device data mesh and the port on ``world`` gloo ranks (each a
child process running `tests/torch_dp_worker.py`), from the same weights
and the same global batch.

`start_ranks` starts the children on a free port and returns at once
(the JAX references compile while the ranks train); `wait_ranks`
collects every rank's results within the children's deadline (a hang
fails the test that started it, not the suite).
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# one layer keeps the JAX engine's compile short. An odd width and
# vocabulary: no dimension of the embeddings, the layer norms or the qkv
# weight divides a world of 2 or 4, so those are ragged leaves ("flat" in
# the JAX layout), and the 47,565 parameters need padding to the
# partition alignment at both worlds (rotary_pct 0.4: 6 of the 15 head
# dimensions, an even count)
SIZE = dict(vocab_size=251, hidden_size=45, num_layers=1, num_heads=3,
            max_seq_len=64, rotary_pct=0.4)
MOE_CFG = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=4.0,
               moe_dispatch="sort")
GAS, MICRO, SEQ = 2, 2, 64
# a rank's process-group timeout (a collective left waiting by a hung
# peer fails after it), and the deadline of a whole set of ranks, which
# also covers their start-up on a loaded host
GROUP_TIMEOUT, CHILD_TIMEOUT = 120, 180


def config(world, dtype="fp32", stage=2, micro=MICRO, gas=GAS, **extra):
    """The DeepSpeed config of one rank (the JAX engine's is the same:
    the batch triple resolves against its world)."""
    fp16 = {"fp32": {"enabled": False},
            "bf16": {"enabled": True, "type": "bfloat16"},
            "fp16": {"enabled": True, "loss_scale": 0,
                     "initial_scale_power": 32, "hysteresis": 1,
                     "loss_scale_window": 1000, "min_loss_scale": 1}}[dtype]
    conf = {
        "train_batch_size": gas * micro * world,
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "fp16": fp16,
        "zero_optimization": {"stage": stage},
    }
    conf.update(extra)
    return conf


def jax_weights(size=SIZE, seed=0):
    """A JAX GPT-NeoX params tree of numpy leaves drawn from ``seed``
    (the JAX init's tree, traced for its shapes only: no compile)."""
    from deeperspeed_tpu.models import gpt_neox as jneox
    cfg = jneox.GPTNeoXConfig(**size)
    shapes = jax.eval_shape(lambda k: jneox.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return x + 1 if "scale" in name else x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tokens(world, micro=MICRO, gas=GAS, vocab=SIZE["vocab_size"], seed=0):
    """The global batch [gas, micro · world, S]."""
    return np.random.default_rng(seed).integers(
        0, vocab, size=(gas, micro * world, SEQ)).astype(np.int32)


def jax_engine(world, weights, conf, size=SIZE):
    """The JAX engine on a ``world``-device data mesh (XLA attention:
    the port's CPU path is the plain version too)."""
    import deeperspeed_tpu
    from deeperspeed_tpu.models import gpt_neox as jneox
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("data",))
    dense = {k: v for k, v in size.items() if not k.startswith("moe_")}
    eng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jneox.GPTNeoXConfig(**dense), use_pallas=False),
        model_parameters=weights, config_params=conf, mesh=mesh)
    assert eng.dp_world_size == world
    return pin_scalars(eng)


def pin_scalars(eng):
    """Place the state's scalars (counters, loss scale) replicated on the
    mesh, where the first step leaves them: the first step's program then
    serves every later step (one XLA compile, not two)."""
    from jax.sharding import NamedSharding, PartitionSpec
    rep = NamedSharding(eng.mesh, PartitionSpec())
    eng.state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, rep) if getattr(x, "ndim", 1) == 0
        else x, eng.state)
    return eng


def jax_steps(eng, toks, steps):
    return [float(eng.train_batch(batch=(toks, toks))) for _ in range(steps)]


def jax_masters(eng):
    """The JAX engine's fp32 masters (its parameters where it keeps
    none) as {path key: numpy}."""
    from deeperspeed_tpu_torch.checkpoint.serialization import path_key
    from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
    tree = eng.layout_to_natural(eng.state.master) \
        if eng.state.master is not None else eng.state.params
    return {path_key(k): np.asarray(v.float().numpy()) for k, v in
            state_dict_from_jax(jax.device_get(tree)).items()}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world, cases, tmp_path, timeout=CHILD_TIMEOUT):
    """Start ``world`` gloo ranks running ``cases`` (`torch_dp_worker`
    case dicts) and return at once: the JAX references can compile while
    they run. `wait_ranks` collects them."""
    tmp_path = str(tmp_path)
    spec = os.path.join(tmp_path, f"spec_w{world}.pkl")
    out = os.path.join(tmp_path, f"out_w{world}")
    os.makedirs(out, exist_ok=True)
    with open(spec, "wb") as f:
        pickle.dump({"cases": cases, "timeout": GROUP_TIMEOUT}, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dp_worker.py"), spec,
             out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs, out, time.monotonic() + timeout


def wait_ranks(handle):
    """Every rank's results ([rank 0's, rank 1's, ...]) of `start_ranks`;
    a rank past its deadline is killed and fails the caller."""
    procs, out, deadline = handle
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n" \
            f"{log[-4000:]}"
    results = []
    for rank in range(len(procs)):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_ranks(world, cases, tmp_path, timeout=CHILD_TIMEOUT):
    """Run ``cases`` on ``world`` gloo ranks; returns every rank's
    results."""
    return wait_ranks(start_ranks(world, cases, tmp_path, timeout))
