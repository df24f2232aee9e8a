"""Shared set-up of the port's online-RL tests (`test_torch_rl_config.py`,
`test_torch_rl_losses.py`, `test_torch_rl_driver.py`,
`test_torch_rl_resume.py`): the tiny GPT-NeoX made in JAX and carried
into the port, the engines on both sides, the "rl" and "inference"
blocks, seeded prompts, a deterministic reward and a recording
monitor."""

import numpy as np

import jax

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox

# the JAX package's GPTNeoXConfig.tiny(): head dim 16, so every kernel
# wrapper takes its plain version on the CPU
SIZE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=128)


def rl_block(**kw):
    block = {"enabled": True, "loss": "ppo_clip",
             "rollouts_per_iteration": 8, "group_size": 2,
             "max_new_tokens": 4}
    block.update(kw)
    return block


def ds_config(**kw):
    """An RL training config: 8 update rows, Adam with an eps large
    enough that the first update is smooth in the gradients (a sign-like
    step would magnify the engines' rounding differences)."""
    cfg = {"train_batch_size": 8, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                    "eps": 1e-3}},
           "rl": rl_block()}
    cfg.update(kw)
    return cfg


def serve_config(**kw):
    block = {"enabled": True, "page_size": 16, "num_pages": 64,
             "max_batch_size": 4, "token_budget": 256,
             "prefill_lengths": [16, 32],
             "prefill_batch_sizes": [1, 2],
             "decode_batch_sizes": [1, 2, 4],
             "temperature": 1.0, "seed": 7}
    block.update(kw)
    return {"inference": block}


def jax_weights(seed=0):
    """(JAX model config, the natural params tree as numpy)."""
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jcfg, jax.device_get(jneox.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def jax_model():
    return jneox.GPTNeoX(jneox.GPTNeoXConfig(**SIZE), use_pallas=False)


def port_model(jparams, dtype=None):
    """The port's GPT-NeoX on the CPU holding ``jparams``; ``dtype``
    casts every parameter (bf16 compute)."""
    cfg = neox.GPTNeoXConfig(**SIZE)
    model = neox.GPTNeoX(cfg, device="cpu").load_jax_params(jparams)
    return model if dtype is None else model.to(dtype)


def jax_engine(jparams, conf):
    """The JAX engine on a one-device mesh."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    eng, *_ = deeperspeed_tpu.initialize(
        model=jax_model(), model_parameters=jparams, config_params=conf,
        mesh=mesh)
    return eng


def port_engine(jparams, conf, dtype=None):
    eng, *_ = dst.initialize(model=port_model(jparams, dtype),
                             config_params=conf)
    return eng


def prompts(n=4, lo=5, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, SIZE["vocab_size"],
                                       size=int(rng.integers(lo, hi)))))
            for _ in range(n)]


def reward(prompt, response):
    return float(sum(response) % 7)


class RecMonitor:
    """Records every scalar; counts flushes and closes."""

    def __init__(self):
        self.records = []
        self.closed = False
        self.flushes = 0

    def record(self, sample, scalars):
        self.records.append((sample, dict(scalars)))

    def observe_histogram(self, tag, value, edges=None):
        pass

    def flush(self, drain=True):
        self.flushes += 1

    def close(self):
        self.closed = True

    def tags(self):
        out = set()
        for _, sc in self.records:
            out.update(sc)
        return out
