"""The MoE routing statistics (``moe.observability``) of the port
against the JAX package's `ROUTING_STATS`, on the CPU: the same batch
and expert weights through both sort engines (fp32, top-1 and top-2,
one and two token groups, a capacity that drops copies) must give the
same four Train/MoE/* values (atol 1e-6: the load fractions are exact
counts over T·top_k, the cv a float64 mean and std of them). Then the
port alone: the statistics stay device tensors until `drain`, which
averages the duplicates a recomputed forward adds; the MAX_PENDING cap;
the einsum engine's refusal; and an engine with the block records the
four scalars at every step, with min ≤ 1/E ≤ max and the drop fraction
in [0, 1).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.moe import layer as jlayer
from deeperspeed_tpu_torch.moe import layer as layer

from tests.test_torch_telemetry_engine import _rows
from tests.torch_sentinel import config, jax_weights

torch.set_num_threads(2)

TAGS = ("Train/MoE/expert_load_min", "Train/MoE/expert_load_max",
        "Train/MoE/expert_load_cv", "Train/MoE/capacity_drop_fraction")
E, H, I, T = 4, 16, 32, 64


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w_in": rng.standard_normal((E, H, I)).astype(np.float32) * .2,
            "b_in": np.zeros((E, I), np.float32),
            "w_out": rng.standard_normal((E, I, H)).astype(np.float32) * .2,
            "b_out": np.zeros((E, H), np.float32),
            # a skewed gate: some experts take more than their capacity
            "gate": (rng.standard_normal((H, E)) +
                     np.linspace(0, 1.5, E)).astype(np.float32)}


def _jax_stats(params, x, **kw):
    jlayer.ROUTING_STATS.drain()
    y, _ = jlayer.moe_ffn_dense({k: jnp.asarray(v) for k, v in
                                 params.items()}, jnp.asarray(x),
                                dispatch="sort", observe=True, **kw)
    jax.block_until_ready(y)
    jax.effects_barrier()
    return jlayer.ROUTING_STATS.drain()


def _port_stats(params, x, **kw):
    layer.ROUTING_STATS.drain()
    layer.moe_ffn_dense({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), dispatch="sort", observe=True,
                        **kw)
    stats = layer.ROUTING_STATS.drain()
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in stats.values())
    return {k: float(v) for k, v in stats.items()}


@pytest.mark.parametrize("top_k,groups,capacity_factor", [
    (1, 1, 1.0), (2, 1, 1.25), (2, 2, 0.75), (1, 2, 2.0)])
def test_routing_stats_match_jax(top_k, groups, capacity_factor):
    params = _params()
    x = np.random.default_rng(1).standard_normal((T, H)).astype(np.float32)
    kw = dict(top_k=top_k, groups=groups, capacity_factor=capacity_factor)
    want, got = _jax_stats(params, x, **kw), _port_stats(params, x, **kw)
    assert set(got) == set(want) == set(TAGS)
    for tag in TAGS:
        assert got[tag] == pytest.approx(want[tag], abs=1e-6), tag
    assert got["Train/MoE/expert_load_min"] <= 1 / E <= \
        got["Train/MoE/expert_load_max"]
    assert 0.0 <= got["Train/MoE/capacity_drop_fraction"] < 1.0


def test_drain_averages_recomputed_duplicates_and_caps():
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (T, H)).astype(np.float32))
    layer.ROUTING_STATS.drain()
    layer.moe_ffn_dense(params, x, top_k=2, dispatch="sort", observe=True)
    once = layer.ROUTING_STATS.drain()
    for _ in range(3):      # a forward recomputed under remat repeats
        layer.moe_ffn_dense(params, x, top_k=2, dispatch="sort",
                            observe=True)
    assert layer.ROUTING_STATS.pending == 3
    thrice = layer.ROUTING_STATS.drain()
    for tag in TAGS:
        assert float(thrice[tag]) == pytest.approx(float(once[tag]),
                                                   abs=1e-12)
    assert layer.ROUTING_STATS.drain() is None
    cap = layer._RoutingStatsCollector.MAX_PENDING
    for _ in range(cap + 5):
        layer.ROUTING_STATS._record(torch.ones(E) / E, torch.tensor(0.0))
    assert layer.ROUTING_STATS.pending == cap
    with layer.ROUTING_STATS.suspended():
        layer.ROUTING_STATS._record(torch.ones(E), torch.tensor(1.0))
    assert layer.ROUTING_STATS.pending == cap
    layer.ROUTING_STATS.drain()
    with pytest.raises(ValueError, match="dispatch='sort'"):
        layer.moe_ffn_dense(params, x, dispatch="einsum", observe=True)


def test_engine_records_the_four_scalars(tmp_path):
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models import gpt_neox as neox
    from tests.torch_sentinel import SIZE, GAS, MICRO, S
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(jax_weights())
    conf = config("fp32", moe={"num_experts": E, "top_k": 2,
                               "dispatch": "sort", "observability": True},
                  tensorboard={"enabled": True, "output_path": str(tmp_path),
                               "job_name": "moe"},
                  activation_checkpointing={"policy": "full"})
    eng, *_ = dst.initialize(model=model, config_params=conf)
    tokens = np.random.default_rng(0).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S))
    for _ in range(3):
        eng.train_batch(batch=(tokens, tokens))
        assert layer.ROUTING_STATS.pending == 0
    eng.monitor.close()
    rows = _rows(os.path.join(tmp_path, "moe"))
    for tag in TAGS:
        assert [s for s, _ in rows[tag]] == [4, 8, 12], tag
    for i in range(3):
        lo, hi, drop = (rows[t][i][1] for t in (TAGS[0], TAGS[1], TAGS[3]))
        assert lo <= 1 / E <= hi and 0.0 <= drop < 1.0
