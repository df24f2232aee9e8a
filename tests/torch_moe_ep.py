"""Shared set-up of the MoE-across-ranks engine tests: the MoE GPT-NeoX
of `torch_dp` (4 experts, top 2) with the JSON "moe" block at the
defaults that bind (capacity factor 1.25, aux loss coefficient 0.01),
the JAX engine on a 1-D ``("data",)`` or ``("expert",)`` mesh, and the
data-parallel comparison of `test_torch_moe_ep_dp2.py` /
`test_torch_moe_ep_dp4.py`.
"""

import numpy as np

import jax

import torch_dp as T

MOE_SIZE = dict(T.SIZE, **T.MOE_CFG)
STEPS = 2
# one micro-batch of 2 a rank and step: the JAX engine compiles a step
# without the accumulation scan in half the time
GAS, MICRO = 1, 2


def moe_weights():
    """`torch_dp.jax_weights` of the MoE model with each block's FFN
    layer-norm bias moved along its gate's first column: random tokens
    route about evenly through a random gate and leave a capacity factor
    of 1.25 idle; the shared offset favours expert 0 (about 40% of the
    copies), so the capacity binds (`drop_fraction`)."""
    weights = T.jax_weights(MOE_SIZE)
    for block in weights["blocks"]:
        col = block["mlp"]["gate"][:, 0]
        block["ln_mlp"]["bias"] = block["ln_mlp"]["bias"] + \
            col / np.linalg.norm(col)
    return weights


def config(world, dtype, stage, micro=MICRO, **extra):
    """`torch_dp.config` at this file's batch (gas 1, micro 2)."""
    return T.config(world, dtype, stage, micro=micro, gas=GAS, **extra)


def tokens(world):
    """The global batch [1, 2 · world, S]."""
    return T.tokens(world, micro=MICRO, gas=GAS)


def moe_block(dispatch="sort", groups=1, **kw):
    return dict({"num_experts": 4, "top_k": 2, "capacity_factor": 1.25,
                 "aux_loss_coef": 0.01, "dispatch": dispatch,
                 "num_groups": groups}, **kw)


def jax_engine(world, weights, conf, axis="data"):
    """The JAX engine on a ``world``-device 1-D mesh named ``axis`` (XLA
    attention), the MoE from the config's "moe" block."""
    import deeperspeed_tpu
    from deeperspeed_tpu.models import gpt_neox as jneox
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), (axis,))
    dense = {k: v for k, v in T.SIZE.items()}
    eng, *_ = deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jneox.GPTNeoXConfig(**dense), use_pallas=False),
        model_parameters=weights, config_params=conf, mesh=mesh)
    assert eng.dp_world_size == world
    return T.pin_scalars(eng)


def dp_cases(world):
    """(name, dispatch, groups) of the data-parallel comparison: both
    engines, one routing group over the global micro-batch and two whole
    groups on each rank."""
    whole = 2 * world
    return [(f"{d}_g{g}", d, g) for d in ("einsum", "sort")
            for g in (1, whole)]


def dp_runs(world, tmp_path):
    """(port results by rank, JAX references by case name) of the
    data-parallel MoE engine on ``world`` gloo ranks against the JAX
    engine on a ``world``-device data mesh, ZeRO stage 2, fp32."""
    weights = moe_weights()
    toks = tokens(world)
    confs = {name: config(world, "fp32", 2, moe=moe_block(d, g))
             for name, d, g in dp_cases(world)}
    handle = T.start_ranks(world, [
        dict(kind="train", name=name, size=MOE_SIZE, weights=weights,
             conf=conf, tokens=toks, steps=STEPS)
        for name, conf in confs.items()], tmp_path)
    ref = {}
    for name, conf in confs.items():
        eng = jax_engine(world, weights, conf)
        ref[name] = dict(losses=T.jax_steps(eng, toks, STEPS),
                         master=T.jax_masters(eng))
    return T.wait_ranks(handle), ref


def check_dp(port, ref, name):
    want = ref[name]
    got = port[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert set(got["master"]) == set(want["master"])
    for key, value in want["master"].items():
        np.testing.assert_allclose(got["master"][key], value, atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    for rank_res in port[1:]:
        for key, value in got["master"].items():
            np.testing.assert_array_equal(rank_res[name]["master"][key],
                                          value, err_msg=key)


def drop_fraction(world, groups):
    """The capacity-drop fraction of the first block over the global
    micro-batch at step 1 (one process, the sort engine's statistics):
    above 0 where the capacity binds."""
    import torch

    from deeperspeed_tpu_torch.models import gpt_neox as neox
    from deeperspeed_tpu_torch.models.convert import state_dict_from_jax
    from deeperspeed_tpu_torch.moe.layer import ROUTING_STATS
    cfg = neox.GPTNeoXConfig(**dict(
        MOE_SIZE, moe_dispatch="sort", moe_capacity_factor=1.25,
        moe_num_groups=groups, moe_observability=True))
    model = neox.GPTNeoX(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(moe_weights()))
    toks = torch.from_numpy(tokens(world)[0]).long()
    ROUTING_STATS.drain()
    with torch.no_grad():
        model.loss_fn(model.params_tree(), (toks, toks))
    return float(ROUTING_STATS.drain()["Train/MoE/capacity_drop_fraction"])
