"""The data-parallel MoE engine on 2 gloo ranks routes the global
micro-batch, as the JAX engine on a 2-device data mesh does, on the CPU.

The JAX engine's loss sees the global micro-batch [micro · world, S], so
its MoE blocks resolve the routing groups and the capacity over every
rank's tokens, run one GShard queue over them and take the aux loss's
means over the whole group. The port's ranks (`tests/torch_dp_worker.py`)
each hold micro 2 of one global batch (one micro-batch a step) and
route it over the data-parallel group (`moe_ffn_dense(..., group=)`).
At the defaults (capacity factor 1.25, aux loss coefficient 0.01; 4
experts, top 2), with weights whose routing makes that capacity bind
(`torch_moe_ep.moe_weights`; `test_the_capacity_binds` holds the drop
fraction above 1%), for both dispatch engines, with one routing group
over the global micro-batch and with two whole groups on each rank: 2
fp32 steps at ZeRO stage 2, losses within rtol 1e-5, masters within
atol = rtol = 1e-4 (rank 0's; every rank's equal bit for bit). Routing
each rank's tokens alone (world times smaller capacity and queues, a
rank's aux statistics) fails this. `test_torch_moe_ep_dp4.py` is the
same on 4 ranks.
"""

import pytest

import torch_moe_ep as M

WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.dp_runs(WORLD, tmp_path_factory.mktemp("w"))


@pytest.mark.parametrize("name", [c[0] for c in M.dp_cases(WORLD)])
def test_moe_routes_the_global_micro_batch(runs, name):
    M.check_dp(*runs, name)


@pytest.mark.parametrize("groups", [1, 2 * WORLD])
def test_the_capacity_binds(groups):
    """The capacity factor of 1.25 drops copies of the global micro-batch
    (at step 1, in one process): the comparison above runs a route that
    binds."""
    assert M.drop_fraction(WORLD, groups) > 0.01
