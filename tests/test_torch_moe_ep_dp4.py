"""The data-parallel MoE engine on 4 gloo ranks routes the global
micro-batch, as the JAX engine on a 4-device data mesh does, on the CPU:
`test_torch_moe_ep_dp2.py`'s comparison (both dispatch engines, one
routing group over the global micro-batch and two whole groups on each
rank, binding capacity, aux loss coefficient 0.01) at world 4.
"""

import pytest

import torch_moe_ep as M

WORLD = 4


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
