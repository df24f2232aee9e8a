"""The block-sparse dK/dV kernel (mma.sync) rehearsed on the CPU: bf16
at D = 64 and 128 on the causal layout with an unattended key block and
the bidirectional one with a dead row (`block_sparse_dkv`). fp16 is in
`test_torch_cpu_shim_fp16.py`. See `test_torch_cpu_shim.py`."""

import pytest

from torch_cpu_shim import rehearse, shim_build


@pytest.fixture(scope="module", autouse=True)
def built():
    shim_build()


def test_block_sparse_dkv_rehearses_on_the_cpu():
    rehearse("--only", "block_sparse_dkv")
