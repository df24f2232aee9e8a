"""The block-sparse dQ kernel (mma.sync) rehearsed on the CPU: bf16 at
D = 64 and 128 on the three layouts (`block_sparse_dq`), and fp16
(`block_sparse_fp16_dq`). See `test_torch_cpu_shim.py`."""

import pytest

from torch_cpu_shim import rehearse, shim_build


@pytest.fixture(scope="module", autouse=True)
def built():
    shim_build()


@pytest.mark.parametrize("family", ("block_sparse_dq",
                                    "block_sparse_fp16_dq"))
def test_block_sparse_dq_rehearses_on_the_cpu(family):
    rehearse("--only", family)
