"""The fp16 block-sparse dK/dV kernel rehearsed on the CPU, and an
overflowing loss-scaled fp16 backward whose non-finite dq, dk and dv
must sit where the plain version's are (`rehearse.py --only
block_sparse_fp16_dkv`). The fp16 forward and dQ cases are in
`test_torch_cpu_shim_sparse_fwd.py` and `test_torch_cpu_shim_sparse_dq.py`.
See `test_torch_cpu_shim.py`."""

import pytest

from torch_cpu_shim import rehearse, shim_build


@pytest.fixture(scope="module", autouse=True)
def built():
    shim_build()


def test_block_sparse_fp16_rehearses_on_the_cpu():
    rehearse("--only", "block_sparse_fp16_dkv")
