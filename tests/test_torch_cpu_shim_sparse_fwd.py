"""The block-sparse forward kernel (mma.sync) rehearsed on the CPU at
D = 64, one layout a case (`rehearse.py --only block_sparse_fwd --case
N`: the causal layout with a global column and a row block dead under
causal, the same with every LUT row reversed, the bidirectional layout
with a dead row), and in fp16 (`block_sparse_fp16_fwd`, D = 64 and 128).
See `test_torch_cpu_shim.py`."""

import pytest

from torch_cpu_shim import rehearse, shim_build


@pytest.fixture(scope="module", autouse=True)
def built():
    shim_build()


@pytest.mark.parametrize("case", range(3),
                         ids=["causal", "causal_reversed", "bidirectional"])
def test_block_sparse_fwd_d64_rehearses_on_the_cpu(case):
    rehearse("--only", "block_sparse_fwd", "--case", str(case))


def test_block_sparse_fwd_fp16_rehearses_on_the_cpu():
    rehearse("--only", "block_sparse_fp16_fwd")
