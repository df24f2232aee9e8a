"""The block-sparse forward kernel (mma.sync) rehearsed on the CPU at
D = 128 (its own tile step), one layout a case: the causal layout with
a global column, several LUT entries a row, the causal diagonal and a
row block dead under causal, the same with every LUT row reversed, and
the bidirectional layout with a dead row (`rehearse.py --only
block_sparse_fwd_d128 --case N`). See `test_torch_cpu_shim.py`."""

import pytest

from torch_cpu_shim import rehearse, shim_build


@pytest.fixture(scope="module", autouse=True)
def built():
    shim_build()


@pytest.mark.parametrize("case", range(3),
                         ids=["causal", "causal_reversed", "bidirectional"])
def test_block_sparse_fwd_d128_rehearses_on_the_cpu(case):
    rehearse("--only", "block_sparse_fwd_d128", "--case", str(case))
