"""The Hopper kernels rehearsed on the CPU: each case runs
`deeperspeed_tpu_torch/csrc/cpu_shim/rehearse.py --only <family>` in a
subprocess, which compiles the family's CUDA source with g++ against the
shim's stand-ins for the CUDA headers, runs the kernel through its
wrapper on CPU tensors (one thread per CUDA thread, TMA, mbarriers,
wgmma and mma.sync emulated) and holds it against the plain version.
What the rehearsal can and cannot see is in its docstring; only the card
can say that a source compiles for sm_90a and runs fast.

The sources are compiled once a checkout, before the first case
(`shim_build`: `rehearse.py --build-only` under a lock file, so the
files that run on other workers wait for the one compile), and no case's
time limit pays for g++. This file holds the quick families; the
block-sparse ones (emulated barrier by barrier, one thread per CUDA
thread: 80-300 s a family beside the rest of the suite) are split by
kernel and layout over `test_torch_cpu_shim_sparse_*.py` and
`test_torch_cpu_shim_fp16.py`, so that no file holds more than about
150 s and `--dist loadfile` spreads them."""

import pytest

from torch_cpu_shim import rehearse, shim_build

FAMILIES = ("quant_matmul", "grouped_matmul", "grouped_matmul_dw",
            "paged_decode", "paged_decode_int8", "adam",
            "paged_decode_fp16", "adam_fp16")


@pytest.fixture(scope="module")
def built():
    shim_build()


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_family_rehearses_on_the_cpu(family, built):
    rehearse("--only", family)
