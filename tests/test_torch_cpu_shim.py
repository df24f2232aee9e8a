"""The Hopper kernels rehearsed on the CPU: each case runs
`deeperspeed_tpu_torch/csrc/cpu_shim/rehearse.py --only <family>` in a
subprocess, which compiles the family's CUDA source with g++ against the
shim's stand-ins for the CUDA headers, runs the kernel through its
wrapper on CPU tensors (one thread per CUDA thread, TMA, mbarriers,
wgmma and mma.sync emulated) and holds it against the plain version.
What the rehearsal can and cannot see is in its docstring; only the card
can say that a source compiles for sm_90a and runs fast.

The sources are compiled once, before the first case (`built`), so no
case's time limit pays for g++, and the block-sparse forward runs as two
cases (D = 64 and D = 128): the emulation (one thread per CUDA thread,
barrier-bound) took 20-134 s alone on an idle 8-core host and several
times that beside other work, and under the whole suite's load the
first block-sparse case, with the compile, passed 300 s."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REHEARSE = (Path(__file__).resolve().parents[1] / "deeperspeed_tpu_torch" /
            "csrc" / "cpu_shim" / "rehearse.py")
FAMILIES = ("quant_matmul", "grouped_matmul", "grouped_matmul_dw",
            "block_sparse_fwd", "block_sparse_fwd_d128", "block_sparse_dkv",
            "block_sparse_dq",
            "paged_decode", "paged_decode_int8", "adam",
            "paged_decode_fp16", "adam_fp16")


@pytest.fixture(scope="module")
def built():
    """Every family's objects and libraries under build/cpu_shim/."""
    if shutil.which("g++") is None:
        pytest.skip("the CPU shim compiles the CUDA sources with g++")
    res = subprocess.run([sys.executable, str(REHEARSE), "--build-only"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-4000:] + res.stderr[-4000:])


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_family_rehearses_on_the_cpu(family, built):
    res = subprocess.run([sys.executable, str(REHEARSE), "--only", family],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-4000:] + res.stderr[-4000:])
    assert res.stdout.strip().splitlines()[-1] == "rehearsal passed"
