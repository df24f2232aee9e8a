"""The fp16 block-sparse kernels rehearsed on the CPU: `rehearse.py
--only block_sparse_fp16` in a subprocess (the forward, dQ and dK/dV
kernels of `csrc/block_sparse_attention.cu` instantiated for fp16 against
their plain versions, and an overflowing loss-scaled backward whose
non-finite gradients must sit where the plain version's do). A file of
its own, so that `--dist loadfile` runs it beside the other rehearsals."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REHEARSE = (Path(__file__).resolve().parents[1] / "deeperspeed_tpu_torch" /
            "csrc" / "cpu_shim" / "rehearse.py")


def test_block_sparse_fp16_rehearses_on_the_cpu():
    if shutil.which("g++") is None:
        pytest.skip("the CPU shim compiles the CUDA sources with g++")
    res = subprocess.run([sys.executable, str(REHEARSE), "--only",
                          "block_sparse_fp16"], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, (res.stdout[-4000:] + res.stderr[-4000:])
    assert res.stdout.strip().splitlines()[-1] == "rehearsal passed"
