"""Shared set-up of the CPU-shim rehearsal tests
(`tests/test_torch_cpu_shim*.py`): the one compile a checkout and a
rehearsal in a subprocess."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

SHIM = (Path(__file__).resolve().parents[1] / "deeperspeed_tpu_torch" /
        "csrc" / "cpu_shim")
REHEARSE = SHIM / "rehearse.py"


def shim_build():
    """Every family's objects and libraries under build/cpu_shim/, once a
    checkout: `rehearse.py --build-only` holds a lock file there, so a
    file on another worker waits for the one compile and then finds every
    object built. Skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("the CPU shim compiles the CUDA sources with g++")
    res = subprocess.run([sys.executable, str(REHEARSE), "--build-only"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-4000:] + res.stderr[-4000:])


def rehearse(*args, timeout=300):
    """``rehearse.py *args`` in a subprocess; it must pass. → stdout."""
    res = subprocess.run([sys.executable, str(REHEARSE), *args],
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, (res.stdout[-4000:] + res.stderr[-4000:])
    assert res.stdout.strip().splitlines()[-1] == "rehearsal passed"
    return res.stdout
