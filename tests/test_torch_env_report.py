"""The port's environment report and op registry on the CPU (no nvcc,
no card): every C entry point of the kernel library
(`ops/hopper/_build.SIGNATURES`) is a row of the op report and reads
unavailable, the Python ops read available, ``python -m
deeperspeed_tpu_torch.env_report [--json]`` exits 0, and
`ops.dispatch_report` keeps the JAX package's keys, with the design each
wrapper last ran ("plain" for the plain versions here).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from deeperspeed_tpu.ops import dispatch_report as jax_dispatch_report
from deeperspeed_tpu_torch import env_report
from deeperspeed_tpu_torch.ops import dispatch_report
from deeperspeed_tpu_torch.ops import compat
from deeperspeed_tpu_torch.ops.hopper import _build
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
from deeperspeed_tpu_torch.ops.op_builder import (ALL_OPS,
                                                  HopperKernelBuilder)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def test_op_report_lists_every_kernel_unavailable(capsys):
    assert list(compat.kernel_ops()) == list(_build.SIGNATURES)
    rows = dict(env_report.op_report())
    out = capsys.readouterr().out
    for symbol in _build.SIGNATURES:
        assert rows[symbol] is False and symbol in out
    for name in ("fused_adam", "fused_lamb", "transformer",
                 "stochastic_transformer", "sparse_attn", "utils"):
        assert rows[name] is True
    assert isinstance(ALL_OPS["ds_flash_fwd"], HopperKernelBuilder)
    with pytest.raises(RuntimeError, match="CUDA|nvcc"):
        ALL_OPS["ds_adam"].load()


@pytest.mark.parametrize("args", [[], ["--json"]])
def test_module_runs_and_exits_zero(args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "deeperspeed_tpu_torch.env_report", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    if args:
        report = json.loads(proc.stdout)
        assert report["env"]["torch"] == torch.__version__
        assert report["env"]["device_count"] == 0
        assert all(not report["ops"][s] for s in _build.SIGNATURES)
        assert set(report["dispatch"]) == set(jax_dispatch_report())
    else:
        assert "op/kernel report" in proc.stdout
        assert "environment info" in proc.stdout


def test_dispatch_report_keys_and_plain_designs():
    fa.LAST_DESIGN.clear()
    da.LAST_DESIGN.clear()
    qm.LAST_DESIGN.clear()
    report = dispatch_report()
    assert set(report) == set(jax_dispatch_report()) == {
        "flash", "decode_attention", "quant_matmul"}
    assert report == {"flash": {}, "decode_attention": {},
                      "quant_matmul": {}}
    q = torch.randn(1, 128, 2, 16, requires_grad=True)
    fa.flash_attention_segmented(q, q, q).sum().backward()
    w = qm.quantize_weight(torch.randn(16, 32))
    qm.quant_matmul(torch.randn(4, 16), w)
    report = dispatch_report()
    assert report["flash"] == {"fwd": "plain", "bwd": "plain"}
    assert report["quant_matmul"] == {"quant_matmul": "plain"}


def test_env_fingerprint_without_a_card():
    env = env_report.env_fingerprint()
    assert env["cuda_available"] is False and env["device_name"] is None
    assert env["deeperspeed_tpu_torch"]
    assert env_report.main(["--json"]) == 0
