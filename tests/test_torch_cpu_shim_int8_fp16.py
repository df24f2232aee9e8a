"""The fp16 int8 kernels rehearsed on the CPU, and the `adam` family on
the inputs a run over every family draws.

- `quant_matmul_fp16`: the int8 matmul's wgmma kernel with fp16
  activations at every plan, the widening read out bit for bit, and fp16
  outputs that overflow to inf where the plain version's do;
- `paged_decode_int8_fp16`: the cluster decode over int8 pools with fp16
  q;
- `adam` from the generator state `rehearse.py` reaches, run over all its
  families, before the `adam` family (`cpu_shim/adam_full_run.state`).
  On those inputs the plain Adam's `torch.sqrt`, which on the CPU is not
  rounded to nearest, once missed the kernel by one fp32 ulp of p.
"""

import pytest

from torch_cpu_shim import SHIM, rehearse, shim_build


@pytest.fixture(scope="module", autouse=True)
def built():
    """The sources compiled once a checkout, before the first case, so no
    case's time limit pays for g++."""
    shim_build()


@pytest.mark.parametrize("family", ("quant_matmul_fp16",
                                    "paged_decode_int8_fp16"))
def test_int8_fp16_family_rehearses_on_the_cpu(family):
    rehearse("--only", family)


def test_adam_family_on_the_full_runs_inputs():
    out = rehearse("--only", "adam", "--generator-state",
                   str(SHIM / "adam_full_run.state"))
    assert out.count("equal to the plain version bit for bit") == 7
