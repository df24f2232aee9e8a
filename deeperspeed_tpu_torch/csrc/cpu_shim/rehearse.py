"""Rehearse the int8 matmul and grouped-matmul kernels on the CPU.

    python deeperspeed_tpu_torch/csrc/cpu_shim/rehearse.py [--keep]

Copies `csrc/quant_matmul.cu`, `csrc/grouped_matmul.cu` and
`csrc/errors.cu` next to this directory's stand-ins for the CUDA headers
and for `common.cuh` / `hopper_gemm.cuh`, compiles them with g++ into a
shared library under `build/cpu_shim/`, and hands that library to the
wrappers of `ops/hopper/` in place of the nvcc build. The wrappers then
run their kernels on CPU tensors, one thread per CUDA thread, and each
result is held against the plain PyTorch version:

- the int8 matmul at every plan the wrapper picks for a set of small
  shapes (token tiles 16 / 32 / 64 with swapped operands, 128-row tiles,
  clusters of 1-8 CTAs, ragged M, N and K), bf16 within 2e-2 of max|ref|
  (chip_smoke's TOL_QMM); one-hot x over a weight that holds all 256
  int8 values, bit for bit; two calls bit-identical;
- the grouped matmul's forward and dx (wgmma) and dW (mma.sync) on spans
  that no 128-row tile divides, dead rows filled with NaN: within 1e-2 of
  max|ref| (TOL_GMM), dead rows exact zeros, dW within 1e-4 (fp32).

It checks indexing, tiling, the mbarrier ring, the TMA box and swizzle,
the descriptors' layouts and the cluster reduction against one reading
of the hardware's rules (`hopper_gemm.cuh` here says which); it cannot
check that reading, speed, or sm_90a code generation: only the card can.
Exits non-zero on the first disagreement.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent
REPO = CSRC.parents[1]
sys.path.insert(0, str(REPO))

from deeperspeed_tpu_torch.ops.hopper import _build  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm  # noqa: E402

SOURCES = ("quant_matmul.cu", "grouped_matmul.cu", "errors.cu")
OUT = REPO / "build" / "cpu_shim"


def shim_source(text):
    """A kernel source as g++ takes it under the shim: dynamic shared
    memory is the CTA's buffer, and `k<<<grid, block, smem, stream>>>(a)`
    is a call of the shim's launcher."""
    text = re.sub(r"extern __shared__[^;]*?(\w+)\[\];",
                  r"unsigned char* \1 = shim::self.block->smem;", text)
    return re.sub(r"([\w:]+(?:<[^;<>]*>)?)<<<([^;]*?)>>>\(",
                  r"shim::Launcher(\2).run(\1, ", text)


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    for name in ("cuda_shim.h", "cuda.h", "cuda_runtime.h", "cuda_bf16.h",
                 "common.cuh", "hopper_gemm.cuh"):
        shutil.copy(HERE / name, OUT / name)
    srcs = []
    for name in SOURCES:
        dst = OUT / (Path(name).stem + ".cpp")
        dst.write_text(shim_source((CSRC / name).read_text()))
        srcs.append(str(dst))
    lib = OUT / "libds_shim_kernels.so"
    cmd = ["g++", "-std=c++20", "-O1", "-g", "-fPIC", "-shared", "-pthread",
           f"-I{OUT}", "-include", "cuda_shim.h", *srcs, "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"g++ failed:\n{res.stderr[-6000:]}")
    return lib


def load(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    for name in ("ds_quant_matmul", "ds_grouped_matmul",
                 "ds_grouped_matmul_dw"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.ds_error_string.argtypes = [ctypes.c_int]
    lib.ds_error_string.restype = ctypes.c_char_p
    _build._LIB = lib
    _build.load_library = lambda: lib
    _build.stream_ptr = lambda t: None
    return lib


def fail(msg):
    sys.exit(f"rehearsal FAILED: {msg}")


def rel_err(got, want):
    w = want.float()
    return float((got.float() - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)


def check_quant_matmul(gen):
    plans = set()
    for M, K, N in ((16, 256, 256), (7, 104, 80), (20, 128, 128),
                    (64, 192, 256), (130, 128, 256), (16, 1024, 128),
                    (256, 512, 128), (1, 64, 16), (100, 128, 128),
                    (300, 192, 256)):
        x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
        qw = qm.quantize_weight(0.02 * torch.randn(K, N, generator=gen))
        plan = qm.launch_plan(M, N, K)
        plans.add(plan[:2])
        got = qm.quant_matmul_cuda(x, qw)
        again = qm.quant_matmul_cuda(x, qw)
        err = rel_err(got, qm.quant_matmul_reference(x, qw))
        print(f"  quant_matmul M={M} K={K} N={N} plan {plan}: rel err "
              f"{err:.2e}", flush=True)
        if err > 2e-2 or not torch.isfinite(got.float()).all():
            fail(f"int8 matmul M={M} K={K} N={N}: rel err {err}")
        if not torch.equal(got, again):
            fail(f"int8 matmul M={M} K={K} N={N}: two calls differ")
    # plans the wrapper picks only at larger shapes (256-token tiles) or
    # at other widths
    orig = qm.launch_plan
    for M, K, N, plan in ((300, 256, 256, (256, 1)), (40, 256, 128, (64, 4)),
                          (200, 512, 128, (128, 2))):
        qm.launch_plan = lambda *a, plan=plan: plan + (0,)
        x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
        qw = qm.quantize_weight(0.02 * torch.randn(K, N, generator=gen))
        err = rel_err(qm.quant_matmul_cuda(x, qw),
                      qm.quant_matmul_reference(x, qw))
        plans.add(plan)
        print(f"  quant_matmul M={M} K={K} N={N} plan {plan} (forced): rel "
              f"err {err:.2e}", flush=True)
        if err > 2e-2:
            fail(f"int8 matmul M={M} K={K} N={N} plan {plan}: rel err {err}")
    qm.launch_plan = orig
    # every int8 value widens exactly: y[m, n] = bf16(q[m, n] * scale[n])
    for M in (16, 200):
        K, N = 256, 128
        q = (torch.arange(K * N) % 256 - 128).to(torch.int8).reshape(K, N)
        scale = torch.rand(N, generator=gen) + 0.5
        qw = qm.QuantizedWeight(q, scale)
        x = torch.zeros(M, K, dtype=torch.bfloat16)
        x[torch.arange(M), torch.arange(M) % K] = 1.0
        got = qm.quant_matmul_cuda(x, qw)
        want = qm.quant_matmul_reference(x, qw)
        if not torch.equal(got, want):
            fail(f"int8 conversion readout (M={M}): "
                 f"{int((got != want).sum())} mismatches")
        print(f"  quant_matmul int8 readout M={M}: bit-equal", flush=True)
    print(f"  plans covered: {sorted(plans)}", flush=True)


def check_grouped_matmul(gen):
    for sizes, span, K, N, W, lut in (
            ((200, 57, 0, 0, 133, 200), 200, 64, 96, 3, (0, 0, 1, 1, 2, 2)),
            ((130, 0, 72), 136, 72, 136, 3, None),
            ((256, 100), 256, 128, 264, 2, None)):
        G = len(sizes)
        R = G * span
        lut_t = tuple(range(W)) if lut is None else lut
        x = torch.randn(R, K, generator=gen).to(torch.bfloat16)
        dy = torch.randn(R, N, generator=gen).to(torch.bfloat16)
        w = (0.1 * torch.randn(W, K, N, generator=gen)).to(torch.bfloat16)
        sz = torch.tensor(sizes, dtype=torch.int32)
        dead = ~(torch.arange(span)[None] < sz[:, None]).reshape(-1)
        x[dead] = float("nan")
        dy[dead] = float("nan")
        y = gm.grouped_matmul_cuda(x, w, sz, span, lut)
        dx = gm.grouped_matmul_cuda(dy, w, sz, span, lut, transpose_w=True)
        live = ~dead
        xc, dyc = x.clone(), dy.clone()
        xc[dead] = 0
        dyc[dead] = 0
        ref = gm.grouped_matmul_reference(xc, w, sz, span, lut)
        ref_dx = gm.grouped_matmul_reference(dyc, w.transpose(1, 2)
                                             .contiguous(), sz, span, lut)
        dw = gm.grouped_matmul_dw_cuda(xc, dyc, sz, span, lut_t, W)
        dw_ref = gm.grouped_matmul_dw_reference(xc, dyc, sz, span, lut_t, W)
        errs = (rel_err(y[live], ref[live]) if live.any() else 0.0,
                rel_err(dx[live], ref_dx[live]) if live.any() else 0.0,
                rel_err(dw, dw_ref))
        zero = bool((y[dead] == 0).all() and (dx[dead] == 0).all())
        print(f"  grouped_matmul sizes={sizes} span={span} K={K} N={N}: "
              f"rel err y {errs[0]:.2e}, dx {errs[1]:.2e}, dW {errs[2]:.2e}; "
              f"dead rows exact zero: {zero}", flush=True)
        if errs[0] > 1e-2 or errs[1] > 1e-2 or errs[2] > 1e-4 or not zero:
            fail(f"grouped matmul {sizes}: {errs}, dead rows zero {zero}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args()
    torch.set_num_threads(2)
    lib = build()
    load(lib)
    gen = torch.Generator().manual_seed(0)
    print("int8 matmul (wgmma kernel under the shim):", flush=True)
    check_quant_matmul(gen)
    print("grouped matmul (wgmma forward / dx, mma.sync dW, under the "
          "shim):", flush=True)
    check_grouped_matmul(gen)
    print("rehearsal passed", flush=True)


if __name__ == "__main__":
    main()
