"""Rehearse the Hopper kernels on the CPU.

    python deeperspeed_tpu_torch/csrc/cpu_shim/rehearse.py [--only FAMILY]
        [--case N] [--build-only] [--generator-state FILE]

FAMILY is one of `quant_matmul`, `grouped_matmul`, `grouped_matmul_dw`,
`block_sparse_fwd` (D = 64), `block_sparse_fwd_d128`, `block_sparse_dkv`,
`block_sparse_dq`, `paged_decode`, `paged_decode_int8`, `adam`,
`paged_decode_fp16`, `adam_fp16`, `block_sparse_fp16_fwd`,
`block_sparse_fp16_dq`, `block_sparse_fp16_dkv` (with the overflow
case), `quant_matmul_fp16` and `paged_decode_int8_fp16` (all of them, in
that order, without ``--only``; ``--case N`` runs one layout of the two
forward families; ``--build-only`` compiles and stops). The process runs
pinned to one core, and the repeat call of every "two calls
bit-identical" check on two (`pin_to_one_core`, `on_two_cores`). Each
family's source (`csrc/quant_matmul.cu`, `csrc/grouped_matmul.cu`,
`csrc/block_sparse_attention.cu`, `csrc/paged_decode.cu`,
`csrc/adam.cu`) and `csrc/errors.cu` are copied next to this
directory's stand-ins for the CUDA headers and for `common.cuh` /
`hopper_gemm.cuh` (the attention headers are the real ones), compiled by
g++ under `build/cpu_shim/` (one object a source, in parallel, kept by a
hash of what it was built from) and linked into a library that is handed
to the wrappers of `ops/hopper/` in place of the nvcc build. The
wrappers then run their kernels on CPU tensors, one thread per CUDA
thread, and each result is held against the plain PyTorch version:

- quant_matmul: the int8 matmul at every plan the wrapper picks for a
  set of small shapes (token tiles 16 / 32 / 64 with swapped operands,
  128-row tiles, clusters of 1-8 CTAs, ragged M, N and K), bf16 within
  2e-2 of max|ref| (chip_smoke's TOL_QMM); one-hot x over a weight that
  holds all 256 int8 values, bit for bit; two calls bit-identical;
- grouped_matmul: the grouped forward and dx (wgmma) on spans that no
  128-row tile divides, dead rows filled with NaN: within 1e-2 of
  max|ref| (TOL_GMM), dead rows exact zeros;
- grouped_matmul_dw: the dW kernel (wgmma with both operands MN-major)
  with NaN in the dead rows of x and dy, spans no 64-row stage divides,
  weights owning several spans, an empty weight (exact zeros), K and N
  edges inside a tile and more tiles than CTAs: within 1e-4 of max|ref|
  (TOL_GMM_DW), finite, two calls bit-identical;
- block_sparse_fwd, block_sparse_dq: the bf16 forward and dQ kernels
  (mma.sync) at D = 64 and 128, q, k, v split out of one projection, on
  a causal layout with a global column and a row block whose only block
  lies above the diagonal (dead under causal), on the same layout with
  every LUT row reversed (the causal skip goes tile by tile, so the
  kernels need no column order), and on a bidirectional layout with a
  dead row: out within chip_smoke's bf16 TOL (2e-2, 2e-2), lse within
  1e-3, dq within TOL_BWD, dead rows exact zeros (lse +1e30), two calls
  bit-identical, every launch counted as the "mma" design;
- block_sparse_dkv: the bf16 dK/dV kernel (mma.sync) at D = 64 and 128
  on a causal fixed layout with a global column and a key block no
  query attends (exact zeros), and on a bidirectional layout with a dead
  row: within chip_smoke's bf16 TOL_BWD of the plain backward, two
  calls on the causal layout bit-identical, every launch counted as the
  "mma" design;
- paged_decode, paged_decode_int8: the cluster kernel over bf16 pools
  (bf16 q) and int8 pools (bf16 and fp32 q) at D = 64 and 128, on page
  tables of 12 pages of 16 slots (clusters of 8, ranks with two page
  slots), 3 pages of 64 and 2 pages of 128 (two 64-row tiles a page):
  ragged lengths with 0, exact page multiples and lengths that leave
  ranks without a live page, the trash page 0 past every length filled
  with large values; within chip_smoke's TOL of the plain version,
  length-0 rows exact zeros, two calls bit-identical, every launch
  counted as the "cluster" design (fp32 pools: the single-block kernel,
  counted "single");
- paged_decode_fp16: the same cluster cases over fp16 pools with fp16 q
  (the plain version rounds P to fp16, the kernel keeps it in fp32):
  within 5e-3 + 5e-3·|ref|, the same zero, identity and design checks;
- adam: the flat Adam(W) kernel at every parameter / moment storage
  pair (fp32 or bf16 p, fp32 or bf16 m and v), fp32 and bf16 grads,
  AdamW and L2 mode, with the bf16 recast beside fp32 p, on a length no
  block or pack of 4 divides, and on views off the 16-byte alignment
  the packed loop needs: p, m and v equal to the plain version bit for bit (the
  kernel rounds each operation once, in the plain version's order), the
  recast equal to the new p rounded, two calls bit-identical, and a
  p_out beside bf16 p refused;
- adam_fp16: the same over the fp16 variants: the classic one (fp32 p,
  m, v with an fp16 g and the fp16 copy, or an fp32 g), fp16 moments
  beside fp32 p, the lean one (fp16 p, m, v; fp16 or fp32 g) and fp16 p
  with fp32 moments, on the aligned and the skewed views: bit for bit,
  launches counted by variant ("fp16 classic", "fp16 lean").

It checks indexing, tiling, the mbarrier ring, the TMA box and swizzle,
the descriptors' layouts, the cluster reduction and the warp-level
fragment layouts against one reading of the hardware's rules
(`hopper_gemm.cuh` and `common.cuh` here say which); it cannot check
that reading, a missing fence or wait, speed, or sm_90a code
generation: only the card can. Exits non-zero on the first
disagreement.
"""

import argparse
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent
REPO = CSRC.parents[1]
sys.path.insert(0, str(REPO))

from deeperspeed_tpu_torch.ops.hopper import _build  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import adam as ad  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa  # noqa: E402,E501
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm  # noqa: E402
from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm  # noqa: E402

OUT = REPO / "build" / "cpu_shim"
SHIM_HEADERS = ("cuda_shim.h", "cuda.h", "cuda_runtime.h", "cuda_bf16.h",
                "cuda_fp16.h", "common.cuh", "hopper_gemm.cuh")
REAL_HEADERS = ("attention_tiles.cuh", "attention_mma.cuh")
CXX = ["g++", "-std=c++20", "-O1", "-g", "-fPIC", "-pthread"]


def shim_source(text):
    """A kernel source as g++ takes it under the shim: dynamic shared
    memory is the CTA's buffer, and `k<<<grid, block, smem, stream>>>(a)`
    is a call of the shim's launcher."""
    text = re.sub(
        r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(shim::self.block->smem);", text)
    return re.sub(r"([\w:]+(?:<[^;<>]*>)?)<<<([^;]*?)>>>\(",
                  r"shim::Launcher(\2).run(\1, ", text)


def _write(path, data):
    """Write ``data`` (bytes) to ``path`` unless it holds them already, by
    a rename, so a concurrent rehearsal reads either version whole."""
    if path.exists() and path.read_bytes() == data:
        return
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def build(sources):
    """Compile ``sources`` (names under csrc/) and errors.cu under the shim
    and link them → the library's path. Objects and libraries are named
    by a hash of the sources, the headers and the flags, so a later run
    on the same files reuses them."""
    OUT.mkdir(parents=True, exist_ok=True)
    headers = b""
    for name in SHIM_HEADERS:
        _write(OUT / name, (HERE / name).read_bytes())
        headers += (HERE / name).read_bytes()
    for name in REAL_HEADERS:
        _write(OUT / name, (CSRC / name).read_bytes())
        headers += (CSRC / name).read_bytes()
    objs, procs = [], []
    for name in (*sources, "errors.cu"):
        text = shim_source((CSRC / name).read_text())
        tag = hashlib.sha256(headers + text.encode() +
                             " ".join(CXX).encode()).hexdigest()[:16]
        obj = OUT / f"{Path(name).stem}_{tag}.o"
        objs.append(obj)
        if obj.exists():
            continue
        src = OUT / f"{Path(name).stem}_{tag}.cpp"
        _write(src, text.encode())
        tmp = obj.with_name(f"{obj.name}.{os.getpid()}.tmp")
        procs.append((name, obj, tmp, subprocess.Popen(
            [*CXX, f"-I{OUT}", "-include", "cuda_shim.h", "-c", str(src),
             "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, obj, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"g++ failed on {name}:\n{log[-6000:]}")
        os.replace(tmp, obj)
    tag = hashlib.sha256("".join(o.name for o in objs).encode()).hexdigest()
    lib = OUT / f"libds_shim_kernels_{tag[:16]}.so"
    if not lib.exists():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        res = subprocess.run([*CXX, "-shared", *map(str, objs), "-o",
                              str(tmp)], capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"g++ link failed:\n{res.stderr[-6000:]}")
        os.replace(tmp, lib)
    return lib


def load(lib_path):
    """Hand the shim library to the wrappers in place of the nvcc build."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ds_error_string.argtypes = [ctypes.c_int]
    lib.ds_error_string.restype = ctypes.c_char_p
    _build._LIB = lib
    _build.load_library = lambda: lib
    _build.stream_ptr = lambda t: None
    return lib


# the CPUs this process may use ("allowed"), the core it is pinned to
# ("own") and the second core of `on_two_cores` (claimed on first use)
_PIN = {}
_HELD = []      # the claimed cores' lock files, held until the process ends


def _claim_core(cpus):
    """The first of ``cpus``, from the one this pid picks, that no other
    rehearsal holds (a lock file under build/cpu_shim, held until this
    process exits); all held: the one the pid picks."""
    import fcntl
    start = os.getpid() % len(cpus)
    OUT.mkdir(parents=True, exist_ok=True)
    for i in range(len(cpus)):
        cpu = cpus[(start + i) % len(cpus)]
        lock = open(OUT / f"core{cpu}.lock", "w")
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            lock.close()
            continue
        _HELD.append(lock)
        return cpu
    return cpus[start]


def pin_to_one_core():
    """Run this process on one of the CPUs it may use. The emulation runs
    one OS thread per CUDA thread and a barrier at every shared-memory
    step; spread over cores beside other work, each barrier waits on
    wake-ups across cores. On one core a barrier is a local context
    switch: the `block_sparse_fwd` D = 64 causal case took 6.5 s alone
    either way, and beside 8 busy processes 50.6 s unpinned, 8.8 s
    pinned. Concurrent rehearsals take different cores. On one core the
    threads run from barrier to barrier one at a time, in an order that
    repeats, so a race cannot show there: every "two calls
    bit-identical" check makes its second call `on_two_cores`."""
    _PIN["allowed"] = sorted(os.sched_getaffinity(0))
    _PIN["own"] = _claim_core(_PIN["allowed"])
    os.sched_setaffinity(0, {_PIN["own"]})


@contextlib.contextmanager
def on_two_cores():
    """Run the launches inside on two cores (this process's own and a
    second free one), so that the CUDA threads of a CTA run at once and a
    missing barrier or a shared-memory race changes the result: the
    repeat call of each "two calls bit-identical" check runs here and is
    held bit for bit against the first call, made on one core. Does
    nothing when the process is not pinned or may use one CPU only."""
    if "own" in _PIN and "second" not in _PIN:
        others = [c for c in _PIN["allowed"] if c != _PIN["own"]]
        _PIN["second"] = _claim_core(others) if others else None
    if _PIN.get("second") is None:
        yield
        return
    os.sched_setaffinity(0, {_PIN["own"], _PIN["second"]})
    try:
        yield
    finally:
        os.sched_setaffinity(0, {_PIN["own"]})


def fail(msg):
    sys.exit(f"rehearsal FAILED: {msg}")


def rel_err(got, want):
    w = want.float()
    return float((got.float() - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)


def check_quant_matmul(gen, dtype=torch.bfloat16):
    plans = set()
    for M, K, N in ((16, 256, 256), (7, 104, 80), (20, 128, 128),
                    (64, 192, 256), (130, 128, 256), (16, 1024, 128),
                    (256, 512, 128), (1, 64, 16), (100, 128, 128),
                    (300, 192, 256)):
        x = torch.randn(M, K, generator=gen).to(dtype)
        qw = qm.quantize_weight(0.02 * torch.randn(K, N, generator=gen))
        plan = qm.launch_plan(M, N, K)
        plans.add(plan[:2])
        got = qm.quant_matmul_cuda(x, qw)
        with on_two_cores():
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
        x = torch.randn(M, K, generator=gen).to(dtype)
        qw = qm.quantize_weight(0.02 * torch.randn(K, N, generator=gen))
        err = rel_err(qm.quant_matmul_cuda(x, qw),
                      qm.quant_matmul_reference(x, qw))
        plans.add(plan)
        print(f"  quant_matmul M={M} K={K} N={N} plan {plan} (forced): rel "
              f"err {err:.2e}", flush=True)
        if err > 2e-2:
            fail(f"int8 matmul M={M} K={K} N={N} plan {plan}: rel err {err}")
    qm.launch_plan = orig
    # every int8 value widens exactly: y[m, n] = x's dtype(q[m, n] *
    # scale[n])
    for M in (16, 200):
        K, N = 256, 128
        q = (torch.arange(K * N) % 256 - 128).to(torch.int8).reshape(K, N)
        scale = torch.rand(N, generator=gen) + 0.5
        qw = qm.QuantizedWeight(q, scale)
        x = torch.zeros(M, K, dtype=dtype)
        x[torch.arange(M), torch.arange(M) % K] = 1.0
        got = qm.quant_matmul_cuda(x, qw)
        want = qm.quant_matmul_reference(x, qw)
        if not torch.equal(got, want):
            fail(f"int8 conversion readout (M={M}): "
                 f"{int((got != want).sum())} mismatches")
        print(f"  quant_matmul int8 readout M={M}: bit-equal", flush=True)
    if dtype == torch.float16:
        _quant_matmul_overflow(gen)
    print(f"  plans covered: {sorted(plans)}", flush=True)


def _quant_matmul_overflow(gen):
    """fp16 x whose products pass 65504 in some columns: the kernel's
    fp16 output is inf exactly where the plain version's is (the scaled
    fp32 sum rounded once, to nearest), on a lone CTA and a cluster."""
    for M, K, N in ((16, 256, 128), (200, 512, 128)):
        x = torch.randn(M, K, generator=gen).to(torch.float16)
        qw = qm.quantize_weight(0.02 * torch.randn(K, N, generator=gen))
        qw.scale[::3] *= 4e5
        got = qm.quant_matmul_cuda(x, qw)
        want = qm.quant_matmul_reference(x, qw)
        inf_got, inf_want = torch.isinf(got), torch.isinf(want)
        # a sum within 1e-3 of fp16's overflow threshold may round either
        # way by its summation order
        y = torch.matmul(x.float(), qw.qval.float()) * qw.scale
        near = ((y.abs() - 65520.0).abs() <= 65.52)
        mism = int(((inf_got != inf_want) & ~near).sum())
        fin = ~inf_want & ~near
        err = float((got.float()[fin] - want.float()[fin]).abs().max() /
                    want.float()[fin].abs().max())
        print(f"  quant_matmul fp16 overflow M={M}: {int(inf_want.sum())} "
              f"inf in the plain version, {int(inf_got.sum())} in the "
              f"kernel, {mism} mismatched; finite rel err {err:.2e}",
              flush=True)
        if mism or not int(inf_want.sum()) or err > 2e-2:
            fail(f"int8 matmul fp16 overflow M={M}: {mism} mismatched inf, "
                 f"rel err {err}")


def _gmm_inputs(gen, sizes, span, K, N, W):
    """bf16 x [R, K], dy [R, N], w [W, K, N] and the sizes, with NaN in
    the dead rows of x and dy → (x, dy, w, sizes, dead)."""
    R = len(sizes) * span
    x = torch.randn(R, K, generator=gen).to(torch.bfloat16)
    dy = torch.randn(R, N, generator=gen).to(torch.bfloat16)
    w = (0.1 * torch.randn(W, K, N, generator=gen)).to(torch.bfloat16)
    sz = torch.tensor(sizes, dtype=torch.int32)
    dead = ~(torch.arange(span)[None] < sz[:, None]).reshape(-1)
    x[dead] = float("nan")
    dy[dead] = float("nan")
    return x, dy, w, sz, dead


def check_grouped_matmul(gen):
    for sizes, span, K, N, W, lut in (
            ((200, 57, 0, 0, 133, 200), 200, 64, 96, 3, (0, 0, 1, 1, 2, 2)),
            ((130, 0, 72), 136, 72, 136, 3, None),
            ((256, 100), 256, 128, 264, 2, None)):
        x, dy, w, sz, dead = _gmm_inputs(gen, sizes, span, K, N, W)
        y = gm.grouped_matmul_cuda(x, w, sz, span, lut)
        dx = gm.grouped_matmul_cuda(dy, w, sz, span, lut, transpose_w=True)
        live = ~dead
        ref = gm.grouped_matmul_reference(x, w, sz, span, lut)
        ref_dx = gm.grouped_matmul_reference(dy, w.transpose(1, 2)
                                             .contiguous(), sz, span, lut)
        errs = (rel_err(y[live], ref[live]) if live.any() else 0.0,
                rel_err(dx[live], ref_dx[live]) if live.any() else 0.0)
        zero = bool((y[dead] == 0).all() and (dx[dead] == 0).all())
        print(f"  grouped_matmul sizes={sizes} span={span} K={K} N={N}: "
              f"rel err y {errs[0]:.2e}, dx {errs[1]:.2e}; dead rows exact "
              f"zero: {zero}", flush=True)
        if errs[0] > 1e-2 or errs[1] > 1e-2 or not zero:
            fail(f"grouped matmul {sizes}: {errs}, dead rows zero {zero}")


def check_grouped_matmul_dw(gen):
    gm.reset_design_launches()
    calls = 0
    for sizes, span, K, N, W, lut in (
            # an empty weight among weights of two spans; K inside one box
            ((200, 57, 0, 0, 133, 200), 200, 64, 96, 3, (0, 0, 1, 1, 2, 2)),
            # K and N edges inside the boxes, an empty weight
            ((130, 0, 72), 136, 72, 136, 3, None),
            # two N tiles, the second 8 columns wide; two K tiles
            ((256, 100), 256, 200, 264, 2, None),
            # 30 tiles on the shim's 3 SMs: the ring runs across tiles;
            # spans of 1, 63, 64 and 129 rows
            ((64, 1, 63, 129, 0), 136, 136, 520, 5, None)):
        x, dy, w, sz, _ = _gmm_inputs(gen, sizes, span, K, N, W)
        lut_t = tuple(range(W)) if lut is None else lut
        dw = gm.grouped_matmul_dw_cuda(x, dy, sz, span, lut_t, W)
        with on_two_cores():
            again = gm.grouped_matmul_dw_cuda(x, dy, sz, span, lut_t,
                                              W)
        calls += 2
        ref = gm.grouped_matmul_dw_reference(x, dy, sz, span, lut_t, W)
        err = rel_err(dw, ref)
        empty = [e for e in range(W)
                 if all(s == 0 for s, l in zip(sizes, lut_t) if l == e)]
        zero = all(bool((dw[e] == 0).all()) for e in empty)
        finite = bool(torch.isfinite(dw).all())
        same = torch.equal(dw, again)
        print(f"  grouped_matmul_dw sizes={sizes} span={span} K={K} N={N}: "
              f"rel err {err:.2e}, finite {finite}, empty weights {empty} "
              f"exact zero {zero}, two calls bit-identical {same}",
              flush=True)
        if err > 1e-4 or not (finite and zero and same):
            fail(f"grouped matmul dW {sizes}: rel err {err}, finite "
                 f"{finite}, empty zero {zero}, bit-identical {same}")
    if gm.dw_design_launches != {"wgmma": calls, "fma": 0}:
        fail(f"dW launches by design {gm.dw_design_launches}, want all "
             f"{calls} on wgmma")


def _dkv_case(gen, layout, causal, D, S, B=1, dtype=torch.bfloat16):
    """q, k, v, dO (bf16 or fp16) and the plain forward's out and lse on a
    layout → the kernel's (dk, dv), a second call's (on causal layouts,
    else the first's) and the plain backward's (dk, dv)."""
    H = layout.shape[0]
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen).to(dtype)
                   for _ in range(4))
    luts = bsa.LayoutLuts(layout)
    out, lse = bsa.block_sparse_attention_reference(q, k, v, luts, causal)
    delta = fa.attention_delta(out, do)
    got = bsa.block_sparse_attention_dkv_cuda(q, k, v, lse, do, delta, luts,
                                              causal)
    again = got
    if causal:
        with on_two_cores():
            again = bsa.block_sparse_attention_dkv_cuda(
                q, k, v, lse, do, delta, luts, causal)
    _, dk, dv = bsa.block_sparse_attention_bwd_reference(q, k, v, out, lse,
                                                         do, luts, causal)
    return got, again, (dk, dv)


def _sparse_layouts(n=4):
    """(causal, bidirectional) 0/1 layouts [2, n, n]. Causal: head 0 a
    fixed-like pattern (local blocks, key block 0 global: every query
    block lists it; key block 2 attended by no query block); head 1 its
    own pattern with a dead key block 3. Bidirectional: head 1 with a
    dead query row (block 2)."""
    causal_layout = np.tril(np.ones((2, n, n), np.int64))
    causal_layout[0, :, 2] = 0
    causal_layout[0, 2, 1] = 0
    causal_layout[1, :, 3] = 0
    causal_layout[1, 3, 1] = 0
    bidir = np.eye(n, dtype=np.int64)[None].repeat(2, 0)
    bidir[:, :, 0] = 1
    bidir[0, 1, 3] = bidir[1, 3, 2] = 1
    bidir[1, 2] = 0
    return causal_layout, bidir


def _sparse_cases(n=4):
    """The forward and dq families' layouts: (name, layout, causal, the
    (head, row block) pairs with no live key, reversed LUT rows). The
    causal layout adds, on head 1, a row block (0) whose only block lies
    above the diagonal, so causal leaves it dead; its reversed copy lists
    every row's columns in descending order, which the tile-by-tile
    causal skip must not depend on."""
    causal_layout, bidir = _sparse_layouts(n)
    causal_layout[1, 0, 0] = 0
    causal_layout[1, 0, 2] = 1
    return (("causal fixed", causal_layout, True, ((1, 0),), False),
            ("causal fixed, LUT rows reversed", causal_layout, True,
             ((1, 0),), True),
            ("bidirectional dead row", bidir, False, ((1, 2),), False))


def _sparse_luts(layout, reverse):
    """LayoutLuts of ``layout``; with ``reverse`` each forward LUT row
    lists its active columns in descending order."""
    luts = bsa.LayoutLuts(layout)
    if reverse:
        lut, counts, order = luts.fwd
        lut = lut.copy()
        for h, i in np.ndindex(counts.shape):
            lut[h, i, :counts[h, i]] = lut[h, i, :counts[h, i]][::-1]
        luts.fwd = (lut, counts, order)
    return luts


def _sparse_qkv(gen, B, S, H, D, dtype=torch.bfloat16):
    """q, k, v (bf16 or fp16) as views split out of one [B, S, H, 3D]
    projection (the main path's strides), and dO."""
    qkv = torch.randn(B, S, H, 3 * D, generator=gen).to(dtype)
    q, k, v = qkv.split(D, dim=-1)
    return q, k, v, torch.randn(B, S, H, D, generator=gen).to(dtype)


# chip_smoke's TOL / TOL_BWD (bf16) and TOL_FP16 for the block-sparse
# kernels: out, dq / dk / dv as (atol, rtol)
TOL_SPARSE = {torch.bfloat16: ((2e-2, 2e-2), (3e-2, 3e-2)),
              torch.float16: ((1e-2, 1e-2), (3e-2, 3e-2))}


def _dead(x, dead, B, H, S):
    """The rows of the (head, row block) pairs ``dead`` of a [B, S, H,
    ...] tensor, or of an lse [B·H, S]."""
    if x.shape == (B * H, S):
        x = x.view(B, H, S).transpose(1, 2)
    return torch.cat([x[:, rb * 128:(rb + 1) * 128, h].reshape(-1)
                      for h, rb in dead])


def _layouts_of(case, reversed_luts):
    """The `_sparse_cases` a run takes: all (without the reversed LUT
    rows unless ``reversed_luts``), or the one at index ``case`` of
    those."""
    cases = [c for c in _sparse_cases() if reversed_luts or not c[4]]
    return cases if case is None else [cases[case]]


def check_block_sparse_fwd(gen, dtype=torch.bfloat16, reversed_luts=True,
                           head_dims=(64, 128), case=None):
    """The bf16 (or fp16) forward at D = 64 and 128 (``head_dims``)
    against the plain version: out within chip_smoke's TOL (bf16 2e-2, 2e-2; fp16 1e-2,
    1e-2), lse within 1e-3, dead rows exact zeros with lse = +1e30, two
    calls bit-identical, every launch counted as "mma". ``case`` runs
    one of the layouts (`_layouts_of`)."""
    bsa.reset_design_launches()
    B, S, H = 1, 512, 2
    calls = 0
    atol, rtol = TOL_SPARSE[dtype][0]
    for D in head_dims:
        for name, layout, causal, dead, reverse in _layouts_of(
                case, reversed_luts):
            luts = _sparse_luts(layout, reverse)
            q, k, v, _ = _sparse_qkv(gen, B, S, H, D, dtype)
            out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts, causal)
            with on_two_cores():
                out2, lse2 = bsa.block_sparse_attention_cuda(q, k, v, luts,
                                                             causal)
            calls += 2
            ref_out, ref_lse = bsa.block_sparse_attention_reference(
                q, k, v, luts, causal)
            err_o = (out.float() - ref_out.float()).abs()
            err_l = (lse - ref_lse).abs()
            live = ref_lse < 1e29
            ok = bool((err_o <= atol + rtol * ref_out.float().abs()).all()) \
                and bool((err_l[live] <= 1e-3).all()) and \
                bool(torch.isfinite(out).all()) and out.dtype == dtype
            zero = bool((_dead(out, dead, B, H, S) == 0).all()) and \
                bool((_dead(lse, dead, B, H, S) == 1e30).all()) and \
                bool((lse[~live] == 1e30).all())
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
            print(f"  block_sparse_fwd {str(dtype)[6:]} D={D} {name}: max "
                  f"abs err out "
                  f"{float(err_o.max()):.2e}, lse "
                  f"{float(err_l[live].max()):.2e}; dead rows exact zero, "
                  f"lse +1e30: {zero}; two calls bit-identical {same}",
                  flush=True)
            if not (ok and zero and same):
                fail(f"block-sparse forward D={D} {name}: out err "
                     f"{float(err_o.max())}, lse err "
                     f"{float(err_l[live].max())}, dead {zero}, "
                     f"bit-identical {same}")
    _check_designs("fwd", calls)


def check_block_sparse_dq(gen, dtype=torch.bfloat16, reversed_luts=True,
                          head_dims=(64, 128)):
    """The bf16 (or fp16) dq at D = 64 and 128 (``head_dims``) against
    the plain backward from the plain forward's (out, lse): within
    chip_smoke's TOL_BWD (3e-2, 3e-2), dead rows exact zeros, two calls
    bit-identical, every launch counted as "mma"."""
    bsa.reset_design_launches()
    B, S, H = 1, 512, 2
    calls = 0
    atol, rtol = TOL_SPARSE[dtype][1]
    for D in head_dims:
        for name, layout, causal, dead, reverse in _layouts_of(
                None, reversed_luts):
            luts = _sparse_luts(layout, reverse)
            q, k, v, do = _sparse_qkv(gen, B, S, H, D, dtype)
            out, lse = bsa.block_sparse_attention_reference(q, k, v, luts,
                                                            causal)
            delta = fa.attention_delta(out, do)
            dq = bsa.block_sparse_attention_dq_cuda(q, k, v, lse, do, delta,
                                                    luts, causal)
            with on_two_cores():
                dq2 = bsa.block_sparse_attention_dq_cuda(
                    q, k, v, lse, do, delta, luts, causal)
            calls += 2
            want = bsa.block_sparse_attention_bwd_reference(
                q, k, v, out, lse, do, luts, causal)[0]
            err = (dq.float() - want.float()).abs()
            ok = bool((err <= atol + rtol * want.float().abs()).all()) and \
                bool(torch.isfinite(dq).all()) and dq.dtype == dtype
            zero = bool((_dead(dq, dead, B, H, S) == 0).all())
            same = torch.equal(dq, dq2)
            print(f"  block_sparse_dq {str(dtype)[6:]} D={D} {name}: max "
                  f"abs err "
                  f"{float(err.max()):.2e}; dead rows exact zero {zero}; "
                  f"two calls bit-identical {same}", flush=True)
            if not (ok and zero and same):
                fail(f"block-sparse dq D={D} {name}: err "
                     f"{float(err.max())}, dead {zero}, bit-identical "
                     f"{same}")
    _check_designs("dq", calls)


def _check_designs(part, calls):
    want = {p: {"mma": calls if p == part else 0, "fma": 0}
            for p in bsa.PARTS}
    if bsa.design_launches != want:
        fail(f"block-sparse launches by design {bsa.design_launches}, want "
             f"{want}")


def check_block_sparse_dkv(gen, dtype=torch.bfloat16, head_dims=(64, 128)):
    bsa.reset_design_launches()
    S, n = 512, 4
    causal_layout, bidir = _sparse_layouts(n)
    calls = 0
    atol, rtol = TOL_SPARSE[dtype][1]
    for D in head_dims:
        for name, layout, causal, dead_keys in (
                ("causal fixed", causal_layout, True, ((0, 2), (1, 3))),
                ("bidirectional dead row", bidir, False, ())):
            (dk, dv), (dk2, dv2), (rk, rv) = _dkv_case(gen, layout, causal,
                                                       D, S, dtype=dtype)
            calls += 2 if causal else 1
            ok, errs = True, []
            for g, w in ((dk, rk), (dv, rv)):
                err = (g.float() - w.float()).abs()
                errs.append(float(err.max()))
                ok = ok and bool((err <= atol + rtol * w.float().abs())
                                 .all()) and bool(torch.isfinite(g).all()) \
                    and g.dtype == dtype
            zero = all(bool((g[:, kb * 128:(kb + 1) * 128, h] == 0).all())
                       for h, kb in dead_keys for g in (dk, dv))
            same = torch.equal(dk, dk2) and torch.equal(dv, dv2)
            print(f"  block_sparse_dkv {str(dtype)[6:]} D={D} {name}: max "
                  f"abs err dk "
                  f"{errs[0]:.2e}, dv {errs[1]:.2e}; unattended key blocks "
                  f"exact zero {zero}; two calls bit-identical {same}",
                  flush=True)
            if not (ok and zero and same):
                fail(f"block-sparse dK/dV D={D} {name}: errs {errs}, zero "
                     f"{zero}, bit-identical {same}")
    _check_designs("dkv", calls)


# (page_size, pages a row, lengths): a row of 12 pages makes clusters of
# 8 whose ranks 0-3 hold two page slots; 16 and 48 tokens leave ranks
# without a live page; 128-slot pages are two tiles
DECODE_CASES = ((16, 12, (0, 16, 37, 192, 130, 48)),
                (64, 3, (70, 0, 192, 1, 128)),
                (128, 2, (200, 256, 0, 64, 129)))
TOL_DECODE = {torch.bfloat16: (2e-2, 2e-2), torch.float16: (5e-3, 5e-3),
              torch.float32: (1e-4, 1e-4)}


def _decode_case(gen, ps, NP, lengths, H, D, q_dtype, int8):
    """q as a strided view, pools [P, H, ps, D] (bf16, fp32 or int8 with
    bf16 scales), a page permutation, the trash page 0 past each length
    filled with large values."""
    B = len(lengths)
    P = B * NP + 3
    q = torch.randn(B, H, 3 * D, generator=gen).to(q_dtype)[..., :D]
    if int8:
        kp, vp = (torch.randint(-127, 128, (P, H, ps, D), generator=gen,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((0.005 + 0.02 * torch.rand(P, H, ps, generator=gen))
                  .to(torch.bfloat16) for _ in range(2))
        kp[0], vp[0], ks[0], vs[0] = 127, -127, 100.0, 100.0
    else:
        kp, vp = (torch.randn(P, H, ps, D, generator=gen).to(q_dtype)
                  for _ in range(2))
        kp[0], vp[0] = 1e4, -1e4
        ks = vs = None
    lens = torch.tensor(lengths, dtype=torch.int32)
    table = (torch.randperm(P - 1, generator=gen)[:B * NP] + 1).reshape(
        B, NP)
    live = torch.arange(NP)[None] * ps < lens[:, None]
    table = torch.where(live, table, 0).to(torch.int32)
    return q, kp, vp, ks, vs, table, lens


def _check_decode(gen, int8, q_dtypes=(torch.bfloat16, torch.float32)):
    da.reset_launches_by_design()
    counts = da.launches_by_design_int8 if int8 else da.launches_by_design
    calls = dict.fromkeys(da.DESIGNS, 0)
    for D in (64, 128):
        for ps, NP, lengths in DECODE_CASES:
            for q_dtype in q_dtypes:
                q, kp, vp, ks, vs, table, lens = _decode_case(
                    gen, ps, NP, lengths, 2, D, q_dtype, int8)
                if int8:
                    run = lambda: da.paged_decode_int8_cuda(  # noqa: E731
                        q, kp, vp, ks, vs, table, lens)
                else:
                    run = lambda: da.paged_decode_cuda(  # noqa: E731
                        q, kp, vp, table, lens)
                got = run()
                with on_two_cores():
                    again = run()
                design = da.kernel_design(q, kp)
                calls[design] += 2
                ref = da.paged_decode_attention_reference(
                    q, kp, vp, table, lens, k_scales=ks, v_scales=vs)
                atol, rtol = TOL_DECODE[q_dtype]
                err = (got.float() - ref.float()).abs()
                ok = bool((err <= atol + rtol * ref.float().abs()).all()) \
                    and bool(torch.isfinite(got).all()) and \
                    got.dtype == q_dtype
                zero = bool((got[lens == 0] == 0).all())
                same = torch.equal(got, again)
                cl = da.launch_plan(*q.shape[:2], NP) \
                    if design == "cluster" else 0
                print(f"  paged_decode{'_int8' if int8 else ''} D={D} "
                      f"ps={ps} NP={NP} q {str(q_dtype)[6:]} ({design}, "
                      f"cluster {cl}): max abs err {float(err.max()):.2e}; "
                      f"length-0 rows exact zero {zero}; two calls "
                      f"bit-identical {same}", flush=True)
                if not (ok and zero and same):
                    fail(f"paged decode{' int8' if int8 else ''} D={D} "
                         f"ps={ps} NP={NP} {q_dtype}: max abs err "
                         f"{float(err.max())}, zero rows {zero}, "
                         f"bit-identical {same}")
    if counts != calls or calls["cluster"] == 0:
        fail(f"paged decode launches by design {counts}, want {calls}")


def check_paged_decode(gen):
    _check_decode(gen, int8=False)


def check_paged_decode_int8(gen):
    _check_decode(gen, int8=True)


def check_paged_decode_fp16(gen):
    _check_decode(gen, int8=False, q_dtypes=(torch.float16,))


ADAM_CASES = (
    # p, m/v, g, adam_w, the copy's dtype (None: no copy), skew
    (torch.float32, torch.float32, torch.bfloat16, True, torch.bfloat16, 0),
    (torch.float32, torch.float32, torch.float32, False, None, 0),
    (torch.float32, torch.bfloat16, torch.float32, True, torch.bfloat16, 0),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True, None, 0),
    (torch.bfloat16, torch.bfloat16, torch.float32, False, None, 0),
    (torch.bfloat16, torch.float32, torch.bfloat16, True, None, 0),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True, None, 1))
# the fp16 variants: classic (fp32 p, m, v, fp16 g and copy) and lean
# (fp16 p, m, v), fp32 g where the engine unscales first, a skewed view
ADAM_CASES_FP16 = (
    (torch.float32, torch.float32, torch.float16, True, torch.float16, 0),
    (torch.float32, torch.float32, torch.float32, True, torch.float16, 0),
    (torch.float32, torch.float16, torch.float32, False, torch.float16, 0),
    (torch.float16, torch.float16, torch.float16, True, None, 0),
    (torch.float16, torch.float16, torch.float32, True, None, 0),
    (torch.float16, torch.float32, torch.float16, False, None, 0),
    (torch.float16, torch.float16, torch.float16, True, None, 1))


def check_adam(gen, cases=ADAM_CASES):
    ad.reset_launches()
    n = 3 * 256 + 77
    hp = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01,
              bias_correction=True)
    for p_dt, m_dt, g_dt, adam_w, copy_dt, skew in cases:
        # skew 1: every buffer a view one element past a 16-byte boundary,
        # which takes the one-element-a-thread loop throughout
        p = torch.randn(n + skew, generator=gen).to(p_dt)[skew:]
        g = torch.randn(n + skew, generator=gen).to(g_dt)[skew:]
        m = (0.1 * torch.randn(n + skew, generator=gen)).to(m_dt)[skew:]
        v = (0.01 * torch.rand(n + skew, generator=gen)).to(m_dt)[skew:]
        want = ad.adam_flat_reference(p, g, m, v, 6e-4, 3, adam_w=adam_w,
                                      **hp)
        runs = []
        for cores in (contextlib.nullcontext, on_two_cores):
            pk, mk, vk = p.clone(), m.clone(), v.clone()
            out = torch.empty(n, dtype=copy_dt) if copy_dt else None
            with cores():
                ad.adam_cuda(pk, g, mk, vk, 6e-4, 3, adam_w=adam_w,
                             p_out=out, **hp)
            runs.append((pk, mk, vk, out))
        pk, mk, vk, out = runs[0]
        case = (f"p {p_dt}, m/v {m_dt}, g {g_dt}, adam_w {adam_w}, "
                f"copy {copy_dt}, skew {skew}")
        for name, got, ref in (("p", pk, want[0]), ("m", mk, want[1]),
                               ("v", vk, want[2])):
            if not torch.equal(got, ref):
                fail(f"adam {case}: {name} off the plain version by "
                     f"{rel_err(got, ref):.3e} of max|ref|")
        if copy_dt and not torch.equal(out, pk.to(copy_dt)):
            fail(f"adam {case}: the recast is not the new p rounded")
        if not all(torch.equal(a, b) for a, b in zip(runs[0][:3],
                                                       runs[1][:3])):
            fail(f"adam {case}: two calls differ")
        print(f"  {case}: equal to the plain version bit for bit, two "
              f"calls bit-identical",
              flush=True)
    half = p.dtype
    try:
        ad.adam_cuda(p, g, m, v, 6e-4, 3, adam_w=True,
                     p_out=torch.empty(n, dtype=half), **hp)
    except TypeError:
        pass
    else:
        fail(f"adam: a {half} p_out beside {half} p was not refused")
    if ad.launches != 2 * len(cases):
        fail(f"adam: {ad.launches} launches counted, want "
             f"{2 * len(cases)}")


def check_adam_fp16(gen):
    check_adam(gen, ADAM_CASES_FP16)
    if set(ad.variant_launches) != {"fp16 classic", "fp16 lean",
                                    "p float32, m float16",
                                    "p float16, m float32"}:
        fail(f"adam fp16 launches by variant {ad.variant_launches}")


def check_block_sparse_fp16_overflow(gen):
    """An overflowing loss-scaled fp16 backward: dO at fp16's full scale
    on head 0 and v at 8x, so that dS passes 65504: dq, dk and dv
    non-finite exactly where the plain version's do, leaving out the
    elements `fp16_overflow_undecided` marks, on head 0 only."""
    B, S, H, D = 1, 256, 2, 64
    layout = np.ones((H, 2, 2), np.int64)
    luts = bsa.LayoutLuts(layout)
    q, k, v, _ = _sparse_qkv(gen, B, S, H, D, torch.float16)
    v = (v.float() * 8).to(torch.float16)
    out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts, True)
    do = torch.randn(B, S, H, D, generator=gen)
    do[:, :, 0] = (do[:, :, 0] * 20000).clamp(-60000, 60000)
    do = do.to(torch.float16)
    delta = fa.attention_delta(out, do)
    got = bsa.block_sparse_attention_bwd_cuda(q, k, v, lse, do, delta, luts,
                                              True)
    want = bsa.block_sparse_attention_bwd_reference(q, k, v, out, lse, do,
                                                    luts, True)
    undecided = fa.fp16_overflow_undecided(
        q, k, v, out, lse, do, layout=torch.as_tensor(layout))
    row = {}
    for name, g, w, u in zip(("dq", "dk", "dv"), got, want, undecided):
        gi, wi = ~torch.isfinite(g), ~torch.isfinite(w)
        row[name] = (int(gi.sum()), int(wi.sum()),
                     int(((gi != wi) & ~u).sum()), int(gi[:, :, 1].sum()))
    print(f"  block_sparse fp16 overflow (non-finite kernel, plain, "
          f"mismatched, on head 1): {row}; forward finite "
          f"{bool(torch.isfinite(out).all())}", flush=True)
    if not (torch.isfinite(out).all() and row["dq"][0] and row["dk"][0] and
            all(r[2] == 0 and r[3] == 0 for r in row.values())):
        fail(f"block-sparse fp16 overflow: {row}")


def check_quant_matmul_fp16(gen):
    check_quant_matmul(gen, torch.float16)


def check_paged_decode_int8_fp16(gen):
    _check_decode(gen, int8=True, q_dtypes=(torch.float16,))


FAMILIES = {
    "quant_matmul": (("quant_matmul.cu",), check_quant_matmul,
                     "int8 matmul (wgmma)"),
    "grouped_matmul": (("grouped_matmul.cu",), check_grouped_matmul,
                       "grouped matmul forward / dx (wgmma)"),
    "grouped_matmul_dw": (("grouped_matmul.cu",), check_grouped_matmul_dw,
                          "grouped matmul dW (wgmma, MN-major A and B)"),
    "block_sparse_fwd": (("block_sparse_attention.cu",),
                         functools.partial(check_block_sparse_fwd,
                                           head_dims=(64,)),
                         "block-sparse forward (mma.sync), D = 64"),
    # D = 128 is a family of its own, so each of the two fits one
    # subprocess's time limit under a loaded host; its draws follow D =
    # 64's, as they did in one family
    "block_sparse_fwd_d128": (("block_sparse_attention.cu",),
                              functools.partial(check_block_sparse_fwd,
                                                head_dims=(128,)),
                              "block-sparse forward (mma.sync), D = 128"),
    "block_sparse_dq": (("block_sparse_attention.cu",),
                        check_block_sparse_dq,
                        "block-sparse dQ (mma.sync)"),
    "block_sparse_dkv": (("block_sparse_attention.cu",),
                         check_block_sparse_dkv,
                         "block-sparse dK/dV (mma.sync)"),
    "paged_decode": (("paged_decode.cu",), check_paged_decode,
                     "paged decode over bf16 pools (cluster split-KV)"),
    "paged_decode_int8": (("paged_decode.cu",), check_paged_decode_int8,
                          "paged decode over int8 pools (cluster "
                          "split-KV)"),
    "adam": (("adam.cu",), check_adam,
             "flat Adam(W) over fp32 / bf16 parameters and moments"),
    "paged_decode_fp16": (("paged_decode.cu",), check_paged_decode_fp16,
                          "paged decode over fp16 pools (cluster "
                          "split-KV)"),
    "adam_fp16": (("adam.cu",), check_adam_fp16,
                  "flat Adam(W), the fp16 variants (classic and lean)"),
    # the three block-sparse kernels in fp16 at D = 64 and 128 (within
    # chip_smoke's TOL_FP16; the reversed LUT rows, which test the causal
    # skip and not the element type, are left to the bf16 families), one
    # kernel a family, and a loss-scaled overflow
    "block_sparse_fp16_fwd": (("block_sparse_attention.cu",),
                              functools.partial(check_block_sparse_fwd,
                                                dtype=torch.float16,
                                                reversed_luts=False),
                              "block-sparse forward in fp16"),
    "block_sparse_fp16_dq": (("block_sparse_attention.cu",),
                             functools.partial(check_block_sparse_dq,
                                               dtype=torch.float16,
                                               reversed_luts=False),
                             "block-sparse dQ in fp16"),
    "block_sparse_fp16_dkv": (("block_sparse_attention.cu",),
                              lambda gen: (
                                  check_block_sparse_dkv(gen, torch.float16),
                                  check_block_sparse_fp16_overflow(gen)),
                              "block-sparse dK/dV in fp16, and a "
                              "loss-scaled overflow"),
    "quant_matmul_fp16": (("quant_matmul.cu",), check_quant_matmul_fp16,
                          "int8 matmul with fp16 activations (wgmma f16)"),
    "paged_decode_int8_fp16": (("paged_decode.cu",),
                               check_paged_decode_int8_fp16,
                               "paged decode over int8 pools with fp16 q "
                               "(cluster split-KV)"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=sorted(FAMILIES),
                    help="rehearse one kernel family")
    ap.add_argument("--build-only", action="store_true",
                    help="compile every family's sources (or --only's) "
                         "into build/cpu_shim/ and stop: a later run on "
                         "the same files reuses the objects")
    ap.add_argument("--case", type=int, metavar="N",
                    help="with --only block_sparse_fwd / "
                         "block_sparse_fwd_d128: run the N-th layout of "
                         "the family only (the tier-1 cases split it so)")
    ap.add_argument("--generator-state", metavar="FILE",
                    help="start the families' generator from this state "
                         "(the bytes of torch.Generator.get_state()) "
                         "instead of seed 0")
    args = ap.parse_args()
    torch.set_num_threads(2)
    names = [args.only] if args.only else list(FAMILIES)
    sources = sorted({s for n in names for s in FAMILIES[n][0]})
    if args.build_only:
        # once a checkout: under a lock, so that concurrent rehearsals
        # (the tier-1 files, one a worker) wait for the one compile and
        # then find every object built
        import fcntl
        OUT.mkdir(parents=True, exist_ok=True)
        with open(OUT / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            # every object in parallel, then each family's library
            build(sources)
            for source in sources:
                build([source])
        print("build done", flush=True)
        return
    check = FAMILIES[args.only][1] if args.only else None
    if args.case is not None:
        if not (isinstance(check, functools.partial) and
                check.func is check_block_sparse_fwd):
            ap.error("--case takes --only block_sparse_fwd or "
                     "block_sparse_fwd_d128")
        check = functools.partial(check, case=args.case)
    load(build(sources))
    pin_to_one_core()
    gen = torch.Generator().manual_seed(0)
    if args.generator_state:
        gen.set_state(torch.frombuffer(
            bytearray(Path(args.generator_state).read_bytes()),
            dtype=torch.uint8))
    for name in names:
        print(f"{FAMILIES[name][2]}, under the shim:", flush=True)
        (check or FAMILIES[name][1])(gen)
    print("rehearsal passed", flush=True)


if __name__ == "__main__":
    main()
