"""Build and load the hand-written Hopper kernels.

Every ``deeperspeed_tpu_torch/csrc/*.cu`` source is compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, at first use, under ``build/torch_kernels/`` beside the
package (git-ignored). The library's name carries a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one loads
the library already there. The sources compile in parallel (one
``nvcc -c`` each) and link with one ``nvcc -shared``.

The library is loaded with ctypes; pointers and the stream are passed
as ``c_void_p``, and each C entry point returns ``cudaGetLastError()``
after its launch, which the wrappers turn into an exception. Nothing
here falls back to a plain version: a missing ``nvcc`` or a failed
build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]


def device_cached(cache, key, make):
    """``cache[key]``, made by ``make()`` (a tensor or a tuple or dict of
    them) on a miss. What the flops count makes under `FakeTensorMode` is
    handed back but not kept, so no later call reads a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_leaves
    value = cache.get(key)
    if value is None:
        value = make()
        if not any(isinstance(t, FakeTensor) for t in tree_leaves(value)):
            cache[key] = value
    return value


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: name → argtypes (restype is int: a cudaError_t)
SIGNATURES = {
    # q, k, v, seg, layout, kbias, seed, out, lse, B, S, H, D, q/k/v
    # strides (b, s, h), sm_scale, causal, dropout thresh, 1 / keep,
    # dtype (0 fp32, 1 bf16, 2 fp16), stream
    "ds_flash_fwd": [_P] * 9 + [_I] * 4 + [_L] * 9 + [_F, _I, _I, _F, _I,
                                                      _P],
    # q, q strides (b, h), k_pages, v_pages, pool strides (page, head,
    # slot), page_table, its row stride, lengths, out, B, H, D,
    # page_size, pages per row, sm_scale, cluster size (0: the
    # single-block kernel), dtype, stream
    "ds_paged_decode": [_P, _L, _L, _P, _P, _L, _L, _L, _P, _L, _P, _P,
                        _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # the same over int8 pools, with k_scales, v_scales and their strides
    # (page, head) after the pool strides; dtype is q's
    "ds_paged_decode_int8": [_P, _L, _L, _P, _P, _L, _L, _L, _P, _P, _L,
                             _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _F,
                             _I, _I, _P],
    # x, its row stride, q (int8 [K, N]), scale (fp32 [N]), y, M, N, K,
    # the bf16 plan's token tile and cluster size, dtype of x and y,
    # stream
    "ds_quant_matmul": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, seg, layout, kbias, seed, dk, dv, B, S,
    # H, D, q/k/v strides (b, s, h), sm_scale, causal, dropout thresh,
    # 1 / keep, dtype, stream
    "ds_flash_bwd_dkv": [_P] * 12 + [_I] * 4 + [_L] * 9 + [_F, _I, _I, _F,
                                                           _I, _P],
    # the same with dq in place of dk, dv
    "ds_flash_bwd_dq": [_P] * 11 + [_I] * 4 + [_L] * 9 + [_F, _I, _I, _F,
                                                          _I, _P],
    # q, k, v, lut, counts, order, max_active, out, lse, B, S, H, D,
    # q/k/v strides (b, s, h), sm_scale, causal, dtype, stream
    "ds_block_sparse_fwd": [_P] * 6 + [_I] + [_P] * 2 + [_I] * 4 +
                           [_L] * 9 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, the transposed lut, counts, order,
    # max_active, dk, dv, then as the forward from B on
    "ds_block_sparse_bwd_dkv": [_P] * 9 + [_I] + [_P] * 2 + [_I] * 4 +
                               [_L] * 9 + [_F, _I, _I, _P],
    # the same over the forward lut, with dq in place of dk, dv
    "ds_block_sparse_bwd_dq": [_P] * 9 + [_I] + [_P] + [_I] * 4 +
                              [_L] * 9 + [_F, _I, _I, _P],
    # p, g, m, v, p_out (bf16, fp16 or null), n, lr, beta1, beta2,
    # 1 - beta1, 1 - beta2, eps, weight_decay, bias_c1, bias_c2, adam_w,
    # g, p, m and p_out dtypes, stream
    "ds_adam": [_P, _P, _P, _P, _P, _L] + [_F] * 9 + [_I] * 5 + [_P],
    # x, its row stride, w, w read transposed (0/1), sizes, lut (int32),
    # y, R, K, N, number of weights, span, dtype, stream
    "ds_grouped_matmul": [_P, _L, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P],
    # x, dy, sizes, lut, dw (fp32), R, K, N, span, n_weights, dtype, stream
    "ds_grouped_matmul_dw": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # what a bf16 kernel takes on the device, into int info[5]: registers,
    # local (spill) bytes, static and dynamic shared memory bytes, blocks
    # an SM; the dW kernel for n_weights weights, the block-sparse
    # tensor-core kernel of a part (0 forward, 1 dk/dv, 2 dq) at head dim
    # D for a LUT of max_active entries a row, the paged-decode cluster
    # kernel at head dim D over bf16 (0) or int8 (1) pools for a page
    # table of n_pages_row pages a row
    "ds_grouped_matmul_dw_info": [_I, _P],
    "ds_block_sparse_info": [_I, _I, _I, _P],
    "ds_paged_decode_info": [_I, _I, _I, _P],
}

# what the kernels are instantiated for: the dtype codes of csrc/common.cuh
# and the head dims of their templates
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)

_LIB = None
BUILD_INFO = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if home:
        candidates.append(str(Path(home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the "
        "Hopper kernels are built from deeperspeed_tpu_torch/csrc at "
        "first use and need the CUDA toolkit")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libds_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(out):
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
    try:
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, out)   # atomic: a concurrent build loads either
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "\n".join(logs)


def load_library():
    """Build (if needed) and load the kernel library; cached for the
    process. `BUILD_INFO` records the path, whether this call built it,
    the build seconds and nvcc's ``-Xptxas -v`` report."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    t0 = time.perf_counter()
    built = not path.exists()
    log = _compile(path) if built else ""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ds_error_string.argtypes = [ctypes.c_int]
    lib.ds_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=str(path), built=built,
                      seconds=time.perf_counter() - t0, log=log)
    _LIB = lib
    return lib


def kernel_info(name, *args):
    """{"registers", "local_bytes", "static_smem", "dynamic_smem",
    "blocks_per_sm"} of a kernel, by its info entry point (``name``) on
    the current device."""
    info = (ctypes.c_int * 5)()
    check(getattr(load_library(), name)(*args, info), name)
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "blocks_per_sm"), info))


def check(err, name):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        msg = _LIB.ds_error_string(err).decode() if _LIB else "unknown"
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")


def stream_ptr(tensor):
    """PyTorch's current stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
