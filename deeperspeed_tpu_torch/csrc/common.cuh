// Helpers shared by the hand-written Hopper kernels of deeperspeed_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace ds {

// Masked scores take this value, as in the JAX package (NEG_INF = -1e30);
// a score at or below half of it marks a masked slot whose probability is
// forced to exactly 0.
constexpr float NEG_INF = -1e30f;

// dtype codes passed by the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F16 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to nearest even: past 65504 this gives +-inf, so an fp16
// overflow reaches the loss scaler's finite check (a saturating _rz
// conversion would hide it)
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// two fp32 values rounded to nearest into one 32-bit pair of T (bf16 or
// fp16; lo in the low half), the operand and store format of the
// tensor-core kernels
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

// -- the mma.sync kernels' pieces (the bf16 flash kernels and the
// block-sparse dK/dV, through attention_mma.cuh) --

// 16-byte global -> shared copy; pred false copies nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

// 4-byte global -> shared copy (fp32 rows of lse, delta, key bias); pred
// false copies nothing and zero-fills
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x by the special-function unit (what __expf uses after its scale)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a * b on one m16n8k16 tile: bf16 A (row) and B (col), fp32 c
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with fp16 A and B
__device__ __forceinline__ void mma_f16(float* c, const unsigned* a,
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the m16n8k16 step of element type T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma16(float* c, const unsigned* a,
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i (16-byte aligned). Plain: lane l gets row l/4,
// columns 2(l%4) and 2(l%4)+1 of each; trans: the transpose's.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

}  // namespace ds
