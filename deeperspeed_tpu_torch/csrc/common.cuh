// Helpers shared by the hand-written Hopper kernels of deeperspeed_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ds {

// Masked scores take this value, as in the JAX package (NEG_INF = -1e30);
// a score at or below half of it marks a masked slot whose probability is
// forced to exactly 0.
constexpr float NEG_INF = -1e30f;

// dtype codes passed by the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

}  // namespace ds
