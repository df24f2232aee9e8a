// One-pass Adam(W) over a flat fp32 partition, for sm_90a.
//
// Replaces the TPU kernel `_adam_kernel` of
// deeperspeed_tpu/ops/pallas/optimizer.py (through `fused_adam_flat`):
// the same update, element by element,
//
//   g' = g + wd * p                       (classic Adam, L2 mode only)
//   m  = b1 * m + (1 - b1) * g'
//   v  = b2 * v + (1 - b2) * g' * g'
//   u  = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd * p in AdamW mode)
//   p  = p - lr * u
//
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t computed by the caller (1 when
// bias correction is off). p, m and v are fp32, g is fp32 or bf16, and
// the new p may also be written as bf16 into the compute-parameter
// buffer in the same pass: the recast of the engine's step.
//
// Bound on the H100: bytes. Each element reads p, g, m, v and writes p,
// m, v (and the bf16 copy): 28-30 bytes, so 162 M elements take about
// 1.4 ms at 3.35 TB/s, against 14 flops an element. Design: a grid-stride
// loop of one element per thread per turn, neighbouring threads on
// neighbouring addresses; any n, no padding to a tile.

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename G>
__global__ void __launch_bounds__(NT)
    adam_kernel(float* __restrict__ p, const G* __restrict__ g,
                float* __restrict__ m, float* __restrict__ v,
                __nv_bfloat16* __restrict__ p_out, long long n, float lr,
                float b1, float b2, float eps, float wd, float bc1,
                float bc2, int adam_w) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    float gi = ds::to_float(g[i]);
    if (!adam_w) gi = gi + wd * pi;
    const float mi = b1 * m[i] + (1.f - b1) * gi;
    const float vi = b2 * v[i] + (1.f - b2) * gi * gi;
    float u = (mi / bc1) / (sqrtf(vi / bc2) + eps);
    if (adam_w) u = u + wd * pi;
    const float pn = pi - lr * u;
    p[i] = pn;
    m[i] = mi;
    v[i] = vi;
    if (p_out != nullptr) p_out[i] = __float2bfloat16(pn);
  }
}

template <typename G>
cudaError_t launch(void* p, const void* g, void* m, void* v, void* p_out,
                   long long n, float lr, float b1, float b2, float eps,
                   float wd, float bc1, float bc2, int adam_w,
                   cudaStream_t stream) {
  // enough blocks to fill every SM several times over; the loop covers
  // the rest
  const long long want = (n + NT - 1) / NT;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  adam_kernel<G><<<blocks, NT, 0, stream>>>(
      static_cast<float*>(p), static_cast<const G*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<__nv_bfloat16*>(p_out), n, lr, b1, b2, eps, wd, bc1, bc2,
      adam_w);
  return cudaGetLastError();
}

}  // namespace

// p, m, v: [n] fp32 contiguous, updated in place; g: [n] contiguous in
// g_dtype (0 fp32, 1 bf16); p_out: [n] bf16 contiguous or null. Returns
// cudaGetLastError() after the launch (n = 0 launches nothing).
extern "C" int ds_adam(void* p, const void* g, void* m, void* v, void* p_out,
                       long long n, float lr, float b1, float b2, float eps,
                       float wd, float bc1, float bc2, int adam_w,
                       int g_dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (g_dtype == ds::DTYPE_F32)
    return launch<float>(p, g, m, v, p_out, n, lr, b1, b2, eps, wd, bc1, bc2,
                         adam_w, cs);
  if (g_dtype == ds::DTYPE_BF16)
    return launch<__nv_bfloat16>(p, g, m, v, p_out, n, lr, b1, b2, eps, wd,
                                 bc1, bc2, adam_w, cs);
  return cudaErrorInvalidValue;
}
