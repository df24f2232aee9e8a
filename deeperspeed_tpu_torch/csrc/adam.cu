// One-pass Adam(W) over a flat partition, for sm_90a.
//
// Replaces the TPU kernel `_adam_kernel` of
// deeperspeed_tpu/ops/pallas/optimizer.py (through `fused_adam_flat`):
// the same update, element by element, in fp32,
//
//   g' = g + wd * p                       (classic Adam, L2 mode only)
//   m  = b1 * m + (1 - b1) * g'
//   v  = b2 * v + ((1 - b2) * g') * g'
//   u  = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd * p in AdamW mode)
//   p  = p - lr * u
//
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t computed by the caller (1 when
// bias correction is off), and 1 - b1, 1 - b2 too: each operation
// rounds once, in the plain version's order (`adam_flat_reference`, one
// PyTorch op each), with no fused multiply-add, so the kernel gives the
// plain version's bits. A template over the storage types: p (P) is
// fp32 (the classic masters) or bf16 or fp16 (the lean state, where the
// compute parameters are the masters, as `fused_adam_flat` takes a
// 16-bit p); the moments (M) rest in fp32, bf16 or fp16 (the optimizer's
// `state_dtype`); g (G) is fp32, bf16 or fp16. Each value is read once,
// the math runs in fp32, and each output is rounded once to its storage
// type, to nearest even (`.astype` / `.to`; fp16 past 65504 becomes
// inf). With fp32 p, the new p may also be written as bf16 or fp16 (C)
// into the compute-parameter buffer in the same pass (the recast of the
// engine's step); with a 16-bit p there is no such copy. The fp16
// variants are the loss-scaled training path's: the classic one (fp32 p,
// m, v, an fp16 copy) and the lean one (fp16 p, m, v).
//
// Bound on the H100: bytes. An element reads p, g, m, v and writes p, m,
// v: 28-30 bytes classic (fp32 p/m/v, 16-bit g and copy), 14 bytes lean
// (all bf16 or all fp16), against 14 flops; GPT-2 XL's 1,557,686,400
// elements take 13.02 / 6.51 ms at 3.35 TB/s. Design: a grid-stride loop over
// packs of 4 neighbouring elements a thread (one 8- or 16-byte load or
// store a buffer: with 2-byte elements one element a thread kept too
// few bytes in flight), neighbouring threads on neighbouring packs,
// 64-bit indices (n passes 2^31 at 1.5B parameters); the tail past the
// last whole pack, and every element when a buffer is not 16-byte
// aligned, one element a thread. Any n, no padding to a tile.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int VEC = 4;

template <typename T>
struct alignas(sizeof(T) * VEC) Pack {
  T x[VEC];
};

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2;
  int adam_w;
};

// one element: p, g, m, v in → new p, m, v in fp32, each operation
// rounded once in the plain version's order
__device__ __forceinline__ void adam_step(const Hyper& h, float pi, float gi,
                                          float m0, float v0, float& pn,
                                          float& mi, float& vi) {
  if (!h.adam_w && h.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(h.wd, pi));
  mi = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.omb1, gi));
  vi = __fadd_rn(__fmul_rn(h.b2, v0), __fmul_rn(__fmul_rn(h.omb2, gi), gi));
  float u = __fdiv_rn(__fdiv_rn(mi, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, h.bc2)), h.eps));
  if (h.adam_w && h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, pi));
  pn = __fsub_rn(pi, __fmul_rn(h.lr, u));
}

template <typename P, typename G, typename M, typename C>
__global__ void __launch_bounds__(NT)
    adam_kernel(P* __restrict__ p, const G* __restrict__ g,
                M* __restrict__ m, M* __restrict__ v,
                C* __restrict__ p_out, long long n,
                long long n_packs, Hyper h) {
  const long long stride = (long long)gridDim.x * NT;
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long j = tid; j < n_packs; j += stride) {
    const Pack<P> pp = reinterpret_cast<const Pack<P>*>(p)[j];
    const Pack<G> gp = reinterpret_cast<const Pack<G>*>(g)[j];
    const Pack<M> mp = reinterpret_cast<const Pack<M>*>(m)[j];
    const Pack<M> vp = reinterpret_cast<const Pack<M>*>(v)[j];
    Pack<P> po;
    Pack<M> mo, vo;
    Pack<C> co;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float pn, mi, vi;
      adam_step(h, ds::to_float(pp.x[k]), ds::to_float(gp.x[k]),
                ds::to_float(mp.x[k]), ds::to_float(vp.x[k]), pn, mi, vi);
      po.x[k] = ds::from_float<P>(pn);
      mo.x[k] = ds::from_float<M>(mi);
      vo.x[k] = ds::from_float<M>(vi);
      co.x[k] = ds::from_float<C>(pn);
    }
    reinterpret_cast<Pack<P>*>(p)[j] = po;
    reinterpret_cast<Pack<M>*>(m)[j] = mo;
    reinterpret_cast<Pack<M>*>(v)[j] = vo;
    if (p_out != nullptr) reinterpret_cast<Pack<C>*>(p_out)[j] = co;
  }
  for (long long i = n_packs * VEC + tid; i < n; i += stride) {
    float pn, mi, vi;
    adam_step(h, ds::to_float(p[i]), ds::to_float(g[i]), ds::to_float(m[i]),
              ds::to_float(v[i]), pn, mi, vi);
    p[i] = ds::from_float<P>(pn);
    m[i] = ds::from_float<M>(mi);
    v[i] = ds::from_float<M>(vi);
    if (p_out != nullptr) p_out[i] = ds::from_float<C>(pn);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename P, typename G, typename M, typename C>
cudaError_t launch(void* p, const void* g, void* m, void* v, void* p_out,
                   long long n, const Hyper& h, cudaStream_t stream) {
  const bool packed = aligned16(p) && aligned16(g) && aligned16(m) &&
                      aligned16(v) && aligned16(p_out);
  const long long n_packs = packed ? n / VEC : 0;
  // enough blocks to fill every SM several times over; the loop covers
  // the rest
  const long long work = packed ? n_packs + (n - n_packs * VEC) : n;
  const long long want = (work + NT - 1) / NT;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  adam_kernel<P, G, M, C><<<blocks, NT, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), static_cast<C*>(p_out), n, n_packs, h);
  return cudaGetLastError();
}

template <typename P, typename M, typename C>
cudaError_t launch_g(int g_dtype, void* p, const void* g, void* m, void* v,
                     void* p_out, long long n, const Hyper& h,
                     cudaStream_t stream) {
  if (g_dtype == ds::DTYPE_F32)
    return launch<P, float, M, C>(p, g, m, v, p_out, n, h, stream);
  if (g_dtype == ds::DTYPE_BF16)
    return launch<P, __nv_bfloat16, M, C>(p, g, m, v, p_out, n, h, stream);
  if (g_dtype == ds::DTYPE_F16)
    return launch<P, __half, M, C>(p, g, m, v, p_out, n, h, stream);
  return cudaErrorInvalidValue;
}

template <typename P, typename C>
cudaError_t launch_m(int m_dtype, int g_dtype, void* p, const void* g,
                     void* m, void* v, void* p_out, long long n,
                     const Hyper& h, cudaStream_t stream) {
  if (m_dtype == ds::DTYPE_F32)
    return launch_g<P, float, C>(g_dtype, p, g, m, v, p_out, n, h, stream);
  if (m_dtype == ds::DTYPE_BF16)
    return launch_g<P, __nv_bfloat16, C>(g_dtype, p, g, m, v, p_out, n, h,
                                         stream);
  if (m_dtype == ds::DTYPE_F16)
    return launch_g<P, __half, C>(g_dtype, p, g, m, v, p_out, n, h, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// p: [n] in p_dtype, m and v: [n] in m_dtype, all contiguous and updated
// in place; g: [n] contiguous in g_dtype (dtype codes: 0 fp32, 1 bf16, 2
// fp16); p_out: [n] contiguous in c_dtype (bf16 or fp16) or null, and
// null when p is 16-bit; omb1 and omb2: 1 - b1 and 1 - b2 as the caller
// rounds them. Returns cudaGetLastError() after the launch (n = 0
// launches nothing).
extern "C" int ds_adam(void* p, const void* g, void* m, void* v, void* p_out,
                       long long n, float lr, float b1, float b2, float omb1,
                       float omb2, float eps, float wd, float bc1, float bc2,
                       int adam_w, int g_dtype, int p_dtype, int m_dtype,
                       int c_dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Hyper h{lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, adam_w};
  using bf16 = __nv_bfloat16;
  if (p_dtype == ds::DTYPE_F32) {
    if (p_out == nullptr || c_dtype == ds::DTYPE_BF16)
      return launch_m<float, bf16>(m_dtype, g_dtype, p, g, m, v, p_out, n, h,
                                   cs);
    if (c_dtype == ds::DTYPE_F16)
      return launch_m<float, __half>(m_dtype, g_dtype, p, g, m, v, p_out, n,
                                     h, cs);
    return cudaErrorInvalidValue;
  }
  if (p_out != nullptr) return cudaErrorInvalidValue;
  if (p_dtype == ds::DTYPE_BF16)
    return launch_m<bf16, bf16>(m_dtype, g_dtype, p, g, m, v, p_out, n, h,
                                cs);
  if (p_dtype == ds::DTYPE_F16)
    return launch_m<__half, __half>(m_dtype, g_dtype, p, g, m, v, p_out, n,
                                    h, cs);
  return cudaErrorInvalidValue;
}
