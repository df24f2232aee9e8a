// Weight-only int8 matmul for sm_90a: y[m, n] = (sum_k x[m, k] * q[k, n])
// * scale[n], fp32 accumulation, y in x's dtype (fp32 or bf16).
//
// Replaces the TPU kernel `_wq_kernel` of
// deeperspeed_tpu/ops/pallas/quant_matmul.py (launched by
// `quant_matmul_pallas`). As there, the int8 weight crosses device memory
// at one byte an element and is widened on chip, and the per-channel
// scale, which commutes with the contraction, multiplies the fp32 sum
// once in the epilogue. int8 -> fp32 and bf16 -> fp32 are exact, so the
// products are exact and only the summation order differs from the plain
// version.
//
// Bound on the H100: at decode (M = 16 rows, one per sequence) each
// weight byte feeds 2 * 16 flops, far below the ~295 flops a byte at
// which the tensor cores would become the limit, so the weight bytes
// bound it; at a large prefill (M = 4096) it is the flops. Design:
//
// - Tensor-core path (bf16 x, 16-byte aligned rows, N % 16 == 0, K % 8 ==
//   0): mma.sync m16n8k16 bf16 with fp32 accumulators. A block of 4 warps
//   owns 16 (M <= 16) or 64 rows x 64 columns; K runs in tiles of 32
//   through a 4-stage cp.async ring in shared memory (x tile and int8
//   weight tile, 16-byte copies, zero fill past the edges). The weight
//   bytes are widened to bf16 (exact) as the B fragments are built. At
//   decode the output has only 12-48 tiles of 64 columns, too few to keep
//   enough weight bytes in flight, so the wrapper splits K over up to
//   ~264 blocks (split-K): each writes its fp32 partial tile to a
//   workspace and a second small kernel sums the splits in a fixed order
//   (deterministic), applies the scale and casts.
// - FMA path for fp32 x (exact fp32 products, as the plain version):
//   64 x 64 tiles, K in steps of 32 staged in shared memory (the weight
//   tile read with 16-byte loads where N allows, widened once), 4 x 4
//   outputs a thread.
// - Ragged M, N and K edges are masked; x is read through its row stride.
//   bf16 inputs the tensor-core path cannot read are refused (the wrapper
//   raises first); every GPT-NeoX block matmul meets its conditions.
#include <cstdint>

#include "common.cuh"

namespace {

// tiled path
constexpr int TL_NT = 256;
constexpr int TL_BM = 64;
constexpr int TL_BN = 64;
constexpr int TL_BK = 32;
constexpr int TL_PAD = 4;                 // keeps float4 rows aligned

// tensor-core path
constexpr int MMA_NT = 128;               // 4 warps
constexpr int MMA_BN = 64;                // 16 columns a warp
constexpr int MMA_BK = 32;                // two k16 steps a tile
constexpr int MMA_STAGES = 4;
constexpr int MMA_XS = MMA_BK + 8;        // padded bf16 row: 80 bytes
constexpr int MMA_WS = MMA_BN + 16;       // padded int8 row: 80 bytes

__device__ __forceinline__ float byte_at(int w, int i) {
  return static_cast<float>(static_cast<signed char>(w >> (8 * i)));
}

__global__ void __launch_bounds__(TL_NT) qmm_tiled_kernel(
    const float* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ y, int M, int N,
    int K, bool vec16) {
  __shared__ __align__(16) float xs[TL_BK][TL_BM + TL_PAD];
  __shared__ __align__(16) float ws[TL_BK][TL_BN + TL_PAD];
  const int tid = threadIdx.x;
  const int tx = tid % (TL_BN / 4), ty = tid / (TL_BN / 4);
  const int m0 = blockIdx.y * TL_BM, n0 = blockIdx.x * TL_BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TL_BK) {
    // x tile [BM, BK], read along k, stored k-major
    for (int i = tid; i < TL_BM * TL_BK; i += TL_NT) {
      const int r = i / TL_BK, c = i % TL_BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? x[(long long)m * ldx + k] : 0.f;
    }
    // weight tile [BK, BN] as 16-byte chunks along N
    for (int i = tid; i < TL_BK * TL_BN / 16; i += TL_NT) {
      const int r = i / (TL_BN / 16), c = (i % (TL_BN / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      float4* dst = reinterpret_cast<float4*>(&ws[r][c]);
      if (vec16 && k < K && n + 16 <= N) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(
            q + (long long)k * N + n));
        const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = make_float4(byte_at(words[u], 0), byte_at(words[u], 1),
                               byte_at(words[u], 2), byte_at(words[u], 3));
      } else {
        float b[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          b[j] = (k < K && n + j < N)
                     ? static_cast<float>(q[(long long)k * N + n + j]) : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = make_float4(b[4 * u], b[4 * u + 1], b[4 * u + 2],
                               b[4 * u + 3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TL_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(long long)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

using ds::cp_async16;
using ds::cp_async_commit;
using ds::cp_async_wait;
using ds::mma_bf16;

// two int8 weights -> packed bf16x2 (exact), the lower k in the low half
__device__ __forceinline__ unsigned pack_bf16x2(signed char lo,
                                                signed char hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                                 static_cast<float>(hi));
  return *reinterpret_cast<const unsigned*>(&v);
}

// MT m16 tiles a block (MT * 16 rows) x 64 columns; blockIdx.z takes the
// K range [z * k_split, (z + 1) * k_split). With gridDim.z == 1 the block
// writes y; otherwise its fp32 partial goes to ws[z] for the reduction.
template <int MT>
__global__ void __launch_bounds__(MMA_NT) qmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, long long ldx,
    const int8_t* __restrict__ q, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int M, int N,
    int K, int k_split) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) __nv_bfloat16 xs[MMA_STAGES][BM][MMA_XS];
  __shared__ __align__(16) signed char wsm[MMA_STAGES][MMA_BK][MMA_WS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * MMA_BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int ktiles = (k_end - k_begin + MMA_BK - 1) / MMA_BK;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = k_begin + kt * MMA_BK;
    // x tile: BM rows x 32 k = BM * 4 chunks of 8 bf16
    for (int c = tid; c < BM * (MMA_BK / 8); c += MMA_NT) {
      const int r = c / (MMA_BK / 8), kc = (c % (MMA_BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < k_end;
      const __nv_bfloat16* src = ok ? x + (long long)(m0 + r) * ldx + k0 + kc
                                    : x;
      cp_async16(&xs[stage][r][kc], src, ok);
    }
    // weight tile: 32 k rows x 64 columns = 128 chunks of 16 int8
    for (int c = tid; c < MMA_BK * (MMA_BN / 16); c += MMA_NT) {
      const int r = c / (MMA_BN / 16), nc = (c % (MMA_BN / 16)) * 16;
      const bool ok = k0 + r < k_end && n0 + nc < N;
      const int8_t* src = ok ? q + (long long)(k0 + r) * N + n0 + nc : q;
      cp_async16(&wsm[stage][r][nc], src, ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();   // tile kt has landed; tile kt-1's stage is free
    const int nxt = kt + MMA_STAGES - 1;
    if (nxt < ktiles) load_tile(nxt, nxt % MMA_STAGES);
    cp_async_commit();
    const int st = kt % MMA_STAGES;
#pragma unroll
    for (int ks = 0; ks < MMA_BK; ks += 16) {
      unsigned b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = warp * 16 + j * 8 + g;
        b[j][0] = pack_bf16x2(wsm[st][ks + 2 * t][n],
                              wsm[st][ks + 2 * t + 1][n]);
        b[j][1] = pack_bf16x2(wsm[st][ks + 2 * t + 8][n],
                              wsm[st][ks + 2 * t + 9][n]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = i * 16 + g;
        unsigned a[4];
        a[0] = *reinterpret_cast<const unsigned*>(&xs[st][r][ks + 2 * t]);
        a[1] = *reinterpret_cast<const unsigned*>(&xs[st][r + 8][ks + 2 * t]);
        a[2] = *reinterpret_cast<const unsigned*>(
            &xs[st][r][ks + 2 * t + 8]);
        a[3] = *reinterpret_cast<const unsigned*>(
            &xs[st][r + 8][ks + 2 * t + 8]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  float* part = split ? ws + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + warp * 16 + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        if (split)
          part[(long long)m * N + n] = acc[i][j][e];
        else
          y[(long long)m * N + n] = __float2bfloat16(acc[i][j][e] * scale[n]);
      }
}

// y[m, n] = bf16(scale[n] * sum over the splits of ws[z, m, n]), the
// splits summed in order
__global__ void qmm_split_reduce_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ scale,
                                        __nv_bfloat16* __restrict__ y, int M,
                                        int N, int splits) {
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    y[i] = __float2bfloat16(s * scale[i % N]);
  }
}

cudaError_t launch_mma(const __nv_bfloat16* x, long long ldx,
                       const int8_t* q, const float* scale,
                       __nv_bfloat16* y, float* ws, int M, int N, int K,
                       int k_split, cudaStream_t stream) {
  const int splits = (K + k_split - 1) / k_split;
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const int mt = M <= 16 ? 1 : 4;
  const dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + 16 * mt - 1) / (16 * mt),
                  splits);
  if (mt == 1)
    qmm_mma_kernel<1><<<grid, MMA_NT, 0, stream>>>(x, ldx, q, scale, y, ws,
                                                   M, N, K, k_split);
  else
    qmm_mma_kernel<4><<<grid, MMA_NT, 0, stream>>>(x, ldx, q, scale, y, ws,
                                                   M, N, K, k_split);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long mn = (long long)M * N;
    const long long want = (mn + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    qmm_split_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, scale, y, M, N,
                                                        splits);
  }
  return cudaGetLastError();
}

cudaError_t launch_fma(const float* x, long long ldx, const int8_t* q,
                       const float* scale, float* y, int M, int N, int K,
                       cudaStream_t stream) {
  const dim3 grid((N + TL_BN - 1) / TL_BN, (M + TL_BM - 1) / TL_BM);
  const bool vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  qmm_tiled_kernel<<<grid, TL_NT, 0, stream>>>(x, ldx, q, scale, y, M, N, K,
                                               vec16);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] through its row stride ldx (K contiguous), fp32 or bf16 as
// `dtype` says; q: [K, N] int8 contiguous; scale: [N] fp32; y: [M, N]
// contiguous in x's dtype. ws: fp32 workspace of ceil(K / k_split) * M *
// N floats for the split-K tensor-core path (null when k_split >= K).
// bf16 needs K % 8 == 0, N % 16 == 0, ldx % 8 == 0 and 16-byte aligned x
// and q (cudaErrorInvalidValue otherwise). Returns cudaGetLastError()
// after the launches.
extern "C" int ds_quant_matmul(const void* x, long long ldx, const void* q,
                               const void* scale, void* y, void* ws, int M,
                               int N, int K, int k_split, int dtype,
                               void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if (dtype == ds::DTYPE_F32)
    return launch_fma(static_cast<const float*>(x), ldx,
                      static_cast<const int8_t*>(q),
                      static_cast<const float*>(scale),
                      static_cast<float*>(y), M, N, K, cs);
  if (dtype != ds::DTYPE_BF16) return cudaErrorInvalidValue;
  const bool mma_ok = K > 0 && k_split > 0 && k_split % MMA_BK == 0 &&
                      K % 8 == 0 && ldx % 8 == 0 && N % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (!mma_ok) return cudaErrorInvalidValue;
  return launch_mma(static_cast<const __nv_bfloat16*>(x), ldx,
                    static_cast<const int8_t*>(q),
                    static_cast<const float*>(scale),
                    static_cast<__nv_bfloat16*>(y),
                    static_cast<float*>(ws), M, N, K, k_split, cs);
}
