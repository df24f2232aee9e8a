// Grouped (ragged) expert matmul for sm_90a, forward and dW.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/pallas/grouped_matmul.py:
// `_fwd_kernel` (launched by `_gmm_pallas`, also for dx against w^T) and
// `_dw_kernel` (launched by `_dw_pallas`). The buffer x [R, K] holds G =
// R / span spans of `span` rows; span g multiplies weight lut[g] and only
// its first sizes[g] rows are real:
//
//   forward  y[r] = x[r] @ w[lut[r / span]], rows at or past their span's
//            size exactly 0;
//   dW       dw[e] = sum over the spans of e of x^T @ dy on their live
//            rows, in fp32, exactly 0 for a weight with no live row.
//
// The sizes and the LUT are read from device memory by each block, so the
// grid is static and the host never waits for the routing (the TPU kernel
// gets them by scalar prefetch).
//
// Bound on the H100: at the MoE training shape (8 experts, span 2560,
// 16,384 live rows of 20,480, (K, N) = (768, 3072) or (3072, 768)) one
// pass is 77 GFLOP on about 70 MB, some 1,100 flops a byte: the tensor
// cores bound it. Design:
//
// - bf16: mma.sync m16n8k16 with fp32 accumulators (the tensor-core path of
//   quant_matmul.cu, with ldmatrix in place of its scalar fragment
//   building). A block of 8 warps owns a 128 x 128 output tile, each warp
//   64 x 32; the contraction runs in slices of 32 through a 4-stage
//   cp.async ring in dynamic shared memory (16-byte copies, zero fill past
//   the edges and past the span's size, so dead rows cost no reads).
//   ldmatrix (.trans where the stored tile is k-major for the operand)
//   builds every fragment, so one kernel body serves the three operand
//   layouts: x [r][k] and w [k][n] (forward), x and w read as [n][k]
//   (dx = dy @ w^T, no transposed copy of w is made), x^T and dy (dW).
// - Forward blocks own (row tile of one span, column tile): a tile wholly
//   past the size writes zeros and returns; a partial tile writes exact
//   zeros on its dead rows.
// - dW blocks own (weight, K tile, N tile) and walk that weight's spans in
//   order, slice by slice up to each size: one fp32 sum in registers, a
//   fixed order, no atomics, and every tile written once, zeros included.
// - fp32 (the parity path) takes FMA tiled kernels of the same contract:
//   64 x 64 tiles, 4 x 4 outputs a thread, slices of 16 staged in shared
//   memory.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ds::cp_async16;
using ds::cp_async_commit;
using ds::cp_async_wait;
using ds::ldmatrix_x4;
using ds::ldmatrix_x4_trans;
using ds::mma_bf16;

// tensor-core path
constexpr int MM_BM = 128;
constexpr int MM_BN = 128;
constexpr int MM_BK = 32;
constexpr int MM_WARPS_M = 2;
constexpr int MM_WARPS_N = 4;
constexpr int MM_NT = 32 * MM_WARPS_M * MM_WARPS_N;   // 256
constexpr int MM_WM = MM_BM / MM_WARPS_M;             // 64 rows a warp
constexpr int MM_WN = MM_BN / MM_WARPS_N;             // 32 columns a warp
constexpr int MM_MT = MM_WM / 16;                     // m16 tiles a warp
constexpr int MM_NT8 = MM_WN / 8;                     // n8 tiles a warp
constexpr int MM_STAGES = 4;
constexpr int MM_PAD = 8;   // 16 bytes: ldmatrix rows fall in distinct banks
// row strides (elements) of the three stored tile shapes
constexpr int LD_K = MM_BK + MM_PAD;     // [128][32]: x rows, w as [n][k]
constexpr int LD_M = MM_BM + MM_PAD;     // [32][128]: x^T slice (dW)
constexpr int LD_N = MM_BN + MM_PAD;     // [32][128]: w [k][n], dy
constexpr int OPERAND_ELEMS = MM_BM * LD_K > MM_BK * LD_N
                                  ? MM_BM * LD_K : MM_BK * LD_N;
constexpr int STAGE_ELEMS = 2 * OPERAND_ELEMS;
constexpr int MM_SMEM_BYTES = MM_STAGES * STAGE_ELEMS * 2;   // 80 KB

// FMA path (fp32)
constexpr int FM_NT = 256;
constexpr int FM_BM = 64;
constexpr int FM_BN = 64;
constexpr int FM_BK = 16;
constexpr int FM_PAD = 4;

__device__ __forceinline__ int live_size(const int* sizes, int g, int span) {
  return min(max(sizes[g], 0), span);
}

// One 32-deep slice of the block tile. A is stored [m][k] (A_KMAJOR false)
// or [k][m]; B is stored [k][n] (B_NMAJOR false) or [n][k].
template <bool A_KMAJOR, bool B_NMAJOR>
__device__ __forceinline__ void mma_slice(float (&acc)[MM_MT][MM_NT8][4],
                                          const bf16* As, const bf16* Bs,
                                          int wm, int wn, int lane) {
  const int mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int ks = 0; ks < MM_BK; ks += 16) {
    unsigned a[MM_MT][4];
#pragma unroll
    for (int i = 0; i < MM_MT; ++i) {
      const int m0 = wm * MM_WM + i * 16;
      if (!A_KMAJOR)
        ldmatrix_x4(a[i], As + (m0 + r + 8 * (mat % 2)) * LD_K + ks +
                              8 * (mat / 2));
      else
        ldmatrix_x4_trans(a[i], As + (ks + r + 8 * (mat / 2)) * LD_M + m0 +
                                    8 * (mat % 2));
    }
    unsigned b[MM_NT8][2];
#pragma unroll
    for (int j = 0; j < MM_NT8; j += 2) {
      const int n0 = wn * MM_WN + j * 8;
      unsigned t[4];
      if (!B_NMAJOR)
        ldmatrix_x4_trans(t, Bs + (ks + r + 8 * (mat % 2)) * LD_N + n0 +
                                 8 * (mat / 2));
      else
        ldmatrix_x4(t, Bs + (n0 + r + 8 * (mat / 2)) * LD_K + ks +
                           8 * (mat % 2));
      b[j][0] = t[0];
      b[j][1] = t[1];
      b[j + 1][0] = t[2];
      b[j + 1][1] = t[3];
    }
#pragma unroll
    for (int i = 0; i < MM_MT; ++i)
#pragma unroll
      for (int j = 0; j < MM_NT8; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[MM_MT][MM_NT8][4]) {
#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int j = 0; j < MM_NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Forward: blockIdx.x = column tile, blockIdx.y = (span, row tile) with
// tps row tiles a span. TRANS_W reads w stored [W, N, K] (the dx product).
template <bool TRANS_W>
__global__ void __launch_bounds__(MM_NT) gmm_fwd_mma_kernel(
    const bf16* __restrict__ x, long long ldx, const bf16* __restrict__ w,
    const int* __restrict__ sizes, const int* __restrict__ lut,
    bf16* __restrict__ y, int K, int N, int span, int tps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int g = blockIdx.y / tps;
  const int row0 = (blockIdx.y % tps) * MM_BM;            // within the span
  const int rows = min(MM_BM, span - row0);                // span rows here
  const int live = max(0, min(live_size(sizes, g, span) - row0, rows));
  const long long grow0 = (long long)g * span + row0;
  const int n0 = blockIdx.x * MM_BN;
  bf16* yt = y + grow0 * N;
  if (live == 0) {
    for (int c = tid; c < rows * (MM_BN / 8); c += MM_NT) {
      const int r = c / (MM_BN / 8), n = n0 + (c % (MM_BN / 8)) * 8;
      if (n < N)
        *reinterpret_cast<int4*>(yt + (long long)r * N + n) =
            make_int4(0, 0, 0, 0);
    }
    return;
  }
  const bf16* xt = x + grow0 * ldx;
  const bf16* we = w + (long long)lut[g] * K * N;
  const int ktiles = (K + MM_BK - 1) / MM_BK;

  auto load_tile = [&](int kt, int stage) {
    bf16* As = smem + stage * STAGE_ELEMS;
    bf16* Bs = As + OPERAND_ELEMS;
    const int k0 = kt * MM_BK;
    for (int c = tid; c < MM_BM * (MM_BK / 8); c += MM_NT) {
      const int r = c / (MM_BK / 8), kc = (c % (MM_BK / 8)) * 8;
      const bool ok = r < live && k0 + kc < K;
      cp_async16(As + r * LD_K + kc,
                 ok ? xt + (long long)r * ldx + k0 + kc : x, ok);
    }
    if (!TRANS_W) {
      for (int c = tid; c < MM_BK * (MM_BN / 8); c += MM_NT) {
        const int kr = c / (MM_BN / 8), nc = (c % (MM_BN / 8)) * 8;
        const bool ok = k0 + kr < K && n0 + nc < N;
        cp_async16(Bs + kr * LD_N + nc,
                   ok ? we + (long long)(k0 + kr) * N + n0 + nc : w, ok);
      }
    } else {
      for (int c = tid; c < MM_BN * (MM_BK / 8); c += MM_NT) {
        const int nr = c / (MM_BK / 8), kc = (c % (MM_BK / 8)) * 8;
        const bool ok = n0 + nr < N && k0 + kc < K;
        cp_async16(Bs + nr * LD_K + kc,
                   ok ? we + (long long)(n0 + nr) * K + k0 + kc : w, ok);
      }
    }
  };

  float acc[MM_MT][MM_NT8][4];
  zero_acc(acc);
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / MM_WARPS_N, wn = warp % MM_WARPS_N;
#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();   // slice kt has landed; slice kt-1's stage is free
    const int nxt = kt + MM_STAGES - 1;
    if (nxt < ktiles) load_tile(nxt, nxt % MM_STAGES);
    cp_async_commit();
    const bf16* As = smem + (kt % MM_STAGES) * STAGE_ELEMS;
    mma_slice<false, TRANS_W>(acc, As, As + OPERAND_ELEMS, wm, wn, lane);
  }
  cp_async_wait<0>();

  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int j = 0; j < MM_NT8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * MM_WM + i * 16 + gq + 8 * h;
        const int n = n0 + wn * MM_WN + j * 8 + 2 * tq;
        if (r >= rows || n >= N) continue;
        const bool dead = r >= live;
        *reinterpret_cast<__nv_bfloat162*>(yt + (long long)r * N + n) =
            __floats2bfloat162_rn(dead ? 0.f : acc[i][j][2 * h],
                                  dead ? 0.f : acc[i][j][2 * h + 1]);
      }
}

// dW: blockIdx.x = column tile of N, blockIdx.y = row tile of K, blockIdx.z
// = weight. The contraction walks the weight's spans (contiguous in the
// non-decreasing LUT) slice by slice up to each span's size.
__global__ void __launch_bounds__(MM_NT) gmm_dw_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const int* __restrict__ sizes, const int* __restrict__ lut,
    float* __restrict__ dw, int G, int K, int N, int span) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * MM_BM;   // rows of dw[e]: the K index
  const int n0 = blockIdx.x * MM_BN;
  int s_lo = G, s_hi = G;
  for (int s = 0; s < G; ++s)
    if (lut[s] == e) {
      if (s_lo == G) s_lo = s;
      s_hi = s + 1;
    }
  int ktiles = 0;
  for (int s = s_lo; s < s_hi; ++s)
    ktiles += (live_size(sizes, s, span) + MM_BK - 1) / MM_BK;

  // the loader's cursor: slices are issued in order, so one (span, row)
  // pair that every thread advances alike walks them
  int cs = s_lo, cr = 0;
  auto load_tile = [&](int stage) {
    int size = cs < s_hi ? live_size(sizes, cs, span) : 0;
    while (cs < s_hi && cr >= size) {
      ++cs;
      cr = 0;
      size = cs < s_hi ? live_size(sizes, cs, span) : 0;
    }
    const long long row0 = (long long)cs * span + cr;
    const int nrows = size - cr;
    bf16* As = smem + stage * STAGE_ELEMS;
    bf16* Bs = As + OPERAND_ELEMS;
    for (int c = tid; c < MM_BK * (MM_BM / 8); c += MM_NT) {
      const int rr = c / (MM_BM / 8), kc = (c % (MM_BM / 8)) * 8;
      const bool ok = rr < nrows && m0 + kc < K;
      cp_async16(As + rr * LD_M + kc,
                 ok ? x + (row0 + rr) * K + m0 + kc : x, ok);
    }
    for (int c = tid; c < MM_BK * (MM_BN / 8); c += MM_NT) {
      const int rr = c / (MM_BN / 8), nc = (c % (MM_BN / 8)) * 8;
      const bool ok = rr < nrows && n0 + nc < N;
      cp_async16(Bs + rr * LD_N + nc,
                 ok ? dy + (row0 + rr) * N + n0 + nc : dy, ok);
    }
    cr += MM_BK;
  };

  float acc[MM_MT][MM_NT8][4];
  zero_acc(acc);
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / MM_WARPS_N, wn = warp % MM_WARPS_N;
#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();
    const int nxt = kt + MM_STAGES - 1;
    if (nxt < ktiles) load_tile(nxt % MM_STAGES);
    cp_async_commit();
    const bf16* As = smem + (kt % MM_STAGES) * STAGE_ELEMS;
    mma_slice<true, false>(acc, As, As + OPERAND_ELEMS, wm, wn, lane);
  }
  cp_async_wait<0>();

  float* dwe = dw + (long long)e * K * N;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int j = 0; j < MM_NT8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MM_WM + i * 16 + gq + 8 * h;
        const int n = n0 + wn * MM_WN + j * 8 + 2 * tq;
        if (m >= K || n >= N) continue;
        *reinterpret_cast<float2*>(dwe + (long long)m * N + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <bool TRANS_W>
__global__ void __launch_bounds__(FM_NT) gmm_fwd_fma_kernel(
    const float* __restrict__ x, long long ldx, const float* __restrict__ w,
    const int* __restrict__ sizes, const int* __restrict__ lut,
    float* __restrict__ y, int K, int N, int span, int tps) {
  __shared__ __align__(16) float As[FM_BK][FM_BM + FM_PAD];
  __shared__ __align__(16) float Bs[FM_BK][FM_BN + FM_PAD];
  const int tid = threadIdx.x;
  const int g = blockIdx.y / tps;
  const int row0 = (blockIdx.y % tps) * FM_BM;
  const int rows = min(FM_BM, span - row0);
  const int live = max(0, min(live_size(sizes, g, span) - row0, rows));
  const long long grow0 = (long long)g * span + row0;
  const int n0 = blockIdx.x * FM_BN;
  float* yt = y + grow0 * N;
  if (live == 0) {
    for (int i = tid; i < rows * FM_BN; i += FM_NT) {
      const int r = i / FM_BN, n = n0 + i % FM_BN;
      if (n < N) yt[(long long)r * N + n] = 0.f;
    }
    return;
  }
  const float* xt = x + grow0 * ldx;
  const float* we = w + (long long)lut[g] * K * N;
  const int tx = tid % (FM_BN / 4), ty = tid / (FM_BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FM_BK) {
    for (int i = tid; i < FM_BM * FM_BK; i += FM_NT) {
      const int r = i / FM_BK, c = i % FM_BK;
      As[c][r] = (r < live && k0 + c < K) ? xt[(long long)r * ldx + k0 + c]
                                          : 0.f;
    }
    for (int i = tid; i < FM_BK * FM_BN; i += FM_NT) {
      if (!TRANS_W) {
        const int kk = i / FM_BN, n = i % FM_BN;
        Bs[kk][n] = (k0 + kk < K && n0 + n < N)
                        ? we[(long long)(k0 + kk) * N + n0 + n] : 0.f;
      } else {
        const int n = i / FM_BK, kk = i % FM_BK;
        Bs[kk][n] = (k0 + kk < K && n0 + n < N)
                        ? we[(long long)(n0 + n) * K + k0 + kk] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FM_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
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
    const int r = ty * 4 + i;
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) yt[(long long)r * N + n] = r < live ? acc[i][j] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(FM_NT) gmm_dw_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const int* __restrict__ sizes, const int* __restrict__ lut,
    float* __restrict__ dw, int G, int K, int N, int span) {
  __shared__ __align__(16) float As[FM_BK][FM_BM + FM_PAD];
  __shared__ __align__(16) float Bs[FM_BK][FM_BN + FM_PAD];
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * FM_BM;
  const int n0 = blockIdx.x * FM_BN;
  const int tx = tid % (FM_BN / 4), ty = tid / (FM_BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < G; ++s) {
    if (lut[s] != e) continue;
    const int size = live_size(sizes, s, span);
    const long long base = (long long)s * span;
    for (int r0 = 0; r0 < size; r0 += FM_BK) {
      for (int i = tid; i < FM_BK * FM_BM; i += FM_NT) {
        const int kk = i / FM_BM, m = i % FM_BM;
        As[kk][m] = (r0 + kk < size && m0 + m < K)
                        ? x[(base + r0 + kk) * K + m0 + m] : 0.f;
      }
      for (int i = tid; i < FM_BK * FM_BN; i += FM_NT) {
        const int kk = i / FM_BN, n = i % FM_BN;
        Bs[kk][n] = (r0 + kk < size && n0 + n < N)
                        ? dy[(base + r0 + kk) * N + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FM_BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* dwe = dw + (long long)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= K) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dwe[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM_BYTES);
  *done = err == cudaSuccess;
  return err;
}

}  // namespace

// y [R, N] = the grouped product of x [R, K] (rows through ldx, K
// contiguous) with w: [W, K, N] contiguous, or with w_transposed = 1 the
// [W, N, K] tensor read as its transpose (dx = dy @ w^T). sizes [G] and
// lut [G] are int32 on the device, G = R / span. bf16 (dtype 1) needs K % 8
// == 0, N % 8 == 0, ldx % 8 == 0 and 16-byte aligned x and w; fp32 (dtype
// 0) takes any shape. Returns cudaGetLastError() after the launch.
extern "C" int ds_grouped_matmul(const void* x, long long ldx, const void* w,
                                 int w_transposed, const void* sizes,
                                 const void* lut, void* y, int R, int K,
                                 int N, int span, int dtype, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (R <= 0 || K <= 0 || N <= 0 || span <= 0 || R % span)
    return cudaErrorInvalidValue;
  const int G = R / span;
  const int* sz = static_cast<const int*>(sizes);
  const int* lt = static_cast<const int*>(lut);
  if (dtype == ds::DTYPE_F32) {
    const int tps = (span + FM_BM - 1) / FM_BM;
    const dim3 grid((N + FM_BN - 1) / FM_BN, G * tps);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    if (w_transposed)
      gmm_fwd_fma_kernel<true><<<grid, FM_NT, 0, cs>>>(xf, ldx, wf, sz, lt, yf,
                                                       K, N, span, tps);
    else
      gmm_fwd_fma_kernel<false><<<grid, FM_NT, 0, cs>>>(xf, ldx, wf, sz, lt,
                                                        yf, K, N, span, tps);
    return cudaGetLastError();
  }
  if (dtype != ds::DTYPE_BF16) return cudaErrorInvalidValue;
  if (K % 8 || N % 8 || ldx % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  const int tps = (span + MM_BM - 1) / MM_BM;
  const dim3 grid((N + MM_BN - 1) / MM_BN, G * tps);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  static bool ready[2] = {false, false};
  cudaError_t err;
  if (w_transposed) {
    err = allow_smem(gmm_fwd_mma_kernel<true>, &ready[1]);
    if (err != cudaSuccess) return err;
    gmm_fwd_mma_kernel<true><<<grid, MM_NT, MM_SMEM_BYTES, cs>>>(
        xb, ldx, wb, sz, lt, yb, K, N, span, tps);
  } else {
    err = allow_smem(gmm_fwd_mma_kernel<false>, &ready[0]);
    if (err != cudaSuccess) return err;
    gmm_fwd_mma_kernel<false><<<grid, MM_NT, MM_SMEM_BYTES, cs>>>(
        xb, ldx, wb, sz, lt, yb, K, N, span, tps);
  }
  return cudaGetLastError();
}

// dw [n_weights, K, N] fp32 = for each weight e, the sum over the spans s
// with lut[s] == e of x[s]^T @ dy[s] on the first sizes[s] rows; x [R, K]
// and dy [R, N] contiguous, in the dtype `dtype` says. Every element of dw
// is written. bf16 needs K % 8 == 0, N % 8 == 0 and 16-byte aligned x and
// dy. Returns cudaGetLastError() after the launch.
extern "C" int ds_grouped_matmul_dw(const void* x, const void* dy,
                                    const void* sizes, const void* lut,
                                    void* dw, int R, int K, int N, int span,
                                    int n_weights, int dtype, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (R <= 0 || K <= 0 || N <= 0 || span <= 0 || R % span || n_weights <= 0)
    return cudaErrorInvalidValue;
  const int G = R / span;
  const int* sz = static_cast<const int*>(sizes);
  const int* lt = static_cast<const int*>(lut);
  float* dwf = static_cast<float*>(dw);
  if (dtype == ds::DTYPE_F32) {
    const dim3 grid((N + FM_BN - 1) / FM_BN, (K + FM_BM - 1) / FM_BM,
                    n_weights);
    gmm_dw_fma_kernel<<<grid, FM_NT, 0, cs>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), sz, lt,
        dwf, G, K, N, span);
    return cudaGetLastError();
  }
  if (dtype != ds::DTYPE_BF16) return cudaErrorInvalidValue;
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 8)
    return cudaErrorInvalidValue;
  static bool ready = false;
  const cudaError_t err = allow_smem(gmm_dw_mma_kernel, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + MM_BN - 1) / MM_BN, (K + MM_BM - 1) / MM_BM, n_weights);
  gmm_dw_mma_kernel<<<grid, MM_NT, MM_SMEM_BYTES, cs>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), sz, lt, dwf,
      G, K, N, span);
  return cudaGetLastError();
}
