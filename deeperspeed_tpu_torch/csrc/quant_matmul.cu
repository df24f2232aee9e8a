// Weight-only int8 matmul for sm_90a: y[m, n] = (sum_k x[m, k] * q[k, n])
// * scale[n], fp32 accumulation, y in x's dtype (fp32, bf16 or fp16).
//
// Replaces the TPU kernel `_wq_kernel` of
// deeperspeed_tpu/ops/pallas/quant_matmul.py (launched by
// `quant_matmul_pallas`). As there, the int8 weight crosses device memory
// at one byte an element and is widened on chip, and the per-channel
// scale, which commutes with the contraction, multiplies the fp32 sum
// once in the epilogue. int8 -> bf16 or fp16 and either -> fp32 are
// exact, so the products are exact and only the summation order differs
// from the plain version.
//
// Bound on the H100: at decode (M = 16 rows, one per sequence) each
// weight byte feeds 2 * 16 flops, far below the ~295 flops a byte at
// which the tensor cores would become the limit, so the weight bytes
// bound it; at a large prefill (M = 4096) it is the flops. Design:
//
// - bf16 or fp16 x (16-byte aligned rows, N % 16 == 0, K % 8 == 0): one
//   launch of `qmm_wgmma_kernel<T, TN>` (csrc/hopper_gemm.cuh; T the
//   16-bit type, wgmma `.bf16` or `.f16`), which computes yᵀ: a CTA
//   owns 128 weight columns by a tile of 16, 32, 64, 128 or 256 token
//   rows (the wrapper's plan). One producer thread keeps a ring of up to
//   8 stages of TMA loads in flight (the x tile, 16-bit, 128-byte
//   swizzle, and the int8 weight tile [64 k][128 n]). Each of two consumer
//   warpgroups widens its 64 columns of every int8 tile into a swizzled
//   tile of T in shared memory (byte permutes into fp32 words with the
//   exponent of 2^23 and one subtraction, exact for -128..127; bf16 packs
//   the high halves, fp16 converts each pair, exact for integers up to
//   2048; double-buffered), fences it for the async proxy and runs
//   wgmma m64nTk16 with that tile as the MN-major A and the x tile as the
//   K-major B, fp32 accumulators in registers. So 16 decode rows are
//   wgmma's N and waste nothing.
// - Too few output tiles to fill the card (decode, prefill; N = 768): the
//   K range is split over a thread-block cluster of up to 8 CTAs in the
//   same launch. Rank r reduces token rows r of the tile: every rank
//   pushes its fp32 partial of those rows into its own slot of rank r's
//   buffer through distributed shared memory, one cluster barrier, then
//   rank r sums the slots in rank order (bit-identical from call to
//   call), scales, casts and stores. The order is JAX's (`_wq_kernel`):
//   the fp32 sum, then the fp32 scale, then one rounding to x's dtype
//   (to nearest; fp16 past 65504 to inf). No workspace, no second kernel: one
//   launch a call. A lone CTA scales and casts in registers and stores
//   its tile through shared memory as 16-byte chunks.
// - FMA path for fp32 x (exact fp32 products, as the plain version):
//   64 x 64 tiles, K in steps of 32 staged in shared memory (the weight
//   tile read with 16-byte loads where N allows, widened once), 4 x 4
//   outputs a thread.
// - TMA zero-fills the ragged M, N and K edges; stores are bounded by M
//   and N. 16-bit inputs that TMA cannot read (unaligned base, row stride
//   or N) are refused (the wrapper raises first); every GPT-NeoX block
//   matmul meets the conditions.
#include <cstdint>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

// tiled path
constexpr int TL_NT = 256;
constexpr int TL_BM = 64;
constexpr int TL_BN = 64;
constexpr int TL_BK = 32;
constexpr int TL_PAD = 4;                 // keeps float4 rows aligned

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

namespace hp = ds::hopper;
using bf16 = __nv_bfloat16;

// wgmma path
constexpr int QW_BK = 64;            // k a stage: one 128-byte bf16 line
constexpr int QW_WN = 128;           // weight columns a CTA: 64 a warpgroup
constexpr int QW_CONSUMERS = 256;    // two warpgroups
constexpr int QW_THREADS = 384;      // + the producer warpgroup
constexpr int QW_P_LD = QW_WN + 4;   // fp32 partial row stride
constexpr int QW_SMEM_MAX = 232448;  // the H100's shared memory a block

// Shared memory of the kernel for a token tile of TN rows: two buffers of
// the widened bf16 weight tile (each warpgroup's 64 columns an MN-major
// [64 k][64] block), then the ring, a stage holding the x tile [TN][64 k]
// (K-major) and the int8 staging tile [64 k][128 n], as many stages as
// fit up to 8; then, for a tile that a cluster shares (TN <= 128), the
// fp32 partial buffer [cluster][TN / cluster][128] that the ranks push
// into. The bf16 output tile of a lone CTA reuses the ring.
template <int TN>
struct QwLayout {
  static constexpr int W_BYTES = QW_BK * QW_WN * 2;      // one buffer
  static constexpr int RING_OFF = 2 * W_BYTES;
  static constexpr int X_BYTES = TN * QW_BK * 2;
  static constexpr int Q_OFF = X_BYTES;
  static constexpr int Q_BYTES = QW_BK * QW_WN;
  static constexpr int STAGE = X_BYTES + Q_BYTES;
  static constexpr bool CLUSTER = TN <= 128;
  static constexpr int P_BYTES = CLUSTER ? TN * QW_P_LD * 4 : 0;
  static constexpr int FIT =
      (QW_SMEM_MAX - 1024 - 256 - RING_OFF - P_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int P_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BARS = P_OFF + P_BYTES;
  static constexpr int SMEM = 1024 + BARS + 2 * STAGES * 8;
  static constexpr int OUT_LD = 64 + 8;                  // bf16 tile row
  static_assert(X_BYTES % 1024 == 0 && STAGE % 1024 == 0, "1 KB tiles");
  static_assert(SMEM <= QW_SMEM_MAX, "shared memory");
  static_assert(2 * TN * OUT_LD * 2 <= STAGES * STAGE, "output tile");
};

// four int8 (one word, the lower k or n in the low byte) -> two pairs of
// T (bf16x2 or half2) words: each byte, offset to unsigned, becomes the
// low byte of the fp32 word 0x4B0000uu = 2^23 + uu; subtracting 2^23 +
// 128 gives the integer exactly. bf16: an integer of at most 8
// significant bits has a zero low half, so the high half is its exact
// bf16; fp16: each pair converted (exact: |integer| <= 128 < 2048)
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) -
           8388736.f;
  if constexpr (std::is_same<T, __half>::value) {
    lo = ds::pack2<__half>(f[0], f[1]);
    hi = ds::pack2<__half>(f[2], f[3]);
  } else {
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
  }
}

// warpgroup cw's 64 columns of the int8 stage [64 k][128 n] -> its block
// [k][64] of T in w, each 128-byte k line swizzled; t is the thread's
// index in the warpgroup
template <typename T>
__device__ __forceinline__ void widen_half(const unsigned char* q,
                                           unsigned char* w, int cw, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int it = t + 128 * i;
    const int r = it >> 2, c = (it & 3) * 16;     // k line, first column
    const uint4 v =
        *reinterpret_cast<const uint4*>(q + r * QW_WN + cw * 64 + c);
    uint4 a, b;
    widen4<T>(v.x, a.x, a.y);
    widen4<T>(v.y, a.z, a.w);
    widen4<T>(v.z, b.x, b.y);
    widen4<T>(v.w, b.z, b.w);
    const int ch = c >> 3;
    unsigned char* line = w + cw * (QW_BK * 128) + r * 128;
    *reinterpret_cast<uint4*>(line + ((ch ^ (r & 7)) << 4)) = a;
    *reinterpret_cast<uint4*>(line + (((ch + 1) ^ (r & 7)) << 4)) = b;
  }
}

// One CTA: yᵀ for 128 weight columns (n0) by TN token rows (m0), over the
// k tiles of its cluster rank. Warpgroup cw's A is its 64 widened weight
// columns (MN-major), the B of both is the x tile (K-major, TMA): wgmma
// m64nTNk16.
template <typename T, int TN>
__global__ void __launch_bounds__(QW_THREADS, 1) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap qmap, const float* __restrict__ scale,
    T* __restrict__ y, int M, int N, int K, int k_per_rank) {
  using L = QwLayout<TN>;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem + L::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const uint32_t cs = hp::cluster_size(), rank = hp::cluster_rank();
  const int n0 = (blockIdx.x / cs) * QW_WN;
  const int m0 = blockIdx.y * TN;
  const int k_tiles = (K + QW_BK - 1) / QW_BK;
  const int kt0 = rank * k_per_rank;
  const int nk = max(0, min(k_tiles, kt0 + k_per_rank) - kt0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], QW_CONSUMERS);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= QW_CONSUMERS) {
    // producer warpgroup: one thread issues the loads
    hp::setmaxnreg_dec<40>();
    if (tid == QW_CONSUMERS) {
      hp::RingPos<S> pos;
      for (int i = 0; i < nk; ++i, pos.advance()) {
        if (pos.round > 0) hp::mbar_wait(&empty[pos.stage], pos.parity() ^ 1);
        unsigned char* st = ring + pos.stage * L::STAGE;
        hp::mbar_arrive_expect_tx(&full[pos.stage], L::STAGE);
        const int k = (kt0 + i) * QW_BK;
        hp::tma_load_2d(st, &xmap, &full[pos.stage], k, m0);
        hp::tma_load_2d(st + L::Q_OFF, &qmap, &full[pos.stage], n0, k);
      }
    }
    __syncwarp();
    if (cs > 1) hp::cluster_sync();   // the consumers' one cluster barrier
    return;
  }

  // consumer warpgroups: warpgroup cw owns weight columns 64 cw .. +63;
  // a thread's accumulators hold columns c0 and c0 + 8
  hp::setmaxnreg_inc<232>();
  const int cw = tid / 128, t = tid % 128;
  const int wi = t / 32, lane = t % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int c0 = cw * 64 + wi * 16 + g;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  hp::fence_operand(acc);
  hp::RingPos<S> pos;
  int prev = -1;
  for (int i = 0; i < nk; ++i, pos.advance()) {
    hp::mbar_wait(&full[pos.stage], pos.parity());
    const unsigned char* st = ring + pos.stage * L::STAGE;
    // the widened buffer of stage i - 2 is free: wgmma_wait<1> of step i - 1
    unsigned char* w = smem + (i & 1) * L::W_BYTES;
    widen_half<T>(st + L::Q_OFF, w, cw, t);
    hp::fence_proxy_async();
    hp::named_bar_sync(1 + cw, 128);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QW_BK / 16; ++kk) {
      const uint64_t da = hp::sw128_desc(
          w + cw * QW_BK * 128 + kk * 2048, QW_BK * 128, 1024);
      const uint64_t db = hp::sw128_desc(st + kk * 32, 0, 1024);
      hp::wgmma<TN, 1, 0, T>(acc, da, db);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();          // the previous stage's products are done
    if (prev >= 0) hp::mbar_arrive(&empty[prev]);
    prev = pos.stage;
  }
  hp::wgmma_wait<0>();
  hp::fence_operand(acc);

  if (cs == 1) {
    // A lone CTA: scale and cast in registers, stage each warpgroup's
    // [TN][64] tile of T in the ring (free once both warpgroups are done),
    // and store it as 16-byte chunks of y's rows.
    const float s0 = n0 + c0 < N ? scale[n0 + c0] : 0.f;
    const float s1 = n0 + c0 + 8 < N ? scale[n0 + c0 + 8] : 0.f;
    hp::named_bar_sync(3, QW_CONSUMERS);
    T* tile = reinterpret_cast<T*>(smem + L::RING_OFF) + cw * TN * L::OUT_LD;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * q4 + (e & 1);
        const int c = wi * 16 + g + (e >= 2 ? 8 : 0);
        tile[r * L::OUT_LD + c] =
            ds::from_float<T>(acc[4 * j + e] * (e >= 2 ? s1 : s0));
      }
    hp::named_bar_sync(1 + cw, 128);
#pragma unroll 4
    for (int it = t; it < TN * 8; it += 128) {
      const int r = it / 8, c = (it % 8) * 8;
      const int m = m0 + r, n = n0 + cw * 64 + c;
      if (m < M && n < N)
        *reinterpret_cast<uint4*>(y + (long long)m * N + n) =
            *reinterpret_cast<const uint4*>(tile + r * L::OUT_LD + c);
    }
    return;
  }

  if constexpr (L::CLUSTER) {
    // Rank r reduces token rows [r * rows, (r + 1) * rows): each rank
    // pushes its fp32 partial of those rows into slot `rank` of rank r's
    // buffer (remote stores through the cluster, its own locally), one
    // cluster barrier, then rank r sums its slots in rank order.
    float* P = reinterpret_cast<float*>(smem + L::P_OFF);
    const int rows = TN / cs;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * q4 + (e & 1);
        const int c = c0 + (e >= 2 ? 8 : 0);
        const uint32_t dest = r * cs / TN;          // TN and cs: powers of 2
        float* dst = P + (rank * rows + r - dest * rows) * QW_P_LD + c;
        if (dest == rank)
          *dst = acc[4 * j + e];
        else
          hp::st_cluster_f32(hp::map_rank(hp::smem_addr(dst), dest),
                             acc[4 * j + e]);
      }
    hp::cluster_sync();   // every partial has landed

    // the slots summed in rank order, scaled, cast and stored, four float4
    // items a thread at a time so that their loads overlap
    constexpr int ITEM_ROW = QW_WN / 4;
    const int items = rows * ITEM_ROW;
    for (int base = tid; base < items; base += 4 * QW_CONSUMERS) {
      float4 sum[4], sc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * QW_CONSUMERS;
        const int n = n0 + (it % ITEM_ROW) * 4;
        sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        sc[u] = it < items && n < N
                    ? make_float4(scale[n], scale[n + 1], scale[n + 2],
                                  scale[n + 3])
                    : sum[u];
      }
      for (uint32_t j = 0; j < cs; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int it = base + u * QW_CONSUMERS;
          if (it >= items) continue;
          const float4 v = *reinterpret_cast<const float4*>(
              P + (j * rows + it / ITEM_ROW) * QW_P_LD + (it % ITEM_ROW) * 4);
          sum[u].x += v.x;
          sum[u].y += v.y;
          sum[u].z += v.z;
          sum[u].w += v.w;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * QW_CONSUMERS;
        const int m = m0 + rank * rows + it / ITEM_ROW;
        const int n = n0 + (it % ITEM_ROW) * 4;
        if (it >= items || m >= M || n >= N) continue;
        uint2 o;
        o.x = ds::pack2<T>(sum[u].x * sc[u].x, sum[u].y * sc[u].y);
        o.y = ds::pack2<T>(sum[u].z * sc[u].z, sum[u].w * sc[u].w);
        *reinterpret_cast<uint2*>(y + (long long)m * N + n) = o;
      }
    }
  }
}

template <typename T, int TN>
cudaError_t launch_wgmma(const T* x, long long ldx, const int8_t* q,
                         const float* scale, T* y, int M, int N, int K,
                         int cluster, cudaStream_t stream) {
  using L = QwLayout<TN>;
  CUtensorMap xm, qm;
  const uint64_t xd[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xs[1] = {static_cast<uint64_t>(ldx) * 2};
  const uint32_t xb[2] = {QW_BK, TN};
  cudaError_t err = hp::tensor_map(
      &xm, x,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t qd[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t qs[1] = {static_cast<uint64_t>(N)};
  const uint32_t qb[2] = {QW_WN, QW_BK};
  err = hp::tensor_map(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qd, qs, qb,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  static bool ready = false;
  if (!ready) {
    err = cudaFuncSetAttribute(qmm_wgmma_kernel<T, TN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int k_tiles = (K + QW_BK - 1) / QW_BK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((N + QW_WN - 1) / QW_WN), (M + TN - 1) / TN);
  cfg.blockDim = dim3(QW_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmm_wgmma_kernel<T, TN>, xm, qm, scale, y,
                            M, N, K, (k_tiles + cluster - 1) / cluster);
}

template <typename T>
cudaError_t dispatch_tile(const void* x, long long ldx, const int8_t* q,
                          const float* scale, void* y, int M, int N, int K,
                          int tile, int cluster, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (tile) {
    case 16:
      return launch_wgmma<T, 16>(xt, ldx, q, scale, yt, M, N, K, cluster,
                                 stream);
    case 32:
      return launch_wgmma<T, 32>(xt, ldx, q, scale, yt, M, N, K, cluster,
                                 stream);
    case 64:
      return launch_wgmma<T, 64>(xt, ldx, q, scale, yt, M, N, K, cluster,
                                 stream);
    case 128:
      return launch_wgmma<T, 128>(xt, ldx, q, scale, yt, M, N, K, cluster,
                                  stream);
    case 256:
      return launch_wgmma<T, 256>(xt, ldx, q, scale, yt, M, N, K, cluster,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
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

// x: [M, K] through its row stride ldx (K contiguous), fp32, bf16 or fp16
// as `dtype` says; q: [K, N] int8 contiguous; scale: [N] fp32; y: [M, N]
// contiguous in x's dtype. bf16 and fp16 take the wgmma kernel with the
// plan the wrapper chose: token tiles of `tile` rows (16, 32, 64, 128 or
// 256) and `cluster` (1, 2, 4 or 8; 1 for 256-row tiles) CTAs splitting
// K. They need K % 8 == 0, N % 16 == 0, ldx % 8 == 0 and 16-byte aligned x
// and q (cudaErrorInvalidValue otherwise); fp32 ignores the plan. Returns
// the launch's error.
extern "C" int ds_quant_matmul(const void* x, long long ldx, const void* q,
                               const void* scale, void* y, int M, int N,
                               int K, int tile, int cluster, int dtype,
                               void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == ds::DTYPE_F32)
    return launch_fma(static_cast<const float*>(x), ldx, qb, sc,
                      static_cast<float*>(y), M, N, K, cs);
  if (dtype != ds::DTYPE_BF16 && dtype != ds::DTYPE_F16)
    return cudaErrorInvalidValue;
  const bool ok = K > 0 && K % 8 == 0 && ldx % 8 == 0 && N % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  (cluster == 1 || cluster == 2 || cluster == 4 ||
                   cluster == 8) &&
                  (tile <= 128 || cluster == 1);
  if (!ok) return cudaErrorInvalidValue;
  if (dtype == ds::DTYPE_F16)
    return dispatch_tile<__half>(x, ldx, qb, sc, y, M, N, K, tile, cluster,
                                 cs);
  return dispatch_tile<bf16>(x, ldx, qb, sc, y, M, N, K, tile, cluster, cs);
}
