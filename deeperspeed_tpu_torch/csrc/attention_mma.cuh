// The tensor-core pieces of the bf16 and fp16 flash kernels (flash_fwd.cu,
// flash_bwd.cu) and of the bf16 block-sparse forward, dK/dV and dQ kernels
// (block_sparse_attention.cu): 64-row tiles of 16-bit elements T (bf16 or
// fp16; every piece is a template over T) in shared memory
// filled by cp.async, fragments built by ldmatrix, products by mma.sync
// m16n8k16 with fp32 accumulators (common.cuh), and the
// accumulator-to-operand repacking that keeps P and dS in registers.
//
// A block is 4 warps; each warp owns 16 rows of the block's 64-row side
// (q rows in the forward and dq kernels, keys in the dk/dv kernel) and
// walks 64-row tiles of the other side. A warp's m16n8 accumulator over a
// 64-wide tile is float[8][4]: lane l holds rows g = l/4 and g + 8 of the
// warp's 16 and columns 8j + 2(l%4) + {0, 1} of n-tile j (elements e = 0,
// 1 on row g, e = 2, 3 on row g + 8). That is the m16n8k16 A fragment's
// layout too, so a tile of P or dS packed to T pairs is the A operand
// of the next product with no shared-memory round trip (`pack_a`).
//
// Tiles are stored row-major with rows padded by 8 elements (16 bytes):
// the 8 row addresses of one ldmatrix matrix then fall in 8 distinct
// 16-byte bank groups, so fragment loads have no bank conflicts. Which
// of the two layouts a product needs decides the ldmatrix form:
//   A·Bᵀ with B stored [n][k] (K for Q·Kᵀ, Q for K·Qᵀ): ldmatrix;
//   A·B  with B stored [k][n] (V for P·V, dO for Pᵀ·dO): ldmatrix.trans.
#pragma once

#include <climits>
#include <type_traits>

#include "attention_tiles.cuh"

namespace ds {
namespace mma_attn {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int NTM = 32 * WARPS;  // threads a block
constexpr int BM = 16 * WARPS;   // the block's own rows
constexpr int BN = 64;           // rows of a tile of the other side
constexpr int PAD = 8;           // elements of row padding (16 bytes)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BM == 64 && BN == 64 && NTM == 128,
              "tile_live and the loaders assume 64-row tiles, 128 threads");

// which tile step a (dtype, head dim) takes: the tensor-core one for bf16
// and fp16 at D = 64 and 128; fp32 (parity) and D = 256 (its accumulators
// would spill) keep attention_tiles.cuh's FMA steps
template <typename T, int D>
__host__ __device__ constexpr bool takes_mma() {
  return (std::is_same<T, bf16>::value || std::is_same<T, __half>::value) &&
         (D == 64 || D == 128);
}

template <int D>
__host__ __device__ constexpr int ld() {
  return D + PAD;
}

// elements of one stored 64-row tile
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return BN * ld<D>();
}

// rows [r0, r0 + 64) of one head (row stride `stride`, head dim
// contiguous, 16-byte aligned) into dst [64][D + PAD] by 16-byte cp.async;
// rows at or past S are zero-filled. The caller commits the group.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int r0, int S) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < BN * CPR; c += NTM) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld<D>() + col,
               ok ? src + (long long)(r0 + r) * stride + col : src, ok);
  }
}

// the A fragments (16 rows from row0, k-step kk) of a stored tile
template <int D, typename T>
__device__ __forceinline__ void a_frag(unsigned (&a)[4], const T* tile,
                                       int row0, int kk) {
  const int lane = threadIdx.x % 32, mat = lane / 8, r = lane % 8;
  ldmatrix_x4(a, tile + (row0 + r + 8 * (mat % 2)) * ld<D>() + kk * 16 +
                     8 * (mat / 2));
}

// A operand kept in registers: frags[kk] for k-step kk
template <int KS>
struct RegA {
  const unsigned (&f)[KS][4];
  __device__ void operator()(int kk, unsigned (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
  }
};

// A operand read from a stored tile at each k-step (rows row0..row0+15)
template <int D, typename T = bf16>
struct SmemA {
  const T* tile;
  int row0;
  __device__ void operator()(int kk, unsigned (&a)[4]) const {
    a_frag<D>(a, tile, row0, kk);
  }
};

// acc[N/8][4] += A (16 x 16·KS) · Bᵀ, B stored [n][k] (rows 0..N-1 of bt,
// k contiguous, row stride ldb); A and B of bt's element type
template <int KS, int N, typename AFrag, typename T>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], AFrag afrag,
                                        const T* bt, int ldb) {
  const int lane = threadIdx.x % 32, mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned a[4];
    afrag(kk, a);
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      unsigned t[4];
      ldmatrix_x4(t, bt + (jp * 16 + r + 8 * (mat / 2)) * ldb + kk * 16 +
                         8 * (mat % 2));
      mma16<T>(acc[2 * jp], a, t[0], t[1]);
      mma16<T>(acc[2 * jp + 1], a, t[2], t[3]);
    }
  }
}

// acc[N/8][4] += A (16 x 16·KS, fragments in registers) · B, B stored
// [k][n] (rows 0..16·KS-1 of b, n contiguous, row stride ldb)
template <int KS, int N, typename T>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 8][4],
                                       const unsigned (&a)[KS][4],
                                       const T* b, int ldb) {
  const int lane = threadIdx.x % 32, mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      unsigned t[4];
      ldmatrix_x4_trans(t, b + (kk * 16 + r + 8 * (mat % 2)) * ldb +
                               jp * 16 + 8 * (mat / 2));
      mma16<T>(acc[2 * jp], a[kk], t[0], t[1]);
      mma16<T>(acc[2 * jp + 1], a[kk], t[2], t[3]);
    }
  }
}

// a 16 x 16·KS fp32 accumulator tile (float[2·KS][4]), rounded to nearest
// T (fp16: past 65504 to inf, so an overflow of dS shows in dQ, dK), as
// the A operand (KS k-steps of 16) of the next product
template <int KS, typename T = bf16>
__device__ __forceinline__ void pack_a(unsigned (&a)[KS][4],
                                       const float (&s)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// Pᵀ (or P) and dS of one accumulator element, from the fp32 score s and
// dP at (row, key), with off2 = (bias − lse)·log2 e: P = 2^(s·scale2 +
// off2) = exp(s·scale + bias − lse) on live pairs; with dropout the
// forward's keep-mask M scales P for dV and dP for dS:
//   pv = M ? P / keep : 0,  ds = P · ((M ? dP / keep : 0) − delta) · scale
template <bool DROP>
__device__ __forceinline__ void p_and_ds(float& s_io, float& dp_io, bool live,
                                         float scale2, float off2,
                                         float delta_r, float sm_scale,
                                         unsigned mix, int row, int key,
                                         int thresh, float inv_keep) {
  const float p = live ? ex2(fmaf(s_io, scale2, off2)) : 0.f;
  float pv = p, dpv = dp_io;
  if constexpr (DROP) {
    const bool keep = attn::dropout_keep(mix, row, key, thresh);
    pv = keep ? p * inv_keep : 0.f;
    dpv = keep ? dpv * inv_keep : 0.f;
  }
  s_io = pv;
  dp_io = p * (dpv - delta_r) * sm_scale;
}

// fp32 values [r0, r0 + 64) of a row (lse, delta, key bias) into dst by
// 4-byte cp.async, one a thread of threads [t0, t0 + 64); past S
// zero-filled. The caller commits the group.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int S, int t0 = 0) {
  const int i = threadIdx.x - t0;
  if (i >= 0 && i < BN)
    cp_async4(dst + i, r0 + i < S ? src + r0 + i : src, r0 + i < S);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// A lane's two rows of a [.., D] output (row stride row_stride from base):
// acc[D/8][4] holds rows[0] (elements 0, 1) and rows[1] (2, 3), each row
// scaled by scale[r] and written as T pairs rounded to nearest; rows at
// or past S skipped
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           const float (&acc)[D / 8][4],
                                           const int (&rows)[2], int S,
                                           const float (&scale)[2]) {
  const int qd = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    T* p = base + (long long)rows[r] * row_stride + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(p + 8 * j) = pack2<T>(
          acc[j][2 * r] * scale[r], acc[j][2 * r + 1] * scale[r]);
  }
}

// Any live (causal, same-segment) pair between the block's own 64 rows
// (origin own0, their segment ids staged in own_s) and the 64 rows of the
// other side at other0? own_is_q says whether the block's rows are q rows
// (forward, dq) or keys (dk/dv). Called by every thread of the block.
__device__ __forceinline__ bool tile_live(const int* own_s, const int* seg_b,
                                          int own0, int other0, bool own_is_q,
                                          int S, int causal) {
  const int c = threadIdx.x % BN, half = threadIdx.x / BN;
  const int o = other0 + c;
  int hit = 0;
  if (o < S) {
    const int so = seg_b[o];
#pragma unroll 8
    for (int r = half * 32; r < half * 32 + 32; ++r) {
      const int w = own0 + r;
      const int row = own_is_q ? w : o, key = own_is_q ? o : w;
      hit |= (w < S) & (!causal | (key <= row)) & (own_s[r] == so);
    }
  }
  return __syncthreads_or(hit);
}

// the segment ids of rows [r0, r0 + 64) into dst; rows past S get INT_MIN
__device__ __forceinline__ void load_own_seg(int* dst, const int* seg_b,
                                             int r0, int S) {
  for (int i = threadIdx.x; i < BM; i += NTM)
    dst[i] = r0 + i < S ? seg_b[r0 + i] : INT_MIN;
}

}  // namespace mma_attn
}  // namespace ds
