// The tile steps shared by the attention kernels: the flash forward
// (flash_fwd.cu), the flash backward (flash_bwd.cu) and the block-sparse
// forward and backward (block_sparse_attention.cu). The kernels differ
// only in which key tiles (forward, dq) or query tiles (dk/dv) a block
// walks and which (row, key) pairs are live; each step here takes the
// tile's origin and a `live(r, c)` predicate over the tile's local row r
// and key c.
//
// Layout: q, k, v [B, S, H, D] read through (batch, seq, head) strides
// with the head dim contiguous; dO, out, dq, dk, dv [B, S, H, D]
// contiguous; lse, delta [B·H, S] fp32. Tiles are staged in shared
// memory as fp32 with rows padded by one word against bank conflicts;
// all products are fp32 FMA on register micro-tiles (thread (ty, tx) of
// a 16 x 16 grid owns rows ty + 16i and columns tx + 16j).
#pragma once

#include "common.cuh"

namespace ds {
namespace attn {

constexpr int NT = 256;  // threads per block (16 x 16 micro-tile grid)

struct Strides {
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// ---------------------------------------------------------------------------
// forward: a 64-row q tile against 64-key tiles, online softmax
// ---------------------------------------------------------------------------

constexpr int FWD_BQ = 64;  // q rows per block
constexpr int FWD_BK = 64;  // keys per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (FWD_BQ * (D + 1) + FWD_BK * (D + 1) + FWD_BK * D +
                          FWD_BQ * (FWD_BK + 1) + 3 * FWD_BQ) +
         sizeof(int) * (FWD_BQ + FWD_BK);
}

template <int D>
struct FwdSmem {
  float* Qs;         // [BQ][D + 1]
  float* Ks;         // [BK][D + 1]
  float* Vs;         // [BK][D]
  float* Ps;         // [BQ][BK + 1] scores, then p
  float* row_alpha;  // [BQ]
  float* row_m;      // [BQ]
  float* row_l;      // [BQ]
  int* seg_q;        // [BQ]
  int* seg_k;        // [BK]
  __device__ explicit FwdSmem(float* base) {
    Qs = base;
    Ks = Qs + FWD_BQ * (D + 1);
    Vs = Ks + FWD_BK * (D + 1);
    Ps = Vs + FWD_BK * D;
    row_alpha = Ps + FWD_BQ * (FWD_BK + 1);
    row_m = row_alpha + FWD_BQ;
    row_l = row_m + FWD_BQ;
    seg_q = reinterpret_cast<int*>(row_l + FWD_BQ);
    seg_k = seg_q + FWD_BQ;
  }
};

// one thread's running softmax state: the max and sum of its quad's row,
// and its 4 x D/16 slice of the output accumulator
template <int D>
struct FwdState {
  float m_i;
  float l_i;
  float acc[4][D / 16];
  __device__ void init() {
    m_i = NEG_INF;
    l_i = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
};

// q rows [q0, q0 + BQ) of one head into smem; rows at or past S read 0
template <typename T, int D>
__device__ __forceinline__ void fwd_load_q(FwdSmem<D>& sm, const T* qb,
                                           long long qss, int q0, int S) {
  for (int i = threadIdx.x; i < FWD_BQ * D; i += NT) {
    const int r = i / D, d = i % D, row = q0 + r;
    sm.Qs[r * (D + 1) + d] = row < S ? to_float(qb[row * qss + d]) : 0.f;
  }
}

// Keys [k0, k0 + BK): load K and V, score the q tile against them, mask
// the pairs `live` rejects to -1e30, and fold the tile into the online
// softmax. The caller syncs before (the previous tile's readers are
// done); keys at or past S are dead whatever `live` says.
template <typename T, int D, typename Live>
__device__ __forceinline__ void fwd_tile(FwdSmem<D>& sm, FwdState<D>& st,
                                         const T* kb, const T* vb,
                                         long long kss, long long vss, int k0,
                                         int S, float sm_scale, Live live) {
  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int sr = tid / 4;    // softmax row owned by this thread's quad
  const int part = tid % 4;  // quarter of that row
  for (int i = tid; i < FWD_BK * D; i += NT) {
    const int r = i / D, d = i % D, key = k0 + r;
    const bool ok = key < S;
    sm.Ks[r * (D + 1) + d] = ok ? to_float(kb[key * kss + d]) : 0.f;
    sm.Vs[r * D + d] = ok ? to_float(vb[key * vss + d]) : 0.f;
  }
  __syncthreads();

  // scores for rows ty + 16i, keys tx + 16j
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = sm.Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = sm.Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const bool ok = k0 + c < S && live(r, c);
      sm.Ps[r * (FWD_BK + 1) + c] = ok ? s[i][j] * sm_scale : NEG_INF;
    }
  }
  __syncthreads();

  // online softmax: each quad of lanes owns one row; a masked score
  // (-1e30) gets p = 0 exactly, so a row with no live key keeps l = 0
  {
    float* prow = sm.Ps + sr * (FWD_BK + 1);
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < FWD_BK / 4; ++jj)
      mx = fmaxf(mx, prow[part + 4 * jj]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m_i, mx);
    const float alpha = __expf(st.m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < FWD_BK / 4; ++jj) {
      const int c = part + 4 * jj;
      const float sv = prow[c];
      const float p = sv <= 0.5f * NEG_INF ? 0.f : __expf(sv - m_new);
      prow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    st.l_i = alpha * st.l_i + sum;
    st.m_i = m_new;
    if (part == 0) sm.row_alpha[sr] = alpha;
  }
  __syncthreads();

  // acc = acc * alpha + P V for rows ty + 16i, columns tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = sm.row_alpha[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) st.acc[i][j] *= a;
  }
#pragma unroll 4
  for (int c = 0; c < FWD_BK; ++c) {
    float vv[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) vv[j] = sm.Vs[c * D + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = sm.Ps[(ty + 16 * i) * (FWD_BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) st.acc[i][j] = fmaf(p, vv[j], st.acc[i][j]);
    }
  }
}

// out rows [q0, q0 + BQ) of head (b, h) and their lse; a row with no live
// key (l = 0) gets zeros and lse = +1e30
template <typename T, int D>
__device__ __forceinline__ void fwd_store(FwdSmem<D>& sm,
                                          const FwdState<D>& st, T* out,
                                          float* lse, int b, int h, int S,
                                          int H, int q0) {
  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  __syncthreads();
  if (tid % 4 == 0) {
    sm.row_m[tid / 4] = st.m_i;
    sm.row_l[tid / 4] = st.l_i;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= S) continue;
    const float l = sm.row_l[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_float<T>(st.acc[i][j] * inv);
    if (tx == 0)
      lse[((long long)b * H + h) * S + row] =
          l == 0.f ? -NEG_INF : sm.row_m[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// backward: P and dS recomputed from the lse on (q tile, key tile) pairs
//
//   P  = exp(s * scale - lse) on live pairs, else 0
//   dP = dO V^T,  dS = P * (dP - delta) * scale
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
// ---------------------------------------------------------------------------

// rows per tile (q rows and keys alike): 64, or 32 where D = 256 would
// not fit four fp32 tiles in shared memory
template <int D>
__host__ __device__ constexpr int bwd_rows() {
  return D <= 128 ? 64 : 32;
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  constexpr int B = bwd_rows<D>();
  return sizeof(float) * (4 * B * (D + 1) + 2 * B * (B + 1) + 2 * B) +
         sizeof(int) * 2 * B;
}

template <int D>
struct BwdSmem {
  static constexpr int B = bwd_rows<D>();
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *row_lse, *row_delta;
  int *seg_q, *seg_k;
  __device__ explicit BwdSmem(float* base) {
    Qs = base;
    dOs = Qs + B * (D + 1);
    Ks = dOs + B * (D + 1);
    Vs = Ks + B * (D + 1);
    Ps = Vs + B * (D + 1);
    dSs = Ps + B * (B + 1);
    row_lse = dSs + B * (B + 1);
    row_delta = row_lse + B;
    seg_q = reinterpret_cast<int*>(row_delta + B);
    seg_k = seg_q + B;
  }
};

// rows [r0, r0 + B) of one head of x (read through its row stride) into
// smem [B][D + 1] as fp32; rows at or past S read as 0
template <typename T, int D, int B>
__device__ __forceinline__ void bwd_load_tile(float* dst, const T* src, int r0,
                                              int S, long long row_stride) {
  for (int i = threadIdx.x; i < B * D; i += NT) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? to_float(src[row * row_stride + d]) : 0.f;
  }
}

// q rows [q0, q0 + B): Q and dO tiles, their lse and delta
template <typename T, int D>
__device__ __forceinline__ void bwd_load_q_side(BwdSmem<D>& sm, const T* qb,
                                                const T* db,
                                                const float* lse_bh,
                                                const float* delta_bh, int q0,
                                                int S, int H, long long qss) {
  constexpr int B = BwdSmem<D>::B;
  bwd_load_tile<T, D, B>(sm.Qs, qb, q0, S, qss);
  bwd_load_tile<T, D, B>(sm.dOs, db, q0, S, (long long)H * D);
  for (int i = threadIdx.x; i < B; i += NT) {
    const bool ok = q0 + i < S;
    sm.row_lse[i] = ok ? lse_bh[q0 + i] : -NEG_INF;
    sm.row_delta[i] = ok ? delta_bh[q0 + i] : 0.f;
  }
}

// P and dS of the staged (q tile, key tile) pair into Ps / dSs [B][B + 1];
// `live(r, c)` decides which pairs count. Called between two syncs.
template <int D, typename Live>
__device__ __forceinline__ void bwd_p_and_ds(BwdSmem<D>& sm, float sm_scale,
                                             Live live) {
  constexpr int B = BwdSmem<D>::B;
  constexpr int R = B / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = sm.Qs[(ty + 16 * i) * (D + 1) + d];
      dov[i] = sm.dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = sm.Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = sm.Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const float p =
          live(r, c) ? __expf(s[i][j] * sm_scale - sm.row_lse[r]) : 0.f;
      sm.Ps[r * (B + 1) + c] = p;
      sm.dSs[r * (B + 1) + c] = p * (dp[i][j] - sm.row_delta[r]) * sm_scale;
    }
  }
}

// dV += P^T dO, dK += dS^T Q for keys ty + 16i, dims tx + 16j
template <int D>
__device__ __forceinline__ void bwd_acc_dkv(
    const BwdSmem<D>& sm, float (&acc_k)[BwdSmem<D>::B / 16][D / 16],
    float (&acc_v)[BwdSmem<D>::B / 16][D / 16]) {
  constexpr int B = BwdSmem<D>::B;
  constexpr int R = B / 16, DJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < B; ++r) {
    float pv[R], dsv[R], dov[DJ], qv[DJ];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      pv[i] = sm.Ps[r * (B + 1) + ty + 16 * i];
      dsv[i] = sm.dSs[r * (B + 1) + ty + 16 * i];
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dov[j] = sm.dOs[r * (D + 1) + tx + 16 * j];
      qv[j] = sm.Qs[r * (D + 1) + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        acc_v[i][j] = fmaf(pv[i], dov[j], acc_v[i][j]);
        acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
      }
  }
}

// dQ += dS K for rows ty + 16i, dims tx + 16j
template <int D>
__device__ __forceinline__ void bwd_acc_dq(
    const BwdSmem<D>& sm, float (&acc)[BwdSmem<D>::B / 16][D / 16]) {
  constexpr int B = BwdSmem<D>::B;
  constexpr int R = B / 16, DJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int c = 0; c < B; ++c) {
    float dsv[R], kv[DJ];
#pragma unroll
    for (int i = 0; i < R; ++i) dsv[i] = sm.dSs[(ty + 16 * i) * (B + 1) + c];
#pragma unroll
    for (int j = 0; j < DJ; ++j) kv[j] = sm.Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
  }
}

// rows [r0, r0 + B) of one [B, S, H, D] gradient from a thread's
// accumulator (rows ty + 16i, dims tx + 16j); rows at or past S skipped
template <typename T, int D>
__device__ __forceinline__ void bwd_store(
    T* g, const float (&acc)[BwdSmem<D>::B / 16][D / 16], int b, int h,
    int r0, int S, int H) {
  constexpr int R = BwdSmem<D>::B / 16, DJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
    const long long o = (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) g[o + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <int R, int DJ>
__device__ __forceinline__ void zero(float (&a)[R][DJ]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) a[i][j] = 0.f;
}

}  // namespace attn
}  // namespace ds
