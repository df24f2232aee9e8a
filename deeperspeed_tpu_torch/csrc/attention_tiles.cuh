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
//
// The flash kernels' BERT flags ride the same steps as two functors: a
// per-key additive bias (`KeyBias`) and dropout on P (`Dropout`). Their
// defaults (`NoBias`, `NoDropout`) are compile-time no-ops, so every
// caller that passes neither keeps its code.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ds {
namespace attn {

constexpr int NT = 256;  // threads per block (16 x 16 micro-tile grid)

struct Strides {
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// ---------------------------------------------------------------------------
// the flags: key bias and dropout
// ---------------------------------------------------------------------------

// no key bias
struct NoBias {
  static constexpr bool kOn = false;
  __device__ float operator()(int) const { return 0.f; }
};

// the additive bias of the key tile's keys, staged in shared memory by
// the kernel (`flash_attention_kbias`: 0 keeps a key, -1e30 masks it);
// added after the scale, as the TPU kernels add it
struct KeyBias {
  static constexpr bool kOn = true;
  const float* tile;  // [keys of the tile]
  __device__ float operator()(int c) const { return tile[c]; }
};

// `_dropout_keep` of deeperspeed_tpu/ops/pallas/flash_attention.py:231: a
// 2-round avalanche hash of (seed, b·H + h, absolute row, absolute key),
// kept when its low 31 bits reach `thresh`. The TPU kernel computes it in
// wrapping int32; unsigned arithmetic wraps the same way, and its logical
// shifts equal the int32 `(x >> 16) & 0xFFFF`, `(x >> 15) & 0x1FFFF`.
// `mix` is seed + pid * 0xC2B2AE35. The last multiplier is the TPU code's
// -2073452917, that is 0x84699E8B (its comment names 0x846CA68B, another
// number; the code is what the masks follow).
__device__ __forceinline__ bool dropout_keep(unsigned mix, int row, int col,
                                             int thresh) {
  unsigned x = static_cast<unsigned>(row) * 0x9E3779B9u ^
               static_cast<unsigned>(col) * 0x85EBCA6Bu;
  x ^= mix;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x84699E8Bu;
  x ^= x >> 16;
  return static_cast<int>(x & 0x7FFFFFFFu) >= thresh;
}

__device__ __forceinline__ unsigned dropout_mix(const int* seed, int pid) {
  return static_cast<unsigned>(seed[0]) +
         static_cast<unsigned>(pid) * 0xC2B2AE35u;
}

// no dropout
struct NoDropout {
  static constexpr bool kOn = false;
  float inv = 1.f;
  __device__ bool keep(int, int) const { return true; }
};

// dropout on P for the tile at (row0, col0): a dropped p is 0, a kept
// one scaled by inv = 1 / (1 - rate); thresh and inv come from the host
// (computed in double as the JAX package does)
struct Dropout {
  static constexpr bool kOn = true;
  float inv;
  unsigned mix;
  int row0, col0, thresh;
  __device__ bool keep(int r, int c) const {
    return dropout_keep(mix, row0 + r, col0 + c, thresh);
  }
};

// the flags' functors for the (q tile, key tile) pair at (q0, k0): the
// key tile's bias staged at kb_tile, the dropout mix, threshold and scale
template <bool BIAS, bool DROP>
struct Flags {
  using Bias = std::conditional_t<BIAS, KeyBias, NoBias>;
  using Drop = std::conditional_t<DROP, Dropout, NoDropout>;
  Bias bias{};
  Drop drop{};
  __device__ Flags(const float* kb_tile, unsigned mix, int q0, int k0,
                   int thresh, float inv_keep) {
    if constexpr (BIAS) bias.tile = kb_tile;
    if constexpr (DROP) drop = {inv_keep, mix, q0, k0, thresh};
  }
};

// the bias of keys [k0, k0 + n) into dst; keys at or past S read 0
__device__ __forceinline__ void load_bias(float* dst, const float* kbias_b,
                                          int k0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += NT)
    dst[i] = k0 + i < S ? kbias_b[k0 + i] : 0.f;
}

// ---------------------------------------------------------------------------
// forward: a 64-row q tile against 64-key tiles, online softmax
// ---------------------------------------------------------------------------

constexpr int FWD_BQ = 64;  // q rows per block
constexpr int FWD_BK = 64;  // keys per tile

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
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
// done); keys at or past S are dead whatever `live` says. `bias(c)` is
// added to live scores after the scale; `drop` zeroes or scales p in the
// P V operand only, so the running sum l counts the undropped p
// (`_apply_dropout`: torch's dropout(softmax(s))).
template <typename T, int D, typename Live, typename Bias = NoBias,
          typename Drop = NoDropout>
__device__ __forceinline__ void fwd_tile(FwdSmem<D>& sm, FwdState<D>& st,
                                         const T* kb, const T* vb,
                                         long long kss, long long vss, int k0,
                                         int S, float sm_scale, Live live,
                                         Bias bias = Bias{},
                                         Drop drop = Drop{}) {
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
      float sc = s[i][j] * sm_scale;
      if constexpr (Bias::kOn) sc += bias(c);
      sm.Ps[r * (FWD_BK + 1) + c] = ok ? sc : NEG_INF;
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
      if constexpr (Drop::kOn)
        prow[c] = drop.keep(sr, c) ? p * drop.inv : 0.f;
      else
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
__host__ __device__ constexpr size_t bwd_smem_bytes() {
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
// `live(r, c)` decides which pairs count. Called between two syncs. With
// a key bias P = exp(s * scale + bias(c) - lse); with dropout the kept
// mask M scales P for dV and dP for dS (`_bwd_dkv_kernel`):
//   Ps = M ? P / keep : 0,  dS = P * ((M ? dP / keep : 0) - delta) * scale
template <int D, typename Live, typename Bias = NoBias,
          typename Drop = NoDropout>
__device__ __forceinline__ void bwd_p_and_ds(BwdSmem<D>& sm, float sm_scale,
                                             Live live, Bias bias = Bias{},
                                             Drop drop = Drop{}) {
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
      float sc = s[i][j] * sm_scale;
      if constexpr (Bias::kOn) sc += bias(c);
      const float p = live(r, c) ? __expf(sc - sm.row_lse[r]) : 0.f;
      float pv = p, dpv = dp[i][j];
      if constexpr (Drop::kOn) {
        const bool keep = drop.keep(r, c);
        pv = keep ? p * drop.inv : 0.f;
        dpv = keep ? dpv * drop.inv : 0.f;
      }
      sm.Ps[r * (B + 1) + c] = pv;
      sm.dSs[r * (B + 1) + c] = p * (dpv - sm.row_delta[r]) * sm_scale;
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
