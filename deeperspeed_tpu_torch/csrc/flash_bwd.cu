// Flash-attention backward, causal or not, with optional segment ids, an
// optional 128-grain layout mask, an optional per-key bias and optional
// dropout on the probabilities, for sm_90a.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/pallas/flash_attention.py
// that `_bwd` reaches: `_bwd_single_kernel` / `_bwd_single_mh_kernel` (one
// block holds the whole sequence, S <= 1024, no segments) and the tiled
// `_bwd_dkv_kernel` / `_bwd_dq_kernel` (longer sequences, segmented
// calls, and the layout-masked calls of `make_masked_flash_attention`,
// where a tile of an inactive 128 x 128 block is skipped and, optionally,
// every key attends). They compute one function, so one pair of kernels
// covers them all:
//
//   P  = exp(s * scale - lse) on live (causal, same-segment) pairs, else 0
//   dP = dO V^T,  dS = P * (dP - delta) * scale
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
//
// with delta = rowsum(dO * out) from the caller and lse from the forward
// kernel (csrc/flash_fwd.cu). A row with no live key has lse = +1e30, so
// its P is 0 and its gradients are 0.
//
// The key-bias and dropout flags (`flash_attention_kbias` /
// `flash_attention_train`, the BERT encoder layer's path through the same
// TPU kernels) recompute P = exp(s * scale + bias - lse) and regenerate
// the forward's keep-mask M from the hash of (seed, b·H + h, absolute row,
// absolute key): dV = (M ? P / keep : 0)^T dO and
// dS = P * ((M ? dP / keep : 0) - delta) * scale, with delta from the
// dropped output. Both flags are template parameters, so the kernels of
// the other paths are unchanged.
//
// Bound on the H100: at the training shape (B=16, H=12, S=1024, D=64,
// causal) the bytes (q, k, v, dO, lse, delta in; dq, dk, dv out) take
// about 0.05 ms at 3.35 TB/s and the five S·S·D products over the causal
// half 0.065 ms at the bf16 tensor-core peak: operations bound it. With
// two kernels and no atomics, S and dP are computed twice (seven
// products), so the reachable floor is about 0.09 ms of tensor-core time.
//
// What held the first (FMA) design back, which fp32 and D = 256 still
// take (the tile steps of attention_tiles.cuh, shared with the
// block-sparse backward): fp32 FMA on the CUDA cores for all five
// products, fp32 tiles in shared memory converted from synchronous 2-byte
// loads, P and dS written to and read back from shared memory behind
// three barriers a tile, and 100.9 KB of shared memory a block (2 blocks
// an SM). It ran the row-3 backward in 4.6-4.9 ms.
//
// This design (bf16 and fp16 at D = 64 and 128, a template over the
// element type; the C dispatch picks it at compile time):
//
// - Two kernels, no atomics, so the result is deterministic, as before.
//   dK/dV (`flash_bwd_dkv_mma_kernel`): one block of 4 warps per (b·h,
//   64-key tile), each warp 16 keys; K and V stay in shared memory, Q and
//   dO tiles of 64 rows stream through a 2-stage cp.async ring from the
//   causal start to S. dQ (`flash_bwd_dq_mma_kernel`): one block per
//   (b·h, 64-row q tile), each warp 16 q rows; Q and dO stay as A
//   fragments, K and V stream through the ring up to the causal limit.
//   Tiles of inactive layout blocks or without a live same-segment pair
//   are skipped.
// - Every product is mma.sync m16n8k16 with fp32 accumulators and
//   ldmatrix fragments from bf16 tiles (rows padded by 16 bytes). The
//   dK/dV kernel computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, forms Pᵀ and dSᵀ in
//   registers (the keep-mask drawn at the transposed coordinates) and
//   uses them, rounded to bf16, as the A operands of dV += Pᵀ·dO and
//   dK += dSᵀ·Q; the dQ kernel forms dS and runs dQ += dS·K the same
//   way. Nothing but the load ring goes through shared memory.
// - fp16 (the loss-scaled training path) runs the same steps with
//   `mma.sync ... f32.f16.f16.f32`. dO arrives multiplied by the loss
//   scale; dS is rounded to nearest fp16 before dQ = dS·K and dK = dSᵀ·Q,
//   and dQ, dK, dV are stored rounded to nearest, so a value past 65504
//   becomes inf there (the plain version rounds dS the same way) and the
//   scaler's finite check skips the step.
// - q, k and v are read through (batch, seq, head) strides, so the views
//   split out of the fused QKV projection need no copy; dO is contiguous
//   [B, S, H, D]; dq, dk, dv are written [B, S, H, D] contiguous.
#include <climits>

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

using ds::attn::BwdSmem;
using ds::attn::NT;
using ds::attn::Strides;

// any live (causal, same-segment) pair between q rows [q0, q0 + B) and
// keys [k0, k0 + B)? Called by every thread of the block.
template <int B>
__device__ __forceinline__ bool tile_live(const int* seg_q, const int* seg_k,
                                          int q0, int k0, int S, int causal) {
  int hit = 0;
  for (int i = threadIdx.x; i < B * B; i += NT) {
    const int r = i / B, c = i % B;
    const int row = q0 + r, key = k0 + c;
    hit |= (row < S && key < S && (!causal || key <= row) &&
            seg_q[r] == seg_k[c]);
  }
  return __syncthreads_or(hit);
}

// segment ids of rows [r0, r0 + B) into dst; rows at or past S get INT_MIN
template <int B>
__device__ __forceinline__ void load_seg(int* dst, const int* seg_b, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < B; i += NT)
    dst[i] = r0 + i < S ? seg_b[r0 + i] : INT_MIN;
}

// the live pairs of a flash tile: in range, causal (when asked), same
// segment (when segmented)
struct FlashLive {
  const int *seg_q, *seg_k;
  int q0, k0, S, causal;
  __device__ bool operator()(int r, int c) const {
    const int row = q0 + r, key = k0 + c;
    return row < S && key < S && (!causal || key <= row) &&
           (seg_q == nullptr || seg_q[r] == seg_k[c]);
  }
};

template <typename T, int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg,
                         const int* __restrict__ layout,
                         const float* __restrict__ kbias,
                         const int* __restrict__ seed, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, Strides st,
                         float sm_scale, int causal, int thresh,
                         float inv_keep) {
  constexpr int B = ds::attn::bwd_rows<D>();
  extern __shared__ float smem[];
  BwdSmem<D> sm(smem);
  // the key tile's bias, after the shared tiles (BIAS calls only)
  float* kb_tile = smem + ds::attn::bwd_smem_bytes<D>() / sizeof(float);
  const int kt = blockIdx.x;  // key tile 0 (the most q tiles) first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * B;
  const int nb = S / 128;  // layout blocks a row (layout calls only)
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;

  ds::attn::bwd_load_tile<T, D, B>(sm.Ks, kb, k0, S, st.kss);
  ds::attn::bwd_load_tile<T, D, B>(sm.Vs, vb, k0, S, st.vss);
  if (seg_b != nullptr) load_seg<B>(sm.seg_k, seg_b, k0, S);
  if constexpr (BIAS) ds::attn::load_bias(kb_tile, kbias + (long long)b * S, k0, B, S);
  const unsigned mix = DROP ? ds::attn::dropout_mix(seed, bh) : 0u;

  float acc_k[B / 16][D / 16], acc_v[B / 16][D / 16];
  ds::attn::zero(acc_k);
  ds::attn::zero(acc_v);

  const int n_qt = (S + B - 1) / B;
  // with causal, q tiles before kt are all masked
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * B;
    if (layout != nullptr &&
        layout[((long long)h * nb + q0 / 128) * nb + k0 / 128] == 0)
      continue;  // inactive layout block
    __syncthreads();  // the previous tile's readers are done
    if (seg_b != nullptr) {
      load_seg<B>(sm.seg_q, seg_b, q0, S);
      __syncthreads();
      if (!tile_live<B>(sm.seg_q, sm.seg_k, q0, k0, S, causal)) continue;
    }
    ds::attn::bwd_load_q_side<T, D>(sm, qb, db, lse_bh, delta_bh, q0, S, H,
                                    st.qss);
    __syncthreads();
    const ds::attn::Flags<BIAS, DROP> fl(kb_tile, mix, q0, k0, thresh, inv_keep);
    ds::attn::bwd_p_and_ds<D>(
        sm, sm_scale,
        FlashLive{seg_b != nullptr ? sm.seg_q : nullptr, sm.seg_k, q0, k0, S,
                  causal},
        fl.bias, fl.drop);
    __syncthreads();
    ds::attn::bwd_acc_dkv<D>(sm, acc_k, acc_v);
  }
  ds::attn::bwd_store<T, D>(dk, acc_k, b, h, k0, S, H);
  ds::attn::bwd_store<T, D>(dv, acc_v, b, h, k0, S, H);
}

template <typename T, int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg,
                        const int* __restrict__ layout,
                        const float* __restrict__ kbias,
                        const int* __restrict__ seed, T* __restrict__ dq,
                        int S, int H, Strides st, float sm_scale, int causal,
                        int thresh, float inv_keep) {
  constexpr int B = ds::attn::bwd_rows<D>();
  extern __shared__ float smem[];
  BwdSmem<D> sm(smem);
  // the key tile's bias, after the shared tiles (BIAS calls only)
  float* kb_tile = smem + ds::attn::bwd_smem_bytes<D>() / sizeof(float);
  const int qt = gridDim.x - 1 - blockIdx.x;  // the most keys first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * B;
  const int nb = S / 128;  // layout blocks a row (layout calls only)
  const int* lrow =
      layout != nullptr ? layout + ((long long)h * nb + q0 / 128) * nb
                        : nullptr;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;

  ds::attn::bwd_load_q_side<T, D>(sm, qb, db, lse + (long long)bh * S,
                                  delta + (long long)bh * S, q0, S, H,
                                  st.qss);
  if (seg_b != nullptr) load_seg<B>(sm.seg_q, seg_b, q0, S);
  const unsigned mix = DROP ? ds::attn::dropout_mix(seed, bh) : 0u;

  float acc[B / 16][D / 16];
  ds::attn::zero(acc);

  // causal limit of the tile, or every key
  const int last_key = causal ? min(S - 1, q0 + B - 1) : S - 1;
  const int n_kt = last_key / B + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * B;
    if (lrow != nullptr && lrow[k0 / 128] == 0) continue;  // inactive block
    __syncthreads();  // the previous tile's readers are done
    if (seg_b != nullptr) {
      load_seg<B>(sm.seg_k, seg_b, k0, S);
      __syncthreads();
      if (!tile_live<B>(sm.seg_q, sm.seg_k, q0, k0, S, causal)) continue;
    }
    ds::attn::bwd_load_tile<T, D, B>(sm.Ks, kb, k0, S, st.kss);
    ds::attn::bwd_load_tile<T, D, B>(sm.Vs, vb, k0, S, st.vss);
    if constexpr (BIAS)
      ds::attn::load_bias(kb_tile, kbias + (long long)b * S, k0, B, S);
    __syncthreads();
    const ds::attn::Flags<BIAS, DROP> fl(kb_tile, mix, q0, k0, thresh, inv_keep);
    ds::attn::bwd_p_and_ds<D>(
        sm, sm_scale,
        FlashLive{seg_b != nullptr ? sm.seg_q : nullptr, sm.seg_k, q0, k0, S,
                  causal},
        fl.bias, fl.drop);
    __syncthreads();
    ds::attn::bwd_acc_dq<D>(sm, acc);
  }
  ds::attn::bwd_store<T, D>(dq, acc, b, h, q0, S, H);
}

// ---------------------------------------------------------------------------
// the 16-bit tensor-core kernels (T bf16 or fp16, D = 64, 128)
// ---------------------------------------------------------------------------

namespace mm = ds::mma_attn;

// dK/dV (the design above). The lse and delta rows ride the Q/dO ring,
// one barrier a tile. A tile is taken in slices of W q rows, each its
// own Sᵀ, dPᵀ, Pᵀ, dSᵀ and two products, so that a thread stays within
// 168 registers at D = 64 and three blocks share an SM.
template <typename T, int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    flash_bwd_dkv_mma_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ seg, const int* __restrict__ layout,
        const float* __restrict__ kbias, const int* __restrict__ seed,
        T* __restrict__ dk, T* __restrict__ dv, int S, int H,
        Strides st, float sm_scale, int causal, int thresh,
        float inv_keep) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  // q rows a slice: narrow enough that dK and dV (2·D/2 accumulators a
  // lane) and the slice's Sᵀ and dPᵀ fit 168 registers without a spill
  constexpr int W = D == 64 ? 16 : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* Qs = Vs + TILE;       // [2][64][LD]
  T* dOs = Qs + 2 * TILE;  // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][64]
  float* dl_s = lse_s + 2 * mm::BN;                          // [2][64]
  int* own_seg = reinterpret_cast<int*>(dl_s + 2 * mm::BN);  // [64]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int kt = blockIdx.x;  // key tile 0 (the most q tiles) first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * mm::BM;
  const int nb = S / 128;  // layout blocks a row (layout calls only)
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;
  const unsigned mix = DROP ? ds::attn::dropout_mix(seed, bh) : 0u;
  const float scale2 = sm_scale * mm::LOG2E;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float kb2[2] = {0.f, 0.f};  // the keys' bias, times log2 e
  if constexpr (BIAS)
    for (int r = 0; r < 2; ++r)
      kb2[r] = keys[r] < S ? kbias[(long long)b * S + keys[r]] * mm::LOG2E
                           : 0.f;
  int segk[2] = {0, 0};
  if (seg_b != nullptr) {
    for (int r = 0; r < 2; ++r)
      segk[r] = keys[r] < S ? seg_b[keys[r]] : INT_MIN;
    mm::load_own_seg(own_seg, seg_b, k0, S);
    __syncthreads();
  }

  const int n_qt = (S + mm::BN - 1) / mm::BN;
  // the next q tile from qt on that is not skipped; uniform over the block
  auto next_tile = [&](int qt) {
    for (; qt < n_qt; ++qt) {
      if (layout != nullptr &&
          layout[((long long)h * nb + qt * mm::BN / 128) * nb + k0 / 128] ==
              0)
        continue;
      if (seg_b == nullptr ||
          mm::tile_live(own_seg, seg_b, k0, qt * mm::BN, false, S, causal))
        break;
    }
    return qt;
  };
  auto load_q_side = [&](int qt, int stage) {
    const int q0 = qt * mm::BN;
    mm::load_tile<D>(Qs + stage * TILE, qb, st.qss, q0, S);
    mm::load_tile<D>(dOs + stage * TILE, db, (long long)H * D, q0, S);
    mm::load_vec(lse_s + stage * mm::BN, lse_bh, q0, S, 0);
    mm::load_vec(dl_s + stage * mm::BN, delta_bh, q0, S, mm::BN);
  };

  mm::load_tile<D>(Ks, kb, st.kss, k0, S);
  mm::load_tile<D>(Vs, vb, st.vss, k0, S);
  // with causal, q tiles before kt are all masked
  int qt = next_tile(causal ? kt : 0);
  if (qt < n_qt) load_q_side(qt, 0);
  ds::cp_async_commit();
  ds::cp_async_wait<0>();
  __syncthreads();

  float acc_k[D / 8][4], acc_v[D / 8][4];
  mm::zero(acc_k);
  mm::zero(acc_v);
  int stage = 0;
  while (qt < n_qt) {
    const int nxt = next_tile(qt + 1);
    if (nxt < n_qt) load_q_side(nxt, stage ^ 1);  // overlaps this tile
    ds::cp_async_commit();
    const int q0 = qt * mm::BN;
    const T* Qt = Qs + stage * TILE;
    const T* dOt = dOs + stage * TILE;
    const float* lse_t = lse_s + stage * mm::BN;
    const float* dl_t = dl_s + stage * mm::BN;
    const bool masked = seg_b != nullptr || q0 + mm::BN > S ||
                        (causal && k0 + warp * 16 + 15 > q0);
#pragma unroll 1  // one slice's registers at a time
    for (int c0 = 0; c0 < mm::BN; c0 += W) {
      float s[W / 8][4], dp[W / 8][4];
      mm::zero(s);
      mm::zero(dp);
      mm::mma_abt<KS, W>(s, mm::SmemA<D, T>{Ks, warp * 16}, Qt + c0 * LD, LD);
      mm::mma_abt<KS, W>(dp, mm::SmemA<D, T>{Vs, warp * 16}, dOt + c0 * LD,
                          LD);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * j + 2 * qd + c, row = q0 + col;
          const float nlse2 = -lse_t[col] * mm::LOG2E, dl = dl_t[col];
          const int segq = masked && seg_b != nullptr && row < S
                               ? __ldg(seg_b + row) : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bool live = true;
            if (masked)
              live = row < S && keys[r] < S &&
                     (!causal || keys[r] <= row) &&
                     (seg_b == nullptr || segq == segk[r]);
            mm::p_and_ds<DROP>(s[j][2 * r + c], dp[j][2 * r + c], live,
                               scale2, nlse2 + kb2[r], dl, sm_scale, mix, row,
                               keys[r], thresh, inv_keep);
          }
        }
      }
      unsigned pa[W / 16][4], da[W / 16][4];
      mm::pack_a<W / 16, T>(pa, s);
      mm::pack_a<W / 16, T>(da, dp);
      mm::mma_ab<W / 16, D>(acc_v, pa, dOt + c0 * LD, LD);
      mm::mma_ab<W / 16, D>(acc_k, da, Qt + c0 * LD, LD);
    }
    ds::cp_async_wait<0>();  // tile nxt landed
    __syncthreads();         // ... for every warp, and this stage is free
    stage ^= 1;
    qt = nxt;
  }
  const float one[2] = {1.f, 1.f};
  const long long off = ((long long)b * S * H + h) * D;
  mm::store_rows<D>(dk + off, (long long)H * D, acc_k, keys, S, one);
  mm::store_rows<D>(dv + off, (long long)H * D, acc_v, keys, S, one);
}

// dQ (the design above). Q and dO are A fragments in registers at D = 64
// and read from shared memory at each step at D = 128, to stay within
// the registers; the key bias rides the K/V ring, one barrier a tile; a
// tile is taken in two halves of 32 keys.
template <typename T, int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    flash_bwd_dq_mma_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ seg, const int* __restrict__ layout,
        const float* __restrict__ kbias, const int* __restrict__ seed,
        T* __restrict__ dq, int S, int H, Strides st, float sm_scale,
        int causal, int thresh, float inv_keep) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  constexpr bool A_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE;
  T* Ks = dOs + TILE;     // [2][64][LD]
  T* Vs = Ks + 2 * TILE;  // [2][64][LD]
  float* kb_s = reinterpret_cast<float*>(Vs + 2 * TILE);       // [2][64]
  int* own_seg = reinterpret_cast<int*>(kb_s + 4 * mm::BN);    // [64]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the most keys first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * mm::BM;
  const int nb = S / 128;  // layout blocks a row (layout calls only)
  const int* lrow =
      layout != nullptr ? layout + ((long long)h * nb + q0 / 128) * nb
                        : nullptr;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;
  const float* kbias_b = BIAS ? kbias + (long long)b * S : nullptr;
  const unsigned mix = DROP ? ds::attn::dropout_mix(seed, bh) : 0u;
  const float scale2 = sm_scale * mm::LOG2E;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float nlse2[2], delta_r[2];  // −lse·log2 e and delta of the two rows
  int segq[2] = {0, 0};
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < S;
    nlse2[r] = in ? -lse[(long long)bh * S + rows[r]] * mm::LOG2E
                  : ds::NEG_INF;
    delta_r[r] = in ? delta[(long long)bh * S + rows[r]] : 0.f;
  }
  if (seg_b != nullptr) {
    for (int r = 0; r < 2; ++r)
      segq[r] = rows[r] < S ? seg_b[rows[r]] : INT_MIN;
    mm::load_own_seg(own_seg, seg_b, q0, S);
    __syncthreads();
  }

  const int last_key = causal ? min(S - 1, q0 + mm::BM - 1) : S - 1;
  const int n_kt = last_key / mm::BN + 1;
  auto next_tile = [&](int kt) {
    for (; kt < n_kt; ++kt) {
      if (lrow != nullptr && lrow[kt * mm::BN / 128] == 0) continue;
      if (seg_b == nullptr ||
          mm::tile_live(own_seg, seg_b, q0, kt * mm::BN, true, S, causal))
        break;
    }
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    mm::load_tile<D>(Ks + stage * TILE, kb, st.kss, kt * mm::BN, S);
    mm::load_tile<D>(Vs + stage * TILE, vb, st.vss, kt * mm::BN, S);
    if constexpr (BIAS)
      mm::load_vec(kb_s + stage * mm::BN, kbias_b, kt * mm::BN, S);
  };

  mm::load_tile<D>(Qs, qb, st.qss, q0, S);
  mm::load_tile<D>(dOs, db, (long long)H * D, q0, S);
  int kt = next_tile(0);
  if (kt < n_kt) load_kv(kt, 0);
  ds::cp_async_commit();
  ds::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[A_REGS ? KS : 1][4], df[A_REGS ? KS : 1][4];
  if constexpr (A_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mm::a_frag<D>(qf[kk], Qs, warp * 16, kk);
      mm::a_frag<D>(df[kk], dOs, warp * 16, kk);
    }
  }

  float acc[D / 8][4];
  mm::zero(acc);
  int stage = 0;
  while (kt < n_kt) {
    const int nxt = next_tile(kt + 1);
    if (nxt < n_kt) load_kv(nxt, stage ^ 1);  // overlaps this tile
    ds::cp_async_commit();
    const int k0 = kt * mm::BN;
    const T* Kt = Ks + stage * TILE;
    const T* Vt = Vs + stage * TILE;
    const float* kb_t = kb_s + stage * mm::BN;
    const bool masked = seg_b != nullptr || k0 + mm::BN > S ||
                        (causal && k0 + mm::BN - 1 > q0 + warp * 16);
#pragma unroll 1  // one half's registers at a time
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      float s[4][4], dp[4][4];
      mm::zero(s);
      mm::zero(dp);
      if constexpr (A_REGS) {
        mm::mma_abt<KS, 32>(s, mm::RegA<KS>{qf}, Kt + c0 * LD, LD);
        mm::mma_abt<KS, 32>(dp, mm::RegA<KS>{df}, Vt + c0 * LD, LD);
      } else {
        mm::mma_abt<KS, 32>(s, mm::SmemA<D, T>{Qs, warp * 16}, Kt + c0 * LD,
                            LD);
        mm::mma_abt<KS, 32>(dp, mm::SmemA<D, T>{dOs, warp * 16}, Vt + c0 * LD,
                            LD);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * j + 2 * qd + c, key = k0 + col;
          const float kbv = BIAS ? kb_t[col] * mm::LOG2E : 0.f;
          const int segk = masked && seg_b != nullptr && key < S
                               ? __ldg(seg_b + key) : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bool live = true;
            if (masked)
              live = key < S && (!causal || key <= rows[r]) &&
                     (seg_b == nullptr || segq[r] == segk);
            mm::p_and_ds<DROP>(s[j][2 * r + c], dp[j][2 * r + c], live,
                               scale2, nlse2[r] + kbv, delta_r[r], sm_scale,
                               mix, rows[r], key, thresh, inv_keep);
          }
        }
      }
      unsigned da[2][4];
      mm::pack_a<2, T>(da, dp);
      mm::mma_ab<2, D>(acc, da, Kt + c0 * LD, LD);
    }
    ds::cp_async_wait<0>();  // tile nxt landed
    __syncthreads();         // ... for every warp, and this stage is free
    stage ^= 1;
    kt = nxt;
  }
  const float one[2] = {1.f, 1.f};
  mm::store_rows<D>(dq + ((long long)b * S * H + h) * D, (long long)H * D,
                    acc, rows, S, one);
}

// which of the two kernels a call launches
enum class Part { kDKV, kDQ };

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg, *layout;
  const float* kbias;
  const int* seed;
  void *g1, *g2;
  int B, S, H;
  Strides st;
  float sm_scale;
  int causal, thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int D, bool BIAS, bool DROP>
cudaError_t launch_mma(Part part, const Args& a) {
  // dk/dv: K, V and a 2-stage Q, dO ring with its lse and delta; dq: Q,
  // dO and a 2-stage K, V ring with its key bias (room for four 64-float
  // rows either way); and the block's segment ids
  constexpr size_t smem = 6 * mm::tile_elems<D>() * sizeof(T) +
                          4 * mm::BN * sizeof(float) + mm::BM * sizeof(int);
  const dim3 grid((a.S + mm::BM - 1) / mm::BM, a.B * a.H);
  const auto* tq = static_cast<const T*>(a.q);
  const auto* tk = static_cast<const T*>(a.k);
  const auto* tv = static_cast<const T*>(a.v);
  const auto* td = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (part == Part::kDKV) {
    auto kernel = flash_bwd_dkv_mma_kernel<T, D, BIAS, DROP>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, mm::NTM, smem, a.stream>>>(
        tq, tk, tv, td, a.lse, a.delta, a.seg, a.layout, a.kbias, a.seed,
        static_cast<T*>(a.g1), static_cast<T*>(a.g2), a.S,
        a.H, a.st, a.sm_scale, a.causal, a.thresh, a.inv_keep);
  } else {
    auto kernel = flash_bwd_dq_mma_kernel<T, D, BIAS, DROP>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, mm::NTM, smem, a.stream>>>(
        tq, tk, tv, td, a.lse, a.delta, a.seg, a.layout, a.kbias, a.seed,
        static_cast<T*>(a.g1), a.S, a.H, a.st, a.sm_scale, a.causal,
        a.thresh, a.inv_keep);
  }
  return cudaGetLastError();
}

// the tile step is chosen here, at compile time, by dtype and head dim
template <typename T, int D, bool BIAS, bool DROP>
cudaError_t launch(Part part, const Args& a) {
  if constexpr (mm::takes_mma<T, D>()) {
    return launch_mma<T, D, BIAS, DROP>(part, a);
  } else {
    constexpr int rows = ds::attn::bwd_rows<D>();
    constexpr size_t smem =
        ds::attn::bwd_smem_bytes<D>() + (BIAS ? rows * sizeof(float) : 0);
    const dim3 grid((a.S + rows - 1) / rows, a.B * a.H);
    const T* tq = static_cast<const T*>(a.q);
    const T* tk = static_cast<const T*>(a.k);
    const T* tv = static_cast<const T*>(a.v);
    const T* td = static_cast<const T*>(a.dout);
    cudaError_t err;
    if (part == Part::kDKV) {
      auto kernel = flash_bwd_dkv_kernel<T, D, BIAS, DROP>;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, NT, smem, a.stream>>>(
          tq, tk, tv, td, a.lse, a.delta, a.seg, a.layout, a.kbias, a.seed,
          static_cast<T*>(a.g1), static_cast<T*>(a.g2), a.S, a.H, a.st,
          a.sm_scale, a.causal, a.thresh, a.inv_keep);
    } else {
      auto kernel = flash_bwd_dq_kernel<T, D, BIAS, DROP>;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, NT, smem, a.stream>>>(
          tq, tk, tv, td, a.lse, a.delta, a.seg, a.layout, a.kbias, a.seed,
          static_cast<T*>(a.g1), a.S, a.H, a.st, a.sm_scale, a.causal,
          a.thresh, a.inv_keep);
    }
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t dispatch_flags(Part part, const Args& a) {
  const bool bias = a.kbias != nullptr, drop = a.seed != nullptr;
  if (bias && drop) return launch<T, D, true, true>(part, a);
  if (bias) return launch<T, D, true, false>(part, a);
  if (drop) return launch<T, D, false, true>(part, a);
  return launch<T, D, false, false>(part, a);
}

template <typename T>
cudaError_t dispatch_d(int D, Part part, const Args& a) {
  switch (D) {
    case 64:
      return dispatch_flags<T, 64>(part, a);
    case 128:
      return dispatch_flags<T, 128>(part, a);
    case 256:
      return dispatch_flags<T, 256>(part, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Part part, const Args& a, int D, int dtype) {
  if (dtype == ds::DTYPE_F32) return dispatch_d<float>(D, part, a);
  if (dtype == ds::DTYPE_BF16) return dispatch_d<__nv_bfloat16>(D, part, a);
  if (dtype == ds::DTYPE_F16) return dispatch_d<__half>(D, part, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [B, S, H, D] read through (batch, seq, head) strides, head dim
// contiguous; dout: [B, S, H, D] contiguous; lse, delta: [B·H, S] fp32;
// seg: [B, S] int32 contiguous or null; layout: [H, S/128, S/128] int32
// contiguous or null (S a multiple of 128 when set); kbias: [B, S] fp32
// contiguous or null; seed: the forward's int32 on the device, or null
// for no dropout, with the forward's thresh and inv_keep; causal: 0
// attends every key. ds_flash_bwd_dkv writes dk, dv and ds_flash_bwd_dq
// writes dq, each [B, S, H, D] contiguous in q's dtype. Each returns
// cudaGetLastError() after its launch.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg,
                                const void* layout, const void* kbias,
                                const void* seed, void* dk, void* dv, int B,
                                int S, int H, int D, long long qsb,
                                long long qss, long long qsh, long long ksb,
                                long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh, float sm_scale,
                                int causal, int thresh, float inv_keep,
                                int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<const int*>(seg),
               static_cast<const int*>(layout),
               static_cast<const float*>(kbias),
               static_cast<const int*>(seed), dk, dv, B, S, H,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, thresh, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return run(Part::kDKV, a, D, dtype);
}

extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* seg,
                               const void* layout, const void* kbias,
                               const void* seed, void* dq, int B, int S,
                               int H, int D, long long qsb, long long qss,
                               long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss,
                               long long vsh, float sm_scale, int causal,
                               int thresh, float inv_keep, int dtype,
                               void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<const int*>(seg),
               static_cast<const int*>(layout),
               static_cast<const float*>(kbias),
               static_cast<const int*>(seed), dq, nullptr, B, S, H,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, thresh, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return run(Part::kDQ, a, D, dtype);
}
