// Flash-attention forward, causal or not, with optional segment ids, an
// optional 128-grain layout mask, an optional per-key bias and optional
// dropout on the probabilities, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` of
// deeperspeed_tpu/ops/pallas/flash_attention.py (reached through `_fwd`
// with `seg`, as `flash_attention_segmented` calls it, and with `layout`,
// as `make_masked_flash_attention` calls it): online-softmax attention
// over the causal trapezoid (or, with a layout, optionally every key),
// with a whole k-tile skipped when its q rows and keys share no segment
// id, or when the layout block holding it is inactive (a 64 x 64 tile
// lies inside one 128 x 128 block, so the skip gives exactly what the
// TPU kernel's additive -1e30 penalty `_apply_layout_mask` gives), and
// the survivors masked to -1e30 element by element. Rows with no live
// key give zero output and lse = +1e30.
//
// The key-bias and dropout flags replace those of the TPU kernels
// `_fwd_kernel`, `_fwd_single_kernel` and `_fwd_single_mh_kernel` as
// `flash_attention_kbias` / `flash_attention_train` reach them (the BERT
// encoder layer): a [B, S] fp32 bias is added to every row's scores
// after the scale (a key at -1e30 gets p = 0 exactly, so a row whose keys
// are all masked gives zeros and lse = +1e30); dropout keeps p by the
// hash of (seed, b·H + h, row, key) at absolute coordinates, so the
// 64 x 64 tiles here draw the same mask as the TPU's larger blocks, and
// the sum l counts the undropped p. Both flags are template parameters:
// without them the kernels are the ones the other paths had.
//
// Bound on the H100: at the training shape (B=16, S=1024, H=12, D=64,
// causal) the call moves about 0.1 GB (q, k, v in; out, lse out), 0.030 ms
// at 3.35 TB/s, and does 2.6e10 flops over the causal half, 0.026 ms at
// the bf16 tensor-core peak: bytes and operations bound it about equally,
// so the kernel has to keep the tensor cores fed from on-chip tiles.
//
// What held the first (FMA) design back, which fp32 and D = 256 still
// take (`attn::fwd_tile`, attention_tiles.cuh, shared with the
// block-sparse forward): every product was fp32 FMA on the CUDA cores
// (at most 67 TFLOP/s); the tiles were staged in shared memory as fp32,
// converted element by element from synchronous 2-byte loads, so the
// inner loops were bound by shared-memory bandwidth; P went through
// shared memory behind three barriers a tile; 67.6 KB of shared memory a
// block. It ran row 2 in 1.65 ms, about 16 TFLOP/s.
//
// This design (bf16 and fp16 at D = 64 and 128, `flash_fwd_mma_kernel`,
// a template over the element type; the C dispatch picks it at compile
// time):
//
// - One block of 4 warps per (b·h, 64-row q tile), each warp 16 q rows; a
//   loop over 64-key tiles up to the causal limit takes the place of the
//   TPU's compacted (qi, ki) schedule; q tiles with the most keys launch
//   first. Tiles of inactive layout blocks and tiles with no live
//   same-segment pair are skipped, as before.
// - Q is loaded once into registers as mma A fragments. K and V tiles are
//   bf16 in shared memory, rows padded by 16 bytes so that ldmatrix has
//   no bank conflicts, filled by a 2-stage cp.async ring: tile j + 1
//   loads while tile j computes.
// - S = Q·Kᵀ by mma.sync m16n8k16 (fp32 accumulate) into registers; the
//   masks, the key bias and the dropout draw are taken at each
//   accumulator's absolute (row, key); the online softmax reduces each
//   row over its lane quad with two shuffles. P, rounded to bf16 as the
//   plain version rounds it, is repacked in registers as the A operand
//   of P·V (V read by ldmatrix.trans); O stays in fp32 registers. In
//   fp16 the same steps run `mma.sync ... f32.f16.f16.f32`, and P and O
//   are rounded to nearest (`__floats2half2_rn`): an output past 65504
//   stores inf, which the loss scaler's finite check then sees.
// - q, k and v are read through (batch, seq, head) strides, so the views
//   split out of the fused QKV projection need no copy (bf16 operands
//   must be 16-byte aligned, which the wrapper checks); out is written
//   [B, S, H, D] contiguous and lse [B·H, S].
#include <climits>

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

using ds::attn::FWD_BK;
using ds::attn::FWD_BQ;
using ds::attn::NT;
using ds::attn::Strides;
namespace mm = ds::mma_attn;

// The 16-bit tensor-core forward (T bf16 or fp16, D = 64, 128; the design
// above). The key
// bias rides the K/V ring, one barrier a tile; the online softmax runs in
// base 2 (scores scaled by log2 e, ex2 on the special-function unit). At
// D = 64 three blocks share an SM (at most 168 registers a thread).
template <typename T, int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    flash_fwd_mma_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ seg,
                         const int* __restrict__ layout,
                         const float* __restrict__ kbias,
                         const int* __restrict__ seed,
                         T* __restrict__ out, float* __restrict__ lse,
                         int S, int H, Strides st, float sm_scale, int causal,
                         int thresh, float inv_keep) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TILE;      // [2][64][LD]
  T* Vs = Ks + 2 * TILE;  // [2][64][LD]
  float* kb_s = reinterpret_cast<float*>(Vs + 2 * TILE);  // [2][64]
  int* own_seg = reinterpret_cast<int*>(kb_s + 2 * mm::BN);  // [64]
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
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;
  const float* kbias_b = BIAS ? kbias + (long long)b * S : nullptr;
  const unsigned mix = DROP ? ds::attn::dropout_mix(seed, bh) : 0u;
  const float scale2 = sm_scale * mm::LOG2E;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int segq[2] = {0, 0};
  if (seg_b != nullptr) {
    for (int r = 0; r < 2; ++r)
      segq[r] = rows[r] < S ? seg_b[rows[r]] : INT_MIN;
    mm::load_own_seg(own_seg, seg_b, q0, S);
    __syncthreads();
  }

  // causal limit of the tile, or every key
  const int last_key = causal ? min(S - 1, q0 + mm::BM - 1) : S - 1;
  const int n_kt = last_key / mm::BN + 1;
  // the next key tile from kt on that is not skipped (inactive layout
  // block, or no live same-segment pair); uniform over the block
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
  int kt = next_tile(0);
  if (kt < n_kt) load_kv(kt, 0);
  ds::cp_async_commit();
  ds::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mm::a_frag<D>(qf[kk], Qs, warp * 16, kk);

  float o[D / 8][4];
  mm::zero(o);
  // running max (base 2) and this lane's part of the row sums
  float m_i[2] = {ds::NEG_INF, ds::NEG_INF}, l_i[2] = {0.f, 0.f};
  int stage = 0;
  while (kt < n_kt) {
    const int nxt = next_tile(kt + 1);
    if (nxt < n_kt) load_kv(nxt, stage ^ 1);  // overlaps this tile
    ds::cp_async_commit();
    const int k0 = kt * mm::BN;
    float s[8][4];
    mm::zero(s);
    mm::mma_abt<KS, 64>(s, mm::RegA<KS>{qf}, Ks + stage * TILE, LD);

    // scale, key bias and masks at each accumulator's (row, key); a tile
    // wholly below the diagonal, inside S and unsegmented needs no mask
    const bool masked = seg_b != nullptr || k0 + mm::BN > S ||
                        (causal && k0 + mm::BN - 1 > q0 + warp * 16);
    float mx[2] = {ds::NEG_INF, ds::NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * qd + c, key = k0 + col;
        const float kbv =
            BIAS ? kb_s[stage * mm::BN + col] * mm::LOG2E : 0.f;
        const int segk =
            masked && seg_b != nullptr && key < S ? __ldg(seg_b + key) : 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sc = fmaf(s[j][2 * r + c], scale2, kbv);
          if (masked) {
            const bool live = key < S && (!causal || key <= rows[r]) &&
                              (seg_b == nullptr || segq[r] == segk);
            sc = live ? sc : ds::NEG_INF;
          }
          s[j][2 * r + c] = sc;
          mx[r] = fmaxf(mx[r], sc);
        }
      }
    }
    // online softmax over the lane quad that shares each row; a masked
    // score (-1e30) gets p = 0 exactly, so a row with no live key keeps
    // l = 0; the sum counts the undropped p
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_i[r], mx[r]);
      const float alpha = ds::ex2(m_i[r] - m_new[r]);
      m_i[r] = m_new[r];
      l_i[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float sv = s[j][e];
        float p = sv <= 0.5f * ds::NEG_INF ? 0.f : ds::ex2(sv - m_new[r]);
        l_i[r] += p;
        if constexpr (DROP) {
          const int key = k0 + 8 * j + 2 * qd + (e & 1);
          p = ds::attn::dropout_keep(mix, rows[r], key, thresh) ? p * inv_keep
                                                                : 0.f;
        }
        s[j][e] = p;
      }
    }
    unsigned pa[4][4];
    mm::pack_a<4, T>(pa, s);
    mm::mma_ab<4, D>(o, pa, Vs + stage * TILE, LD);
    ds::cp_async_wait<0>();  // tile nxt landed
    __syncthreads();         // ... for every warp, and this stage is free
    stage ^= 1;
    kt = nxt;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);
    if (qd == 0 && rows[r] < S)
      lse[(long long)bh * S + rows[r]] =
          l == 0.f ? -ds::NEG_INF : m_i[r] * mm::LN2 + logf(l);
  }
  mm::store_rows<D>(out + ((long long)b * S * H + h) * D, (long long)H * D,
                    o, rows, S, inv);
}

template <typename T, int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const int* __restrict__ layout,
                     const float* __restrict__ kbias,
                     const int* __restrict__ seed, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, Strides st,
                     float sm_scale, int causal, int thresh, float inv_keep) {
  extern __shared__ float smem[];
  ds::attn::FwdSmem<D> sm(smem);
  // the key tile's bias, after the shared tiles (BIAS calls only)
  float* kb_tile = smem + ds::attn::fwd_smem_bytes<D>() / sizeof(float);
  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the most keys first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * FWD_BQ;
  const int nb = S / 128;  // layout blocks a row (layout calls only)
  const int* lrow =
      layout != nullptr ? layout + ((long long)h * nb + q0 / 128) * nb
                        : nullptr;

  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const float* kbias_b = BIAS ? kbias + (long long)b * S : nullptr;
  const unsigned mix = DROP ? ds::attn::dropout_mix(seed, bh) : 0u;

  ds::attn::fwd_load_q<T, D>(sm, qb, st.qss, q0, S);
  if (seg != nullptr) {
    for (int i = tid; i < FWD_BQ; i += NT)
      sm.seg_q[i] = q0 + i < S ? seg[(long long)b * S + q0 + i] : INT_MIN;
  }
  ds::attn::FwdState<D> state;
  state.init();

  // causal limit of the tile, or every key
  const int last_key = causal ? min(S - 1, q0 + FWD_BQ - 1) : S - 1;
  const int n_kt = last_key / FWD_BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FWD_BK;
    if (lrow != nullptr && lrow[k0 / 128] == 0) continue;  // inactive block
    __syncthreads();  // the previous tile's readers are done
    if constexpr (BIAS) ds::attn::load_bias(kb_tile, kbias_b, k0, FWD_BK, S);
    if (seg != nullptr) {
      for (int i = tid; i < FWD_BK; i += NT)
        sm.seg_k[i] = k0 + i < S ? seg[(long long)b * S + k0 + i] : INT_MIN;
      __syncthreads();
      // block-level skip: no live (causal, same-segment) pair in the tile
      int hit = 0;
      for (int i = tid; i < FWD_BQ * FWD_BK; i += NT) {
        const int r = i / FWD_BK, c = i % FWD_BK;
        const int row = q0 + r, key = k0 + c;
        hit |= (row < S && key < S && (!causal || key <= row) &&
                sm.seg_q[r] == sm.seg_k[c]);
      }
      if (!__syncthreads_or(hit)) continue;
    }
    const int* sq = sm.seg_q;
    const int* sk = sm.seg_k;
    auto live = [=](int r, int c) {
      return (!causal || k0 + c <= q0 + r) &&
             (seg == nullptr || sq[r] == sk[c]);
    };
    const ds::attn::Flags<BIAS, DROP> fl(kb_tile, mix, q0, k0, thresh,
                                         inv_keep);
    ds::attn::fwd_tile<T, D>(sm, state, kb, vb, st.kss, st.vss, k0, S,
                             sm_scale, live, fl.bias, fl.drop);
  }
  ds::attn::fwd_store<T, D>(sm, state, out, lse, b, h, S, H, q0);
}

struct Args {
  const void *q, *k, *v;
  const int *seg, *layout;
  const float* kbias;
  const int* seed;
  void* out;
  float* lse;
  int B, S, H;
  Strides st;
  float sm_scale;
  int causal, thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int D, bool BIAS, bool DROP>
cudaError_t launch_mma(const Args& a) {
  auto kernel = flash_fwd_mma_kernel<T, D, BIAS, DROP>;
  // Q, the K and V ring, the key bias ring, the block's segment ids
  constexpr size_t smem = 5 * mm::tile_elems<D>() * sizeof(T) +
                          2 * mm::BN * sizeof(float) + mm::BM * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + mm::BM - 1) / mm::BM, a.B * a.H);
  kernel<<<grid, mm::NTM, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg, a.layout, a.kbias, a.seed,
      static_cast<T*>(a.out), a.lse, a.S, a.H, a.st, a.sm_scale,
      a.causal, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

// the tile step is chosen here, at compile time, by dtype and head dim
template <typename T, int D, bool BIAS, bool DROP>
cudaError_t launch(const Args& a) {
  if constexpr (mm::takes_mma<T, D>()) {
    return launch_mma<T, D, BIAS, DROP>(a);
  } else {
    auto kernel = flash_fwd_kernel<T, D, BIAS, DROP>;
    constexpr size_t smem =
        ds::attn::fwd_smem_bytes<D>() + (BIAS ? FWD_BK * sizeof(float) : 0);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.S + FWD_BQ - 1) / FWD_BQ, a.B * a.H);
    kernel<<<grid, NT, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg, a.layout, a.kbias, a.seed,
        static_cast<T*>(a.out), a.lse, a.S, a.H, a.st, a.sm_scale, a.causal,
        a.thresh, a.inv_keep);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t dispatch_flags(const Args& a) {
  const bool bias = a.kbias != nullptr, drop = a.seed != nullptr;
  if (bias && drop) return launch<T, D, true, true>(a);
  if (bias) return launch<T, D, true, false>(a);
  if (drop) return launch<T, D, false, true>(a);
  return launch<T, D, false, false>(a);
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return dispatch_flags<T, 64>(a);
    case 128:
      return dispatch_flags<T, 128>(a);
    case 256:
      return dispatch_flags<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, S, H, D] read through (batch, seq, head) strides, with the
// head dim contiguous; seg: [B, S] int32 contiguous or null; layout: [H,
// S/128, S/128] int32 contiguous or null (S a multiple of 128 when set);
// kbias: [B, S] fp32 contiguous or null; seed: one int32 on the device,
// or null for no dropout, with thresh = int(rate * 2147483647) and
// inv_keep = 1 / (1 - rate) from the host; causal: 0 attends every key;
// out: [B, S, H, D] contiguous; lse: [B·H, S] fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seg, const void* layout,
                            const void* kbias, const void* seed, void* out,
                            void* lse, int B, int S, int H, int D,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            float sm_scale, int causal, int thresh,
                            float inv_keep, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(seg),
               static_cast<const int*>(layout),
               static_cast<const float*>(kbias),
               static_cast<const int*>(seed), out,
               static_cast<float*>(lse), B, S, H,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, thresh, inv_keep,
               static_cast<cudaStream_t>(stream)};
  if (dtype == ds::DTYPE_F32) return dispatch_d<float>(D, a);
  if (dtype == ds::DTYPE_BF16) return dispatch_d<__nv_bfloat16>(D, a);
  if (dtype == ds::DTYPE_F16) return dispatch_d<__half>(D, a);
  return cudaErrorInvalidValue;
}
