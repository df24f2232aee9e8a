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
// Bound on the H100: at the training shape (B=16, H=12, S=1024, D=64) the
// bytes (q, k, v, dO, lse, delta in; dq, dk, dv out) take a few tens of
// microseconds at 3.35 TB/s and the 5 S*S*D products over the causal
// half about 0.1 ms at the bf16 tensor-core peak. This first kernel does
// its products with fp32 FMA and is bound by their throughput. Design:
//
// - Two kernels, no atomics, so the result is deterministic. dK/dV: one
//   block per (b*h, key tile) loops over the q tiles from the causal
//   start to S, keeping dK and dV in registers. dQ: one block per (b*h,
//   q tile) loops over the key tiles up to the causal limit. Both
//   recompute P and dP; tiles with no live pair are skipped.
// - The TPU kernel's fusion of one head's whole sequence in VMEM
//   (`_head_bwd`) does not fit: at S = 1024 one head's q/k/v/dO alone
//   take 512 KB in bf16 against 227 KB of shared memory. Tiles are 64
//   rows (32 at D = 256), staged in shared memory as fp32 with rows
//   padded by one word against bank conflicts.
// - q, k and v are read through (batch, seq, head) strides, so the views
//   split out of the fused QKV projection need no copy; dO is contiguous
//   [B, S, H, D]; dq, dk, dv are written [B, S, H, D] contiguous.
// - The tile steps (load, P and dS, the dK/dV and dQ sums, the stores)
//   are attention_tiles.cuh's, shared with the block-sparse backward.
#include <climits>

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
cudaError_t launch(Part part, const Args& a) {
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
