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
// encoder layer): a [B, S] fp32 bias, staged a key tile at a time in
// shared memory, is added to every row's scores after the scale (a key
// at -1e30 gets p = 0 exactly, so a row whose keys are all masked gives
// zeros and lse = +1e30); dropout keeps p by the hash of (seed, b·H + h,
// row, key) at absolute coordinates, so the 64 x 64 tiles here draw the
// same mask as the TPU's larger blocks, and the sum l counts the
// undropped p. Both flags are template parameters: without them the
// kernel is the one the other paths had.
//
// Bound on the H100: at the serving prefill shapes (B=4, H=12, D=64,
// S <= 1024) the bytes (q, k, v, seg in, out, lse out) take a few
// microseconds at 3.35 TB/s, and the 4·B·H·D·S(S+1)/2 flops take a few
// microseconds at the bf16 tensor-core peak: the work is small, and this
// first kernel is bound by its own instruction issue. Design:
//
// - One thread block per (b·h, 64-row q tile). A loop over 64-key tiles
//   up to the causal limit takes the place of the TPU's compacted
//   (qi, ki) schedule; q tiles with the most keys launch first.
// - Q, K and V tiles are staged in shared memory as fp32 (rows padded by
//   one word against bank conflicts); scores, the running max and sum,
//   and the output accumulator stay fp32. Scores are plain FMA on a
//   4x4 register micro-tile per thread; tensor cores (wgmma/TMA) are
//   later work. The tile step is `attn::fwd_tile` (attention_tiles.cuh),
//   shared with the block-sparse forward.
// - q, k and v are read through (batch, seq, head) strides, so the
//   views split out of the fused QKV projection need no copy; out is
//   written [B, S, H, D] contiguous and lse [B·H, S].
#include <climits>

#include "attention_tiles.cuh"

namespace {

using ds::attn::FWD_BK;
using ds::attn::FWD_BQ;
using ds::attn::NT;
using ds::attn::Strides;

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
cudaError_t launch(const Args& a) {
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
  return cudaErrorInvalidValue;
}
