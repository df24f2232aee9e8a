// Causal flash-attention forward with optional segment ids and an
// optional 128-grain layout mask, for sm_90a.
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const int* __restrict__ layout, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, Strides st,
                     float sm_scale, int causal) {
  extern __shared__ float smem[];
  ds::attn::FwdSmem<D> sm(smem);
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
    ds::attn::fwd_tile<T, D>(
        sm, state, kb, vb, st.kss, st.vss, k0, S, sm_scale,
        [=](int r, int c) {
          return (!causal || k0 + c <= q0 + r) &&
                 (seg == nullptr || sq[r] == sk[c]);
        });
  }
  ds::attn::fwd_store<T, D>(sm, state, out, lse, b, h, S, H, q0);
}

struct Args {
  const void *q, *k, *v;
  const int *seg, *layout;
  void* out;
  float* lse;
  int B, S, H;
  Strides st;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = ds::attn::fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + FWD_BQ - 1) / FWD_BQ, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg, a.layout, static_cast<T*>(a.out),
      a.lse, a.S, a.H, a.st, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    case 256:
      return launch<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, S, H, D] read through (batch, seq, head) strides, with the
// head dim contiguous; seg: [B, S] int32 contiguous or null; layout: [H,
// S/128, S/128] int32 contiguous or null (S a multiple of 128 when set);
// causal: 0 attends every key (layout calls only); out: [B, S, H, D]
// contiguous; lse: [B·H, S] fp32. Returns cudaGetLastError() after the
// launch.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seg, const void* layout, void* out,
                            void* lse, int B, int S, int H, int D,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            float sm_scale, int causal, int dtype,
                            void* stream) {
  const Args a{q, k, v, static_cast<const int*>(seg),
               static_cast<const int*>(layout), out,
               static_cast<float*>(lse), B, S, H,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  if (dtype == ds::DTYPE_F32) return dispatch_d<float>(D, a);
  if (dtype == ds::DTYPE_BF16) return dispatch_d<__nv_bfloat16>(D, a);
  return cudaErrorInvalidValue;
}
