// Block-sparse attention over a static 128-grain layout, forward and
// backward, for sm_90a.
//
// Replaces the TPU kernels of
// deeperspeed_tpu/ops/pallas/block_sparse_attention.py: the forward
// `_sparse_fwd_kernel` (`sparse_attention_fwd`) and the backward
// `_sparse_dkv_kernel` / `_sparse_dq_kernel` (`sparse_attention_bwd`).
// Query block i attends key block j where layout[h, i, j] is set; with
// `causal` a key after its query is masked element by element (inside the
// diagonal blocks). A row with no live key gives zero output, lse = +1e30
// and zero gradients, as the TPU kernel's poisoned lse does.
//
// Bound on the H100: at the sparse training shape (B=2, S=16384, H=12,
// D=64, fixed layout with 16 local and 1 global 128-blocks a window,
// causal) the live pairs number about 2·12·16384·1500, so the forward's
// 4·D flops a pair take a few hundred microseconds at the bf16
// tensor-core peak while q, k, v, out cross device memory in a few
// tens: operations bound. These first kernels do their products with
// fp32 FMA, as the flash kernels do, and are bound by FMA throughput.
// Design:
//
// - The TPU kernels group `group_q` row blocks and fan out over `fanout`
//   key blocks to feed the MXU fat strips (`build_row_union_lut`, with
//   activity bits for the rows the union drags in). That is not carried
//   over: a block here walks a compact per-row LUT of the active
//   128-column blocks (built on the host by `ops/hopper/
//   block_sparse_attention.build_lut`), so no work is spent on rows or
//   columns the layout leaves out.
// - Forward: one thread block per (b·h, 64-row q tile), the online
//   softmax of csrc/flash_fwd.cu (`attn::fwd_tile`) over the two 64-key
//   tiles of each active column block of its row block.
// - dK/dV: one block per (b·h, key tile), walking the TRANSPOSED layout's
//   LUT (every query block that attends its key block; global columns
//   list most of the sequence). dQ: one block per (b·h, q tile), walking
//   the forward LUT. Both recompute P and dP from the lse
//   (`attn::bwd_p_and_ds`). No atomics: every gradient element is one
//   fp32 sum in a fixed order, so results are reproducible.
// - Under `causal`, key tiles wholly after the q tile (and, for dK/dV,
//   q tiles wholly before the key tile) are skipped before any load.
// - The LUTs list row blocks in `order` (the longest rows first), so the
//   blocks with the most tiles start first and the short ones fill in
//   behind them.
// - Tiles and layout: S is a multiple of 128; a 64-row tile (32 at D =
//   256) lies inside one 128 x 128 block.
#include "attention_tiles.cuh"

namespace {

using ds::attn::BwdSmem;
using ds::attn::FWD_BK;
using ds::attn::FWD_BQ;
using ds::attn::NT;
using ds::attn::Strides;

constexpr int GRAIN = 128;  // layout block

// a layout walk: for row block `rb` of head h, the active column blocks
// lut[(h·nb + rb)·max_active + a] for a < counts[h·nb + rb]
struct Lut {
  const int* lut;
  const int* counts;
  const int* order;
  int max_active;
  __device__ const int* row(int h, int nb, int rb) const {
    return lut + ((long long)h * nb + rb) * max_active;
  }
  __device__ int count(int h, int nb, int rb) const {
    return counts[h * nb + rb];
  }
};

// the live pairs of a tile: causal (when asked); the LUT decided the rest
struct CausalLive {
  int q0, k0, causal;
  __device__ bool operator()(int r, int c) const {
    return !causal || k0 + c <= q0 + r;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, Lut lut,
                            T* __restrict__ out, float* __restrict__ lse,
                            int S, int H, Strides st, float sm_scale,
                            int causal) {
  constexpr int SUB = GRAIN / FWD_BQ;  // q tiles a row block
  extern __shared__ float smem[];
  ds::attn::FwdSmem<D> sm(smem);
  const int nb = S / GRAIN;
  const int rb = lut.order[blockIdx.x / SUB];
  const int q0 = rb * GRAIN + (blockIdx.x % SUB) * FWD_BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;

  ds::attn::fwd_load_q<T, D>(sm, qb, st.qss, q0, S);
  ds::attn::FwdState<D> state;
  state.init();
  const int* cols = lut.row(h, nb, rb);
  const int n = lut.count(h, nb, rb);
  for (int a = 0; a < n; ++a) {
    for (int t = 0; t < GRAIN / FWD_BK; ++t) {
      const int k0 = cols[a] * GRAIN + t * FWD_BK;
      if (causal && k0 > q0 + FWD_BQ - 1) break;  // wholly after the tile
      __syncthreads();  // the previous tile's readers are done
      ds::attn::fwd_tile<T, D>(sm, state, kb, vb, st.kss, st.vss, k0, S,
                               sm_scale, CausalLive{q0, k0, causal});
    }
  }
  ds::attn::fwd_store<T, D>(sm, state, out, lse, b, h, S, H, q0);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    block_sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, Lut lut_t,
                            T* __restrict__ dk, T* __restrict__ dv, int S,
                            int H, Strides st, float sm_scale, int causal) {
  constexpr int B = ds::attn::bwd_rows<D>();
  constexpr int SUB = GRAIN / B;  // tiles a layout block
  extern __shared__ float smem[];
  BwdSmem<D> sm(smem);
  const int nb = S / GRAIN;
  const int cb = lut_t.order[blockIdx.x / SUB];  // key block
  const int k0 = cb * GRAIN + (blockIdx.x % SUB) * B;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;

  ds::attn::bwd_load_tile<T, D, B>(sm.Ks, kb, k0, S, st.kss);
  ds::attn::bwd_load_tile<T, D, B>(sm.Vs, vb, k0, S, st.vss);
  float acc_k[B / 16][D / 16], acc_v[B / 16][D / 16];
  ds::attn::zero(acc_k);
  ds::attn::zero(acc_v);

  const int* rows = lut_t.row(h, nb, cb);  // query blocks attending cb
  const int n = lut_t.count(h, nb, cb);
  for (int a = 0; a < n; ++a) {
    for (int t = 0; t < SUB; ++t) {
      const int q0 = rows[a] * GRAIN + t * B;
      if (causal && q0 + B - 1 < k0) continue;  // wholly before the keys
      __syncthreads();  // the previous tile's readers are done
      ds::attn::bwd_load_q_side<T, D>(sm, qb, db, lse_bh, delta_bh, q0, S, H,
                                      st.qss);
      __syncthreads();
      ds::attn::bwd_p_and_ds<D>(sm, sm_scale, CausalLive{q0, k0, causal});
      __syncthreads();
      ds::attn::bwd_acc_dkv<D>(sm, acc_k, acc_v);
    }
  }
  ds::attn::bwd_store<T, D>(dk, acc_k, b, h, k0, S, H);
  ds::attn::bwd_store<T, D>(dv, acc_v, b, h, k0, S, H);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    block_sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, Lut lut,
                           T* __restrict__ dq, int S, int H, Strides st,
                           float sm_scale, int causal) {
  constexpr int B = ds::attn::bwd_rows<D>();
  constexpr int SUB = GRAIN / B;  // tiles a layout block
  extern __shared__ float smem[];
  BwdSmem<D> sm(smem);
  const int nb = S / GRAIN;
  const int rb = lut.order[blockIdx.x / SUB];
  const int q0 = rb * GRAIN + (blockIdx.x % SUB) * B;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;

  ds::attn::bwd_load_q_side<T, D>(sm, qb, db, lse + (long long)bh * S,
                                  delta + (long long)bh * S, q0, S, H,
                                  st.qss);
  float acc[B / 16][D / 16];
  ds::attn::zero(acc);

  const int* cols = lut.row(h, nb, rb);
  const int n = lut.count(h, nb, rb);
  for (int a = 0; a < n; ++a) {
    for (int t = 0; t < SUB; ++t) {
      const int k0 = cols[a] * GRAIN + t * B;
      if (causal && k0 > q0 + B - 1) break;  // wholly after the tile
      __syncthreads();  // the previous tile's readers are done
      ds::attn::bwd_load_tile<T, D, B>(sm.Ks, kb, k0, S, st.kss);
      ds::attn::bwd_load_tile<T, D, B>(sm.Vs, vb, k0, S, st.vss);
      __syncthreads();
      ds::attn::bwd_p_and_ds<D>(sm, sm_scale, CausalLive{q0, k0, causal});
      __syncthreads();
      ds::attn::bwd_acc_dq<D>(sm, acc);
    }
  }
  ds::attn::bwd_store<T, D>(dq, acc, b, h, q0, S, H);
}

enum class Part { kFwd, kDKV, kDQ };

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  Lut lut;
  void *o1, *o2;  // out and lse (forward), dk and dv, or dq
  int B, S, H;
  Strides st;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch(Part part, const Args& a) {
  const T* tq = static_cast<const T*>(a.q);
  const T* tk = static_cast<const T*>(a.k);
  const T* tv = static_cast<const T*>(a.v);
  const T* td = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (part == Part::kFwd) {
    auto kernel = block_sparse_fwd_kernel<T, D>;
    constexpr size_t smem = ds::attn::fwd_smem_bytes<D>();
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    const dim3 grid(a.S / FWD_BQ, a.B * a.H);
    kernel<<<grid, NT, smem, a.stream>>>(
        tq, tk, tv, a.lut, static_cast<T*>(a.o1), static_cast<float*>(a.o2),
        a.S, a.H, a.st, a.sm_scale, a.causal);
    return cudaGetLastError();
  }
  constexpr size_t smem = ds::attn::bwd_smem_bytes<D>();
  const dim3 grid(a.S / ds::attn::bwd_rows<D>(), a.B * a.H);
  if (part == Part::kDKV) {
    auto kernel = block_sparse_dkv_kernel<T, D>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, NT, smem, a.stream>>>(
        tq, tk, tv, td, a.lse_in, a.delta, a.lut, static_cast<T*>(a.o1),
        static_cast<T*>(a.o2), a.S, a.H, a.st, a.sm_scale, a.causal);
  } else {
    auto kernel = block_sparse_dq_kernel<T, D>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, NT, smem, a.stream>>>(
        tq, tk, tv, td, a.lse_in, a.delta, a.lut, static_cast<T*>(a.o1),
        a.S, a.H, a.st, a.sm_scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, Part part, const Args& a) {
  switch (D) {
    case 64:
      return launch<T, 64>(part, a);
    case 128:
      return launch<T, 128>(part, a);
    case 256:
      return launch<T, 256>(part, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Part part, const Args& a, int D, int dtype) {
  if (a.S % GRAIN != 0) return cudaErrorInvalidValue;
  if (dtype == ds::DTYPE_F32) return dispatch_d<float>(D, part, a);
  if (dtype == ds::DTYPE_BF16) return dispatch_d<__nv_bfloat16>(D, part, a);
  return cudaErrorInvalidValue;
}

Lut make_lut(const void* lut, const void* counts, const void* order,
             int max_active) {
  return Lut{static_cast<const int*>(lut), static_cast<const int*>(counts),
             static_cast<const int*>(order), max_active};
}

}  // namespace

// q, k, v: [B, S, H, D] read through (batch, seq, head) strides, head dim
// contiguous, S a multiple of 128; lut: [H, S/128, max_active] int32, its
// row (h, i) listing counts[h, i] active column blocks; order: [S/128]
// int32, the row blocks in launch order; causal: 1 masks keys after their
// query. The forward writes out [B, S, H, D] contiguous in q's dtype and
// lse [B·H, S] fp32. Each returns cudaGetLastError() after its launch.
extern "C" int ds_block_sparse_fwd(const void* q, const void* k,
                                   const void* v, const void* lut,
                                   const void* counts, const void* order,
                                   int max_active, void* out, void* lse,
                                   int B, int S, int H, int D, long long qsb,
                                   long long qss, long long qsh, long long ksb,
                                   long long kss, long long ksh, long long vsb,
                                   long long vss, long long vsh,
                                   float sm_scale, int causal, int dtype,
                                   void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr,
               make_lut(lut, counts, order, max_active), out, lse, B, S, H,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(Part::kFwd, a, D, dtype);
}

// dout: [B, S, H, D] contiguous; lse, delta: [B·H, S] fp32; lut, counts,
// order: the TRANSPOSED layout's (for each key block, the query blocks
// that attend it). Writes dk, dv [B, S, H, D] contiguous in q's dtype.
extern "C" int ds_block_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lut, const void* counts,
    const void* order, int max_active, void* dk, void* dv, int B, int S,
    int H, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    float sm_scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               make_lut(lut, counts, order, max_active), dk, dv, B, S, H,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(Part::kDKV, a, D, dtype);
}

// the forward layout's lut, counts, order; writes dq [B, S, H, D]
// contiguous in q's dtype
extern "C" int ds_block_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lut, const void* counts,
    const void* order, int max_active, void* dq, int B, int S, int H, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    float sm_scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               make_lut(lut, counts, order, max_active), dq, nullptr, B, S,
               H, Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(Part::kDQ, a, D, dtype);
}
