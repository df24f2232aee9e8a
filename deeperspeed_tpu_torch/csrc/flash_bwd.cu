// Causal flash-attention backward with optional segment ids, for sm_90a.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/pallas/flash_attention.py
// that `_bwd` reaches: `_bwd_single_kernel` / `_bwd_single_mh_kernel` (one
// block holds the whole sequence, S <= 1024, no segments) and the tiled
// `_bwd_dkv_kernel` / `_bwd_dq_kernel` (longer sequences, segmented
// calls). They compute one function, so one pair of kernels covers both:
//
//   P  = exp(s * scale - lse) on live (causal, same-segment) pairs, else 0
//   dP = dO V^T,  dS = P * (dP - delta) * scale
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
//
// with delta = rowsum(dO * out) from the caller and lse from the forward
// kernel (csrc/flash_fwd.cu). A row with no live key has lse = +1e30, so
// its P is 0 and its gradients are 0.
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
#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block (16 x 16 micro-tile grid)

// rows per tile (q rows and keys alike): 64, or 32 where D = 256 would
// not fit four fp32 tiles in shared memory
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D <= 128 ? 64 : 32;
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  constexpr int B = tile_rows<D>();
  return sizeof(float) * (4 * B * (D + 1) + 2 * B * (B + 1) + 2 * B) +
         sizeof(int) * 2 * B;
}

struct Strides {
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
};

// rows [r0, r0 + B) of one head of x (read through its strides) into
// smem [B][D + 1] as fp32; rows at or past S read as 0
template <typename T, int D, int B>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, long long row_stride) {
  for (int i = threadIdx.x; i < B * D; i += NT) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] =
        row < S ? ds::to_float(src[row * row_stride + d]) : 0.f;
  }
}

// any live (causal, same-segment) pair between q rows [q0, q0 + B) and
// keys [k0, k0 + B)? Called by every thread of the block.
template <int B>
__device__ __forceinline__ bool tile_live(const int* seg_q, const int* seg_k,
                                          int q0, int k0, int S) {
  int hit = 0;
  for (int i = threadIdx.x; i < B * B; i += NT) {
    const int r = i / B, c = i % B;
    const int row = q0 + r, key = k0 + c;
    hit |= (row < S && key <= row && seg_q[r] == seg_k[c]);
  }
  return __syncthreads_or(hit);
}

// P and dS of one (q tile, key tile) pair into Ps / dSs [B][B + 1]:
// thread (ty, tx) computes rows ty + 16i and keys tx + 16j.
template <int D, int B>
__device__ __forceinline__ void p_and_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* row_lse, const float* row_delta, const int* seg_q,
    const int* seg_k, bool use_seg, int q0, int k0, int S, float sm_scale,
    float* Ps, float* dSs) {
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
      qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      dov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
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
      const int row = q0 + r, key = k0 + c;
      bool live = key <= row && row < S && key < S;
      if (use_seg) live = live && seg_q[r] == seg_k[c];
      const float p =
          live ? __expf(s[i][j] * sm_scale - row_lse[r]) : 0.f;
      Ps[r * (B + 1) + c] = p;
      dSs[r * (B + 1) + c] = p * (dp[i][j] - row_delta[r]) * sm_scale;
    }
  }
}

// the shared-memory carve-up of both kernels
template <int D>
struct Smem {
  static constexpr int B = tile_rows<D>();
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *row_lse, *row_delta;
  int *seg_q, *seg_k;
  __device__ explicit Smem(float* base) {
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

// q rows [q0, q0 + B): Q and dO tiles, their lse and delta, segment ids
template <typename T, int D>
__device__ __forceinline__ void load_q_side(Smem<D>& sm, const T* qb,
                                            const T* db, const float* lse_bh,
                                            const float* delta_bh,
                                            const int* seg_b, int q0, int S,
                                            int H, long long qss) {
  constexpr int B = Smem<D>::B;
  load_tile<T, D, B>(sm.Qs, qb, q0, S, qss);
  load_tile<T, D, B>(sm.dOs, db, q0, S, (long long)H * D);
  for (int i = threadIdx.x; i < B; i += NT) {
    const bool ok = q0 + i < S;
    sm.row_lse[i] = ok ? lse_bh[q0 + i] : -ds::NEG_INF;
    sm.row_delta[i] = ok ? delta_bh[q0 + i] : 0.f;
    if (seg_b != nullptr) sm.seg_q[i] = ok ? seg_b[q0 + i] : INT_MIN;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, Strides st,
                         float sm_scale) {
  constexpr int B = tile_rows<D>();
  constexpr int R = B / 16;   // keys per thread
  constexpr int DJ = D / 16;  // head dims per thread
  extern __shared__ float smem[];
  Smem<D> sm(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kt = blockIdx.x;  // key tile 0 (the most q tiles) first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * B;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;

  load_tile<T, D, B>(sm.Ks, kb, k0, S, st.kss);
  load_tile<T, D, B>(sm.Vs, vb, k0, S, st.vss);
  if (seg_b != nullptr)
    for (int i = threadIdx.x; i < B; i += NT)
      sm.seg_k[i] = k0 + i < S ? seg_b[k0 + i] : INT_MIN;

  float acc_k[R][DJ], acc_v[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (S + B - 1) / B;
  for (int qt = kt; qt < n_qt; ++qt) {  // q tiles before kt are all masked
    const int q0 = qt * B;
    __syncthreads();  // the previous tile's readers are done
    if (seg_b != nullptr) {
      for (int i = threadIdx.x; i < B; i += NT)
        sm.seg_q[i] = q0 + i < S ? seg_b[q0 + i] : INT_MIN;
      __syncthreads();
      if (!tile_live<B>(sm.seg_q, sm.seg_k, q0, k0, S)) continue;
    }
    load_q_side<T, D>(sm, qb, db, lse_bh, delta_bh, seg_b, q0, S, H, st.qss);
    __syncthreads();
    p_and_ds<D, B>(sm.Qs, sm.dOs, sm.Ks, sm.Vs, sm.row_lse, sm.row_delta,
                   sm.seg_q, sm.seg_k, seg_b != nullptr, q0, k0, S, sm_scale,
                   sm.Ps, sm.dSs);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q for keys ty + 16i, dims tx + 16j
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

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    const long long o = (((long long)b * S + key) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[o + tx + 16 * j] = ds::from_float<T>(acc_k[i][j]);
      dv[o + tx + 16 * j] = ds::from_float<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg, T* __restrict__ dq,
                        int S, int H, Strides st, float sm_scale) {
  constexpr int B = tile_rows<D>();
  constexpr int R = B / 16;   // q rows per thread
  constexpr int DJ = D / 16;  // head dims per thread
  extern __shared__ float smem[];
  Smem<D> sm(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the most keys first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * B;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const int* seg_b = seg != nullptr ? seg + (long long)b * S : nullptr;

  load_q_side<T, D>(sm, qb, db, lse + (long long)bh * S,
                    delta + (long long)bh * S, seg_b, q0, S, H, st.qss);

  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int last_key = min(S - 1, q0 + B - 1);  // causal limit of the tile
  const int n_kt = last_key / B + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the previous tile's readers are done
    if (seg_b != nullptr) {
      for (int i = threadIdx.x; i < B; i += NT)
        sm.seg_k[i] = k0 + i < S ? seg_b[k0 + i] : INT_MIN;
      __syncthreads();
      if (!tile_live<B>(sm.seg_q, sm.seg_k, q0, k0, S)) continue;
    }
    load_tile<T, D, B>(sm.Ks, kb, k0, S, st.kss);
    load_tile<T, D, B>(sm.Vs, vb, k0, S, st.vss);
    __syncthreads();
    p_and_ds<D, B>(sm.Qs, sm.dOs, sm.Ks, sm.Vs, sm.row_lse, sm.row_delta,
                   sm.seg_q, sm.seg_k, seg_b != nullptr, q0, k0, S, sm_scale,
                   sm.Ps, sm.dSs);
    __syncthreads();
    // dQ += dS K for rows ty + 16i, dims tx + 16j
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

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const long long o = (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[o + tx + 16 * j] = ds::from_float<T>(acc[i][j]);
  }
}

// which of the two kernels a call launches
enum class Part { kDKV, kDQ };

template <typename T, int D>
cudaError_t launch(Part part, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* seg, void* g1, void* g2, int B, int S, int H,
                   const Strides& st, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  constexpr int rows = tile_rows<D>();
  const dim3 grid((S + rows - 1) / rows, B * H);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* td = static_cast<const T*>(dout);
  cudaError_t err;
  if (part == Part::kDKV) {
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(tq, tk, tv, td, lse, delta, seg,
                                       static_cast<T*>(g1),
                                       static_cast<T*>(g2), S, H, st,
                                       sm_scale);
  } else {
    auto kernel = flash_bwd_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(tq, tk, tv, td, lse, delta, seg,
                                       static_cast<T*>(g1), S, H, st,
                                       sm_scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, Part part, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, const int* seg, void* g1, void* g2,
                       int B, int S, int H, const Strides& st, float sm_scale,
                       cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(part, q, k, v, dout, lse, delta, seg, g1, g2, B,
                           S, H, st, sm_scale, stream);
    case 128:
      return launch<T, 128>(part, q, k, v, dout, lse, delta, seg, g1, g2, B,
                            S, H, st, sm_scale, stream);
    case 256:
      return launch<T, 256>(part, q, k, v, dout, lse, delta, seg, g1, g2, B,
                            S, H, st, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Part part, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, const void* seg,
        void* g1, void* g2, int B, int S, int H, int D, const Strides& st,
        float sm_scale, int dtype, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* s = static_cast<const int*>(seg);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == ds::DTYPE_F32)
    return dispatch_d<float>(D, part, q, k, v, dout, l, dl, s, g1, g2, B, S,
                             H, st, sm_scale, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, part, q, k, v, dout, l, dl, s, g1,
                                     g2, B, S, H, st, sm_scale, cs);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [B, S, H, D] read through (batch, seq, head) strides, head dim
// contiguous; dout: [B, S, H, D] contiguous; lse, delta: [B·H, S] fp32;
// seg: [B, S] int32 contiguous or null (plain causal). ds_flash_bwd_dkv
// writes dk, dv and ds_flash_bwd_dq writes dq, each [B, S, H, D]
// contiguous in q's dtype. Each returns cudaGetLastError() after its
// launch.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg, void* dk,
                                void* dv, int B, int S, int H, int D,
                                long long qsb, long long qss, long long qsh,
                                long long ksb, long long kss, long long ksh,
                                long long vsb, long long vss, long long vsh,
                                float sm_scale, int dtype, void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return run(Part::kDKV, q, k, v, dout, lse, delta, seg, dk, dv, B, S, H, D,
             st, sm_scale, dtype, stream);
}

extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* seg, void* dq,
                               int B, int S, int H, int D, long long qsb,
                               long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb,
                               long long vss, long long vsh, float sm_scale,
                               int dtype, void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return run(Part::kDQ, q, k, v, dout, lse, delta, seg, dq, nullptr, B, S,
             H, D, st, sm_scale, dtype, stream);
}
