// Causal flash-attention forward with optional segment ids, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` of
// deeperspeed_tpu/ops/pallas/flash_attention.py (reached through `_fwd`
// with `seg`, as `flash_attention_segmented` calls it): online-softmax
// attention over the causal trapezoid, with a whole k-tile skipped when
// its q rows and keys share no segment id and the survivors masked to
// -1e30 element by element. Rows with no live key give zero output and
// lse = +1e30.
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
//   later work.
// - q, k and v are read through (batch, seq, head) strides, so the
//   views split out of the fused QKV projection need no copy; out is
//   written [B, S, H, D] contiguous and lse [B·H, S].
#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads per block (16 x 16 micro-tile grid)

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D +
                          BQ * (BK + 1) + 3 * BQ) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ out, float* __restrict__ lse, int S,
                     int H, long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     float sm_scale) {
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);           // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D]
  float* Ps = Vs + BK * D;                 // [BQ][BK + 1] scores, then p
  float* row_alpha = Ps + BQ * (BK + 1);   // [BQ]
  float* row_m = row_alpha + BQ;           // [BQ]
  float* row_l = row_m + BQ;               // [BQ]
  int* seg_q = reinterpret_cast<int*>(row_l + BQ);  // [BQ]
  int* seg_k = seg_q + BQ;                          // [BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // micro-tile column group
  const int ty = tid / 16;   // micro-tile row group
  const int sr = tid / 4;    // softmax row owned by this thread's quad
  const int part = tid % 4;  // quarter of that row
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[r * (D + 1) + d] = row < S ? ds::to_float(qb[row * qss + d]) : 0.f;
  }
  if (seg != nullptr) {
    for (int i = tid; i < BQ; i += NT)
      seg_q[i] = q0 + i < S ? seg[(long long)b * S + q0 + i] : INT_MIN;
  }

  float m_i = ds::NEG_INF;  // running max of row sr
  float l_i = 0.f;          // running sum of row sr
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int last_key = min(S - 1, q0 + BQ - 1);  // causal limit of the tile
  const int n_kt = last_key / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    if (seg != nullptr) {
      for (int i = tid; i < BK; i += NT)
        seg_k[i] = k0 + i < S ? seg[(long long)b * S + k0 + i] : INT_MIN;
      __syncthreads();
      // block-level skip: no live (causal, same-segment) pair in the tile
      int hit = 0;
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const int row = q0 + r, key = k0 + c;
        hit |= (row < S && key <= row && seg_q[r] == seg_k[c]);
      }
      if (!__syncthreads_or(hit)) continue;
    }
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, key = k0 + r;
      const bool ok = key < S;
      Ks[r * (D + 1) + d] = ok ? ds::to_float(kb[key * kss + d]) : 0.f;
      Vs[r * D + d] = ok ? ds::to_float(vb[key * vss + d]) : 0.f;
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
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
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
        const int row = q0 + r, key = k0 + c;
        bool live = key <= row && key < S;
        if (seg != nullptr) live = live && seg_q[r] == seg_k[c];
        Ps[r * (BK + 1) + c] = live ? s[i][j] * sm_scale : ds::NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: each quad of lanes owns one row
    {
      float* prow = Ps + sr * (BK + 1);
      float mx = ds::NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) mx = fmaxf(mx, prow[part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = __expf(m_i - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) {
        const int c = part + 4 * jj;
        const float sv = prow[c];
        const float p = sv <= 0.5f * ds::NEG_INF ? 0.f : __expf(sv - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = alpha * l_i + sum;
      m_i = m_new;
      if (part == 0) row_alpha[sr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  __syncthreads();
  if (part == 0) {
    row_m[sr] = m_i;
    row_l[sr] = l_i;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= S) continue;
    const float l = row_l[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = ds::from_float<T>(acc[i][j] * inv);
    if (tx == 0)
      lse[(long long)bh * S + row] =
          l == 0.f ? -ds::NEG_INF : row_m[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, void* out, float* lse, int B, int S, int H,
                   const long long* st, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), lse, S, H, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* seg, void* out, float* lse, int B, int S,
                       int H, const long long* st, float sm_scale,
                       cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, seg, out, lse, B, S, H, st, sm_scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, seg, out, lse, B, S, H, st, sm_scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, seg, out, lse, B, S, H, st, sm_scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, S, H, D] read through (batch, seq, head) strides, with the
// head dim contiguous; seg: [B, S] int32 contiguous or null (plain causal);
// out: [B, S, H, D] contiguous; lse: [B·H, S] fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seg, void* out, void* lse, int B,
                            int S, int H, int D, long long qsb, long long qss,
                            long long qsh, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss,
                            long long vsh, float sm_scale, int dtype,
                            void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int* s = static_cast<const int*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == ds::DTYPE_F32)
    return dispatch_d<float>(D, q, k, v, s, out, l, B, S, H, st, sm_scale, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, s, out, l, B, S, H, st,
                                     sm_scale, cs);
  return cudaErrorInvalidValue;
}
