// Paged decode attention for sm_90a: one query row per sequence attends
// over its K/V history, read through the page table.
//
// Replaces the TPU kernel `_decode_kernel` of
// deeperspeed_tpu/ops/pallas/decode_attention.py (launched by
// `paged_decode_attention_pallas`). Keys at positions >= length are
// masked; a sequence of length 0 gets exact zeros, written here without
// reading any page.
//
// Bound on the H100: bytes. Each step reads every live key and value row
// once (2·H·len·D elements per sequence) and does 4·H·len·D flops on
// them, far below the ~295 flops a byte at which the tensor cores would
// become the limit. Design:
//
// - One thread block per (sequence, head), 8 warps. The block reads the
//   page id from `page_table` itself and visits only the live positions
//   (ceil(length / 8) chunks of 8 keys; a chunk never crosses a page
//   because page_size is a multiple of 8). Trash entries past the length
//   are never read.
// - Warps take chunks round-robin. Within a warp each lane holds D/32
//   contiguous dims of q and of the accumulator, so a key or value row is
//   one coalesced read; the 8 dot products of a chunk reduce across lanes
//   with shuffles. Each warp keeps its own online softmax (max, sum,
//   accumulator, all fp32); the block merges the 8 partial states at the
//   end.
// - The pool is read through (page, head, slot) strides from the layer's
//   base pointer, so the per-layer view of the [L, P, H, ps, D] pool needs
//   no copy.
#include "common.cuh"

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int KC = 8;          // keys per warp iteration

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, long long qsb, long long qsh,
    const T* __restrict__ kp, const T* __restrict__ vp, long long sp,
    long long sh, long long ss, const int* __restrict__ page_table,
    long long pt_sb, const int* __restrict__ lengths, T* __restrict__ out,
    int H, int page_size, int n_pages_row, float sm_scale) {
  constexpr int DPL = D / 32;  // dims per lane
  __shared__ float sm_m[NW];
  __shared__ float sm_l[NW];
  __shared__ float sm_acc[NW][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* o = out + (long long)bh * D;

  int len = lengths[b];
  len = min(len, n_pages_row * page_size);
  if (len <= 0) {
    for (int d = threadIdx.x; d < D; d += NT) o[d] = ds::from_float<T>(0.f);
    return;
  }

  float qv[DPL];
  const T* qrow = q + b * qsb + h * qsh + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = ds::to_float(qrow[i]);

  float m = ds::NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  const int* pt = page_table + b * pt_sb;
  const int n_chunks = (len + KC - 1) / KC;
  for (int c = warp; c < n_chunks; c += NW) {
    const int pos0 = c * KC;
    const long long page = pt[pos0 / page_size];
    const long long base = page * sp + h * sh + (pos0 % page_size) * ss +
                           lane * DPL;
    const T* kr = kp + base;
    const T* vr = vp + base;

    float s[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        part = fmaf(qv[i], ds::to_float(kr[j * ss + i]), part);
      s[j] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KC; ++j)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);

    float cmax = ds::NEG_INF;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      s[j] = pos0 + j < len ? s[j] * sm_scale : ds::NEG_INF;
      cmax = fmaxf(cmax, s[j]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (pos0 + j >= len) break;   // the masked tail: p is exactly 0
      const float p = __expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(p, ds::to_float(vr[j * ss + i]), acc[i]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NT) {
    float mx = ds::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = __expf(sm_m[w] - mx);
      lsum += sm_l[w] * sc;
      a += sm_acc[w][d] * sc;
    }
    o[d] = ds::from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, long long qsb, long long qsh,
                   const void* kp, const void* vp, long long sp, long long sh,
                   long long ss, const int* pt, long long pt_sb,
                   const int* lengths, void* out, int B, int H,
                   int page_size, int n_pages_row, float sm_scale,
                   cudaStream_t stream) {
  paged_decode_kernel<T, D><<<B * H, NT, 0, stream>>>(
      static_cast<const T*>(q), qsb, qsh, static_cast<const T*>(kp),
      static_cast<const T*>(vp), sp, sh, ss, pt, pt_sb, lengths,
      static_cast<T*>(out), H, page_size, n_pages_row, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, long long qsb, long long qsh,
                       const void* kp, const void* vp, long long sp,
                       long long sh, long long ss, const int* pt,
                       long long pt_sb, const int* lengths, void* out, int B,
                       int H, int page_size, int n_pages_row, float sm_scale,
                       cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, qsb, qsh, kp, vp, sp, sh, ss, pt, pt_sb,
                           lengths, out, B, H, page_size, n_pages_row,
                           sm_scale, stream);
    case 128:
      return launch<T, 128>(q, qsb, qsh, kp, vp, sp, sh, ss, pt, pt_sb,
                            lengths, out, B, H, page_size, n_pages_row,
                            sm_scale, stream);
    case 256:
      return launch<T, 256>(q, qsb, qsh, kp, vp, sp, sh, ss, pt, pt_sb,
                            lengths, out, B, H, page_size, n_pages_row,
                            sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, H, D] through (batch, head) strides; k_pages/v_pages: one layer's
// [P, H, page_size, D] pool through (page, head, slot) strides, head dim
// contiguous; page_table: [B, n_pages_row] int32 with row stride pt_sb;
// lengths: [B] int32; out: [B, H, D] contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_paged_decode(const void* q, long long qsb, long long qsh,
                               const void* k_pages, const void* v_pages,
                               long long sp, long long sh, long long ss,
                               const void* page_table, long long pt_sb,
                               const void* lengths, void* out, int B, int H,
                               int D, int page_size, int n_pages_row,
                               float sm_scale, int dtype, void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == ds::DTYPE_F32)
    return dispatch_d<float>(D, q, qsb, qsh, k_pages, v_pages, sp, sh, ss,
                             pt, pt_sb, ln, out, B, H, page_size,
                             n_pages_row, sm_scale, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, qsb, qsh, k_pages, v_pages, sp,
                                     sh, ss, pt, pt_sb, ln, out, B, H,
                                     page_size, n_pages_row, sm_scale, cs);
  return cudaErrorInvalidValue;
}
