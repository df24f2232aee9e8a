// Paged decode attention for sm_90a: one query row per sequence attends
// over its K/V history, read through the page table.
//
// Replaces the TPU kernels `_decode_kernel` (bf16/fp32 pools) and
// `_decode_kernel_quant` (int8 pools with bf16 per-slot scales) of
// deeperspeed_tpu/ops/pallas/decode_attention.py (both launched by
// `paged_decode_attention_pallas`). Keys at positions >= length are
// masked; a sequence of length 0 gets exact zeros, written here without
// reading any page.
//
// Bound on the H100: bytes. Each step reads every live key and value row
// once (2·H·len·D elements per sequence, plus 2·H·len bf16 scales for
// int8 pools) and does 4·H·len·D flops on them, far below the ~295 flops
// a byte at which the tensor cores would become the limit. Design:
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
// - int8 pools: the one page id of a chunk addresses both the int8 rows
//   and the 8 bf16 scales of the same (page, head); each element is
//   dequantized as float(q) * float(scale[slot]) right after its load.
//   q is read in its own dtype and widened to fp32, and P·V runs on the
//   fp32 probabilities, as the TPU kernel does.
// - The pools (and scale pools) are read through (page, head, slot)
//   strides from the layer's base pointer, so the per-layer views of the
//   [L, P, H, ps, D] pool and the [L, P, H, ps] scale pool need no copy.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int KC = 8;          // keys per warp iteration

struct DecodeArgs {
  const void* q;
  long long qsb, qsh;                  // q strides (batch, head)
  const void* kp;
  const void* vp;
  long long sp, sh, ss;                // pool strides (page, head, slot)
  const __nv_bfloat16* ks;             // int8 pools only: scale pools
  const __nv_bfloat16* vs;
  long long ssp, ssh;                  // scale strides (page, head)
  const int* page_table;
  long long pt_sb;                     // page-table row stride
  const int* lengths;
  void* out;                           // [B, H, D] contiguous
  int B, H, page_size, n_pages_row;
  float sm_scale;
};

// T: q/out dtype; KV: pool element type (T, or int8_t for quantized pools)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(DecodeArgs a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int DPL = D / 32;  // dims per lane
  __shared__ float sm_m[NW];
  __shared__ float sm_l[NW];
  __shared__ float sm_acc[NW][D];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int page_size = a.page_size;
  const long long ss = a.ss;
  T* o = static_cast<T*>(a.out) + (long long)bh * D;
  const KV* kp = static_cast<const KV*>(a.kp);
  const KV* vp = static_cast<const KV*>(a.vp);

  int len = a.lengths[b];
  len = min(len, a.n_pages_row * page_size);
  if (len <= 0) {
    for (int d = threadIdx.x; d < D; d += NT) o[d] = ds::from_float<T>(0.f);
    return;
  }

  float qv[DPL];
  const T* qrow = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh +
                  lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = ds::to_float(qrow[i]);

  float m = ds::NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  const int* pt = a.page_table + b * a.pt_sb;
  const int n_chunks = (len + KC - 1) / KC;
  for (int c = warp; c < n_chunks; c += NW) {
    const int pos0 = c * KC;
    const long long page = pt[pos0 / page_size];
    const int slot0 = pos0 % page_size;
    const long long base = page * a.sp + h * a.sh + slot0 * ss + lane * DPL;
    const KV* kr = kp + base;
    const KV* vr = vp + base;
    float ksc[KC], vsc[KC];
    if constexpr (kQuant) {
      const long long sbase = page * a.ssp + h * a.ssh + slot0;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        ksc[j] = __bfloat162float(a.ks[sbase + j]);
        vsc[j] = __bfloat162float(a.vs[sbase + j]);
      }
    }

    float s[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float kv;
        if constexpr (kQuant)
          kv = static_cast<float>(kr[j * ss + i]) * ksc[j];
        else
          kv = ds::to_float(kr[j * ss + i]);
        part = fmaf(qv[i], kv, part);
      }
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
      s[j] = pos0 + j < len ? s[j] * a.sm_scale : ds::NEG_INF;
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
      for (int i = 0; i < DPL; ++i) {
        float vv;
        if constexpr (kQuant)
          vv = static_cast<float>(vr[j * ss + i]) * vsc[j];
        else
          vv = ds::to_float(vr[j * ss + i]);
        acc[i] = fmaf(p, vv, acc[i]);
      }
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
    float lsum = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = __expf(sm_m[w] - mx);
      lsum += sm_l[w] * sc;
      acc_d += sm_acc[w][d] * sc;
    }
    o[d] = ds::from_float<T>(acc_d / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, typename KV>
cudaError_t dispatch_d(int D, const DecodeArgs& a, cudaStream_t stream) {
  const int blocks = a.B * a.H;
  switch (D) {
    case 64:
      paged_decode_kernel<T, KV, 64><<<blocks, NT, 0, stream>>>(a);
      break;
    case 128:
      paged_decode_kernel<T, KV, 128><<<blocks, NT, 0, stream>>>(a);
      break;
    case 256:
      paged_decode_kernel<T, KV, 256><<<blocks, NT, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

DecodeArgs make_args(const void* q, long long qsb, long long qsh,
                     const void* k_pages, const void* v_pages, long long sp,
                     long long sh, long long ss, const void* page_table,
                     long long pt_sb, const void* lengths, void* out, int B,
                     int H, int page_size, int n_pages_row, float sm_scale) {
  DecodeArgs a{};
  a.q = q;
  a.qsb = qsb;
  a.qsh = qsh;
  a.kp = k_pages;
  a.vp = v_pages;
  a.sp = sp;
  a.sh = sh;
  a.ss = ss;
  a.page_table = static_cast<const int*>(page_table);
  a.pt_sb = pt_sb;
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.B = B;
  a.H = H;
  a.page_size = page_size;
  a.n_pages_row = n_pages_row;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// q: [B, H, D] through (batch, head) strides; k_pages/v_pages: one layer's
// [P, H, page_size, D] pool through (page, head, slot) strides, head dim
// contiguous, in q's dtype; page_table: [B, n_pages_row] int32 with row
// stride pt_sb; lengths: [B] int32; out: [B, H, D] contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_paged_decode(const void* q, long long qsb, long long qsh,
                               const void* k_pages, const void* v_pages,
                               long long sp, long long sh, long long ss,
                               const void* page_table, long long pt_sb,
                               const void* lengths, void* out, int B, int H,
                               int D, int page_size, int n_pages_row,
                               float sm_scale, int dtype, void* stream) {
  const DecodeArgs a = make_args(q, qsb, qsh, k_pages, v_pages, sp, sh, ss,
                                 page_table, pt_sb, lengths, out, B, H,
                                 page_size, n_pages_row, sm_scale);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == ds::DTYPE_F32) return dispatch_d<float, float>(D, a, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, a, cs);
  return cudaErrorInvalidValue;
}

// The int8 pools of kv_cache_dtype "int8": k_pages/v_pages int8 as above,
// k_scales/v_scales: one layer's [P, H, page_size] bf16 scale pool
// through (page, head) strides, slot contiguous; q and out in `dtype`.
extern "C" int ds_paged_decode_int8(
    const void* q, long long qsb, long long qsh, const void* k_pages,
    const void* v_pages, long long sp, long long sh, long long ss,
    const void* k_scales, const void* v_scales, long long ssp, long long ssh,
    const void* page_table, long long pt_sb, const void* lengths, void* out,
    int B, int H, int D, int page_size, int n_pages_row, float sm_scale,
    int dtype, void* stream) {
  DecodeArgs a = make_args(q, qsb, qsh, k_pages, v_pages, sp, sh, ss,
                           page_table, pt_sb, lengths, out, B, H, page_size,
                           n_pages_row, sm_scale);
  a.ks = static_cast<const __nv_bfloat16*>(k_scales);
  a.vs = static_cast<const __nv_bfloat16*>(v_scales);
  a.ssp = ssp;
  a.ssh = ssh;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == ds::DTYPE_F32) return dispatch_d<float, int8_t>(D, a, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16, int8_t>(D, a, cs);
  return cudaErrorInvalidValue;
}
