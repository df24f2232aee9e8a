// Paged decode attention for sm_90a: one query row per sequence attends
// over its K/V history, read through the page table.
//
// Replaces the TPU kernels `_decode_kernel` (bf16/fp32 pools) and
// `_decode_kernel_quant` (int8 pools with bf16 per-slot scales) of
// deeperspeed_tpu/ops/pallas/decode_attention.py (both launched by
// `paged_decode_attention_pallas`). Keys at positions >= length are
// masked; a sequence of length 0 gets exact zeros without reading any
// page.
//
// Bound on the H100: bytes. Each step reads every live key and value row
// once (2·H·len·D elements per sequence, plus 2·H·len bf16 scales for
// int8 pools) and does 4·H·len·D flops on them, far below the ~295 flops
// a byte at which the tensor cores would become the limit. At serving
// lengths (tens to a few hundred keys a row) one launch moves a few MB,
// so the latency of the one DRAM round trip and the number of bytes in
// flight decide the time. Two designs:
//
// `paged_decode_cluster_kernel` (bf16 pools with bf16 q, fp16 pools with
// fp16 q, int8 pools with bf16, fp16 or fp32 q, at D = 64 and 128; the
// wrapper's "cluster" design; fp16 pools run the bf16 kernel with the
// element type swapped, the output rounded to nearest fp16):
//
// - Split-KV over a thread-block cluster of C CTAs a (sequence, head).
//   The host picks C from the shapes, never from the lengths, so one
//   launch serves any lengths (and a CUDA graph): C = min(8, pages a row),
//   halved while the B·H·C CTAs would not fit one wave of the card (6
//   CTAs on each of 132 SMs, this kernel's occupancy at bf16, D = 64).
//   GPT-NeoX-125M's decode batch (B=16, H=12, 16 pages a row) thus takes
//   C = 4, not the 8 a row alone would give: on the H100, 4 matches 8 at
//   lengths up to 1024 and is faster at serving lengths, where most ranks
//   have no page and half as many CTAs cost less to launch
//   (chip_smoke.py phase 3 times both).
//   Rank r takes page slots r, r + C, r + 2C, ... (round-robin, so ragged
//   lengths stay balanced). A rank > 0 with no live page exits before it
//   reads any page: rank 0 merges only the live ranks' slots, and a
//   cluster barrier waits only for threads that have not exited, so the
//   SM slot frees at once (empty ranks that waited for the merge held
//   their slots and made the grid two waves). Rank 0 always
//   stays, and writes exact zeros for a length-0 row. NEG_INF is finite,
//   so no step evaluates inf - inf.
// - Whole-page tiles in shared memory before any math: with slot stride
//   == D a (page, head) of K is one contiguous page_size x D block, copied
//   as 16-byte cp.async chunks (V and, for int8, the two 128-byte scale
//   rows beside it), 64 rows a tile (a larger page is several tiles), two
//   stages so the next tile loads while this one is computed. The length,
//   q and every page id of the rank are read in one step before the first
//   tile is asked for. (32-row tiles, a third stage and 256 threads were
//   each no faster on the H100.)
// - From shared memory, vector reads: a lane reads 16 bytes of a bf16 row
//   (8 values) or 8 bytes of an int8 row (8 values; 16 took the int8
//   kernel to 96 registers and was slower), so D/8 lanes share a key
//   and reduce its dot product with 3-4 shuffles. int8 pools fold the
//   scales out of the inner products: s_j = (q · k_j) · ks[j] · sm_scale
//   and acc += (p_j · vs[j]) · v_j, the TPU kernel's per-element
//   dequantization in exact arithmetic, one multiply a key instead of one
//   an element. q widens to fp32; scores, P and the accumulator stay fp32
//   (the TPU kernel casts P to bf16 for bf16 pools; both are within the
//   stated tolerances). Softmax in base 2 (scores pre-scaled by log2 e,
//   `ex2`).
// - Fixed-order merge over distributed shared memory, in the same launch:
//   each live rank writes its (acc[D], m, l) into its slot of rank 0's
//   shared memory (`map_rank` / `st_cluster_f32`), one cluster barrier,
//   then rank 0 merges slots 0 .. min(C, live pages) - 1 in that order,
//   divides by l (by 1 where l == 0) and writes the output in q's dtype.
//   No atomics, no global workspace: two calls give the same bits.
//
// `paged_decode_kernel` (the "single" design: fp32 pools, and D = 256 at
// any pool dtype) is the design that came before, unchanged:
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
//
// Both read the pools (and scale pools) through (page, head, slot)
// strides from the layer's base pointer, so the per-layer views of the
// [L, P, H, ps, D] pool and the [L, P, H, ps] scale pool need no copy.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

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

// ---------------------------------------------------------------------------
// the cluster design (bf16, fp16 and int8 pools at D = 64 and 128)
// ---------------------------------------------------------------------------

namespace hp = ds::hopper;

constexpr int CL_NT = 128;      // threads a CTA
constexpr int CL_TR = 64;       // key rows a tile (a page, or 64 rows of one)
constexpr int CL_STAGES = 2;    // tiles in flight
constexpr int CL_MAX = 8;       // the portable cluster size limit
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a CTA: CL_STAGES stages of [K tile][V tile][ks][vs]
// (the scale rows for int8 pools only), the tile's scores, the merge
// slots (rank 0's are read: [CL_MAX][D + 2] fp32 = acc[D], m, l) and the
// rank's page ids. After the last tile the stages hold the key groups'
// partial sums.
template <typename KV, int D>
struct ClLayout {
  static constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static constexpr int VEC = QUANT ? 8 : 16;   // bytes of a lane's vector
  static constexpr int EPV = VEC / static_cast<int>(sizeof(KV));
  static constexpr int LPK = D / EPV;        // lanes that share a key row
  static constexpr int KPP = CL_NT / LPK;    // keys a pass of the CTA
  static constexpr int TILE = CL_TR * D * static_cast<int>(sizeof(KV));
  static constexpr int SC = QUANT ? CL_TR * 2 : 0;
  static constexpr int STAGE = 2 * TILE + 2 * SC;
  static constexpr int S_OFF = CL_STAGES * STAGE;
  static constexpr int SLOT = D + 2;
  static constexpr int SLOT_OFF = S_OFF + CL_TR * 4;
  static constexpr int PID_OFF = SLOT_OFF + CL_MAX * SLOT * 4;
  static constexpr int RED = KPP * (D + 1) * 4;
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key's lanes in one warp");
  static_assert(RED <= S_OFF, "the partial sums fit the stages");
  static_assert(TILE % 16 == 0 && SLOT_OFF % 16 == 0, "16-byte chunks");
  static size_t smem(int n_pr) { return PID_OFF + 4 * static_cast<size_t>(n_pr); }
};

// one 16- (or 8-) byte vector of a key or value row, widened to fp32
template <typename KV, int N>
__device__ __forceinline__ void widen(const KV* p, float (&f)[N]) {
  constexpr int W = N * static_cast<int>(sizeof(KV)) / 4;   // 32-bit words
  unsigned w[W];
  if constexpr (W == 4) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x, w[1] = r.y;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (std::is_same<KV, int8_t>::value) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xFFu));
    } else if constexpr (std::is_same<KV, __half>::value) {
      f[2 * i] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i] & 0xFFFFu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i] >> 16)));
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// T: q/out dtype; KV: __nv_bfloat16 (with T bf16), __half (with T fp16)
// or int8_t. Grid: C CTAs
// (one cluster) a (sequence, head), blockIdx.x / C = b·H + h.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(CL_NT)
    paged_decode_cluster_kernel(DecodeArgs a) {
  using L = ClLayout<KV, D>;
  constexpr int EPV = L::EPV, LPK = L::LPK, KPP = L::KPP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem + L::S_OFF);
  float* slots = reinterpret_cast<float*>(smem + L::SLOT_OFF);
  int* pid = reinterpret_cast<int*>(smem + L::PID_OFF);

  hp::cluster_arrive_relaxed();   // its wait comes before the merge
  const int tid = threadIdx.x;
  const int C = static_cast<int>(hp::cluster_size());
  const int rank = static_cast<int>(hp::cluster_rank());
  const int bh = blockIdx.x / C;
  const int b = bh / a.H, h = bh % a.H;
  const int ps = a.page_size, np = a.n_pages_row;
  const int g = tid / LPK, c = tid % LPK;   // key group, vector in the row

  // one step: the page ids dealt to this rank (live or not), the length
  // and this thread's vector of q
  const int n_pr = rank < np ? (np - rank + C - 1) / C : 0;
  const int* pt = a.page_table + b * a.pt_sb;
  for (int i = tid; i < n_pr; i += CL_NT) pid[i] = pt[rank + i * C];
  const int len = max(0, min(a.lengths[b], np * ps));
  // a rank > 0 without a live page leaves at once: rank 0 merges only the
  // slots of the live ranks, and a cluster barrier waits only for threads
  // that have not exited, so its SM slot frees for the next cluster
  const int n_live = (len + ps - 1) / ps;   // live pages of the row
  if (rank > 0 && rank >= n_live) return;
  float qv[EPV];
  const T* qrow = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh +
                  c * EPV;
#pragma unroll
  for (int e = 0; e < EPV; ++e) qv[e] = ds::to_float(qrow[e]);
  const float scale = a.sm_scale * LOG2E;

  // the rank's tiles: its live pages in slot order, each cut into
  // ceil(ps / 64) tiles; tile t is (page i = t / nsub, part t % nsub)
  const int n_mine = n_live > rank ? (n_live - rank + C - 1) / C : 0;
  const int nsub = (ps + CL_TR - 1) / CL_TR;
  const int n_tiles = n_mine * nsub;
  auto tile_pos = [&](int t) {
    return (rank + (t / nsub) * C) * ps + (t % nsub) * CL_TR;
  };
  auto tile_rows = [&](int t) {
    const int sub = t % nsub;
    return min(min(CL_TR, ps - sub * CL_TR), len - tile_pos(t));
  };
  __syncthreads();   // the page ids

  // tile t's K and V rows (and scale rows) into stage t % CL_STAGES, as
  // 16-byte cp.async chunks; one commit group a tile, empty past the end
  auto load = [&](int t) {
    const int rows = t < n_tiles ? tile_rows(t) : 0;
    if (rows > 0) {
      unsigned char* st = smem + (t % CL_STAGES) * L::STAGE;
      const long long page = pid[t / nsub];
      const int slot0 = (t % nsub) * CL_TR;
      const long long off = page * a.sp + h * a.sh + slot0 * D;
      const unsigned char* kg = reinterpret_cast<const unsigned char*>(
          static_cast<const KV*>(a.kp) + off);
      const unsigned char* vg = reinterpret_cast<const unsigned char*>(
          static_cast<const KV*>(a.vp) + off);
      const int chunks = rows * D * static_cast<int>(sizeof(KV)) / 16;
      for (int ch = tid; ch < chunks; ch += CL_NT) {
        ds::cp_async16(st + ch * 16, kg + ch * 16, true);
        ds::cp_async16(st + L::TILE + ch * 16, vg + ch * 16, true);
      }
      if constexpr (L::QUANT) {
        // whole 8-slot chunks: page_size % 8 == 0 keeps them in the page
        const long long soff = page * a.ssp + h * a.ssh + slot0;
        const int sch = (rows + 7) / 8;
        if (tid < sch)
          ds::cp_async16(st + 2 * L::TILE + tid * 16, a.ks + soff + tid * 8,
                         true);
        else if (tid >= 32 && tid - 32 < sch)
          ds::cp_async16(st + 2 * L::TILE + L::SC + (tid - 32) * 16,
                         a.vs + soff + (tid - 32) * 8, true);
      }
    }
    ds::cp_async_commit();
  };

  float m = ds::NEG_INF, l = 0.f;
  float acc[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) acc[e] = 0.f;
#pragma unroll
  for (int t = 0; t < CL_STAGES - 1; ++t) load(t);
  for (int t = 0; t < n_tiles; ++t) {
    load(t + CL_STAGES - 1);
    ds::cp_async_wait<CL_STAGES - 1>();
    __syncthreads();   // tile t has landed, from every thread's copies
    const int rows = tile_rows(t);   // the same for every thread
    if (rows > 0) {
      const unsigned char* st = smem + (t % CL_STAGES) * L::STAGE;
      const KV* kt = reinterpret_cast<const KV*>(st);
      const KV* vt = reinterpret_cast<const KV*>(st + L::TILE);
      const __nv_bfloat16* kst =
          reinterpret_cast<const __nv_bfloat16*>(st + 2 * L::TILE);
      const __nv_bfloat16* vst = kst + CL_TR;
      // scores: LPK lanes a key, one vector each, then a shuffle tree
      for (int k0 = 0; k0 < rows; k0 += KPP) {
        const int key = k0 + g;
        float part = 0.f;
        if (key < rows) {
          float kv[EPV];
          widen<KV>(kt + key * D + c * EPV, kv);
#pragma unroll
          for (int e = 0; e < EPV; ++e) part = fmaf(qv[e], kv[e], part);
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (c == 0 && key < rows) {
          if constexpr (L::QUANT) part *= __bfloat162float(kst[key]);
          scores[key] = part * scale;
        }
      }
      __syncthreads();
      // the tile's max, by every warp over the tile's scores
      float mt = ds::NEG_INF;
      for (int j = tid % 32; j < rows; j += 32) mt = fmaxf(mt, scores[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m, mt);
      const float alpha = ds::ex2(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc[e] *= alpha;
      for (int key = g; key < rows; key += KPP) {
        const float p = ds::ex2(scores[key] - m_new);
        l += p;
        float pv = p;
        if constexpr (L::QUANT) pv *= __bfloat162float(vst[key]);
        float vv[EPV];
        widen<KV>(vt + key * D + c * EPV, vv);
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[e] = fmaf(pv, vv[e], acc[e]);
      }
      m = m_new;
    }
    __syncthreads();   // every thread is done with the stage and the scores
  }
  ds::cp_async_wait<0>();
  __syncthreads();

  // the key groups' partial sums, added in group order; then this rank's
  // (acc, m, l) into its slot of rank 0's shared memory
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < EPV; ++e) red[g * D + c * EPV + e] = acc[e];
  if (c == 0) red[KPP * D + g] = l;
  __syncthreads();
  hp::cluster_wait();   // every CTA of the cluster has started
  float* mine = slots + rank * L::SLOT;
  for (int d = tid; d < L::SLOT; d += CL_NT) {
    float v = m;
    if (d != D) {
      const int base = d < D ? d : KPP * D, stride = d < D ? D : 1;
      v = 0.f;
      for (int j = 0; j < KPP; ++j) v += red[base + j * stride];
    }
    if (rank == 0)
      mine[d] = v;
    else
      hp::st_cluster_f32(hp::map_rank(hp::smem_addr(mine + d), 0), v);
  }
  hp::cluster_sync();   // every slot has landed in rank 0
  if (rank != 0) return;

  // rank 0 merges the live ranks' slots 0 .. min(C, n_live) - 1 in that
  // order (none for a length-0 row: exact zeros)
  const int n_used = min(C, n_live);
  T* o = static_cast<T*>(a.out) + static_cast<long long>(bh) * D;
  for (int d = tid; d < D; d += CL_NT) {
    float mx = ds::NEG_INF;
    for (int j = 0; j < n_used; ++j) mx = fmaxf(mx, slots[j * L::SLOT + D]);
    float lsum = 0.f, acc_d = 0.f;
    for (int j = 0; j < n_used; ++j) {
      const float* sl = slots + j * L::SLOT;
      const float w = ds::ex2(sl[D] - mx);
      lsum += sl[D + 1] * w;
      acc_d += sl[d] * w;
    }
    o[d] = ds::from_float<T>(acc_d / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, typename KV, int D>
cudaError_t set_cluster_smem(size_t bytes) {
  static size_t ready = 0;   // the most this instantiation was allowed
  if (bytes <= ready) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_cluster_kernel<T, KV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) ready = bytes;
  return err;
}

template <typename T, typename KV, int D>
cudaError_t launch_cluster(const DecodeArgs& a, int cluster,
                           cudaStream_t stream) {
  const int n_pr = (a.n_pages_row + cluster - 1) / cluster;
  const size_t smem = ClLayout<KV, D>::smem(n_pr);
  cudaError_t err = set_cluster_smem<T, KV, D>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * a.B * a.H);
  cfg.blockDim = dim3(CL_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_cluster_kernel<T, KV, D>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the cluster kernel takes beyond the single one: 1-8 CTAs, D 64 or
// 128, rows of a (page, head) contiguous (slot stride == D) and every
// 16-byte chunk of a tile (and of a scale row) aligned.
template <typename KV>
bool cluster_takes(const DecodeArgs& a, int D, int cluster) {
  const long long es = sizeof(KV);
  bool ok = cluster >= 1 && cluster <= CL_MAX && (D == 64 || D == 128) &&
            a.ss == D && a.page_size % 8 == 0 && (a.sp * es) % 16 == 0 &&
            (a.sh * es) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.kp) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.vp) % 16 == 0;
  if (std::is_same<KV, int8_t>::value)
    ok = ok && (a.ssp * 2) % 16 == 0 && (a.ssh * 2) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.ks) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.vs) % 16 == 0;
  return ok;
}

template <typename T, typename KV>
cudaError_t dispatch_cluster(int D, const DecodeArgs& a, int cluster,
                             cudaStream_t stream) {
  if (!cluster_takes<KV>(a, D, cluster)) return cudaErrorInvalidValue;
  return D == 64 ? launch_cluster<T, KV, 64>(a, cluster, stream)
                 : launch_cluster<T, KV, 128>(a, cluster, stream);
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
// stride pt_sb; lengths: [B] int32; out: [B, H, D] contiguous. `cluster`
// 0 takes the single-block kernel; 1-8 the cluster kernel with that many
// CTAs a (sequence, head), for bf16 at D 64/128 with slot stride == D and
// 16-byte aligned pools and page/head strides (cudaErrorInvalidValue
// otherwise). Returns the launch's error.
extern "C" int ds_paged_decode(const void* q, long long qsb, long long qsh,
                               const void* k_pages, const void* v_pages,
                               long long sp, long long sh, long long ss,
                               const void* page_table, long long pt_sb,
                               const void* lengths, void* out, int B, int H,
                               int D, int page_size, int n_pages_row,
                               float sm_scale, int cluster, int dtype,
                               void* stream) {
  const DecodeArgs a = make_args(q, qsb, qsh, k_pages, v_pages, sp, sh, ss,
                                 page_table, pt_sb, lengths, out, B, H,
                                 page_size, n_pages_row, sm_scale);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (dtype == ds::DTYPE_BF16)
      return dispatch_cluster<__nv_bfloat16, __nv_bfloat16>(D, a, cluster,
                                                            cs);
    if (dtype == ds::DTYPE_F16)
      return dispatch_cluster<__half, __half>(D, a, cluster, cs);
    return cudaErrorInvalidValue;
  }
  if (dtype == ds::DTYPE_F32) return dispatch_d<float, float>(D, a, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, a, cs);
  if (dtype == ds::DTYPE_F16) return dispatch_d<__half, __half>(D, a, cs);
  return cudaErrorInvalidValue;
}

// The int8 pools of kv_cache_dtype "int8": k_pages/v_pages int8 as above,
// k_scales/v_scales: one layer's [P, H, page_size] bf16 scale pool
// through (page, head) strides, slot contiguous; q and out in `dtype`.
// `cluster` as above, for fp32, bf16 or fp16 q at D 64/128; the cluster
// kernel also needs 16-byte aligned scale pools and scale strides. The
// scales stay bf16 whatever q's dtype, as the JAX package makes them.
extern "C" int ds_paged_decode_int8(
    const void* q, long long qsb, long long qsh, const void* k_pages,
    const void* v_pages, long long sp, long long sh, long long ss,
    const void* k_scales, const void* v_scales, long long ssp, long long ssh,
    const void* page_table, long long pt_sb, const void* lengths, void* out,
    int B, int H, int D, int page_size, int n_pages_row, float sm_scale,
    int cluster, int dtype, void* stream) {
  DecodeArgs a = make_args(q, qsb, qsh, k_pages, v_pages, sp, sh, ss,
                           page_table, pt_sb, lengths, out, B, H, page_size,
                           n_pages_row, sm_scale);
  a.ks = static_cast<const __nv_bfloat16*>(k_scales);
  a.vs = static_cast<const __nv_bfloat16*>(v_scales);
  a.ssp = ssp;
  a.ssh = ssh;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (dtype == ds::DTYPE_F32)
      return dispatch_cluster<float, int8_t>(D, a, cluster, cs);
    if (dtype == ds::DTYPE_BF16)
      return dispatch_cluster<__nv_bfloat16, int8_t>(D, a, cluster, cs);
    if (dtype == ds::DTYPE_F16)
      return dispatch_cluster<__half, int8_t>(D, a, cluster, cs);
    return cudaErrorInvalidValue;
  }
  if (dtype == ds::DTYPE_F32) return dispatch_d<float, int8_t>(D, a, cs);
  if (dtype == ds::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16, int8_t>(D, a, cs);
  if (dtype == ds::DTYPE_F16) return dispatch_d<__half, int8_t>(D, a, cs);
  return cudaErrorInvalidValue;
}

// What the cluster kernel for bf16 q at head dim D (64 or 128) over bf16
// (int8_pool 0) or int8 (1) pools takes on this device for a page table
// of n_pages_row pages a row, into info[0..4]: registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory bytes, and
// blocks an SM can hold.
extern "C" int ds_paged_decode_info(int D, int int8_pool, int n_pages_row,
                                    int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  int blocks = 0;
  size_t bytes = 0;
  const int n_pr = (n_pages_row + CL_MAX - 1) / CL_MAX;
  auto query = [&](auto kernel, size_t smem, cudaError_t set) {
    bytes = smem;
    err = set;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          CL_NT, smem);
  };
  using bf16 = __nv_bfloat16;
  if (n_pages_row < 1) return cudaErrorInvalidValue;
  if (D == 64 && !int8_pool)
    query(paged_decode_cluster_kernel<bf16, bf16, 64>,
          ClLayout<bf16, 64>::smem(n_pr),
          set_cluster_smem<bf16, bf16, 64>(ClLayout<bf16, 64>::smem(n_pr)));
  else if (D == 128 && !int8_pool)
    query(paged_decode_cluster_kernel<bf16, bf16, 128>,
          ClLayout<bf16, 128>::smem(n_pr),
          set_cluster_smem<bf16, bf16, 128>(ClLayout<bf16, 128>::smem(n_pr)));
  else if (D == 64 && int8_pool)
    query(paged_decode_cluster_kernel<bf16, int8_t, 64>,
          ClLayout<int8_t, 64>::smem(n_pr),
          set_cluster_smem<bf16, int8_t, 64>(ClLayout<int8_t, 64>::smem(n_pr)));
  else if (D == 128 && int8_pool)
    query(paged_decode_cluster_kernel<bf16, int8_t, 128>,
          ClLayout<int8_t, 128>::smem(n_pr),
          set_cluster_smem<bf16, int8_t, 128>(
              ClLayout<int8_t, 128>::smem(n_pr)));
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(bytes);
  info[4] = blocks;
  return cudaSuccess;
}
