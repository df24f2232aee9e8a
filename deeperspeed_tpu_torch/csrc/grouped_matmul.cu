// Grouped (ragged) expert matmul for sm_90a, forward and dW.
//
// Replaces the TPU kernels of deeperspeed_tpu/ops/pallas/grouped_matmul.py:
// `_fwd_kernel` (launched by `_gmm_pallas`, also for dx against w^T) and
// `_dw_kernel` (launched by `_dw_pallas`). The buffer x [R, K] holds G =
// R / span spans of `span` rows; span g multiplies weight lut[g] and only
// its first sizes[g] rows are real:
//
//   forward  y[r] = x[r] @ w[lut[r / span]], rows at or past their span's
//            size exactly 0;
//   dW       dw[e] = sum over the spans of e of x^T @ dy on their live
//            rows, in fp32, exactly 0 for a weight with no live row.
//
// The sizes and the LUT are read from device memory by each block, so the
// grid is static and the host never waits for the routing (the TPU kernel
// gets them by scalar prefetch).
//
// Bound on the H100: at the MoE training shape (8 experts, span 2560,
// 16,384 live rows of 20,480, (K, N) = (768, 3072) or (3072, 768)) one
// pass is 77 GFLOP on about 70 MB, some 1,100 flops a byte: the tensor
// cores bound it. Design:
//
// - bf16 and fp16 forward and dx: `gmm_fwd_wgmma_kernel`, a template
//   over the element type (csrc/hopper_gemm.cuh's `wgmma` takes the
//   operand type: the descriptors and swizzles are those of any 2-byte
//   type, only the instruction's type fields change; fp16 stores its
//   output rounded to nearest, past 65504 as inf),
//   persistent: one CTA an SM walks output tiles of 128 rows of one span
//   by 256 columns. One producer thread keeps a 3-stage ring of TMA loads
//   in flight, running on into the next tile's loads while the consumers
//   store the last one: the x tile (box 128
//   rows x 64 k through ldx, 128-byte swizzle) and the weight tile of
//   lut[g] through a 3-D map [W][K][N] (forward: four [64 k][64 n] boxes,
//   the MN-major B) or [W][N][K] (dx = dy @ w^T read in place: one [256
//   n][64 k] box, the K-major B), so a tile never reads another weight's
//   rows and the K edge is zero-filled. Two consumer warpgroups run wgmma
//   m64n256k16 on each stage as it lands (fp32 accumulators in registers,
//   one group kept in flight) and release it through its empty barrier;
//   each warpgroup stages its 64 output rows in shared memory and stores
//   them as 16-byte chunks. A tile wholly past the span's size is stored
//   as zeros and issues no loads.
//   The 128-row box of a span's last tile may read the next span's rows:
//   each output row depends only on its own input row, and dead rows are
//   stored as zeros by a select, so no bits of a dead row (Inf, NaN) reach
//   a live one; stores stop at the span's end.
// - dW (bf16 and fp16): `gmm_dw_wgmma_kernel`, the same producer /
//   two-consumer ring. The contraction runs over rows, so both operands are MN-major:
//   a stage is 64 rows of x (two [64 r][64 k] boxes, warpgroup cw's 64
//   K-rows of dw each) and of dy (four [64 r][64 n] boxes), and each
//   warpgroup runs wgmma m64n256k16 with A = x^T and B = dy both
//   transposed (TA = TB = 1). A CTA owns a 128 x 256 fp32 tile of one
//   weight and walks that weight's spans in LUT order, 64 rows a stage up
//   to each span's size: one fp32 sum in registers, a fixed order, no
//   atomics. The grid is persistent; the weights are dealt out in order of
//   their live rows (most first, ranked by each CTA at its start), since
//   the routing decides the loads and the heaviest weight's tail sets the
//   time. A weight with no live row issues no loads: its tiles are stored
//   as zeros.
//   TMA reads whole 64-row boxes, so a span's last stage brings in dead
//   rows of that span (NaN, Inf) and rows of the next: the consumers
//   zero those lines of both operands in shared memory, fence them for
//   the async proxy and meet at a named barrier before the products.
//   The ring holds 4 stages of 64 rows (48 KB each): the stages are fed
//   from L2 at 85 flops a byte, so more bytes in flight pay. The epilogue
//   stages each warpgroup's 64 rows in shared memory, 32 columns at a
//   time, and stores them as 16-byte chunks of whole rows.
// - fp32 (the parity path) takes FMA tiled kernels of the same contract:
//   64 x 64 tiles, 4 x 4 outputs a thread, slices of 16 staged in shared
//   memory.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

namespace hp = ds::hopper;

using bf16 = __nv_bfloat16;

// FMA path (fp32)
constexpr int FM_NT = 256;
constexpr int FM_BM = 64;
constexpr int FM_BN = 64;
constexpr int FM_BK = 16;
constexpr int FM_PAD = 4;

__device__ __forceinline__ int live_size(const int* sizes, int g, int span) {
  return min(max(sizes[g], 0), span);
}

// wgmma forward
constexpr int GW_BM = 128;
constexpr int GW_BN = 256;
constexpr int GW_BK = 64;                       // one 128-byte bf16 line
constexpr int GW_STAGES = 3;
constexpr int GW_CONSUMERS = 256;               // two warpgroups
constexpr int GW_THREADS = 384;                 // + the producer warpgroup
constexpr int GW_A_BYTES = GW_BM * GW_BK * 2;   // x: [128 rows][64 k]
constexpr int GW_B_BYTES = GW_BK * GW_BN * 2;   // w: 4 x [64 k][64 n] or [256 n][64 k]
constexpr int GW_STAGE = GW_A_BYTES + GW_B_BYTES;
constexpr int GW_OUT_LD = GW_BN + 8;            // a staged bf16 output row
constexpr int GW_OUT_OFF = GW_STAGES * GW_STAGE;
constexpr int GW_BARS = GW_OUT_OFF + GW_BM * GW_OUT_LD * 2;
constexpr int GW_SMEM = 1024 + GW_BARS + 2 * GW_STAGES * 8;

// An output tile: a 128-row tile of span g (row0 within the span, rows
// of them in the span, live of those below its size) by 256 columns.
struct GwTile {
  int n0, g, row0, rows, live;
  long long grow0;
};

// The tiles are listed live first: the row tiles holding a live row, span
// by span, each by its n_tiles column tiles; then the wholly dead ones.
// Tile t of one list (live: the first, else the second).
__device__ __forceinline__ GwTile gw_tile(int t, bool live_list, int n_tiles,
                                          int tps, int span, int G,
                                          const int* sizes) {
  GwTile w;
  int rt = t / n_tiles;
  w.n0 = (t % n_tiles) * GW_BN;
  int size = 0, lt = 0;
  for (w.g = 0; w.g < G; ++w.g) {
    size = live_size(sizes, w.g, span);
    lt = (size + GW_BM - 1) / GW_BM;
    const int cnt = live_list ? lt : tps - lt;
    if (rt < cnt) break;
    rt -= cnt;
  }
  w.row0 = (live_list ? rt : lt + rt) * GW_BM;
  w.rows = min(GW_BM, span - w.row0);
  w.live = max(0, min(size - w.row0, w.rows));
  w.grow0 = (long long)w.g * span + w.row0;
  return w;
}

// the number of live tiles
__device__ __forceinline__ int gw_live_tiles(int n_tiles, int span, int G,
                                             const int* sizes) {
  int n = 0;
  for (int g = 0; g < G; ++g)
    n += (live_size(sizes, g, span) + GW_BM - 1) / GW_BM;
  return n * n_tiles;
}

// Forward, persistent: CTA b takes live tiles b, b + gridDim.x, ... (so
// every CTA gets as many products, whatever the sizes), then dead tiles
// the same way; the row tiles are tps a span. The producer runs ahead
// into the next tile's loads while the consumers store the last one.
// TRANS_W: wmap reads w stored [W, N, K] (the dx product); otherwise
// [W, K, N].
template <typename T, bool TRANS_W>
__global__ void __launch_bounds__(GW_THREADS, 1) gmm_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const int* __restrict__ sizes,
    const int* __restrict__ lut, T* __restrict__ y, int K, int N, int span,
    int G, int tps, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GW_BARS);
  uint64_t* empty = full + GW_STAGES;
  const int tid = threadIdx.x;
  const int k_tiles = (K + GW_BK - 1) / GW_BK;
  const int live_tiles = gw_live_tiles(n_tiles, span, G, sizes);
  if (tid == 0) {
    for (int s = 0; s < GW_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], GW_CONSUMERS);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= GW_CONSUMERS) {
    // producer warpgroup: one thread issues the loads of every live tile
    hp::setmaxnreg_dec<40>();
    if (tid == GW_CONSUMERS) {
      hp::RingPos<GW_STAGES> pos;
      for (int t = blockIdx.x; t < live_tiles; t += gridDim.x) {
        const GwTile w = gw_tile(t, true, n_tiles, tps, span, G, sizes);
        const int e = lut[w.g];
        for (int i = 0; i < k_tiles; ++i, pos.advance()) {
          if (pos.round > 0)
            hp::mbar_wait(&empty[pos.stage], pos.parity() ^ 1);
          unsigned char* st = smem + pos.stage * GW_STAGE;
          uint64_t* bar = &full[pos.stage];
          hp::mbar_arrive_expect_tx(bar, GW_STAGE);
          const int k = i * GW_BK;
          hp::tma_load_2d(st, &xmap, bar, k, static_cast<int>(w.grow0));
          if (TRANS_W) {
            hp::tma_load_3d(st + GW_A_BYTES, &wmap, bar, k, w.n0, e);
          } else {
#pragma unroll
            for (int b = 0; b < GW_BN / 64; ++b)
              hp::tma_load_3d(st + GW_A_BYTES + b * GW_BK * 128, &wmap, bar,
                              w.n0 + 64 * b, k, e);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows 64 cw .. 64 cw + 63 of each tile
  hp::setmaxnreg_inc<232>();
  const int cw = tid / 128, t = tid % 128;
  const int wi = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  T* out = reinterpret_cast<T*>(smem + GW_OUT_OFF) + cw * 64 * GW_OUT_LD;
  hp::RingPos<GW_STAGES> pos;
  for (int tile = blockIdx.x; tile < live_tiles; tile += gridDim.x) {
    const GwTile w = gw_tile(tile, true, n_tiles, tps, span, G, sizes);
    T* yt = y + w.grow0 * N;
    float acc[GW_BN / 2];
#pragma unroll
    for (int i = 0; i < GW_BN / 2; ++i) acc[i] = 0.f;
    hp::fence_operand(acc);
    int prev = -1;
    for (int i = 0; i < k_tiles; ++i, pos.advance()) {
      hp::mbar_wait(&full[pos.stage], pos.parity());
      const unsigned char* st = smem + pos.stage * GW_STAGE;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GW_BK / 16; ++kk) {
        const uint64_t da =
            hp::sw128_desc(st + cw * 64 * 128 + kk * 32, 0, 1024);
        if (TRANS_W) {
          const uint64_t db =
              hp::sw128_desc(st + GW_A_BYTES + kk * 32, 0, 1024);
          hp::wgmma<GW_BN, 0, 0, T>(acc, da, db);
        } else {
          const uint64_t db = hp::sw128_desc(st + GW_A_BYTES + kk * 2048,
                                             GW_BK * 128, 1024);
          hp::wgmma<GW_BN, 0, 1, T>(acc, da, db);
        }
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();        // the previous stage's products are done
      if (prev >= 0) hp::mbar_arrive(&empty[prev]);
      prev = pos.stage;
    }
    hp::wgmma_wait<0>();
    hp::fence_operand(acc);
    hp::mbar_arrive(&empty[prev]);

    // stage this warpgroup's 64 rows in T, rounded to nearest (dead rows as
    // zeros; fp16 past 65504 as inf), and store them as 16-byte chunks of
    // whole rows
    hp::named_bar_sync(2 + cw, 128);   // the last tile's rows are stored
#pragma unroll
    for (int j = 0; j < GW_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wi * 16 + gq + 8 * h;
        const bool dead = cw * 64 + r >= w.live;
        *reinterpret_cast<unsigned*>(out + r * GW_OUT_LD + j * 8 + 2 * tq) =
            ds::pack2<T>(dead ? 0.f : acc[4 * j + 2 * h],
                         dead ? 0.f : acc[4 * j + 2 * h + 1]);
      }
    hp::named_bar_sync(2 + cw, 128);
    for (int it = t; it < 64 * (GW_BN / 8); it += 128) {
      const int r = it / (GW_BN / 8), c = (it % (GW_BN / 8)) * 8;
      const int row = cw * 64 + r, n = w.n0 + c;
      if (row < w.rows && n < N)
        *reinterpret_cast<int4*>(yt + (long long)row * N + n) =
            *reinterpret_cast<const int4*>(out + r * GW_OUT_LD + c);
    }
  }
  // wholly dead tiles: zeros, no loads
  const int dead_tiles = (G * tps) * n_tiles - live_tiles;
  for (int tile = blockIdx.x; tile < dead_tiles; tile += gridDim.x) {
    const GwTile w = gw_tile(tile, false, n_tiles, tps, span, G, sizes);
    T* yt = y + w.grow0 * N;
    for (int it = t; it < 64 * (GW_BN / 8); it += 128) {
      const int r = cw * 64 + it / (GW_BN / 8);
      const int n = w.n0 + (it % (GW_BN / 8)) * 8;
      if (r < w.rows && n < N)
        *reinterpret_cast<int4*>(yt + (long long)r * N + n) =
            make_int4(0, 0, 0, 0);
    }
  }
}

// wgmma dW
constexpr int DW_BM = 128;                      // K rows of dw a tile
constexpr int DW_BN = 256;                      // N columns a tile
constexpr int DW_BR = 64;                       // contraction rows a stage
constexpr int DW_STAGES = 4;
constexpr int DW_BOX = DW_BR * 128;             // one [64 r][64] bf16 box
constexpr int DW_A_BYTES = 2 * DW_BOX;          // x: 2 x [64 r][64 k]
constexpr int DW_STAGE = DW_A_BYTES + 4 * DW_BOX;   // + dy: 4 x [64 r][64 n]
constexpr int DW_CHUNK = 32;                    // columns staged at a time
constexpr int DW_OUT_LD = DW_CHUNK + 8;         // a staged fp32 row
constexpr int DW_OUT_OFF = DW_STAGES * DW_STAGE;
constexpr int DW_BARS = DW_OUT_OFF + 2 * 64 * DW_OUT_LD * 4;
constexpr int DW_TABLE = DW_BARS + 2 * DW_STAGES * 8;
// the weights a launch may rank (its table: an int4 and an int a weight)
constexpr int DW_MAX_WEIGHTS = 512;

__host__ __device__ constexpr int dw_smem(int n_weights) {
  return 1024 + DW_TABLE + 20 * n_weights;
}
static_assert(dw_smem(DW_MAX_WEIGHTS) <= 232448, "the H100's shared memory");

// Each weight's spans [lo, hi) (contiguous: the LUT is non-decreasing) and
// live rows into spans[e], then order[rank] = e with the weights ranked by
// live rows, most first (ties by index). Every thread of the CTA.
__device__ __forceinline__ void dw_rank_weights(const int* sizes,
                                                const int* lut, int G,
                                                int span, int W, int4* spans,
                                                int* order) {
  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    int lo = G, hi = G, live = 0;
    for (int s = 0; s < G; ++s)
      if (lut[s] == e) {
        if (lo == G) lo = s;
        hi = s + 1;
        live += live_size(sizes, s, span);
      }
    spans[e] = make_int4(lo, hi, live, 0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    const int live = spans[e].z;
    int rank = 0;
    for (int f = 0; f < W; ++f)
      rank += spans[f].z > live || (spans[f].z == live && f < e);
    order[rank] = e;
  }
  __syncthreads();
}

// dW, persistent: tile t is (weight order[t / per_w], K tile, N tile);
// CTA b takes tiles b, b + gridDim.x, ... The producer runs ahead into
// the next tile's loads while the consumers store the last one. T: the
// element type of x and dy (bf16 or fp16); dW is fp32 either way.
template <typename T>
__global__ void __launch_bounds__(GW_THREADS, 1) gmm_dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap dymap, const int* __restrict__ sizes,
    const int* __restrict__ lut, float* __restrict__ dw, int G, int K,
    int N, int span, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_BARS);
  uint64_t* empty = full + DW_STAGES;
  int4* spans = reinterpret_cast<int4*>(smem + DW_TABLE);
  int* order = reinterpret_cast<int*>(spans + W);
  const int tid = threadIdx.x;
  const int k_tiles = (K + DW_BM - 1) / DW_BM;
  const int n_tiles = (N + DW_BN - 1) / DW_BN;
  const int per_w = k_tiles * n_tiles;
  const int tiles = W * per_w;
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], GW_CONSUMERS);
    }
    hp::mbar_fence_init();
  }
  dw_rank_weights(sizes, lut, G, span, W, spans, order);

  if (tid >= GW_CONSUMERS) {
    // producer warpgroup: one thread issues the loads of every stage
    hp::setmaxnreg_dec<40>();
    if (tid == GW_CONSUMERS) {
      hp::RingPos<DW_STAGES> pos;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int4 sp = spans[order[t / per_w]];
        const int k0 = (t % per_w) / n_tiles * DW_BM;
        const int n0 = (t % n_tiles) * DW_BN;
        for (int s = sp.x; s < sp.y; ++s) {
          const int size = live_size(sizes, s, span);
          for (int r = 0; r < size; r += DW_BR, pos.advance()) {
            if (pos.round > 0)
              hp::mbar_wait(&empty[pos.stage], pos.parity() ^ 1);
            unsigned char* st = smem + pos.stage * DW_STAGE;
            uint64_t* bar = &full[pos.stage];
            hp::mbar_arrive_expect_tx(bar, DW_STAGE);
            const int row = s * span + r;
#pragma unroll
            for (int b = 0; b < 2; ++b)
              hp::tma_load_2d(st + b * DW_BOX, &xmap, bar, k0 + 64 * b, row);
#pragma unroll
            for (int b = 0; b < 4; ++b)
              hp::tma_load_2d(st + DW_A_BYTES + b * DW_BOX, &dymap, bar,
                              n0 + 64 * b, row);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: K rows 64 cw .. 64 cw + 63 of each tile
  hp::setmaxnreg_inc<232>();
  const int cw = tid / 128, t = tid % 128;
  const int wi = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  float* out = reinterpret_cast<float*>(smem + DW_OUT_OFF) +
               cw * 64 * DW_OUT_LD;
  hp::RingPos<DW_STAGES> pos;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = order[tile / per_w];
    const int4 sp = spans[e];
    const int k0 = (tile % per_w) / n_tiles * DW_BM;
    const int n0 = (tile % n_tiles) * DW_BN;
    float acc[DW_BN / 2];
#pragma unroll
    for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
    hp::fence_operand(acc);
    int prev = -1;
    for (int s = sp.x; s < sp.y; ++s) {
      const int size = live_size(sizes, s, span);
      for (int r = 0; r < size; r += DW_BR, pos.advance()) {
        hp::mbar_wait(&full[pos.stage], pos.parity());
        unsigned char* st = smem + pos.stage * DW_STAGE;
        const int live = min(DW_BR, size - r);
        if (live < DW_BR) {
          // lines [live, 64) of all six boxes hold dead or foreign rows
          const int chunks = (DW_BR - live) * 8;
          for (int i = tid; i < 6 * chunks; i += GW_CONSUMERS) {
            const int c = i % chunks;
            *reinterpret_cast<uint4*>(st + (i / chunks) * DW_BOX +
                                      (live + c / 8) * 128 + (c % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          hp::fence_proxy_async();
          hp::named_bar_sync(1, GW_CONSUMERS);
        }
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DW_BR / 16; ++kk) {
          const uint64_t da =
              hp::sw128_desc(st + cw * DW_BOX + kk * 2048, DW_BOX, 1024);
          const uint64_t db =
              hp::sw128_desc(st + DW_A_BYTES + kk * 2048, DW_BOX, 1024);
          hp::wgmma<DW_BN, 1, 1, T>(acc, da, db);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<1>();      // the previous stage's products are done
        if (prev >= 0) hp::mbar_arrive(&empty[prev]);
        prev = pos.stage;
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_operand(acc);
    if (prev >= 0) hp::mbar_arrive(&empty[prev]);

    // this warpgroup's 64 rows, DW_CHUNK columns at a time: staged in
    // shared memory, stored as 16-byte chunks of whole rows
    float* dwe = dw + (long long)e * K * N;
    constexpr int J = DW_CHUNK / 8, V = DW_CHUNK / 4;   // n8 tiles, float4s
#pragma unroll
    for (int q = 0; q < DW_BN / DW_CHUNK; ++q) {
      hp::named_bar_sync(2 + cw, 128);   // the last chunk's rows are read
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + (wi * 16 + gq + 8 * h) * DW_OUT_LD +
                                     j * 8 + 2 * tq) =
              make_float2(acc[4 * (J * q + j) + 2 * h],
                          acc[4 * (J * q + j) + 2 * h + 1]);
      hp::named_bar_sync(2 + cw, 128);
      for (int it = t; it < 64 * V; it += 128) {
        const int r = it / V, c = (it % V) * 4;
        const int m = k0 + cw * 64 + r, n = n0 + q * DW_CHUNK + c;
        if (m < K && n < N)
          *reinterpret_cast<float4*>(dwe + (long long)m * N + n) =
              *reinterpret_cast<const float4*>(out + r * DW_OUT_LD + c);
      }
    }
  }
}

template <bool TRANS_W>
__global__ void __launch_bounds__(FM_NT) gmm_fwd_fma_kernel(
    const float* __restrict__ x, long long ldx, const float* __restrict__ w,
    const int* __restrict__ sizes, const int* __restrict__ lut,
    float* __restrict__ y, int K, int N, int span, int tps) {
  __shared__ __align__(16) float As[FM_BK][FM_BM + FM_PAD];
  __shared__ __align__(16) float Bs[FM_BK][FM_BN + FM_PAD];
  const int tid = threadIdx.x;
  const int g = blockIdx.y / tps;
  const int row0 = (blockIdx.y % tps) * FM_BM;
  const int rows = min(FM_BM, span - row0);
  const int live = max(0, min(live_size(sizes, g, span) - row0, rows));
  const long long grow0 = (long long)g * span + row0;
  const int n0 = blockIdx.x * FM_BN;
  float* yt = y + grow0 * N;
  if (live == 0) {
    for (int i = tid; i < rows * FM_BN; i += FM_NT) {
      const int r = i / FM_BN, n = n0 + i % FM_BN;
      if (n < N) yt[(long long)r * N + n] = 0.f;
    }
    return;
  }
  const float* xt = x + grow0 * ldx;
  const float* we = w + (long long)lut[g] * K * N;
  const int tx = tid % (FM_BN / 4), ty = tid / (FM_BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FM_BK) {
    for (int i = tid; i < FM_BM * FM_BK; i += FM_NT) {
      const int r = i / FM_BK, c = i % FM_BK;
      As[c][r] = (r < live && k0 + c < K) ? xt[(long long)r * ldx + k0 + c]
                                          : 0.f;
    }
    for (int i = tid; i < FM_BK * FM_BN; i += FM_NT) {
      if (!TRANS_W) {
        const int kk = i / FM_BN, n = i % FM_BN;
        Bs[kk][n] = (k0 + kk < K && n0 + n < N)
                        ? we[(long long)(k0 + kk) * N + n0 + n] : 0.f;
      } else {
        const int n = i / FM_BK, kk = i % FM_BK;
        Bs[kk][n] = (k0 + kk < K && n0 + n < N)
                        ? we[(long long)(n0 + n) * K + k0 + kk] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FM_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) yt[(long long)r * N + n] = r < live ? acc[i][j] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(FM_NT) gmm_dw_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const int* __restrict__ sizes, const int* __restrict__ lut,
    float* __restrict__ dw, int G, int K, int N, int span) {
  __shared__ __align__(16) float As[FM_BK][FM_BM + FM_PAD];
  __shared__ __align__(16) float Bs[FM_BK][FM_BN + FM_PAD];
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * FM_BM;
  const int n0 = blockIdx.x * FM_BN;
  const int tx = tid % (FM_BN / 4), ty = tid / (FM_BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < G; ++s) {
    if (lut[s] != e) continue;
    const int size = live_size(sizes, s, span);
    const long long base = (long long)s * span;
    for (int r0 = 0; r0 < size; r0 += FM_BK) {
      for (int i = tid; i < FM_BK * FM_BM; i += FM_NT) {
        const int kk = i / FM_BM, m = i % FM_BM;
        As[kk][m] = (r0 + kk < size && m0 + m < K)
                        ? x[(base + r0 + kk) * K + m0 + m] : 0.f;
      }
      for (int i = tid; i < FM_BK * FM_BN; i += FM_NT) {
        const int kk = i / FM_BN, n = i % FM_BN;
        Bs[kk][n] = (r0 + kk < size && n0 + n < N)
                        ? dy[(base + r0 + kk) * N + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FM_BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* dwe = dw + (long long)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= K) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dwe[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

// the SMs of the current device (the persistent grids' size), read once
cudaError_t sm_count(int* out) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = sms;
  return cudaSuccess;
}

// the tensor maps' element type of T
template <typename T>
constexpr CUtensorMapDataType map_dtype() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// the 16-bit forward: x [R, K] through ldx and the weight as a 3-D map
// (innermost first: [N, K, W], or [K, N, W] when w is stored [W, N, K])
template <typename T, bool TRANS_W>
cudaError_t launch_fwd_wgmma(const T* x, long long ldx, const T* w,
                             const int* sizes, const int* lut, T* y, int R,
                             int K, int N, int W, int span,
                             cudaStream_t stream) {
  CUtensorMap xm, wm;
  const uint64_t xd[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(R)};
  const uint64_t xs[1] = {static_cast<uint64_t>(ldx) * 2};
  const uint32_t xb[2] = {GW_BK, GW_BM};
  cudaError_t err = hp::tensor_map(&xm, x, map_dtype<T>(), 2, xd, xs, xb,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t inner = TRANS_W ? K : N, outer = TRANS_W ? N : K;
  const uint64_t wd[3] = {inner, outer, static_cast<uint64_t>(W)};
  const uint64_t ws[2] = {inner * 2, inner * outer * 2};
  const uint32_t wb[3] = {64, static_cast<uint32_t>(TRANS_W ? GW_BN : GW_BK),
                          1};
  err = hp::tensor_map(&wm, w, map_dtype<T>(), 3, wd, ws, wb,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  static bool ready = false;
  err = allow_smem(gmm_fwd_wgmma_kernel<T, TRANS_W>, GW_SMEM, &ready);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int tps = (span + GW_BM - 1) / GW_BM;
  const int n_tiles = (N + GW_BN - 1) / GW_BN;
  const int G = R / span;
  gmm_fwd_wgmma_kernel<T, TRANS_W><<<min(G * tps * n_tiles, sms),
                                     GW_THREADS, GW_SMEM, stream>>>(
      xm, wm, sizes, lut, y, K, N, span, G, tps, n_tiles);
  return cudaGetLastError();
}

// room for the dW kernel's table of the most weights a launch may rank
template <typename T>
cudaError_t allow_dw_smem() {
  static bool ready = false;
  return allow_smem(gmm_dw_wgmma_kernel<T>, dw_smem(DW_MAX_WEIGHTS), &ready);
}

// the 16-bit dW: x [R, K] and dy [R, N] contiguous, each read as
// [64 r][64] boxes
template <typename T>
cudaError_t launch_dw_wgmma(const T* x, const T* dy, const int* sizes,
                            const int* lut, float* dw, int R, int K, int N,
                            int span, int W, cudaStream_t stream) {
  CUtensorMap xm, dym;
  const uint64_t xd[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(R)};
  const uint64_t xs[1] = {static_cast<uint64_t>(K) * 2};
  const uint64_t dd[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(R)};
  const uint64_t dys[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t box[2] = {64, DW_BR};
  cudaError_t err = hp::tensor_map(&xm, x, map_dtype<T>(), 2, xd, xs, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hp::tensor_map(&dym, dy, map_dtype<T>(), 2, dd, dys, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if ((err = allow_dw_smem<T>()) != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int tiles = W * ((K + DW_BM - 1) / DW_BM) * ((N + DW_BN - 1) / DW_BN);
  gmm_dw_wgmma_kernel<T><<<min(tiles, sms), GW_THREADS, dw_smem(W), stream>>>(
      xm, dym, sizes, lut, dw, R / span, K, N, span, W);
  return cudaGetLastError();
}

}  // namespace

// y [R, N] = the grouped product of x [R, K] (rows through ldx, K
// contiguous) with w: [W, K, N] contiguous, or with w_transposed = 1 the
// [W, N, K] tensor read as its transpose (dx = dy @ w^T). sizes [G] and
// lut [G] are int32 on the device, G = R / span. bf16 (dtype 1) needs K % 8
// == 0, N % 8 == 0, ldx % 8 == 0 and 16-byte aligned x, w and y; fp32
// (dtype 0) takes any shape. Returns cudaGetLastError() after the launch.
extern "C" int ds_grouped_matmul(const void* x, long long ldx, const void* w,
                                 int w_transposed, const void* sizes,
                                 const void* lut, void* y, int R, int K,
                                 int N, int W, int span, int dtype,
                                 void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (R <= 0 || K <= 0 || N <= 0 || W <= 0 || span <= 0 || R % span)
    return cudaErrorInvalidValue;
  const int G = R / span;
  const int* sz = static_cast<const int*>(sizes);
  const int* lt = static_cast<const int*>(lut);
  if (dtype == ds::DTYPE_F32) {
    const int tps = (span + FM_BM - 1) / FM_BM;
    const dim3 grid((N + FM_BN - 1) / FM_BN, G * tps);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    if (w_transposed)
      gmm_fwd_fma_kernel<true><<<grid, FM_NT, 0, cs>>>(xf, ldx, wf, sz, lt, yf,
                                                       K, N, span, tps);
    else
      gmm_fwd_fma_kernel<false><<<grid, FM_NT, 0, cs>>>(xf, ldx, wf, sz, lt,
                                                        yf, K, N, span, tps);
    return cudaGetLastError();
  }
  if (dtype != ds::DTYPE_BF16 && dtype != ds::DTYPE_F16)
    return cudaErrorInvalidValue;
  if (K % 8 || N % 8 || ldx % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  if (dtype == ds::DTYPE_F16) {
    const __half* xh = static_cast<const __half*>(x);
    const __half* wh = static_cast<const __half*>(w);
    __half* yh = static_cast<__half*>(y);
    if (w_transposed)
      return launch_fwd_wgmma<__half, true>(xh, ldx, wh, sz, lt, yh, R, K, N,
                                            W, span, cs);
    return launch_fwd_wgmma<__half, false>(xh, ldx, wh, sz, lt, yh, R, K, N,
                                           W, span, cs);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  if (w_transposed)
    return launch_fwd_wgmma<bf16, true>(xb, ldx, wb, sz, lt, yb, R, K, N, W,
                                        span, cs);
  return launch_fwd_wgmma<bf16, false>(xb, ldx, wb, sz, lt, yb, R, K, N, W,
                                       span, cs);
}

// dw [n_weights, K, N] fp32 = for each weight e, the sum over the spans s
// with lut[s] == e of x[s]^T @ dy[s] on the first sizes[s] rows; x [R, K]
// and dy [R, N] contiguous, in the dtype `dtype` says. Every element of dw
// is written. bf16 needs K % 8 == 0, N % 8 == 0, 16-byte aligned x, dy and
// dw and at most 512 weights. Returns cudaGetLastError() after the launch.
extern "C" int ds_grouped_matmul_dw(const void* x, const void* dy,
                                    const void* sizes, const void* lut,
                                    void* dw, int R, int K, int N, int span,
                                    int n_weights, int dtype, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (R <= 0 || K <= 0 || N <= 0 || span <= 0 || R % span || n_weights <= 0)
    return cudaErrorInvalidValue;
  const int G = R / span;
  const int* sz = static_cast<const int*>(sizes);
  const int* lt = static_cast<const int*>(lut);
  float* dwf = static_cast<float*>(dw);
  if (dtype == ds::DTYPE_F32) {
    const dim3 grid((N + FM_BN - 1) / FM_BN, (K + FM_BM - 1) / FM_BM,
                    n_weights);
    gmm_dw_fma_kernel<<<grid, FM_NT, 0, cs>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), sz, lt,
        dwf, G, K, N, span);
    return cudaGetLastError();
  }
  if (dtype != ds::DTYPE_BF16 && dtype != ds::DTYPE_F16)
    return cudaErrorInvalidValue;
  if (K % 8 || N % 8 || n_weights > DW_MAX_WEIGHTS ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 16)
    return cudaErrorInvalidValue;
  if (dtype == ds::DTYPE_F16)
    return launch_dw_wgmma(static_cast<const __half*>(x),
                           static_cast<const __half*>(dy), sz, lt, dwf, R, K,
                           N, span, n_weights, cs);
  return launch_dw_wgmma(static_cast<const bf16*>(x),
                         static_cast<const bf16*>(dy), sz, lt, dwf, R, K, N,
                         span, n_weights, cs);
}

// What the bf16 dW kernel takes on this device for n_weights weights, into
// info[0..4]: registers a thread at launch, local (spill) bytes a thread,
// static and dynamic shared memory bytes, and CTAs an SM can hold.
extern "C" int ds_grouped_matmul_dw_info(int n_weights, int* info) {
  if (n_weights <= 0 || n_weights > DW_MAX_WEIGHTS)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dw_smem<bf16>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, gmm_dw_wgmma_kernel<bf16>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gmm_dw_wgmma_kernel<bf16>, GW_THREADS, dw_smem(n_weights));
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = dw_smem(n_weights);
  info[4] = blocks;
  return cudaSuccess;
}
