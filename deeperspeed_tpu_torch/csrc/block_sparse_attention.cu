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
// causal) the live pairs number about 5.8e8, so the forward's 4·D flops
// a pair take 0.15 ms at the bf16 tensor-core peak while q, k, v, out
// cross device memory in about 0.06 ms: operations bound, and the dq
// (6·D) and dk/dv (8·D) more so. What the kernels can reach is the flash
// kernels' tile rate on the live tiles only, so each walks a compact
// per-row LUT and runs the flash kernels' tensor-core tile step.
//
// Design (bf16 and fp16 at D = 64 and 128, one template over the 16-bit
// type T; the C dispatch picks it at compile time through `takes_mma`, as
// the flash kernels do; fp32, which the fp32 parity runs take, and D =
// 256, whose accumulators would spill, keep the FMA tile steps of
// attention_tiles.cuh, bound by FMA throughput):
//
// - The TPU kernels group `group_q` row blocks and fan out over `fanout`
//   key blocks to feed the MXU fat strips (`build_row_union_lut`, with
//   activity bits for the rows the union drags in). That is not carried
//   over: a block here walks a compact per-row LUT of the active
//   128-column blocks (built on the host by `ops/hopper/
//   block_sparse_attention.build_lut`), so no work is spent on rows or
//   columns the layout leaves out.
// - Forward (`block_sparse_fwd_mma_kernel`) and dQ
//   (`block_sparse_dq_mma_kernel`): one block of 4 warps per (b·h, 64-row
//   q tile), each warp 16 q rows, walking the forward LUT; dK/dV
//   (`block_sparse_dkv_mma_kernel`): one block per (b·h, 64-key tile),
//   each warp 16 keys, walking the TRANSPOSED layout's LUT (every query
//   block that attends its key block; global columns list most of the
//   sequence). The block's LUT row is copied to shared memory first, and
//   tile i of the walk is the (i % 2)-th 64-row half of block i / 2; the
//   next tile's address is resolved before the current tile's products.
// - The block's own side stays on chip (Q as mma A fragments in the
//   forward; Q and dO as fragments at D = 64, in shared memory at D = 128
//   in the dQ; K and V in shared memory in the dK/dV) while the other
//   side's tiles stream through a 2-stage cp.async ring of 16-bit tiles,
//   rows padded by 16 bytes for conflict-free ldmatrix.
// - Every product is mma.sync m16n8k16 with fp32 accumulators
//   (attention_mma.cuh; `.bf16.bf16` or `.f16.f16` by T). The forward
//   runs the base-2 online softmax of `flash_fwd_mma_kernel` and keeps P,
//   rounded to T as the Pallas kernel rounds it to v's dtype, in
//   registers as the A operand of P·V. The backward recomputes P from the
//   lse and forms dS = P∘(dP − Δ)·scale in registers, rounded to T (the
//   Pallas kernel's `ds.astype(k.dtype)`) as the A operand of dQ += dS·K
//   (and Pᵀ, dSᵀ of dV += Pᵀ·dO, dK += dSᵀ·Q). Every rounding to fp16 is
//   to nearest, past 65504 to inf: a loss-scaled dS, dQ, dK or dV that
//   overflows shows as inf, which the loss scaler's finite check sees.
// - Under `causal`, a key tile wholly after the q tile (and, for dK/dV, a
//   q tile wholly before the key tile) is skipped tile by tile before any
//   load, so no kernel of this design relies on the LUT's order; the
//   element mask runs only on tiles that cross the diagonal. (The FMA
//   forward and dQ stop at the first such tile, which is right because
//   `build_lut` lists columns in ascending order.)
// - A row with no live key gives zero output, lse = +1e30 and zero
//   gradients. No atomics: every output element is one fp32 sum in a
//   fixed order, so two calls are bit-identical.
// - The LUTs list row blocks in `order` (the longest rows first), so the
//   blocks with the most tiles start first and the short ones fill in
//   behind them.
// - Tiles and layout: S is a multiple of 128; a 64-row tile (32 at D =
//   256 in the FMA kernels) lies inside one 128 x 128 block.
#include "attention_mma.cuh"
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

// ---------------------------------------------------------------------------
// the tensor-core kernels (bf16 and fp16, D = 64 and 128)
// ---------------------------------------------------------------------------

namespace mm = ds::mma_attn;

constexpr int SUB_MMA = GRAIN / mm::BN;  // 64-row tiles a layout block
static_assert(mm::BM == mm::BN, "q and key tiles share one 64-row grain");

// bytes of dynamic shared memory: `tiles` 16-bit 64-row tiles, `rows`
// fp32 rows of 64 (the dK/dV ring's lse and delta) and the block's LUT row
template <int D>
__host__ __device__ constexpr size_t mma_smem(int tiles, int rows,
                                              int max_active) {
  return tiles * mm::tile_elems<D>() * sizeof(mm::bf16) +
         rows * mm::BN * sizeof(float) + ((max_active + 3) / 4) * 16;
}

// the forward: Q and the 2-stage K / V ring; dQ: Q, dO and the ring;
// dK/dV: K, V and the 2-stage Q / dO ring with its lse and delta rows
template <int D>
__host__ __device__ constexpr size_t fwd_mma_smem(int max_active) {
  return mma_smem<D>(5, 0, max_active);
}
template <int D>
__host__ __device__ constexpr size_t dq_mma_smem(int max_active) {
  return mma_smem<D>(6, 0, max_active);
}
template <int D>
__host__ __device__ constexpr size_t dkv_mma_smem(int max_active) {
  return mma_smem<D>(6, 4, max_active);
}

// The tile step of `flash_fwd_mma_kernel` (csrc/flash_fwd.cu) without its
// segment, key-bias and dropout branches, over the forward LUT: one block
// of 4 warps per (b·h, 64-row q tile), each warp 16 q rows held as A
// fragments; the key tiles of the row block's active column blocks
// stream through a 2-stage cp.async ring, the next tile's address
// resolved from the LUT row in shared memory before the current tile's
// products. S = Q·Kᵀ by mma.sync, the element mask only on tiles that
// cross the diagonal, the base-2 online softmax over each row's lane
// quad, P rounded to T in registers as the A operand of O += P·V.
template <typename T, int D>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    block_sparse_fwd_mma_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, Lut lut,
                                T* __restrict__ out,
                                float* __restrict__ lse, int S, int H,
                                Strides st, float sm_scale, int causal) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TILE;      // [2][64][LD]
  T* Vs = Ks + 2 * TILE;  // [2][64][LD]
  int* blocks = reinterpret_cast<int*>(Vs + 2 * TILE);  // the LUT row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int nb = S / GRAIN;
  const int rb = lut.order[blockIdx.x / SUB_MMA];
  const int q0 = rb * GRAIN + (blockIdx.x % SUB_MMA) * mm::BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const float scale2 = sm_scale * mm::LOG2E;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int n_blocks = lut.count(h, nb, rb);
  const int n_tiles = SUB_MMA * n_blocks;
  const int* row = lut.row(h, nb, rb);
  for (int i = tid; i < n_blocks; i += mm::NTM) blocks[i] = row[i];
  __syncthreads();
  auto k_start = [&](int i) {
    return blocks[i / SUB_MMA] * GRAIN + (i % SUB_MMA) * mm::BN;
  };
  // the next tile from i on that holds a live pair: with causal, a key
  // tile wholly after the q tile is skipped (uniform over the block)
  auto next_tile = [&](int i) {
    while (i < n_tiles && causal && k_start(i) > q0 + mm::BM - 1) ++i;
    return i;
  };
  auto load_kv = [&](int i, int stage) {
    const int k0 = k_start(i);
    mm::load_tile<D>(Ks + stage * TILE, kb, st.kss, k0, S);
    mm::load_tile<D>(Vs + stage * TILE, vb, st.vss, k0, S);
  };

  mm::load_tile<D>(Qs, qb, st.qss, q0, S);
  int i = next_tile(0);
  if (i < n_tiles) load_kv(i, 0);
  ds::cp_async_commit();
  ds::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mm::a_frag<D>(qf[kk], Qs, warp * 16, kk);

  float o[D / 8][4];
  mm::zero(o);
  // running max (base 2) and this lane's part of the row sums
  float m_i[2] = {ds::NEG_INF, ds::NEG_INF}, l_i[2] = {0.f, 0.f};
  int stage = 0;
  while (i < n_tiles) {
    const int nxt = next_tile(i + 1);
    if (nxt < n_tiles) load_kv(nxt, stage ^ 1);  // overlaps this tile
    ds::cp_async_commit();
    const int k0 = k_start(i);
    float s[8][4];
    mm::zero(s);
    mm::mma_abt<KS, 64>(s, mm::RegA<KS>{qf}, Ks + stage * TILE, LD);

    // scale and the causal mask at each accumulator's (row, key); a tile
    // wholly below the warp's diagonal needs no mask
    const bool masked = causal && k0 + mm::BN - 1 > q0 + warp * 16;
    float mx[2] = {ds::NEG_INF, ds::NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * qd + c;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sc = s[j][2 * r + c] * scale2;
          if (masked && key > rows[r]) sc = ds::NEG_INF;
          s[j][2 * r + c] = sc;
          mx[r] = fmaxf(mx[r], sc);
        }
      }
    }
    // online softmax over the lane quad that shares each row; a masked
    // score (-1e30) gets p = 0 exactly, so a row with no live key keeps
    // l = 0
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_i[r], mx[r]);
      const float alpha = ds::ex2(m_i[r] - m_new[r]);
      m_i[r] = m_new[r];
      l_i[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float sv = s[j][e];
        const float p =
            sv <= 0.5f * ds::NEG_INF ? 0.f : ds::ex2(sv - m_new[r]);
        l_i[r] += p;
        s[j][e] = p;
      }
    }
    unsigned pa[4][4];
    mm::pack_a<4, T>(pa, s);
    mm::mma_ab<4, D>(o, pa, Vs + stage * TILE, LD);
    ds::cp_async_wait<0>();  // tile nxt landed
    __syncthreads();         // ... for every warp, and this stage is free
    stage ^= 1;
    i = nxt;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);
    if (qd == 0 && rows[r] < S)
      lse[(long long)bh * S + rows[r]] =
          l == 0.f ? -ds::NEG_INF : m_i[r] * mm::LN2 + logf(l);
  }
  mm::store_rows<D>(out + ((long long)b * S * H + h) * D, (long long)H * D,
                    o, rows, S, inv);
}

// The tile step of `flash_bwd_dkv_mma_kernel` (csrc/flash_bwd.cu) over the
// transposed LUT: one block of 4 warps per (b·h, 64-key tile), each warp
// 16 keys; K and V stay in shared memory while the Q and dO tiles of the
// query blocks that attend the key block stream through a 2-stage
// cp.async ring with their lse and delta rows. The LUT row is copied to
// shared memory first, so the next tile's rows are found without a
// global load. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by mma.sync; Pᵀ and dSᵀ stay in
// registers as the A operands of dV += Pᵀ·dO and dK += dSᵀ·Q. A tile is
// taken in slices of W q rows (16 at D = 64, 32 at D = 128) to keep the
// registers of three (two) blocks an SM.
template <typename T, int D>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    block_sparse_dkv_mma_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        Lut lut_t, T* __restrict__ dk, T* __restrict__ dv,
        int S, int H, Strides st, float sm_scale, int causal) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  constexpr int W = D == 64 ? 16 : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* Qs = Vs + TILE;       // [2][64][LD]
  T* dOs = Qs + 2 * TILE;  // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][64]
  float* dl_s = lse_s + 2 * mm::BN;                          // [2][64]
  int* blocks = reinterpret_cast<int*>(dl_s + 2 * mm::BN);   // the LUT row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int nb = S / GRAIN;
  const int cb = lut_t.order[blockIdx.x / SUB_MMA];  // key block
  const int k0 = cb * GRAIN + (blockIdx.x % SUB_MMA) * mm::BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  const float scale2 = sm_scale * mm::LOG2E;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // the q tiles: tile i is the (i % 2)-th 64 rows of query block
  // blocks[i / 2]
  const int n_blocks = lut_t.count(h, nb, cb);
  const int n_tiles = SUB_MMA * n_blocks;
  const int* row = lut_t.row(h, nb, cb);
  for (int i = tid; i < n_blocks; i += mm::NTM) blocks[i] = row[i];
  __syncthreads();
  auto q_start = [&](int i) {
    return blocks[i / SUB_MMA] * GRAIN + (i % SUB_MMA) * mm::BN;
  };
  // the next tile from i on that holds a live pair: with causal, a q tile
  // wholly before the keys is skipped (uniform over the block)
  auto next_tile = [&](int i) {
    while (i < n_tiles && causal && q_start(i) + mm::BN - 1 < k0) ++i;
    return i;
  };
  auto load_q_side = [&](int i, int stage) {
    const int q0 = q_start(i);
    mm::load_tile<D>(Qs + stage * TILE, qb, st.qss, q0, S);
    mm::load_tile<D>(dOs + stage * TILE, db, (long long)H * D, q0, S);
    mm::load_vec(lse_s + stage * mm::BN, lse_bh, q0, S, 0);
    mm::load_vec(dl_s + stage * mm::BN, delta_bh, q0, S, mm::BN);
  };

  mm::load_tile<D>(Ks, kb, st.kss, k0, S);
  mm::load_tile<D>(Vs, vb, st.vss, k0, S);
  int i = next_tile(0);
  if (i < n_tiles) load_q_side(i, 0);
  ds::cp_async_commit();
  ds::cp_async_wait<0>();
  __syncthreads();

  float acc_k[D / 8][4], acc_v[D / 8][4];
  mm::zero(acc_k);
  mm::zero(acc_v);
  int stage = 0;
  while (i < n_tiles) {
    const int nxt = next_tile(i + 1);
    if (nxt < n_tiles) load_q_side(nxt, stage ^ 1);  // overlaps this tile
    ds::cp_async_commit();
    const int q0 = q_start(i);
    const T* Qt = Qs + stage * TILE;
    const T* dOt = dOs + stage * TILE;
    const float* lse_t = lse_s + stage * mm::BN;
    const float* dl_t = dl_s + stage * mm::BN;
    const bool masked = causal && k0 + warp * 16 + 15 > q0;
#pragma unroll 1  // one slice's registers at a time
    for (int c0 = 0; c0 < mm::BN; c0 += W) {
      float s[W / 8][4], dp[W / 8][4];
      mm::zero(s);
      mm::zero(dp);
      mm::mma_abt<KS, W>(s, mm::SmemA<D, T>{Ks, warp * 16}, Qt + c0 * LD,
                         LD);
      mm::mma_abt<KS, W>(dp, mm::SmemA<D, T>{Vs, warp * 16}, dOt + c0 * LD,
                         LD);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * j + 2 * qd + c, qrow = q0 + col;
          const float nlse2 = -lse_t[col] * mm::LOG2E, dl = dl_t[col];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            mm::p_and_ds<false>(s[j][2 * r + c], dp[j][2 * r + c],
                                !masked || keys[r] <= qrow, scale2, nlse2,
                                dl, sm_scale, 0u, qrow, keys[r], 0, 1.f);
        }
      }
      unsigned pa[W / 16][4], da[W / 16][4];
      mm::pack_a<W / 16, T>(pa, s);
      mm::pack_a<W / 16, T>(da, dp);
      mm::mma_ab<W / 16, D>(acc_v, pa, dOt + c0 * LD, LD);
      mm::mma_ab<W / 16, D>(acc_k, da, Qt + c0 * LD, LD);
    }
    ds::cp_async_wait<0>();  // tile nxt landed
    __syncthreads();         // ... for every warp, and this stage is free
    stage ^= 1;
    i = nxt;
  }
  const float one[2] = {1.f, 1.f};
  const long long off = ((long long)b * S * H + h) * D;
  mm::store_rows<D>(dk + off, (long long)H * D, acc_k, keys, S, one);
  mm::store_rows<D>(dv + off, (long long)H * D, acc_v, keys, S, one);
}

// The tile step of `flash_bwd_dq_mma_kernel` (csrc/flash_bwd.cu) without
// its segment, key-bias and dropout branches, over the forward LUT: one
// block of 4 warps per (b·h, 64-row q tile), each warp 16 q rows; Q and
// dO are A fragments in registers at D = 64 and read from shared memory
// at each step at D = 128 (to stay within the registers of two blocks an
// SM); the two rows' −lse·log2 e and delta stay in registers; the K / V
// tiles of the row block's active column blocks stream through a 2-stage
// cp.async ring, the LUT row in shared memory. S and dP by mma.sync, a
// tile taken in two halves of 32 keys; dS = P∘(dP − delta)·scale rounded
// to T in registers as the A operand of dQ += dS·K.
template <typename T, int D>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    block_sparse_dq_mma_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        Lut lut, T* __restrict__ dq, int S, int H, Strides st,
        float sm_scale, int causal) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  constexpr bool A_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE;
  T* Ks = dOs + TILE;     // [2][64][LD]
  T* Vs = Ks + 2 * TILE;  // [2][64][LD]
  int* blocks = reinterpret_cast<int*>(Vs + 2 * TILE);  // the LUT row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int nb = S / GRAIN;
  const int rb = lut.order[blockIdx.x / SUB_MMA];
  const int q0 = rb * GRAIN + (blockIdx.x % SUB_MMA) * mm::BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;
  const T* db = dout + ((long long)b * S * H + h) * D;
  const float scale2 = sm_scale * mm::LOG2E;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float nlse2[2], delta_r[2];  // −lse·log2 e and delta of the two rows
  for (int r = 0; r < 2; ++r) {
    nlse2[r] = -lse[(long long)bh * S + rows[r]] * mm::LOG2E;
    delta_r[r] = delta[(long long)bh * S + rows[r]];
  }

  const int n_blocks = lut.count(h, nb, rb);
  const int n_tiles = SUB_MMA * n_blocks;
  const int* row = lut.row(h, nb, rb);
  for (int i = tid; i < n_blocks; i += mm::NTM) blocks[i] = row[i];
  __syncthreads();
  auto k_start = [&](int i) {
    return blocks[i / SUB_MMA] * GRAIN + (i % SUB_MMA) * mm::BN;
  };
  // as the forward's: a key tile wholly after the q tile is skipped
  auto next_tile = [&](int i) {
    while (i < n_tiles && causal && k_start(i) > q0 + mm::BM - 1) ++i;
    return i;
  };
  auto load_kv = [&](int i, int stage) {
    const int k0 = k_start(i);
    mm::load_tile<D>(Ks + stage * TILE, kb, st.kss, k0, S);
    mm::load_tile<D>(Vs + stage * TILE, vb, st.vss, k0, S);
  };

  mm::load_tile<D>(Qs, qb, st.qss, q0, S);
  mm::load_tile<D>(dOs, db, (long long)H * D, q0, S);
  int i = next_tile(0);
  if (i < n_tiles) load_kv(i, 0);
  ds::cp_async_commit();
  ds::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[A_REGS ? KS : 1][4], df[A_REGS ? KS : 1][4];
  if constexpr (A_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mm::a_frag<D>(qf[kk], Qs, warp * 16, kk);
      mm::a_frag<D>(df[kk], dOs, warp * 16, kk);
    }
  }

  float acc[D / 8][4];
  mm::zero(acc);
  int stage = 0;
  while (i < n_tiles) {
    const int nxt = next_tile(i + 1);
    if (nxt < n_tiles) load_kv(nxt, stage ^ 1);  // overlaps this tile
    ds::cp_async_commit();
    const int k0 = k_start(i);
    const T* Kt = Ks + stage * TILE;
    const T* Vt = Vs + stage * TILE;
    const bool masked = causal && k0 + mm::BN - 1 > q0 + warp * 16;
#pragma unroll 1  // one half's registers at a time
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      float s[4][4], dp[4][4];
      mm::zero(s);
      mm::zero(dp);
      if constexpr (A_REGS) {
        mm::mma_abt<KS, 32>(s, mm::RegA<KS>{qf}, Kt + c0 * LD, LD);
        mm::mma_abt<KS, 32>(dp, mm::RegA<KS>{df}, Vt + c0 * LD, LD);
      } else {
        mm::mma_abt<KS, 32>(s, mm::SmemA<D, T>{Qs, warp * 16},
                            Kt + c0 * LD, LD);
        mm::mma_abt<KS, 32>(dp, mm::SmemA<D, T>{dOs, warp * 16},
                            Vt + c0 * LD, LD);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + c0 + 8 * j + 2 * qd + c;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            mm::p_and_ds<false>(s[j][2 * r + c], dp[j][2 * r + c],
                                !masked || key <= rows[r], scale2, nlse2[r],
                                delta_r[r], sm_scale, 0u, rows[r], key, 0,
                                1.f);
        }
      }
      unsigned da[2][4];
      mm::pack_a<2, T>(da, dp);
      mm::mma_ab<2, D>(acc, da, Kt + c0 * LD, LD);
    }
    ds::cp_async_wait<0>();  // tile nxt landed
    __syncthreads();         // ... for every warp, and this stage is free
    stage ^= 1;
    i = nxt;
  }
  const float one[2] = {1.f, 1.f};
  mm::store_rows<D>(dq + ((long long)b * S * H + h) * D, (long long)H * D,
                    acc, rows, S, one);
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
    if constexpr (mm::takes_mma<T, D>()) {
      auto kernel = block_sparse_fwd_mma_kernel<T, D>;
      const size_t bytes = fwd_mma_smem<D>(a.lut.max_active);
      if ((err = set_smem(kernel, bytes)) != cudaSuccess) return err;
      kernel<<<dim3(a.S / mm::BM, a.B * a.H), mm::NTM, bytes, a.stream>>>(
          tq, tk, tv, a.lut, static_cast<T*>(a.o1), static_cast<float*>(a.o2),
          a.S, a.H, a.st, a.sm_scale, a.causal);
      return cudaGetLastError();
    }
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
    if constexpr (mm::takes_mma<T, D>()) {
      auto kernel = block_sparse_dkv_mma_kernel<T, D>;
      const size_t bytes = dkv_mma_smem<D>(a.lut.max_active);
      if ((err = set_smem(kernel, bytes)) != cudaSuccess) return err;
      kernel<<<dim3(a.S / mm::BM, a.B * a.H), mm::NTM, bytes, a.stream>>>(
          tq, tk, tv, td, a.lse_in, a.delta, a.lut, static_cast<T*>(a.o1),
          static_cast<T*>(a.o2), a.S, a.H, a.st, a.sm_scale, a.causal);
      return cudaGetLastError();
    }
    auto kernel = block_sparse_dkv_kernel<T, D>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, NT, smem, a.stream>>>(
        tq, tk, tv, td, a.lse_in, a.delta, a.lut, static_cast<T*>(a.o1),
        static_cast<T*>(a.o2), a.S, a.H, a.st, a.sm_scale, a.causal);
  } else {
    if constexpr (mm::takes_mma<T, D>()) {
      auto kernel = block_sparse_dq_mma_kernel<T, D>;
      const size_t bytes = dq_mma_smem<D>(a.lut.max_active);
      if ((err = set_smem(kernel, bytes)) != cudaSuccess) return err;
      kernel<<<dim3(a.S / mm::BM, a.B * a.H), mm::NTM, bytes, a.stream>>>(
          tq, tk, tv, td, a.lse_in, a.delta, a.lut, static_cast<T*>(a.o1),
          a.S, a.H, a.st, a.sm_scale, a.causal);
      return cudaGetLastError();
    }
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
  if (dtype == ds::DTYPE_F16) return dispatch_d<__half>(D, part, a);
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

// What the bf16 tensor-core kernel of `part` (0 the forward, 1 dK/dV, 2
// dQ) at head dim D (64 or 128) takes on this device for a LUT of
// max_active entries a row (the transposed layout's for dK/dV), into
// info[0..4]: registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes, and blocks an SM can hold.
extern "C" int ds_block_sparse_info(int part, int D, int max_active,
                                    int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  int blocks = 0;
  size_t bytes = 0;
  auto query = [&](auto kernel, size_t smem) {
    bytes = smem;
    err = set_smem(kernel, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          mm::NTM, smem);
  };
  auto query_d = [&](auto d) {
    constexpr int DD = decltype(d)::value;
    if (part == 0)
      query(block_sparse_fwd_mma_kernel<mm::bf16, DD>,
            fwd_mma_smem<DD>(max_active));
    else if (part == 1)
      query(block_sparse_dkv_mma_kernel<mm::bf16, DD>,
            dkv_mma_smem<DD>(max_active));
    else if (part == 2)
      query(block_sparse_dq_mma_kernel<mm::bf16, DD>,
            dq_mma_smem<DD>(max_active));
  };
  if (max_active < 1) return cudaErrorInvalidValue;
  if (D == 64)
    query_d(std::integral_constant<int, 64>{});
  else if (D == 128)
    query_d(std::integral_constant<int, 128>{});
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(bytes);
  info[4] = blocks;
  return cudaSuccess;
}
