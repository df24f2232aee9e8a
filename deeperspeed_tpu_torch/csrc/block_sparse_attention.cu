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
// tens: operations bound. The forward and dQ kernels do their products
// with fp32 FMA (attention_tiles.cuh), as the first flash kernels did,
// and are bound by FMA throughput; for bf16 at D = 64 and 128 the dK/dV
// kernel takes the tensor-core tile step of the flash dK/dV kernel
// (attention_mma.cuh), fp32 and D = 256 the FMA one. Design:
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
//   the forward LUT. Both recompute P and dP from the lse. No atomics:
//   every gradient element is one fp32 sum in a fixed order, so results
//   are reproducible.
// - bf16 dK/dV (`block_sparse_dkv_mma_kernel`): 4 warps × 16 keys; K and
//   V stay in shared memory, the Q and dO tiles of the listed query
//   blocks stream through a 2-stage cp.async ring, the next tile's
//   address resolved from the LUT row (copied to shared memory at the
//   start) before the current tile's products; Sᵀ, dPᵀ and the two
//   accumulations by mma.sync with Pᵀ and dSᵀ kept in registers.
// - Under `causal`, key tiles wholly after the q tile (and, for dK/dV,
//   q tiles wholly before the key tile) are skipped before any load.
// - The LUTs list row blocks in `order` (the longest rows first), so the
//   blocks with the most tiles start first and the short ones fill in
//   behind them.
// - Tiles and layout: S is a multiple of 128; a 64-row tile (32 at D =
//   256) lies inside one 128 x 128 block.
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
// dK/dV on the tensor cores (bf16, D = 64 and 128)
// ---------------------------------------------------------------------------

namespace mm = ds::mma_attn;

// bytes of dynamic shared memory: K, V and the 2-stage Q / dO ring (bf16
// tiles), the ring's lse and delta rows, and the key block's LUT row
template <int D>
__host__ __device__ constexpr size_t dkv_mma_smem(int max_active) {
  return 6 * mm::tile_elems<D>() * sizeof(mm::bf16) +
         4 * mm::BN * sizeof(float) + ((max_active + 3) / 4) * 16;
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
template <int D>
__global__ void __launch_bounds__(mm::NTM, D == 64 ? 3 : 2)
    block_sparse_dkv_mma_kernel(
        const mm::bf16* __restrict__ q, const mm::bf16* __restrict__ k,
        const mm::bf16* __restrict__ v, const mm::bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        Lut lut_t, mm::bf16* __restrict__ dk, mm::bf16* __restrict__ dv,
        int S, int H, Strides st, float sm_scale, int causal) {
  constexpr int TILE = mm::tile_elems<D>();
  constexpr int LD = mm::ld<D>();
  constexpr int KS = D / 16;
  constexpr int W = D == 64 ? 16 : 32;
  constexpr int SUB = GRAIN / mm::BM;  // key tiles a layout block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mm::bf16* Ks = reinterpret_cast<mm::bf16*>(smem_raw);
  mm::bf16* Vs = Ks + TILE;
  mm::bf16* Qs = Vs + TILE;       // [2][64][LD]
  mm::bf16* dOs = Qs + 2 * TILE;  // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][64]
  float* dl_s = lse_s + 2 * mm::BN;                          // [2][64]
  int* blocks = reinterpret_cast<int*>(dl_s + 2 * mm::BN);   // the LUT row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int nb = S / GRAIN;
  const int cb = lut_t.order[blockIdx.x / SUB];  // key block
  const int k0 = cb * GRAIN + (blockIdx.x % SUB) * mm::BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const mm::bf16* qb = q + b * st.qsb + h * st.qsh;
  const mm::bf16* kb = k + b * st.ksb + h * st.ksh;
  const mm::bf16* vb = v + b * st.vsb + h * st.vsh;
  const mm::bf16* db = dout + ((long long)b * S * H + h) * D;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  const float scale2 = sm_scale * mm::LOG2E;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // the q tiles: tile i is the (i % 2)-th 64 rows of query block
  // blocks[i / 2]
  const int n_blocks = lut_t.count(h, nb, cb);
  const int n_tiles = SUB * n_blocks;
  const int* row = lut_t.row(h, nb, cb);
  for (int i = tid; i < n_blocks; i += mm::NTM) blocks[i] = row[i];
  __syncthreads();
  auto q_start = [&](int i) {
    return blocks[i / SUB] * GRAIN + (i % SUB) * mm::BN;
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
    const mm::bf16* Qt = Qs + stage * TILE;
    const mm::bf16* dOt = dOs + stage * TILE;
    const float* lse_t = lse_s + stage * mm::BN;
    const float* dl_t = dl_s + stage * mm::BN;
    const bool masked = causal && k0 + warp * 16 + 15 > q0;
#pragma unroll 1  // one slice's registers at a time
    for (int c0 = 0; c0 < mm::BN; c0 += W) {
      float s[W / 8][4], dp[W / 8][4];
      mm::zero(s);
      mm::zero(dp);
      mm::mma_abt<KS, W>(s, mm::SmemA<D>{Ks, warp * 16}, Qt + c0 * LD, LD);
      mm::mma_abt<KS, W>(dp, mm::SmemA<D>{Vs, warp * 16}, dOt + c0 * LD,
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
      mm::pack_a<W / 16>(pa, s);
      mm::pack_a<W / 16>(da, dp);
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
    if constexpr (mm::takes_mma<T, D>()) {
      auto kernel = block_sparse_dkv_mma_kernel<D>;
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

// What the bf16 dK/dV kernel at head dim D (64 or 128) takes on this
// device for a transposed LUT of max_active entries a row, into
// info[0..4]: registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes, and blocks an SM can hold.
extern "C" int ds_block_sparse_dkv_info(int D, int max_active, int* info) {
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
  if (max_active < 1) return cudaErrorInvalidValue;
  if (D == 64)
    query(block_sparse_dkv_mma_kernel<64>, dkv_mma_smem<64>(max_active));
  else if (D == 128)
    query(block_sparse_dkv_mma_kernel<128>, dkv_mma_smem<128>(max_active));
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(bytes);
  info[4] = blocks;
  return cudaSuccess;
}
