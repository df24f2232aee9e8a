// CPU shim copy of csrc/hopper_gemm.cuh: the same names, emulated.
//
// - A tensor map records base, shape, byte strides, box and swizzle; a
//   TMA load copies the box element by element into shared memory (zero
//   outside the shape), 128-byte swizzle applied as the hardware does (the
//   16-byte chunk bits [4:6] of the shared address XOR its bits [7:9]),
//   and then completes its bytes on the mbarrier.
// - An mbarrier keeps its arrival count, transaction bytes and phase; a
//   phase completes when both reach zero; a wait that does not return in
//   20 s aborts (a ring that never fills). More bytes than expected abort.
// - wgmma: each thread computes its own accumulator fragment from the two
//   descriptors, reading every element at the address the B128 layout
//   gives it (K-major: row r at (r / 8) * SBO + (r % 8) * 128 bytes, k
//   two bytes apart; MN-major: index i at (i / 64) * LBO + (i % 64) * 2, k
//   at (k / 8) * SBO + (k % 8) * 128), then swizzled.
// - A cluster's CTAs run together; mapa / ld.shared::cluster reach the
//   other CTA's buffer; barrier.cluster is a barrier over all of their
//   threads that have not exited (`shim::ClusterBarrier`).
#pragma once

#include "common.cuh"
#include "cuda_shim.h"

enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0,
  CU_TENSOR_MAP_DATA_TYPE_FLOAT16 = 6,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_128B = 3
};
struct CUtensorMap {
  const unsigned char* base;
  int esize, rank, swizzle;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
};

namespace shim {

inline MBar& mbar_at(uint32_t addr) {
  Block& b = *self.block;
  if (addr % 8) shim_fail("mbarrier not 8-byte aligned");
  auto& slot = b.mbars.at(addr / 8);
  if (!slot) shim_fail("mbarrier used before mbarrier.init");
  return *slot;
}

inline unsigned char* smem_ptr(uint32_t addr) {
  return self.block->smem + addr;
}

inline uint32_t swz128(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

}  // namespace shim

namespace ds {
namespace hopper {

inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr,
                              CUtensorMapDataType dtype, int rank,
                              const uint64_t* dims, const uint64_t* strides,
                              const uint32_t* box, CUtensorMapSwizzle swz) {
  map->base = static_cast<const unsigned char*>(ptr);
  map->esize = dtype == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ||
                       dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                   ? 2
                   : 1;
  map->rank = rank;
  map->swizzle = swz;
  // cuTensorMapEncodeTiled's conditions
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < rank; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (box[i] < 1 || box[i] > 256) return cudaErrorInvalidValue;
    if (i + 1 < rank) {
      map->strides[i] = strides[i];
      if (strides[i] % 16) return cudaErrorInvalidValue;
    }
  }
  if (box[0] * map->esize % 16) return cudaErrorInvalidValue;
  if (swz == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * map->esize > 128)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

inline void mbar_init(uint64_t* bar, uint32_t count) {
  shim::Block& b = *shim::self.block;
  auto m = std::make_unique<shim::MBar>();
  m->count = m->pending = count;
  b.mbars.at(smem_addr(bar) / 8) = std::move(m);
}

inline void mbar_fence_init() {}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  shim::MBar& m = shim::mbar_at(smem_addr(bar));
  std::lock_guard<std::mutex> lock(m.mu);
  if (m.pending == 0) shim_fail("arrival on a completed mbarrier phase");
  m.tx += bytes;
  --m.pending;
  m.complete_if_done();
}

inline void mbar_arrive(uint64_t* bar) {
  shim::MBar& m = shim::mbar_at(smem_addr(bar));
  std::lock_guard<std::mutex> lock(m.mu);
  if (m.pending == 0) shim_fail("arrival on a completed mbarrier phase");
  --m.pending;
  m.complete_if_done();
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  shim::MBar& m = shim::mbar_at(smem_addr(bar));
  std::unique_lock<std::mutex> lock(m.mu);
  if (!m.cv.wait_for(lock, std::chrono::seconds(20),
                     [&] { return m.phase != parity; }))
    shim_fail("mbarrier wait never returned (a ring that never fills)");
}

template <int STAGES>
struct RingPos {
  int stage = 0;
  uint32_t round = 0;
  uint32_t parity() const { return round & 1; }
  void advance() {
    if (++stage == STAGES) {
      stage = 0;
      ++round;
    }
  }
};

inline void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                     const int* c) {
  const uint32_t d = smem_addr(dst);
  if (d % (map->swizzle ? 1024 : 128))
    shim_fail("TMA destination misaligned for its swizzle");
  const int es = map->esize;
  const uint32_t b0 = map->box[0], b1 = map->box[1];
  const uint32_t b2 = map->rank == 3 ? map->box[2] : 1;
  uint32_t off = 0;
  for (uint32_t i2 = 0; i2 < b2; ++i2)
    for (uint32_t i1 = 0; i1 < b1; ++i1)
      for (uint32_t i0 = 0; i0 < b0; ++i0, off += es) {
        const int64_t g0 = c[0] + (int64_t)i0, g1 = c[1] + (int64_t)i1;
        const int64_t g2 = map->rank == 3 ? c[2] + (int64_t)i2 : 0;
        const bool in = g0 >= 0 && g0 < (int64_t)map->dims[0] && g1 >= 0 &&
                        g1 < (int64_t)map->dims[1] &&
                        (map->rank < 3 ||
                         (g2 >= 0 && g2 < (int64_t)map->dims[2]));
        const uint32_t a = map->swizzle ? shim::swz128(d + off) : d + off;
        unsigned char* out = shim::smem_ptr(a);
        if (in) {
          const unsigned char* src = map->base + g0 * es +
                                     g1 * map->strides[0] +
                                     (map->rank == 3 ? g2 * map->strides[1]
                                                     : 0);
          std::memcpy(out, src, es);
        } else {
          std::memset(out, 0, es);
        }
      }
  shim::MBar& m = shim::mbar_at(smem_addr(bar));
  std::lock_guard<std::mutex> lock(m.mu);
  m.tx -= off;
  if (m.tx < 0) shim_fail("TMA bytes beyond the mbarrier's expect_tx");
  m.complete_if_done();
}

inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1) {
  if (map->rank != 2) shim_fail("2-D load from a map of another rank");
  const int c[3] = {c0, c1, 0};
  tma_load(dst, map, bar, c);
}

inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2) {
  if (map->rank != 3) shim_fail("3-D load from a map of another rank");
  const int c[3] = {c0, c1, c2};
  tma_load(dst, map, bar, c);
}

inline void fence_proxy_async() {}

inline void named_bar_sync(int id, int count) {
  shim::named_barrier(id, count).arrive_and_wait();
}

template <int REGS>
inline void setmaxnreg_inc() {}
template <int REGS>
inline void setmaxnreg_dec() {}

inline uint32_t cluster_rank() { return shim::self.rank; }
inline uint32_t cluster_size() { return shim::self.csize; }
inline void cluster_sync() { shim::self.cluster->sync->arrive_and_wait(); }
// the split halves: the arrival's token is kept until the wait
inline void cluster_arrive_relaxed() {
  if (shim::self.cluster_token) shim_fail("two cluster arrivals, no wait");
  shim::self.cluster_token.emplace(shim::self.cluster->sync->arrive());
}
inline void cluster_wait() {
  if (!shim::self.cluster_token) shim_fail("cluster wait without arrival");
  shim::self.cluster->sync->wait(*shim::self.cluster_token);
  shim::self.cluster_token.reset();
}

// a cluster address: (rank + 1) << 24 | offset
inline uint32_t map_rank(uint32_t addr, uint32_t rank) {
  if (rank >= shim::self.csize) shim_fail("mapa to a rank outside the cluster");
  return ((rank + 1) << 24) | addr;
}

inline void st_cluster_f32(uint32_t addr, float v) {
  const uint32_t rank = (addr >> 24) - 1, off = addr & 0xFFFFFF;
  if (off % 4) shim_fail("misaligned st.shared::cluster.f32");
  std::memcpy(shim::self.cluster->blocks.at(rank)->smem + off, &v, 4);
}

inline uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int R>
inline void fence_operand(float (&)[R]) {}

// element (i, k) of a 64 x 16 (A) or N x 16 (B) operand of element type T
// (bf16 or fp16) under a descriptor
template <typename T>
inline float desc_elem(uint64_t desc, bool mn_major, int i, int k) {
  if ((desc >> 62) != 1) shim_fail("descriptor without the B128 layout");
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  const uint32_t a =
      mn_major ? start + (i / 64) * lbo + (i % 64) * 2 + (k / 8) * sbo +
                     (k % 8) * 128
               : start + (i / 8) * sbo + (i % 8) * 128 + k * 2;
  const unsigned char* p = shim::smem_ptr(shim::swz128(a));
  T h;
  std::memcpy(&h, p, 2);
  return ds::to_float(h);
}

template <int N, int TA, int TB, typename T = __nv_bfloat16>
inline void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + l / 4 + (e >= 2 ? 8 : 0);
      const int c = 8 * j + 2 * (l % 4) + (e & 1);
      float s = 0.f;
      for (int k = 0; k < 16; ++k)
        s = std::fma(desc_elem<T>(da, TA, r, k), desc_elem<T>(db, TB, c, k),
                     s);
      d[4 * j + e] += s;
    }
}

}  // namespace hopper
}  // namespace ds
