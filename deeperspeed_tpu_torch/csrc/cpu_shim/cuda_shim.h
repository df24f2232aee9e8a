// A CPU stand-in for the CUDA built-ins the kernels of csrc/ use, so that
// g++ can compile a kernel source and run it on host memory: one
// std::thread per CUDA thread, the CTAs of one cluster at a time, shared
// memory as a per-CTA buffer. Warp- and warpgroup-wide instructions are
// emulated in this directory's copies of common.cuh and hopper_gemm.cuh.
// It checks a kernel's indexing, tiling, ring and layout logic against the
// plain PyTorch version; it says nothing of speed, and only nvcc can say
// whether a source compiles for sm_90a. `rehearse.py` drives it.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))
// static __shared__ arrays (the FMA kernels) compile but are not per-CTA:
// rehearse only kernels whose shared memory is dynamic
#define __shared__ static

using std::max;
using std::min;

[[noreturn]] inline void shim_fail(const char* what) {
  std::fprintf(stderr, "cuda shim: %s\n", what);
  std::fflush(stderr);
  std::abort();
}

// ---------------------------------------------------------------------------
// types
// ---------------------------------------------------------------------------

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

struct __nv_bfloat16 { uint16_t bits; };
struct alignas(4) __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {   // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return {0x7FC0};
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
// IEEE binary16: round to nearest even, past 65504 to +-inf, subnormals
// kept, NaN quieted
struct __half { uint16_t bits; };
struct alignas(4) __half2 { __half x, y; };
inline float __half2float(__half h) {
  const uint32_t sign = static_cast<uint32_t>(h.bits & 0x8000u) << 16;
  const uint32_t exp = (h.bits >> 10) & 0x1Fu, man = h.bits & 0x3FFu;
  if (exp == 0x1F) {
    const uint32_t u = sign | 0x7F800000u | (man << 13);
    float f;
    std::memcpy(&f, &u, 4);
    return f;
  }
  const float mag = exp == 0 ? std::ldexp(static_cast<float>(man), -24)
                             : std::ldexp(static_cast<float>(man | 0x400u),
                                          static_cast<int>(exp) - 25);
  return sign ? -mag : mag;
}
inline __half __float2half_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  const uint16_t sign = static_cast<uint16_t>((u >> 16) & 0x8000u);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u)
    return {static_cast<uint16_t>(sign | 0x7E00u)};
  const float a = std::fabs(f);
  if (a >= 65520.f) return {static_cast<uint16_t>(sign | 0x7C00u)};
  // a multiple of the spacing at a's binade (2^-24 below 2^-14), rounded
  // to nearest even by nearbyint under the default rounding mode
  int e;
  std::frexp(a, &e);                       // a = m 2^e, m in [0.5, 1)
  const int q = std::max(e - 11, -24);     // the spacing's exponent
  const float n = std::nearbyint(std::ldexp(a, -q));
  const float r = std::ldexp(n, q);
  if (r >= 65520.f) return {static_cast<uint16_t>(sign | 0x7C00u)};
  int re;
  std::frexp(r, &re);
  uint16_t bits;
  if (r == 0.f) {
    bits = 0;
  } else if (re - 1 < -14) {               // subnormal: man = r / 2^-24
    bits = static_cast<uint16_t>(std::ldexp(r, 24));
  } else {
    const uint32_t man =
        static_cast<uint32_t>(std::ldexp(r, 11 - re)) & 0x3FFu;
    bits = static_cast<uint16_t>(((re - 1 + 15) << 10) | man);
  }
  return {static_cast<uint16_t>(sign | bits)};
}
inline __half2 __floats2half2_rn(float a, float b) {
  return {__float2half_rn(a), __float2half_rn(b)};
}
inline __half __ushort_as_half(unsigned short u) { return {u}; }

// IEEE single operations, each rounded to nearest even (no contraction:
// the host build targets no FMA)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  return r;
}
template <typename T>
inline T __ldg(const T* p) { return *p; }

// ---------------------------------------------------------------------------
// runtime
// ---------------------------------------------------------------------------

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// what the kernels' info entry points read; the shim has no registers or
// occupancy to report, so they read as zeros
struct cudaFuncAttributes {
  size_t sharedSizeBytes = 0, localSizeBytes = 0;
  int numRegs = 0;
};
template <typename F>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F*) {
  *a = cudaFuncAttributes{};
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*,
                                                                 int,
                                                                 size_t) {
  *n = 0;
  return cudaSuccess;
}
// three SMs, so that a persistent kernel's CTAs each walk several tiles
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return cudaSuccess;
}

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

namespace shim {

// an mbarrier: its arrival count, transaction bytes and phase (driven by
// hopper_gemm.cuh here)
struct MBar {
  std::mutex mu;
  std::condition_variable cv;
  uint32_t count = 0, pending = 0, phase = 0;
  int64_t tx = 0;
  void complete_if_done() {
    if (pending == 0 && tx == 0) {
      phase ^= 1;
      pending = count;
      cv.notify_all();
    }
  }
};


// one CTA: its shared memory, barriers and (named) bar.sync barriers
struct Block {
  std::vector<unsigned char> raw;
  unsigned char* smem = nullptr;
  size_t bytes = 0;
  std::unique_ptr<std::barrier<>> sync;
  std::vector<std::unique_ptr<std::barrier<>>> warps;   // one per warp
  std::unique_ptr<std::barrier<>> named[16];
  std::mutex mu;
  std::vector<std::unique_ptr<MBar>> mbars;             // by offset / 8
  // per-warp exchange buffers of the warp collectives
  std::vector<std::vector<uint64_t>> xchg;
  std::atomic<int> vote{0};                              // __syncthreads_or
};

// barrier.cluster: a phase completes when every thread of the cluster
// that has not exited has arrived. A thread that exits leaves every later
// phase; if it had not arrived in the current one, it stops holding that
// one up. A wait that does not return in 20 s aborts.
struct ClusterBarrier {
  std::mutex mu;
  std::condition_variable cv;
  unsigned expected, arrived = 0, leaving = 0;
  uint64_t phase = 0;
  explicit ClusterBarrier(unsigned n) : expected(n) {}
  void complete_if_done() {   // with mu held
    if (arrived == 0 || arrived < expected) return;
    ++phase;
    arrived = 0;
    expected -= leaving;
    leaving = 0;
    cv.notify_all();
  }
  uint64_t arrive() {
    std::lock_guard<std::mutex> lock(mu);
    const uint64_t p = phase;
    ++arrived;
    complete_if_done();
    return p;
  }
  void wait(uint64_t p) {
    std::unique_lock<std::mutex> lock(mu);
    if (!cv.wait_for(lock, std::chrono::seconds(20),
                     [&] { return phase != p; }))
      shim_fail("barrier.cluster wait never returned");
  }
  void arrive_and_wait() { wait(arrive()); }
  // the thread exits; `pending`: the phase of an arrival it never waited on
  void leave(std::optional<uint64_t> pending) {
    std::lock_guard<std::mutex> lock(mu);
    if (pending && *pending == phase) {
      ++leaving;   // counted in this phase, gone from the next
    } else {
      --expected;
      complete_if_done();
    }
  }
};

struct Cluster {
  std::vector<Block*> blocks;
  std::unique_ptr<ClusterBarrier> sync;
};

struct Thread {
  unsigned rank = 0, csize = 1;
  Block* block = nullptr;
  Cluster* cluster = nullptr;
  unsigned exchanges = 0;   // warp exchanges this thread has taken part in
  // the phase of a barrier.cluster arrival not yet waited on
  std::optional<uint64_t> cluster_token;
};

inline thread_local Thread self;

// The slots of this warp's next exchange (a warp collective: each lane
// writes its slots, one warp barrier, each lane reads the others'). The
// buffer's two halves alternate from one exchange to the next, so a
// lane may write the next half as soon as it has read: by then every
// lane has passed this exchange's barrier, so every read of the half
// before is done.
constexpr unsigned XCHG_SLOTS = 256;
inline uint64_t* exchange_slots() {
  std::vector<uint64_t>& buf = self.block->xchg[threadIdx.x / 32];
  return buf.data() + (self.exchanges++ & 1) * XCHG_SLOTS;
}

inline std::barrier<>& named_barrier(int id, int count) {
  Block& b = *self.block;
  std::lock_guard<std::mutex> lock(b.mu);
  if (!b.named[id]) b.named[id] = std::make_unique<std::barrier<>>(count);
  return *b.named[id];
}

template <typename K, typename... A>
void run_grid(dim3 grid, dim3 block, size_t smem, unsigned cx, K kernel,
              A... args) {
  const unsigned nt = block.x * block.y * block.z;
  if (grid.x % cx) shim_fail("grid.x is not a multiple of the cluster");
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx0 = 0; bx0 < grid.x; bx0 += cx) {
        Cluster cl;
        std::vector<std::unique_ptr<Block>> blocks;
        for (unsigned r = 0; r < cx; ++r) {
          auto b = std::make_unique<Block>();
          b->raw.assign(smem + 2048, 0xA5);   // garbage, as on the card
          const uintptr_t base = reinterpret_cast<uintptr_t>(b->raw.data());
          b->smem = b->raw.data() + ((1024 - base % 1024) % 1024);
          b->bytes = smem;
          b->sync = std::make_unique<std::barrier<>>(nt);
          for (unsigned w = 0; w < (nt + 31) / 32; ++w)
            b->warps.push_back(std::make_unique<std::barrier<>>(
                std::min(32u, nt - 32 * w)));
          b->mbars.resize(smem / 8 + 1);
          b->xchg.assign((nt + 31) / 32,
                         std::vector<uint64_t>(2 * XCHG_SLOTS));
          cl.blocks.push_back(b.get());
          blocks.push_back(std::move(b));
        }
        cl.sync = std::make_unique<ClusterBarrier>(nt * cx);
        std::vector<std::thread> threads;
        for (unsigned r = 0; r < cx; ++r)
          for (unsigned t = 0; t < nt; ++t)
            threads.emplace_back([&, r, t] {
              threadIdx = {t % block.x, (t / block.x) % block.y,
                           t / (block.x * block.y)};
              blockIdx = {bx0 + r, by, bz};
              blockDim = block;
              gridDim = grid;
              self.rank = r;
              self.csize = cx;
              self.block = cl.blocks[r];
              self.cluster = &cl;
              kernel(args...);
              cl.sync->leave(self.cluster_token);
            });
        for (auto& th : threads) th.join();
      }
}

struct Launcher {
  dim3 grid, block;
  size_t smem;
  Launcher(dim3 g, dim3 b, size_t s = 0, cudaStream_t = nullptr)
      : grid(g), block(b), smem(s) {}
  template <typename K, typename... A>
  void run(K kernel, A... args) {
    run_grid(grid, block, smem, 1, kernel, args...);
  }
};

}  // namespace shim


inline void __syncthreads() { shim::self.block->sync->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  shim::self.block->warps[threadIdx.x / 32]->arrive_and_wait();
}

// every thread's p, or-ed: the vote is cleared, set and read between
// three block barriers
inline int __syncthreads_or(int p) {
  shim::Block& b = *shim::self.block;
  b.sync->arrive_and_wait();
  if (threadIdx.x == 0) b.vote = 0;
  b.sync->arrive_and_wait();
  if (p) b.vote = 1;
  b.sync->arrive_and_wait();
  return b.vote;
}

// lane l gets lane (l ^ m)'s value, through the warp's exchange buffer
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  uint64_t* buf = shim::exchange_slots();
  const int l = threadIdx.x % 32;
  static_assert(sizeof(T) <= sizeof(uint64_t), "one exchange slot a lane");
  std::memcpy(&buf[l], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, &buf[l ^ m], sizeof(T));
  return r;
}

inline float __expf(float x) { return std::exp(x); }

// a shared-memory address is the offset into the CTA's buffer
inline size_t __cvta_generic_to_shared(const void* p) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  shim::Block& b = *shim::self.block;
  if (c < b.smem || c >= b.smem + b.bytes + 64)
    shim_fail("shared address outside the CTA's dynamic shared memory");
  return static_cast<size_t>(c - b.smem);
}

template <typename... E, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(E...), A&&... args) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      cx = cfg->attrs[i].val.clusterDim.x;
      if (cfg->attrs[i].val.clusterDim.y != 1 ||
          cfg->attrs[i].val.clusterDim.z != 1 || cx < 1 || cx > 8)
        return cudaErrorInvalidValue;
    }
  shim::run_grid(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cx,
                 kernel, static_cast<E>(args)...);
  return cudaSuccess;
}

inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
