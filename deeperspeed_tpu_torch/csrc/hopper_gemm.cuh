// Hopper GEMM pieces shared by the wgmma kernels (quant_matmul.cu,
// grouped_matmul.cu): TMA tile loads described by a CUtensorMap, an
// mbarrier ring between one producer thread and the consumer warpgroups,
// wgmma on operands read from shared memory through matrix descriptors,
// thread-block-cluster helpers and setmaxnreg.
//
// Shared-memory operand layout (the one TMA's 128-byte swizzle writes and
// the descriptors' B128 layout reads): a tile is stored as 128-byte lines
// (64 bf16); the 16-byte chunk c of line l sits at chunk c ^ (l % 8), so
// eight lines form a 1024-byte swizzle atom, and every tile starts on a
// 1024-byte boundary.
//
// - K-major operand (rows of an M or N index, 64 k a line): line = row.
//   Descriptor: SBO = 1024 (the next 8 rows), LBO unused; the k16 step kk
//   starts 32 * kk bytes into the line.
// - MN-major operand (lines of 64 M or N indices, one line a k): each
//   64-wide column block is its own [k][64] region. Descriptor: LBO = the
//   byte distance between column blocks, SBO = 1024 (the next 8 k); the
//   k16 step kk starts 2048 * kk bytes into each block.
//
// The CUDA driver's cuTensorMapEncodeTiled is reached through the runtime's
// entry-point query, so the library links against no libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace ds {
namespace hopper {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// a CUDA driver entry point by name (null if the installed one lacks it)
template <typename F>
F driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &status);
#endif
  return err == cudaSuccess && status == cudaDriverEntryPointSuccess
             ? reinterpret_cast<F>(p) : nullptr;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
using CtxGetCurrent = CUresult (*)(CUcontext*);
using CtxSetCurrent = CUresult (*)(CUcontext);
using PrimaryCtxRetain = CUresult (*)(CUcontext*, CUdevice);

// The encoder needs a current context in the calling thread. A thread
// that has reached the card only through another runtime (PyTorch's
// autograd thread) may have none yet: bind the current device's primary
// context, as this library's runtime does at its first launch there.
inline bool bind_context() {
  static const CtxGetCurrent get = driver_fn<CtxGetCurrent>("cuCtxGetCurrent");
  static const CtxSetCurrent set = driver_fn<CtxSetCurrent>("cuCtxSetCurrent");
  static const PrimaryCtxRetain retain =
      driver_fn<PrimaryCtxRetain>("cuDevicePrimaryCtxRetain");
  if (!get || !set || !retain) return false;
  CUcontext ctx = nullptr;
  if (get(&ctx) == CUDA_SUCCESS && ctx != nullptr) return true;
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         retain(&ctx, dev) == CUDA_SUCCESS && set(ctx) == CUDA_SUCCESS;
}

// What a map encodes: a map depends on nothing else, so one encoded for a
// (pointer, shape) stays right for whatever tensor later lives there.
struct MapKey {
  const void* ptr;
  int dtype, rank, swizzle;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
  bool operator==(const MapKey& o) const {
    return std::memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ p[i]) * 1099511628211ull;
    return static_cast<size_t>(h);
  }
};

// A rank-2 or rank-3 tiled map over `ptr` (dims innermost first, byte
// strides of the outer dims, box in elements), zero fill out of bounds.
// Encoded maps are cached by what they encode (at most 4096, then the
// cache starts over). cudaErrorInvalidValue when the encoder refuses it.
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr,
                              CUtensorMapDataType dtype, int rank,
                              const uint64_t* dims, const uint64_t* strides,
                              const uint32_t* box, CUtensorMapSwizzle swz) {
  MapKey key;
  std::memset(&key, 0, sizeof(key));
  key.ptr = ptr;
  key.dtype = static_cast<int>(dtype);
  key.rank = rank;
  key.swizzle = static_cast<int>(swz);
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  static const EncodeTiled encode =
      driver_fn<EncodeTiled>("cuTensorMapEncodeTiled");
  if (encode == nullptr || !bind_context()) return cudaErrorInvalidValue;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res = encode(
      map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr),
      reinterpret_cast<const cuuint64_t*>(dims),
      reinterpret_cast<const cuuint64_t*>(strides),
      reinterpret_cast<const cuuint32_t*>(box), ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// device: addresses, barriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy and the cluster
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// waits until the barrier's phase of parity `parity` has completed; a
// phase that never completes (a ring whose loads never land) traps after
// about 2^35 cycles (some 20 s) instead of hanging the stream
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// The ring's position: stage s of round r waits for parity r & 1 on its
// full barrier, and (from the second round on) for parity (r - 1) & 1 on
// its empty barrier.
template <int STAGES>
struct RingPos {
  int stage = 0;
  uint32_t round = 0;
  __device__ __forceinline__ uint32_t parity() const { return round & 1; }
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      ++round;
    }
  }
};

// TMA tile loads into this CTA's shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on a named barrier among `count` threads (id 0 is
// __syncthreads')
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------------------
// device: clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster; orders shared-memory accesses
// across the cluster (release / acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the two halves of cluster_sync, for a barrier split around other work:
// every thread arrives (relaxed: it orders nothing), later waits. A CTA
// that arrives at a kernel's start and waits before its first remote
// store knows that the other CTAs have started, so their shared memory
// exists.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared::cluster address of the same offset in CTA `rank`'s memory
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// B128-swizzled shared-memory matrix descriptor (offsets in bytes)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N committed groups of this warpgroup still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the async
// products
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N], bf16 or fp16 (T) operands from
// shared memory,
// fp32 d in registers: thread (warp w, lane l) of the warpgroup holds rows
// 16w + l/4 (+8) at columns 8j + 2(l%4) (+1) in d[4j .. 4j+3]. TA / TB: 1
// when A / B is MN-major.
#define DS_WGMMA_M64N16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, %8, %9, p, 1, 1, %10, %11;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "l"(da), "l"(db), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], uint64_t da,
                                             uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    DS_WGMMA_M64N16("f16");
  else
    DS_WGMMA_M64N16("bf16");
}

#define DS_WGMMA_M64N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, %18, %19;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    DS_WGMMA_M64N32("f16");
  else
    DS_WGMMA_M64N32("bf16");
}

#define DS_WGMMA_M64N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, %34, %35;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    DS_WGMMA_M64N64("f16");
  else
    DS_WGMMA_M64N64("bf16");
}

#define DS_WGMMA_M64N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %66, %67;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    DS_WGMMA_M64N128("f16");
  else
    DS_WGMMA_M64N128("bf16");
}

#define DS_WGMMA_M64N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, %130, %131;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    DS_WGMMA_M64N256("f16");
  else
    DS_WGMMA_M64N256("bf16");
}


// T: the operands' element type, bf16 or fp16 (the descriptors and
// swizzles are the same for any 2-byte type; only the instruction's type
// fields change)
template <int N, int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 16) wgmma_m64n16<TA, TB, T>(d, da, db);
  else if constexpr (N == 32) wgmma_m64n32<TA, TB, T>(d, da, db);
  else if constexpr (N == 64) wgmma_m64n64<TA, TB, T>(d, da, db);
  else if constexpr (N == 128) wgmma_m64n128<TA, TB, T>(d, da, db);
  else wgmma_m64n256<TA, TB, T>(d, da, db);
}

}  // namespace hopper
}  // namespace ds
