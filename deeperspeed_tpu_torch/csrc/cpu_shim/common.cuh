// CPU shim copy of csrc/common.cuh, emulated. cp.async copies at once (so
// the shim cannot see a missing wait); ldmatrix and mma.sync exchange
// their operands through a per-warp buffer between two warp barriers,
// then each lane computes its own fragment by the m16n8k16 / 8x8 layouts
// (one warp barrier an exchange, `shim::exchange_slots`);
// ex2 is std::exp2 (the card's ex2.approx differs in the last bits).
#pragma once

#include <type_traits>

#include "cuda_shim.h"

namespace ds {

constexpr float NEG_INF = -1e30f;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F16 = 2;

inline float to_float(float x) { return x; }
inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
inline float to_float(__half x) { return __half2float(x); }

template <typename T>
T from_float(float x);
template <>
inline float from_float<float>(float x) {
  return x;
}
template <>
inline __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
inline __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
inline unsigned pack2(float lo, float hi) {
  const T a = from_float<T>(lo), b = from_float<T>(hi);
  uint16_t x, y;
  std::memcpy(&x, &a, 2);
  std::memcpy(&y, &b, 2);
  return x | (static_cast<unsigned>(y) << 16);
}

inline float ex2(float x) { return std::exp2(x); }

inline void cp_async16(void* smem, const void* gmem, bool pred) {
  if (reinterpret_cast<uintptr_t>(smem) % 16 ||
      (pred && reinterpret_cast<uintptr_t>(gmem) % 16))
    shim_fail("cp.async.cg needs 16-byte aligned addresses");
  if (pred)
    std::memcpy(smem, gmem, 16);
  else
    std::memset(smem, 0, 16);
}

inline void cp_async4(void* smem, const void* gmem, bool pred) {
  if (reinterpret_cast<uintptr_t>(smem) % 4 ||
      (pred && reinterpret_cast<uintptr_t>(gmem) % 4))
    shim_fail("cp.async.ca (4 bytes) needs 4-byte aligned addresses");
  if (pred)
    std::memcpy(smem, gmem, 4);
  else
    std::memset(smem, 0, 4);
}

inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}


inline float bf16_lo(unsigned v) {
  return __uint_as_float((v & 0xFFFFu) << 16);
}
inline float bf16_hi(unsigned v) { return __uint_as_float(v & 0xFFFF0000u); }
inline float f16_lo(unsigned v) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(v)));
}
inline float f16_hi(unsigned v) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(v >> 16)));
}

// lane l's row address goes to slot l; lane l reads 2 halves of each of
// the 4 matrices: plain (row l/4, cols 2(l%4), +1), trans (rows 2(l%4), +1
// of col l/4)
inline void ldmatrix_x4_any(unsigned* r, const void* smem, bool trans) {
  uint64_t* buf = shim::exchange_slots();
  const int l = threadIdx.x % 32;
  if (reinterpret_cast<uintptr_t>(smem) % 16)
    shim_fail("ldmatrix row address not 16-byte aligned");
  buf[l] = reinterpret_cast<uintptr_t>(smem);
  __syncwarp();
  for (int m = 0; m < 4; ++m) {
    uint16_t h[2];
    for (int e = 0; e < 2; ++e) {
      const int row = trans ? 2 * (l % 4) + e : l / 4;
      const int col = trans ? l / 4 : 2 * (l % 4) + e;
      const auto* p = reinterpret_cast<const uint16_t*>(buf[8 * m + row]);
      h[e] = p[col];
    }
    r[m] = h[0] | (static_cast<unsigned>(h[1]) << 16);
  }
}

inline void ldmatrix_x4(unsigned* r, const void* smem) {
  ldmatrix_x4_any(r, smem, false);
}
inline void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  ldmatrix_x4_any(r, smem, true);
}

// c += a * b on one m16n8k16 tile: bf16 (or, F16, fp16) A (row) and B
// (col), fp32 c
template <bool F16 = false>
inline void mma_b16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  const auto lo = [](unsigned v) { return F16 ? f16_lo(v) : bf16_lo(v); };
  const auto hi = [](unsigned v) { return F16 ? f16_hi(v) : bf16_hi(v); };
  uint64_t* buf = shim::exchange_slots();
  const int l = threadIdx.x % 32;
  buf[l * 8 + 0] = a[0];
  buf[l * 8 + 1] = a[1];
  buf[l * 8 + 2] = a[2];
  buf[l * 8 + 3] = a[3];
  buf[l * 8 + 4] = b0;
  buf[l * 8 + 5] = b1;
  __syncwarp();
  auto A = [&](int row, int col) {   // row 0..15, col (k) 0..15
    const int lane = (row % 8) * 4 + (col % 8) / 2;
    const int reg = (row >= 8 ? 1 : 0) + (col >= 8 ? 2 : 0);
    const unsigned v = static_cast<unsigned>(buf[lane * 8 + reg]);
    return col % 2 ? hi(v) : lo(v);
  };
  auto B = [&](int k, int col) {     // k 0..15, col 0..7
    const int lane = col * 4 + (k % 8) / 2;
    const unsigned v = static_cast<unsigned>(buf[lane * 8 + 4 + (k >= 8)]);
    return k % 2 ? hi(v) : lo(v);
  };
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >= 2 ? 8 : 0), col = 2 * t + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s = std::fma(A(row, k), B(k, col), s);
    c[e] += s;
  }
}

inline void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  mma_b16<false>(c, a, b0, b1);
}
inline void mma_f16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  mma_b16<true>(c, a, b0, b1);
}
template <typename T>
inline void mma16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  mma_b16<std::is_same<T, __half>::value>(c, a, b0, b1);
}

}  // namespace ds
