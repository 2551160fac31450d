// Host emulation of the bfloat16 of <cuda_bf16.h> that K1's and K2's
// generated sources use (pytensor_tpu_torch/link/cuda/cexpr.py
// BF16_SOURCE), for tests/k1_host.h and tests/k2_host.h: 16 bits, the
// upper half of a float; float to bfloat16 rounds to nearest, ties to
// even, and keeps a NaN a (quiet) NaN; bfloat16 to float is exact.  The
// tests drop the source's #include <cuda_bf16.h>.
#pragma once
#include <cstring>

struct __nv_bfloat16 { unsigned short x; };
struct alignas(16) uint4 { unsigned int x, y, z, w; };

inline float __bfloat162float(__nv_bfloat16 h) {
  const unsigned int u = (unsigned int)h.x << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned int u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short s) { return {s}; }
