// Host emulation of what the threefry kernel's source
// (pytensor_tpu_torch/csrc/threefry.cu) uses, for
// tests/test_torch_random.py: K1's host header (a grid of blocks run one
// after another, the threads of a block as a loop; erfinv), CUDA's
// funnel shift, the bit casts and the rounded multiply and add
// intrinsics.  A resident grid is 3 blocks, so that a thread strides over
// the draws.  The test includes this header in place of <cuda_runtime.h>
// and compiles the source with g++ -ffp-contract=off, so that no multiply
// and add is fused, as the intrinsics promise.
#pragma once
#include <cstdint>
#include <cstring>
#include "k1_host.h"

enum { cudaErrorInvalidValue = 1 };

#define THREEFRY_ROOM(kernel) 3

// the high word of (hi:lo) << (shift & 31)
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  const uint64_t v = ((uint64_t)hi << 32) | lo;
  return (uint32_t)((v << (shift & 31)) >> 32);
}
inline double __longlong_as_double(long long x) {
  double d;
  std::memcpy(&d, &x, sizeof d);
  return d;
}
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

#define THREEFRY_LAUNCH(kernel, blocks, stream, ...) \
  k1_host_launch(blocks, THREEFRY_THREADS, [&] { kernel(__VA_ARGS__); })
