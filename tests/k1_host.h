// Host emulation of the CUDA features that K1's generated source
// (pytensor_tpu_torch/tensor/fused_kernel.py) uses, for
// tests/test_torch_fused.py: a grid of blocks run one after another, the
// threads of a block as a loop (K1 has no barrier and no shuffle), float4
// and double2 as 16-byte aligned structs, the stream as a pointer that is
// never read, and cudaGetLastError().  float2 (complex64) is an 8-byte
// aligned struct.  The test includes this header in
// place of <cuda_runtime.h> and compiles the source with g++ -std=c++17;
// k1_host_blocks() gives the grid of the last launch.
#pragma once
#include <cmath>
#include <math.h>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) double2 { double x, y; };
#include "bf16_host.h"

struct K1HostDim3 { unsigned int x; };
// a thread's own, so that tests/loops_host.h may run blocks on threads
static thread_local K1HostDim3 threadIdx, blockIdx, blockDim, gridDim;

template <typename F> void k1_host_launch(unsigned blocks, unsigned threads, F body) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      threadIdx.x = t;
      body();
    }
  }
}

#define K1_LAUNCH(kernel, blocks, stream, ...) \
  k1_host_launch(blocks, K1_THREADS, [&] { kernel(__VA_ARGS__); })

extern "C" unsigned k1_host_blocks() { return gridDim.x; }

// CUDA math-library functions that glibc lacks, for the special functions
// (pytensor_tpu_torch/link/cuda/special.py): host definitions of erfinv,
// erfcinv, erfcx, cyl_bessel_i0, cyl_bessel_i1, normcdf and normcdfinv
// (and their float forms), each to double precision; the card's are
// CUDA's own.  glibc has erf, erfc, lgamma, tgamma, j0 and j1.
static const double K1H_SQRT_PI = 1.7724538509055160273;
inline double erfcx(double x) {
  if (x != x) return x;
  if (x < 0) return x < -26.7 ? INFINITY : 2.0 * std::exp(x * x) - erfcx(-x);
  if (x < 2.0) return std::exp(x * x) * std::erfc(x);
  if (x > 1e8) return 1.0 / (K1H_SQRT_PI * x);
  // erfc(x) e^{x^2} sqrt(pi) = 1/(x + (1/2)/(x + 1/(x + (3/2)/(x + ...))))
  double t = x;
  for (int k = 200; k >= 1; --k) t = x + 0.5 * k / t;
  return 1.0 / (K1H_SQRT_PI * t);
}
// erfc(x) = y by Newton's method on erfcx, from a rough start
inline double erfcinv(double y) {
  if (y != y || y < 0 || y > 2) return NAN;
  if (y == 0) return INFINITY;
  if (y == 2) return -INFINITY;
  if (y > 1) return -erfcinv(2.0 - y);
  // from above the root, where Newton on the convex erfc converges monotonically
  double x = y > 0.5 ? (1.0 - y) * K1H_SQRT_PI / 2 : std::sqrt(-std::log(y));
  for (int i = 0; i < 60; ++i) {
    const double step = (erfcx(x) - std::exp(std::log(y) + x * x)) * K1H_SQRT_PI / 2;
    x += step;
    if (std::fabs(step) <= 1e-17 * std::fabs(x)) break;
  }
  return x;
}
inline double erfinv(double y) {
  if (y != y || y < -1 || y > 1) return NAN;
  if (y == 0) return y;
  if (std::fabs(y) < 0.5) {
    // Newton on erf from the first terms of the series
    double x = y * K1H_SQRT_PI / 2;
    for (int i = 0; i < 40; ++i) {
      const double step = (std::erf(x) - y) * K1H_SQRT_PI / 2 * std::exp(x * x);
      x -= step;
      if (std::fabs(step) <= 1e-17 * std::fabs(x)) break;
    }
    return x;
  }
  return y > 0 ? erfcinv(1.0 - y) : -erfcinv(1.0 + y);
}
inline double normcdf(double x) { return 0.5 * std::erfc(-x / std::sqrt(2.0)); }
inline double normcdfinv(double p) { return -std::sqrt(2.0) * erfcinv(2.0 * p); }
inline double cyl_bessel_i0(double x) {
  return x != x ? x : std::isinf(x) ? INFINITY : std::cyl_bessel_i(0.0, std::fabs(x));
}
inline double cyl_bessel_i1(double x) {
  if (x != x) return x;
  if (std::isinf(x)) return x;
  const double r = std::cyl_bessel_i(1.0, std::fabs(x));
  return x < 0 ? -r : r;
}
inline float erfcxf(float x) { return (float)erfcx(x); }
inline float erfcinvf(float x) { return (float)erfcinv(x); }
inline float erfinvf(float x) { return (float)erfinv(x); }
inline float normcdff(float x) { return (float)normcdf(x); }
inline float normcdfinvf(float x) { return (float)normcdfinv(x); }
inline float cyl_bessel_i0f(float x) { return (float)cyl_bessel_i0(x); }
inline float cyl_bessel_i1f(float x) { return (float)cyl_bessel_i1(x); }
