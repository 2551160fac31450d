// Host emulation of what the loop samplers' kernel sources
// (pytensor_tpu_torch/csrc/{gamma,poisson,binomial}.cu) use, for
// tests/test_torch_random_loop_kernels.py: the threefry kernel's host
// header (K1's grid of blocks run one after another, the threads of a
// block as a loop; the funnel shift, bit casts and rounded intrinsics;
// erfinv), and __host__, atomicMax, __double_as_longlong and
// cudaMemsetAsync.  The blocks and threads run one at a time, so an atomic
// is a plain read and write.  The test includes this header in place of
// <cuda_runtime.h> and compiles the sources with g++ -ffp-contract=off, so
// that no multiply and add is fused, as -fmad=false promises on the card.
#pragma once
#include <cstring>
#include "threefry_host.h"

#define __host__
#undef THREEFRY_LAUNCH
#define LOOP_LAUNCH(kernel, blocks, stream, ...) \
  k1_host_launch(blocks, LOOP_THREADS, [&] { kernel(__VA_ARGS__); })

inline double __ddiv_rn(double a, double b) { return a / b; }
inline int atomicMax(int* address, int value) {
  const int old = *address;
  if (value > old) *address = value;
  return old;
}
inline long long __double_as_longlong(double x) {
  long long v;
  std::memcpy(&v, &x, sizeof v);
  return v;
}
inline int cudaMemsetAsync(void* ptr, int value, size_t bytes, cudaStream_t) {
  std::memset(ptr, value, bytes);
  return 0;
}
