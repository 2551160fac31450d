// Host emulation of the CUDA features that K1's generated source
// (pytensor_tpu_torch/tensor/fused_kernel.py) uses, for
// tests/test_torch_fused.py: a grid of blocks run one after another, the
// threads of a block as a loop (K1 has no barrier and no shuffle), float4
// and double2 as 16-byte aligned structs, the stream as a pointer that is
// never read, and cudaGetLastError().  The test includes this header in
// place of <cuda_runtime.h> and compiles the source with g++ -std=c++17;
// k1_host_blocks() gives the grid of the last launch.
#pragma once
#include <cmath>
#include <math.h>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };

struct K1HostDim3 { unsigned int x; };
static K1HostDim3 threadIdx, blockIdx, blockDim, gridDim;

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
