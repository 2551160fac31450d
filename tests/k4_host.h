// Host emulation of the CUDA features that K4's source (csrc/spmv_csr.cu)
// uses, for tests/test_torch_spmv_kernel.py: a grid of blocks run one after
// another, each block as blockDim.x std::threads, warp shuffles with a width
// through a per-warp exchange buffer and a barrier of 32, __ldg as a plain
// load.  The test includes this header in place of <cuda_runtime.h>,
// replaces the kernel launch by k4_host_launch and compiles the source with
// g++ -std=c++20.  (tests/k2_host.h does the same for K2's one block.)
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }

struct K4HostDim3 { int x; };
thread_local K4HostDim3 threadIdx;
static K4HostDim3 blockIdx, blockDim;
static std::barrier<>* k4_host_warp[32];
static unsigned long long k4_host_lanes[32][32];

template <typename T> T __ldg(const T* p) { return *p; }

// CUDA's __shfl_down_sync with a width: lane l reads lane l + delta of its
// own segment of `width` lanes, or keeps its value past the segment's end.
template <typename T> T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  std::memcpy(&k4_host_lanes[w][lane], &v, sizeof(T));
  k4_host_warp[w]->arrive_and_wait();
  T r = v;
  if ((lane % width) + (int)delta < width)
    std::memcpy(&r, &k4_host_lanes[w][lane + delta], sizeof(T));
  k4_host_warp[w]->arrive_and_wait();
  return r;
}

// Runs body() for every thread of a grid of `blocks` blocks of `threads`.
inline void k4_host_launch(int blocks, int threads, std::function<void()> body) {
  blockDim.x = threads;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    k4_host_warp[w] = warps.back().get();
  }
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([t, &body] { threadIdx.x = t; body(); });
    for (auto& th : pool) th.join();
  }
}
