// Host emulation of the CUDA features that K2's generated source uses, for
// tests/test_torch_scan_kernel.py: one block of K2_THREADS std::threads,
// __syncthreads() as a std::barrier, and warp shuffles through a per-warp
// exchange buffer with a barrier of 32.  The test includes this header in
// place of <cuda_runtime.h> and compiles the source with g++ -std=c++20.
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#include <math.h>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

struct K2HostDim3 { int x; };
thread_local K2HostDim3 threadIdx;
static std::barrier<>* k2_host_block;
static std::barrier<>* k2_host_warp[32];
static unsigned long long k2_host_lanes[32][32];

inline void __syncthreads() { k2_host_block->arrive_and_wait(); }

template <typename T> T __shfl_down_sync(unsigned, T v, int delta) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  std::memcpy(&k2_host_lanes[w][lane], &v, sizeof(T));
  k2_host_warp[w]->arrive_and_wait();
  T r = v;
  if (lane + delta < 32) std::memcpy(&r, &k2_host_lanes[w][lane + delta], sizeof(T));
  k2_host_warp[w]->arrive_and_wait();
  return r;
}

// Runs body() on `threads` threads, one block.
inline void k2_host_launch(int threads, std::function<void()> body) {
  std::barrier<> block(threads);
  k2_host_block = &block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    k2_host_warp[w] = warps.back().get();
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([t, &body] { threadIdx.x = t; body(); });
  for (auto& th : pool) th.join();
}
