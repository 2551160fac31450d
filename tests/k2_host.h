// Host emulation of the CUDA features that K2's generated source uses, for
// tests/test_torch_scan_kernel.py: one block of any number of std::threads,
// __syncthreads() and __syncthreads_or() on a std::barrier, warp shuffles
// through a per-warp exchange buffer with a barrier of 32, the dynamic
// shared memory as a per-launch buffer behind the name the source declares
// (filled with garbage, so a slot read before it is written shows), a
// refusal of more dynamic shared memory than the H100 gives one block, and
// clock64() from the host's steady clock.  The test includes this header
// in place of <cuda_runtime.h> and compiles the source with g++ -std=c++20.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdlib>
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
typedef int cudaError_t;
#define cudaSuccess 0
// cudaErrorInvalidValue, what the card returns for too much shared memory
#define K2_HOST_INVALID_VALUE 1
inline int cudaGetLastError() { return 0; }
#include "bf16_host.h"

static unsigned char* k2_host_smem;
#define K2_SHARED_ARENA unsigned char* k2_smem = k2_host_smem

enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static int k2_host_smem_limit;
template <typename F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  if (bytes > 232448) return K2_HOST_INVALID_VALUE;
  k2_host_smem_limit = bytes;
  return cudaSuccess;
}

struct K2HostDim3 { int x; };
thread_local K2HostDim3 threadIdx;
thread_local int k2_host_or_calls;
static std::barrier<>* k2_host_block;
static std::barrier<>* k2_host_warp[32];
static unsigned long long k2_host_lanes[32][32];
static std::atomic<int> k2_host_or[3];

inline void __syncthreads() { k2_host_block->arrive_and_wait(); }

// Three flags in turn: the one of call k is cleared by thread 0 in call
// k - 1, after every thread has read it in call k - 3 (each thread reads
// it before it reaches the barrier of call k - 2).
inline int __syncthreads_or(int pred) {
  const int k = k2_host_or_calls++ % 3;
  if (threadIdx.x == 0) k2_host_or[(k + 1) % 3].store(0);
  if (pred) k2_host_or[k].fetch_or(1);
  k2_host_block->arrive_and_wait();
  return k2_host_or[k].load();
}

// the stamped source's clock: nanoseconds of the host's steady clock
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}

template <typename T> T __shfl_down_sync(unsigned, T v, int delta) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  std::memcpy(&k2_host_lanes[w][lane], &v, sizeof(T));
  k2_host_warp[w]->arrive_and_wait();
  T r = v;
  if (lane + delta < 32) std::memcpy(&r, &k2_host_lanes[w][lane + delta], sizeof(T));
  k2_host_warp[w]->arrive_and_wait();
  return r;
}

// Runs body() on `threads` threads (a multiple of 32) as one block with
// `smem` bytes of dynamic shared memory; like the card, refuses more than
// 48 KB that cudaFuncSetAttribute did not allow.
inline void k2_host_launch(int threads, int smem, std::function<void()> body) {
  if (smem > k2_host_smem_limit && smem > 48 * 1024) std::abort();
  std::vector<unsigned char> shared(smem > 0 ? smem : 1, 0xAB);
  k2_host_smem = shared.data();
  for (auto& f : k2_host_or) f.store(0);
  std::barrier<> block(threads);
  k2_host_block = &block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    k2_host_warp[w] = warps.back().get();
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([t, &body] {
      threadIdx.x = t;
      k2_host_or_calls = 0;
      body();
    });
  for (auto& th : pool) th.join();
}
