// Host emulation of the CUDA features that K3's source (csrc/radon_leapfrog.cu)
// uses, for tests/test_torch_radon_kernel.py: a grid of blocks run one after
// another, each block as blockDim.x std::threads with __syncthreads() on a
// std::barrier, warp shuffles through a per-warp exchange buffer and a
// barrier of 32, float4, the dynamic shared memory as a per-block buffer
// filled with garbage (so a value read before it is written shows), the
// card's refusal of more threads or more dynamic shared memory than one
// block may use, and clock64() from the host's steady clock.  The test
// includes this header in place of <cuda_runtime.h> and compiles the source
// with g++ -std=c++20.  (Beside tests/k2_host.h and tests/k4_host.h, which do
// the same for K2 and K4.)
#pragma once
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
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
typedef void* cudaStream_t;
typedef int cudaError_t;
#define cudaSuccess 0
// cudaErrorInvalidValue and cudaErrorInvalidConfiguration, as the card
// returns them for too much shared memory and too many threads
#define K3_HOST_INVALID_VALUE 1
#define cudaErrorInvalidValue K3_HOST_INVALID_VALUE
#define K3_HOST_INVALID_CONFIGURATION 9

static int k3_host_error;
inline int cudaGetLastError() {
  const int e = k3_host_error;
  k3_host_error = 0;
  return e;
}

enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static size_t k3_host_smem_limit = 48 * 1024;
template <typename F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  if (bytes > 232448) return K3_HOST_INVALID_VALUE;
  k3_host_smem_limit = bytes;
  return cudaSuccess;
}

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
// a product rounded on its own (the host compiler contracts nothing)
inline float __fmul_rn(float a, float b) { return a * b; }

struct K3HostDim3 { unsigned int x; };
thread_local K3HostDim3 threadIdx;
static K3HostDim3 blockIdx, blockDim, gridDim;
static std::barrier<>* k3_host_block;
static std::barrier<>* k3_host_warp[32];
static unsigned long long k3_host_lanes[32][32];
static unsigned char* k3_host_smem;
#define K3_SHARED_ARENA float* smem = reinterpret_cast<float*>(k3_host_smem)

inline void __syncthreads() { k3_host_block->arrive_and_wait(); }

// the stamped variant's clock: nanoseconds of the host's steady clock
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}

// lane l reads lane `src` of its warp (__shfl_sync) or lane l + delta, when
// there is one (__shfl_down_sync)
template <typename T> T k3_host_shuffle(T v, int src) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  std::memcpy(&k3_host_lanes[w][lane], &v, sizeof(T));
  k3_host_warp[w]->arrive_and_wait();
  T r = v;
  if (src < 32) std::memcpy(&r, &k3_host_lanes[w][src], sizeof(T));
  k3_host_warp[w]->arrive_and_wait();
  return r;
}
template <typename T> T __shfl_down_sync(unsigned, T v, unsigned delta) {
  return k3_host_shuffle(v, (int)(threadIdx.x & 31) + (int)delta);
}
template <typename T> T __shfl_sync(unsigned, T v, int src) { return k3_host_shuffle(v, src); }

// Runs body() on every thread of `blocks` blocks of `threads` (a multiple of
// 32), one block after another, each with `smem` bytes of dynamic shared
// memory; refuses, as the card does, more than 1,024 threads and more than
// 48 KB of shared memory that cudaFuncSetAttribute did not allow.
inline void k3_host_launch(int blocks, int threads, size_t smem, std::function<void()> body) {
  if (threads > 1024 || threads % 32) {
    k3_host_error = K3_HOST_INVALID_CONFIGURATION;
    return;
  }
  if (smem > k3_host_smem_limit) {
    k3_host_error = K3_HOST_INVALID_VALUE;
    return;
  }
  blockDim.x = threads;
  gridDim.x = blocks;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    k3_host_warp[w] = warps.back().get();
  }
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::vector<unsigned char> shared(smem > 0 ? smem : 1, 0xAB);
    k3_host_smem = shared.data();
    std::barrier<> block(threads);
    k3_host_block = &block;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([t, &body] { threadIdx.x = t; body(); });
    for (auto& th : pool) th.join();
  }
}

#define K3_LAUNCH(kernel, blocks, threads, smem, stream, ...) \
  k3_host_launch(blocks, threads, smem, [&] { kernel(__VA_ARGS__); })
