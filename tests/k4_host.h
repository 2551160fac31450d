// Host emulation of the CUDA features that K4's source (csrc/spmv_csr.cu)
// uses, for tests/test_torch_spmv_kernel.py.  The test includes this header
// in place of <cuda_runtime.h> and compiles the source with g++ -std=c++20.
//
// - A launch (K4_LAUNCH) runs the grid's blocks one after another, each
//   block as blockDim.x std::threads, made once a launch.
// - Warp shuffles with a width go through a per-warp exchange buffer and a
//   barrier of 32; __ldg is a plain load.
// - The occupancy query reports a card of k4_host_set_card's SMs and blocks
//   an SM (132 and 8 unless set).
// - k4_host_blocks() gives the blocks of the last launch, and
//   k4_host_reference() the lane order that the source's note states, in
//   plain C: y[r] from G lane sums by fmaf, then the tree.
// (tests/k2_host.h does the same for K2's one block.)
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }

struct K4HostDim3 { unsigned x; };
thread_local K4HostDim3 threadIdx, blockIdx;
static K4HostDim3 blockDim;
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

static int k4_host_sms = 132, k4_host_per_sm = 8, k4_host_last_blocks = 0;
extern "C" void k4_host_set_card(int sms, int blocks_per_sm) {
  k4_host_sms = sms;
  k4_host_per_sm = blocks_per_sm;
}
extern "C" int k4_host_blocks() { return k4_host_last_blocks; }
inline int cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = k4_host_sms;
  return 0;
}
template <typename F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = k4_host_per_sm;
  return 0;
}

// Runs body() for every thread of a grid of `blocks` blocks of `threads`.
inline void k4_host_launch(int blocks, int threads, std::function<void()> body) {
  blockDim.x = threads;
  k4_host_last_blocks = blocks;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    k4_host_warp[w] = warps.back().get();
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([t, blocks, &body] {
      threadIdx.x = t;
      for (int b = 0; b < blocks; ++b) {
        blockIdx.x = b;
        body();
      }
    });
  for (auto& th : pool) th.join();
}
#define K4_LAUNCH(kernel, blocks, stream, ...) \
  k4_host_launch(blocks, SPMV_THREADS, [&] { kernel(__VA_ARGS__); })

extern "C" void k4_host_reference(const int* indptr, const int* indices, const float* data,
                                  const float* x, float* y, int M, int G) {
  for (int r = 0; r < M; ++r) {
    float acc[32];
    for (int l = 0; l < G; ++l) {
      acc[l] = 0.f;
      for (int k = indptr[r] + l; k < indptr[r + 1]; k += G)
        acc[l] = std::fmaf(data[k], x[indices[k]], acc[l]);
    }
    for (int o = G / 2; o > 0; o >>= 1)
      for (int l = 0; l < o; ++l) acc[l] += acc[l + o];
    y[r] = acc[0];
  }
}
