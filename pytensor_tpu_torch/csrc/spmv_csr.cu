// K4: y = A x for a CSR matrix A, in one CUDA kernel.
//
// Replaces pytensor_tpu/link/pallas/route.py:194 lane_gather as the JAX
// package composes it in pytensor_tpu/sparse/spmv.py:143 build_spmv_fn: a
// Mosaic kernel can only move data along the 128 lanes of a tile, so the
// gather x[col] of every nonzero was built from one-hot matmuls on the matrix
// unit, one lane gather, and a Clos network of transposes and seven more lane
// gathers that routed each product to its row, before a multiply and a
// reshape-sum.  On Hopper a gather is a load, so none of that is here: the
// kernel reads each row's nonzeros, loads x[indices[k]], multiplies by
// data[k] and sums the row.
//
// What bounds it on this card: the gathers.  Counted as bytes a matvec is
// cheap (8 bytes a nonzero, plus indptr, x and y once: 6.0 MB, 1.80 us at
// 3.35 TB/s for the 65,536^2 matrix of ten nonzeros a row), and it has no
// arithmetic to speak of.  But each x[indices[k]] of a random column costs
// the SM a 32-byte sector from L2 for its 4 bytes, so the 655,360 gathers
// move ~21 MB between L2 and the SMs (less what an SM's L1 already holds).
// On an H100 the gathers alone, with nothing else, take most of K4's time
// at that size, with one or four in flight a thread alike: a limit of
// the L1/L2 path's throughput, not the latency of the chain indptr ->
// indices -> x.  A is not the cost either: between launches its 5.2 MB
// stay in the 50 MB L2.  PERF.md says which other designs were measured
// against this one.
//
// The design keeps the gathers streaming and spends little else:
// - A group of G lanes of a warp takes one row; G is a power of two from 1
//   to 32, a template argument, chosen by the wrapper from the mean row
//   length (link/cuda/spmv_kernel.py group_size).  The lanes of a group
//   stride through the row's range [indptr[r], indptr[r+1]), so data and
//   indices are read coalesced across the group, each byte once.
// - A lane takes its nonzeros two at a time: both data loads, both index
//   loads and both gathers are issued before either product is summed, so
//   two gathers of a lane are in flight.  Four at a time costs registers
//   (40 against 32, so six blocks an SM where 32 allow eight), more than it
//   saves.
// - No shared memory: the whole unified L1 is left to cache x.
//
// The order of every sum is fixed, so K4 is deterministic (two launches on
// the same inputs give the same bits), and it is the order of the kernel
// this one replaced: for lanes l = 0..G-1,
//   acc_l = fmaf(data[k], x[indices[k]], acc_l)
// over k = start + l, start + l + G, ... below end, from 0.f, then the tree
// acc_l += acc_{l+o} for o = G/2, ..., 1 (a __shfl_down_sync of width G),
// and y[r] = acc_0.  No atomics.  An empty row writes 0.  Lanes past the
// last row take part in the shuffles with 0 and write nothing.
//
// SPMV_THREADS threads a block, a grid of ceil(M * G / SPMV_THREADS)
// blocks, launched on the caller's stream; the kernel allocates nothing.
// Built by nvcc into a shared library with a plain C interface and called
// through ctypes.  The host test (tests/k4_host.h) defines K4_LAUNCH and
// the CUDA calls used here, and runs this source under g++.

#include <cuda_runtime.h>

#define SPMV_THREADS 256

#ifndef K4_LAUNCH
#define K4_LAUNCH(kernel, blocks, stream, ...) \
  kernel<<<blocks, SPMV_THREADS, 0, stream>>>(__VA_ARGS__)
#endif

template <int G>
__global__ void __launch_bounds__(SPMV_THREADS)
spmv_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x,
                float* __restrict__ y, int M) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid / G;
  const int lane = threadIdx.x & (G - 1);
  float acc = 0.f;
  if (row < M) {
    const int start = __ldg(indptr + row);
    const int end = __ldg(indptr + row + 1);
    int k = start + lane;
    for (; k + G < end; k += 2 * G) {
      const float d0 = __ldg(data + k), d1 = __ldg(data + k + G);
      const float x0 = __ldg(x + __ldg(indices + k)), x1 = __ldg(x + __ldg(indices + k + G));
      acc = fmaf(d0, x0, acc);
      acc = fmaf(d1, x1, acc);
    }
    if (k < end) acc = fmaf(__ldg(data + k), __ldg(x + __ldg(indices + k)), acc);
  }
  // every lane of the warp reaches this: the grid is whole blocks of whole warps
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o, G);
  if (lane == 0 && row < M) y[row] = acc;
}

static int spmv_blocks(int M, int G) {
  return (int)(((long long)M * G + SPMV_THREADS - 1) / SPMV_THREADS);
}

template <int G>
static int spmv_plan(int M, int* out) {
  out[0] = SPMV_THREADS / G;
  out[1] = spmv_blocks(M, G);
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, spmv_csr_kernel<G>,
                                                             SPMV_THREADS, 0);
  if (!err) err = (int)cudaDeviceGetAttribute(out + 3, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <int G>
static int spmv_launch(const int* indptr, const int* indices, const float* data,
                       const float* x, float* y, int M, cudaStream_t stream) {
  K4_LAUNCH(spmv_csr_kernel<G>, spmv_blocks(M, G), stream, indptr, indices, data, x, y, M);
  return (int)cudaGetLastError();
}

// return fn<G>(...) for a lane count G the kernel is built for
#define K4_BY_G(G, fn, ...)                     \
  switch (G) {                                  \
    case 1: return fn<1>(__VA_ARGS__);          \
    case 2: return fn<2>(__VA_ARGS__);          \
    case 4: return fn<4>(__VA_ARGS__);          \
    case 8: return fn<8>(__VA_ARGS__);          \
    case 16: return fn<16>(__VA_ARGS__);        \
    case 32: return fn<32>(__VA_ARGS__);        \
    default: return (int)cudaErrorInvalidValue; \
  }

// How a launch for M rows with G lanes a row fills the current device:
// writes the rows a block, the blocks of the launch, the blocks one SM holds
// at once and the SMs to out[0..3].  Returns the first CUDA error, or
// cudaErrorInvalidValue for a G that is not 1, 2, 4, 8, 16 or 32.
extern "C" int spmv_csr_plan(int M, int G, int* out) {
  K4_BY_G(G, spmv_plan, M, out)
}

// y[r] = sum over k in [indptr[r], indptr[r+1]) of data[k] * x[indices[k]],
// r < M, with G lanes a row.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a G that is not 1, 2, 4, 8, 16 or 32.
extern "C" int spmv_csr(const int* indptr, const int* indices, const float* data,
                        const float* x, float* y, int M, int G, cudaStream_t stream) {
  if (M <= 0) return 0;
  K4_BY_G(G, spmv_launch, indptr, indices, data, x, y, M, stream)
}
