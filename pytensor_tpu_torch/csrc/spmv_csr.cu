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
// What bounds it on this card: bytes.  A matvec does 2 operations per
// nonzero and moves at least data (4 B) and indices (4 B) per nonzero, plus
// indptr, x and y once: about 1 operation a byte, far below the card's ~20
// float32 operations a byte.  The design spends nothing but those bytes:
//
// - A group of G lanes of a warp takes one row; G is a power of two from 1
//   to 32, a template argument, chosen by the wrapper from the mean row
//   length (link/cuda/spmv_kernel.py).  The lanes of a group stride through
//   the row's range [indptr[r], indptr[r+1]), so data and indices are read
//   coalesced across the group, each byte once.
// - x[indices[k]] is read through the read-only path (__ldg): x is small
//   against the 50 MB L2 at the sizes this runs at, so the gathers are L2
//   hits after the first touch, and data and indices stream from memory.
// - Each lane accumulates in float32 with one fused multiply-add per
//   nonzero; the group combines its lanes with a fixed __shfl_down_sync
//   tree.  Every order is fixed, so K4 is deterministic: two launches on the
//   same inputs give the same bits.  No atomics, no shared memory.
// - An empty row writes 0.  Lanes past the last row take part in the
//   shuffles with 0 and write nothing.
//
// 256 threads a block, a grid of ceil(M * G / 256) blocks, launched on the
// caller's stream; the kernel allocates nothing.  Built by nvcc into a shared
// library with a plain C interface and called through ctypes.

#include <cuda_runtime.h>

#define SPMV_THREADS 256

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
    for (int k = start + lane; k < end; k += G)
      acc = fmaf(__ldg(data + k), __ldg(x + __ldg(indices + k)), acc);
  }
  // every lane of the warp reaches this: the grid is whole blocks of whole warps
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o, G);
  if (lane == 0 && row < M) y[row] = acc;
}

template <int G>
static int spmv_launch(const int* indptr, const int* indices, const float* data,
                       const float* x, float* y, int M, cudaStream_t stream) {
  const long long threads = (long long)M * G;
  const int blocks = (int)((threads + SPMV_THREADS - 1) / SPMV_THREADS);
  spmv_csr_kernel<G><<<blocks, SPMV_THREADS, 0, stream>>>(indptr, indices, data, x, y, M);
  return (int)cudaGetLastError();
}

// y[r] = sum over k in [indptr[r], indptr[r+1]) of data[k] * x[indices[k]],
// r < M, with G lanes a row.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a G that is not 1, 2, 4, 8, 16 or 32.
extern "C" int spmv_csr(const int* indptr, const int* indices, const float* data,
                        const float* x, float* y, int M, int G, cudaStream_t stream) {
  if (M <= 0) return 0;
  switch (G) {
    case 1: return spmv_launch<1>(indptr, indices, data, x, y, M, stream);
    case 2: return spmv_launch<2>(indptr, indices, data, x, y, M, stream);
    case 4: return spmv_launch<4>(indptr, indices, data, x, y, M, stream);
    case 8: return spmv_launch<8>(indptr, indices, data, x, y, M, stream);
    case 16: return spmv_launch<16>(indptr, indices, data, x, y, M, stream);
    case 32: return spmv_launch<32>(indptr, indices, data, x, y, M, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
