// threefry2x32: the counter-based hash behind jax.random, bit for bit.
//
// Replaces no Pallas kernel: the JAX package draws through jax.random
// (pytensor_tpu/tensor/random/utils.py:97-121, op.py:200-210), whose
// threefry2x32 XLA runs (jax/_src/prng.py:883 _threefry2x32_lowering, with
// the partitionable counters of prng.py:989 iota_2x32_shape).  The port's
// plain version is tensor/random/threefry.py (int64 torch ops, one launch
// an operation: ~135 of them a draw); this kernel is one launch a draw.
//
// Thread i of a launch of n hashes the 64-bit counter c = first + i (the
// flat index of the draw when first is 0, as jax counts) as the pair
// (c >> 32, c & 0xFFFFFFFF) under the key (k0, k1): 20 rounds of add,
// rotate and xor with the rotations 13, 15, 26, 6 and 17, 29, 16, 24, a
// key injection with
// k0 ^ k1 ^ 0x1BD11BDA every 4 rounds (Salmon et al. 2011, Random123).  It
// writes, by MODE:
//   BITS32    the 32-bit bits b1 ^ b2, as int64 (the port holds a uint32
//             in int64: link/torch/convert.py UNSIGNED)
//   BITS64    the 64-bit bits (b1 << 32) | b2, as int64 of the same bits
//   KEYS      the pair (b1, b2) as two int64: a split into n keys
//   UNIFORM64 jax's float64 uniform in [lo, hi) (jax/_src/random.py:435
//             _uniform): the top 52 bits as the mantissa under exponent 1,
//             minus 1, times (hi - lo), plus lo, clamped below at lo
//   NORMAL64  sqrt(2) * erfinv(u), u the UNIFORM64 draw in
//             [nextafter(-1, 0), 1) (random.py:867 _normal_real); CUDA's
//             erfinv is not torch's, so this mode is held to its plain
//             version within a tolerance, not bit for bit
//   UNIFORM32 jax's float32 uniform from the 32-bit bits, as UNIFORM64
// Every multiply and add of the uniforms is rounded on its own
// (__dmul_rn, __dadd_rn): nvcc would otherwise contract them into a fused
// multiply-add, whose one rounding is not jax's two.
//
// What bounds it on this card: the bytes it writes, 8 a draw (16 a key);
// it reads the 16-byte key once a thread (from L1 after the first).  The
// hash is ~117 32-bit integer operations a draw (add, funnel-shift
// rotate, xor), 1.96 G operations at 2**24 draws, against 134 MB written:
// at 3.35 TB/s the bytes take 40 us, so the kernel is a store stream.  The
// design does nothing but that: the state lives in registers, each thread
// writes one coalesced word (two for KEYS), and the mode is a template
// argument, so each variant is a straight line with no branch.  A grid
// of at most 2**20 blocks of 256 threads strides over n.  At the sizes of
// a sampler's step (2 keys, 89 draws) the launch is all there is.
//
// The key is read on the card, never on the host, so a launch may be
// captured into a CUDA graph while the key changes from replay to replay.
// Built by nvcc (sm_90a) into a shared library with a plain C interface
// and called through ctypes (link/cuda/threefry_kernel.py).  The hash and
// the draws from its bits are threefry.cuh's, which the loop samplers'
// kernels share.  The host test (tests/threefry_host.h) defines
// THREEFRY_LAUNCH and the CUDA intrinsics used here, and runs this source
// under g++.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define THREEFRY_THREADS 256
#define THREEFRY_MAX_BLOCKS (1 << 20)

#ifndef THREEFRY_LAUNCH
#define THREEFRY_LAUNCH(kernel, blocks, stream, ...) \
  kernel<<<blocks, THREEFRY_THREADS, 0, stream>>>(__VA_ARGS__)
#endif

enum { BITS32 = 0, BITS64 = 1, KEYS = 2, UNIFORM64 = 3, NORMAL64 = 4, UNIFORM32 = 5 };

template <int MODE>
__global__ void __launch_bounds__(THREEFRY_THREADS)
    threefry_kernel(const long long* __restrict__ key, unsigned long long first, long long n,
                    void* __restrict__ out, double lo, double hi) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const long long stride = (long long)gridDim.x * THREEFRY_THREADS;
  for (long long i = (long long)blockIdx.x * THREEFRY_THREADS + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long c = first + (unsigned long long)i;
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    threefry2x32(k0, k1, x0, x1);
    if (MODE == BITS32) {
      ((long long*)out)[i] = (long long)(x0 ^ x1);
    } else if (MODE == BITS64) {
      ((long long*)out)[i] = (long long)(((uint64_t)x0 << 32) | x1);
    } else if (MODE == KEYS) {
      ((long long*)out)[2 * i] = (long long)x0;
      ((long long*)out)[2 * i + 1] = (long long)x1;
    } else if (MODE == UNIFORM64) {
      ((double*)out)[i] = uniform64(x0, x1, lo, hi);
    } else if (MODE == NORMAL64) {
      ((double*)out)[i] = normal64(x0, x1);
    } else {  // UNIFORM32
      ((float*)out)[i] = uniform32(x0, x1, (float)lo, (float)hi);
    }
  }
}

// out <- the n draws of MODE at the counters first, first + 1, ... under
// the key at `key` (two int64 on the card, each a uint32), on `stream`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an unknown mode.
extern "C" int threefry2x32_draw(const long long* key, unsigned long long first, long long n,
                                 int mode, void* out, double lo, double hi,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  long long b = (n + THREEFRY_THREADS - 1) / THREEFRY_THREADS;
  const int blocks = (int)(b < THREEFRY_MAX_BLOCKS ? b : THREEFRY_MAX_BLOCKS);
#define THREEFRY_CASE(M)                                                              \
  case M:                                                                              \
    THREEFRY_LAUNCH(threefry_kernel<M>, blocks, stream, key, first, n, out, lo, hi); \
    break;
  switch (mode) {
    THREEFRY_CASE(BITS32)
    THREEFRY_CASE(BITS64)
    THREEFRY_CASE(KEYS)
    THREEFRY_CASE(UNIFORM64)
    THREEFRY_CASE(NORMAL64)
    THREEFRY_CASE(UNIFORM32)
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
