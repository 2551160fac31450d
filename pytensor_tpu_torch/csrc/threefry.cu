// threefry2x32: the counter-based hash behind jax.random, bit for bit.
//
// Replaces no Pallas kernel: the JAX package draws through jax.random
// (pytensor_tpu/tensor/random/utils.py:97-121, op.py:200-210), whose
// threefry2x32 XLA runs (jax/_src/prng.py:883 _threefry2x32_lowering, with
// the partitionable counters of prng.py:989 iota_2x32_shape).  The port's
// plain version is tensor/random/threefry.py (int64 torch ops, one launch
// an operation: ~135 of them a draw); this kernel is one launch a draw.
//
// Draw i of n hashes the 64-bit counter c = first + i (the flat index of
// the draw when first is 0, as jax counts) as the pair (c >> 32, c &
// 0xFFFFFFFF) under the key (k0, k1): 20 rounds of add, rotate and xor with
// the rotations 13, 15, 26, 6 and 17, 29, 16, 24, a key injection with
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
// Folded split: given a `split` output, the entry takes a random
// variable's own key and draws under split(key)[1], which each thread
// makes for itself (one hash), and block 0 writes split(key) for the
// wrapper (tf_draw_key, tf_next_key in threefry.cuh): the split that was a
// launch of its own before each draw.
//
// What bounds it on this card (chip_smoke.py phase 18 and PERF.md, H100
// SXM): the hash is 68.25 SASS instructions of 32-bit integer work, 50 on
// the ALU pipe (HASH_PROBE), so at 2**24 draws the ALU pipe alone needs
// 50.2 us and bits32, bits64, uniform64 and uniform32, which write 67-134
// MB, are bound by it (57-62 us, ~0.85 of it); keys writes 268 MB and is
// bound by the bytes (80 us); normal64 adds CUDA's erfinv, ~25
// instructions a draw on the ALU and FP64 pipes (138-141 us).  A rotate
// as a multiply moves the hash's count onto the FMA pipe, but IMAD.WIDE
// issues far below its rate: every round so written made the hash slower.
// The design: the state lives in registers; a wide draw (at least
// THREEFRY_WIDE_N) takes 4 consecutive counters a thread and stores them
// as 16-byte vectors, on a grid cut to the blocks the card holds at once,
// so a thread strides over ~60 draws and the per-draw work around the hash
// is shared; a narrow draw (an HMC step's 89 or 22,784) takes one a
// thread, to spread its latency over the most threads; keys take one a
// thread at any size (16 bytes already, and 32 a thread halve the store's
// coalescing).  A launch keeps the counters' high word, so the counter and
// the index are 32-bit (the C entry cuts a draw at each 2**32 boundary of
// the counter, every 2**31 draws and every 2**30 keys); the mode is a
// template argument, so each variant is a straight line with no branch.
// At the HMC sizes the launch is all there is, and folding the split into
// it halves a random variable's launches.
//
// The key is read on the card, never on the host, so a launch may be
// captured into a CUDA graph while the key changes from replay to replay.
// Built by nvcc (sm_90a) into a shared library with a plain C interface
// and called through ctypes (link/cuda/threefry_kernel.py).  The hash and
// the draws from its bits are threefry.cuh's, which the loop samplers'
// kernels share.  The host test (tests/threefry_host.h) defines
// THREEFRY_LAUNCH, THREEFRY_ROOM and the CUDA intrinsics used here, and
// runs this source under g++.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define THREEFRY_THREADS 256
#define THREEFRY_MAX_BLOCKS (1 << 20)
// a draw of at least this many takes the wide kernel (the host tests set
// it lower, to run the wide kernel at their sizes)
#ifndef THREEFRY_WIDE_N
#define THREEFRY_WIDE_N (1ll << 20)
#endif

#ifndef THREEFRY_LAUNCH
#define THREEFRY_LAUNCH(kernel, blocks, stream, ...) \
  kernel<<<blocks, THREEFRY_THREADS, 0, stream>>>(__VA_ARGS__)
#endif

enum { BITS32 = 0, BITS64 = 1, KEYS = 2, UNIFORM64 = 3, NORMAL64 = 4, UNIFORM32 = 5 };

// the counters a thread takes and whether the grid is cut to the resident
// blocks, by mode, for a wide draw (a narrow one takes one a thread)
template <int MODE>
struct TfPlan {
  static constexpr int per = MODE == KEYS ? 1 : 4;
  static constexpr bool resident = MODE != KEYS && MODE != NORMAL64;
};

// the type each mode writes
template <int MODE> struct TfOut { typedef long long type; };
template <> struct TfOut<UNIFORM64> { typedef double type; };
template <> struct TfOut<NORMAL64> { typedef double type; };
template <> struct TfOut<UNIFORM32> { typedef float type; };

template <typename T, int W>
struct alignas(W * sizeof(T) >= 16 ? 16 : W * sizeof(T)) TfVec {
  T v[W];
};

// v into out[i], ..., out[i + W - 1], those below `end`: vector stores
// where all are in and `aligned` (out's alignment, the same for the grid)
template <typename T, int W>
__device__ __forceinline__ void tf_store(T* __restrict__ out, uint32_t i, uint32_t end,
                                         const TfVec<T, W>& v, bool aligned) {
  if (aligned && end - i >= (uint32_t)W) {
    *reinterpret_cast<TfVec<T, W>*>(out + i) = v;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (i + j < end) out[i + j] = v.v[j];
  }
}

// the draws at the counters (c_hi, c_lo + i), i < n (c_lo + n <= 2**32),
// P consecutive a thread, into out[i] (KEYS: out[2i], out[2i + 1]), under
// key, or under split(key)[1] with split(key) written into `split`
// (tf_draw_key)
template <int MODE, int P>
__global__ void __launch_bounds__(THREEFRY_THREADS)
    threefry_kernel(const long long* __restrict__ key, long long* __restrict__ split,
                    uint32_t c_hi, uint32_t c_lo, uint32_t n, void* __restrict__ out_, double lo,
                    double hi) {
  typedef typename TfOut<MODE>::type T;
  constexpr int W = MODE == KEYS ? 2 * P : P;
  const TfKey k = tf_draw_key(key, split, threadIdx.x == 0);
  // the next key from the last warp, idle in a draw of a few warps
  if (threadIdx.x == THREEFRY_THREADS - 1) tf_next_key(key, split);
  T* out = (T*)out_;
  const bool aligned = ((uintptr_t)out_ & (alignof(TfVec<T, W>) - 1)) == 0;
  const uint32_t stride = gridDim.x * THREEFRY_THREADS * P;
#pragma unroll 1
  for (uint32_t i = (blockIdx.x * THREEFRY_THREADS + threadIdx.x) * P; i < n; i += stride) {
    TfVec<T, W> v;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      uint32_t x0 = c_hi, x1 = c_lo + i + j;
      threefry2x32(k.k0, k.k1, x0, x1);
      if (MODE == BITS32) {
        v.v[j] = (T)(x0 ^ x1);
      } else if (MODE == BITS64) {
        v.v[j] = (T)(((uint64_t)x0 << 32) | x1);
      } else if (MODE == KEYS) {
        v.v[2 * j] = (T)x0;
        v.v[2 * j + 1] = (T)x1;
      } else if (MODE == UNIFORM64) {
        v.v[j] = (T)uniform64(x0, x1, lo, hi);
      } else if (MODE == NORMAL64) {
        v.v[j] = (T)normal64(x0, x1);
      } else {  // UNIFORM32
        v.v[j] = (T)uniform32(x0, x1, (float)lo, (float)hi);
      }
    }
    const uint32_t per = MODE == KEYS ? 2 : 1;
    tf_store<T, W>(out, per * i, per * n, v, aligned);
  }
}

#ifndef THREEFRY_ROOM
// the blocks of `kernel` the card holds at once
template <typename K>
__host__ int threefry_room(K kernel) {
  int per_sm = 0, sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREEFRY_THREADS, 0) !=
          cudaSuccess)
    return THREEFRY_MAX_BLOCKS;
  return per_sm * sms > 0 ? per_sm * sms : THREEFRY_MAX_BLOCKS;
}
#define THREEFRY_ROOM(kernel) threefry_room(kernel)
#endif

// the n draws of MODE, P a thread, at the counters first, first + 1, ...:
// one launch for each run of counters that keeps its high word, at most
// 2**31 draws each (2**30 keys, whose 2**31 words the kernel indexes in
// 32 bits); a folded draw's later launches read the draw key that the
// first wrote into split[2:4].  Returns the launches made, or minus the
// first launch's error.
template <int MODE, int P, bool RESIDENT>
int threefry_launch(const long long* key, long long* split, unsigned long long first,
                    long long n, void* out, double lo, double hi, cudaStream_t stream) {
  const auto kernel = threefry_kernel<MODE, P>;
  const long long width = MODE == KEYS ? 16 : MODE == UNIFORM32 ? 4 : 8;
  const long long per_block = (long long)THREEFRY_THREADS * P;
  long long cap = THREEFRY_MAX_BLOCKS;
  if (RESIDENT) {
    static int room = 0;
    if (room == 0) room = THREEFRY_ROOM(kernel);
    if (room < cap) cap = room;
  }
  int launches = 0;
  for (long long done = 0; done < n; ++launches) {
    const unsigned long long c = first + (unsigned long long)done;
    long long m = (long long)((1ull << 32) - (uint32_t)c);
    if (m > n - done) m = n - done;
    const long long most = MODE == KEYS ? 1ll << 30 : 1ll << 31;
    if (m > most) m = most;
    const long long need = (m + per_block - 1) / per_block;
    const int blocks = (int)(need < cap ? need : cap);
    THREEFRY_LAUNCH(kernel, blocks, stream, key, split, (uint32_t)(c >> 32), (uint32_t)c,
                    (uint32_t)m, (char*)out + done * width, lo, hi);
    const int err = (int)cudaGetLastError();
    if (err != 0) return -err;
    if (split != nullptr) {
      key = split + 2;
      split = nullptr;
    }
    done += m;
  }
  return launches;
}

// the plan of MODE for a draw of n (TfPlan)
template <int MODE>
int threefry_mode(const long long* key, long long* split, unsigned long long first, long long n,
                  void* out, double lo, double hi, cudaStream_t stream) {
  if (n >= THREEFRY_WIDE_N)
    return threefry_launch<MODE, TfPlan<MODE>::per, TfPlan<MODE>::resident>(key, split, first,
                                                                             n, out, lo, hi,
                                                                             stream);
  return threefry_launch<MODE, 1, false>(key, split, first, n, out, lo, hi, stream);
}

// out <- the n draws of MODE at the counters first, first + 1, ... under
// the key at `key` (two int64 on the card, each a uint32), on `stream`;
// with `split` (four int64 on the card) under split(key)[1], a random
// variable's draw key, with split(key) written into `split` (the next key,
// then the draw key).  Returns the launches made (0 for n <= 0), or minus
// the CUDA error (cudaErrorInvalidValue for an unknown mode).
extern "C" int threefry2x32_draw(const long long* key, long long* split, unsigned long long first,
                                 long long n, int mode, void* out, double lo, double hi,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (mode) {
    case BITS32: return threefry_mode<BITS32>(key, split, first, n, out, lo, hi, stream);
    case BITS64: return threefry_mode<BITS64>(key, split, first, n, out, lo, hi, stream);
    case KEYS: return threefry_mode<KEYS>(key, split, first, n, out, lo, hi, stream);
    case UNIFORM64: return threefry_mode<UNIFORM64>(key, split, first, n, out, lo, hi, stream);
    case NORMAL64: return threefry_mode<NORMAL64>(key, split, first, n, out, lo, hi, stream);
    case UNIFORM32: return threefry_mode<UNIFORM32>(key, split, first, n, out, lo, hi, stream);
    default: return -(int)cudaErrorInvalidValue;
  }
}
