// What the loop samplers' kernels (csrc/gamma.cu, csrc/poisson.cu,
// csrc/binomial.cu) share: the loops' bound, the block size and launch,
// XLA's saturating conversion of a float to int64, the device-wide
// iteration count of a whole-array loop, and the math functions by
// operand type.  The includer brings <cuda_runtime.h> (or the host tests'
// emulation of it), <stdint.h> and threefry.cuh.
//
// A whole-array rejection loop of jax (PTRS, BTRS) runs until every
// element has accepted, and writes each element's k on every accepting
// pass.  So an element's draw is the k of its last accepting pass before
// the whole array's loop ends, after N passes, where N is one more than
// the largest first-accept pass over the elements.  The kernels find it in
// two launches: pass 1 runs each element to its first accept and takes the
// largest into a device word (loop_count_at_least), pass 2 runs each element on from
// there to pass N - 1 and keeps its last accept.  N never leaves the card,
// so a draw may be captured into a CUDA graph.

#pragma once

// jax bounds its loops by its dtype's largest value; no draw that ends
// comes near this bound (tensor/random/samplers.py MAX_ITERS)
#define LOOP_MAX_ITERS (1 << 16)
#define LOOP_THREADS 256
#define LOOP_MAX_BLOCKS (1 << 20)

#ifndef LOOP_LAUNCH
#define LOOP_LAUNCH(kernel, blocks, stream, ...) \
  kernel<<<blocks, LOOP_THREADS, 0, stream>>>(__VA_ARGS__)
#endif

__host__ __forceinline__ int loop_blocks(long long n) {
  const long long b = (n + LOOP_THREADS - 1) / LOOP_THREADS;
  return (int)(b < LOOP_MAX_BLOCKS ? b : LOOP_MAX_BLOCKS);
}

#define LOOP_FOR_EACH(i, n)                                                              \
  for (long long i = (long long)blockIdx.x * LOOP_THREADS + threadIdx.x; i < (n);      \
       i += (long long)gridDim.x * LOOP_THREADS)

// XLA's float -> int64: toward zero, NaN to 0, out of range to the end
__device__ __forceinline__ long long saturating_int64(double x) {
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return 9223372036854775807LL;
  if (x < -9223372036854775808.0) return (-9223372036854775807LL - 1);
  return (long long)x;
}

// the whole-array loop's pass count N: the largest (first accept + 1);
// a read before the atomic spares most threads the atomic
__device__ __forceinline__ void loop_count_at_least(int* count, int passes) {
  if (passes > *(volatile int*)count) atomicMax(count, passes);
}

// the math functions by operand type: the float forms for float
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_lgamma(float x) { return lgammaf(x); }
__device__ __forceinline__ double m_lgamma(double x) { return lgamma(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }
__device__ __forceinline__ float m_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double m_ceil(double x) { return ceil(x); }
__device__ __forceinline__ float m_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_fabs(double x) { return fabs(x); }
__device__ __forceinline__ bool m_isnan(float x) { return x != x; }
__device__ __forceinline__ bool m_isnan(double x) { return x != x; }

// jax's uniform in [0, 1) of the operand type at flat index c under key
__device__ __forceinline__ float tf_uniform(TfKey key, unsigned long long c, float) {
  return tf_uniform32(key, c);
}
__device__ __forceinline__ double tf_uniform(TfKey key, unsigned long long c, double) {
  return tf_uniform64(key, c);
}

// the key of pass `pass` of a loop whose passes each take key 0 of a
// split of the previous pass's key (Knuth's, PTRS's, BTRS's chains)
__device__ __forceinline__ TfKey chain_key(TfKey key, int pass, int next_at) {
  for (int j = 0; j < pass; ++j) key = tf_hash(key, (unsigned long long)next_at);
  return key;
}
