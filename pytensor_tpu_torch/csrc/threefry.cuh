// threefry2x32 and jax's draws from its bits, for the kernels that hash in
// registers: csrc/threefry.cu (one draw a thread) and the loop samplers
// csrc/gamma.cu, csrc/poisson.cu and csrc/binomial.cu (a key chain a
// thread).  Each function is jax's (jax/_src/prng.py:883
// _threefry2x32_lowering, :1156 _threefry_split_foldlike, :1184
// _threefry_random_bits_partitionable; jax/_src/random.py:435 _uniform,
// :867 _normal_real), as tensor/random/threefry.py computes it in torch.
//
// A key is two uint32 words.  Key j of split(key, num) is the hash of the
// counter j; a draw of shape s hashes the counter of each flat index i of
// s as the pair (i >> 32, i & 0xFFFFFFFF).  Every multiply and add of the
// uniforms is rounded on its own (__dmul_rn, __fadd_rn, ...): nvcc would
// otherwise contract them into a fused multiply-add, whose one rounding
// is not jax's two.  The includer brings <cuda_runtime.h> (or the host
// tests' emulation of it) and <stdint.h>.

#pragma once

struct TfKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// (x0, x1) <- threefry2x32((k0, k1), (x0, x1)): 20 rounds of add, rotate
// and xor with the rotations 13, 15, 26, 6 and 17, 29, 16, 24, a key
// injection with k0 ^ k1 ^ 0x1BD11BDA every 4 rounds (Salmon et al. 2011,
// Random123)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[g & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// the hash of the 64-bit counter c under key: key c of a split, or the
// two words behind the draw at flat index c
__device__ __forceinline__ TfKey tf_hash(TfKey key, unsigned long long c) {
  uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
  threefry2x32(key.k0, key.k1, x0, x1);
  return TfKey{x0, x1};
}

// jax's float64 uniform in [lo, hi) from the words (x0, x1): the top 52
// bits of (x0 << 32) | x1 as the mantissa under exponent 1, minus 1, times
// (hi - lo), plus lo, clamped below at lo
__device__ __forceinline__ double uniform64(uint32_t x0, uint32_t x1, double lo, double hi) {
  const uint64_t bits = ((uint64_t)x0 << 32) | x1;
  const double f =
      __longlong_as_double((long long)((bits >> 12) | 0x3FF0000000000000ull)) - 1.0;
  const double u = __dadd_rn(__dmul_rn(f, hi - lo), lo);
  return u > lo ? u : lo;
}

// jax's float32 uniform in [lo, hi) from the 32-bit bits x0 ^ x1
__device__ __forceinline__ float uniform32(uint32_t x0, uint32_t x1, float lo, float hi) {
  const float f = __int_as_float((int)(((x0 ^ x1) >> 9) | 0x3F800000u)) - 1.0f;
  const float u = __fadd_rn(__fmul_rn(f, hi - lo), lo);
  return u > lo ? u : lo;
}

// jax's float64 normal: sqrt(2) * erfinv(u), u the float64 uniform in
// [nextafter(-1, 0), 1) (np.sqrt(2) in float64)
__device__ __forceinline__ double normal64(uint32_t x0, uint32_t x1) {
  const double u = uniform64(x0, x1, -0x1.fffffffffffffp-1, 1.0);
  return __dmul_rn(1.4142135623730951, erfinv(u));
}

// the draws at flat index c of a draw under key, in [0, 1)
__device__ __forceinline__ double tf_uniform64(TfKey key, unsigned long long c) {
  const TfKey b = tf_hash(key, c);
  return uniform64(b.k0, b.k1, 0.0, 1.0);
}
__device__ __forceinline__ float tf_uniform32(TfKey key, unsigned long long c) {
  const TfKey b = tf_hash(key, c);
  return uniform32(b.k0, b.k1, 0.0f, 1.0f);
}
