// jax's gamma sampler: Marsaglia and Tsang's two nested loops, one element
// a thread, with every split, normal and uniform hashed in registers.
//
// Replaces no Pallas kernel: the JAX package draws gamma, loggamma and the
// distributions built on them (beta, dirichlet, chisquare, invgamma,
// gengamma, t, negative_binomial's gamma) through jax.random, whose
// _gamma_one (jax/_src/random.py:1298) XLA runs as a while_loop vmapped
// over the elements (:1398 _gamma_impl).  The port's plain version is
// tensor/random/samplers.py gamma_loops (torch ops over the whole array,
// a host read a pass); this kernel is one launch a draw, with no host
// read.
//
// Thread i takes element i's key, split(key, n)[i] (the hash of the
// counter i), splits it into the loop's key and the boost's subkey, and
// runs the loops of _gamma_one in float64: the outer loop draws
// (x_key, U_key) from a split into three, the inner loop redraws a normal
// x until v = 1 + x c is positive, and the outer one ends when
// U < 1 - 0.0331 X^2 or log U < X / 2 + d (1 - V + log V) fails (jax's
// test, with X = x^2 and V = v^3).  Alpha below 1 is boosted to alpha + 1
// and the draw scaled by u^(1/alpha) (in log space, log u / alpha).  Its
// elements are independent (vmap), so the draw of element i is the same
// whatever the size of the array: one launch suffices.
//
// What bounds it on this card: the threefry hashes.  An element needs 4
// (its key, its two keys, the boost's uniform), 4 an outer pass (the split
// into three, U; alpha >= 1 accepts ~96% of the passes) and 3 an inner
// pass (the split into two, the normal): ~11, with two logs, an erfinv
// and a pow, against 16 bytes moved.  It runs one thread an element, the state in registers; the
// threads of a warp diverge only where their loops take different counts.
// Every multiply, add and divide is rounded on its own (__dmul_rn,
// __dadd_rn, __ddiv_rn, which nvcc never contracts), as the plain version's
// torch ops round them.  CUDA's erfinv, log, log1p and pow are the
// functions torch's CUDA ops call, built with nvcc's default contraction
// as torch builds them (so not with -fmad=false, which changes pow's bits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "loops.cuh"

__device__ __forceinline__ bool gamma_test(double X, double V, double U, double d) {
  return (U >= __dadd_rn(1.0, -__dmul_rn(0.0331, __dmul_rn(X, X)))) &
         (log(U) >= __dadd_rn(__dmul_rn(X, 0.5),
                              __dmul_rn(d, __dadd_rn(__dadd_rn(1.0, -V), log(V)))));
}

__global__ void __launch_bounds__(LOOP_THREADS)
    gamma_kernel(const long long* __restrict__ key, const double* __restrict__ alpha,
                 long long n, int log_space, double* __restrict__ out) {
  const TfKey root{(uint32_t)key[0], (uint32_t)key[1]};
  const double third = 1.0 / 3.0;
  LOOP_FOR_EACH(i, n) {
    const double a = alpha[i];
    const TfKey ki = tf_hash(root, (unsigned long long)i);
    const bool boost = a >= 1.0;
    const double d = __dadd_rn(boost ? a : __dadd_rn(a, 1.0), -third);
    const double c = __ddiv_rn(third, sqrt(d));
    TfKey kk = tf_hash(ki, 0);
    const TfKey subkey = tf_hash(ki, 1);
    double X = 0.0, V = 1.0, U = 2.0;
    for (int it = 0; it < LOOP_MAX_ITERS && gamma_test(X, V, U, d); ++it) {
      const TfKey x_key = tf_hash(kk, 1), u_key = tf_hash(kk, 2);
      kk = tf_hash(kk, 0);
      TfKey xk = x_key;
      double x = 0.0, v = -1.0;
      for (int jt = 0; jt < LOOP_MAX_ITERS && v <= 0.0; ++jt) {
        const TfKey b = tf_hash(tf_hash(xk, 1), 0);
        xk = tf_hash(xk, 0);
        x = normal64(b.k0, b.k1);
        v = __dadd_rn(1.0, __dmul_rn(x, c));
      }
      X = __dmul_rn(x, x);
      V = __dmul_rn(__dmul_rn(v, v), v);
      U = tf_uniform64(u_key, 0);
    }
    const double u = tf_uniform64(subkey, 0);
    if (log_space) {
      // -exponential(subkey) = -(-log1p(-u))
      const double log_samples = -(-log1p(-u));
      const double log_boost =
          (boost || log_samples == 0.0) ? 0.0 : __dmul_rn(log_samples, __ddiv_rn(1.0, a));
      out[i] = __dadd_rn(__dadd_rn(log(d), log(V)), log_boost);
    } else {
      const double boost_by = boost ? 1.0 : pow(__dadd_rn(1.0, -u), __ddiv_rn(1.0, a));
      out[i] = __dmul_rn(__dmul_rn(d, V), boost_by);
    }
  }
}

// out[i] <- jax's standard gamma (loggamma with log_space) of alpha[i]
// under split(key, n)[i], float64, on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int gamma_draw(const long long* key, const double* alpha, long long n, int log_space,
                          double* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  LOOP_LAUNCH(gamma_kernel, loop_blocks(n), stream, key, alpha, n, log_space, out);
  return (int)cudaGetLastError();
}
