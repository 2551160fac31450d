// jax's Poisson sampler: Knuth's loop and Hormann's transformed rejection
// (PTRS), with jax's whole-array loop semantics, in two launches.
//
// Replaces no Pallas kernel: the JAX package draws poisson (and
// negative_binomial's Poisson) through jax.random, whose _poisson
// (jax/_src/random.py:1600) XLA runs as two while_loops over the whole
// array, both on the same key, in float32: Knuth's (:1547) for lam < 10 or
// NaN, PTRS (:1572) for the rest, PTRS running the Knuth elements on the
// dummy lam 1e5.  The port's plain version is tensor/random/samplers.py
// poisson_loops (torch ops, a host read a pass); this kernel is two
// launches a draw, with no host read.
//
// Knuth's loop is monotone: an element whose product of uniforms has
// fallen below exp(-lam) never changes again.  So thread i runs its own
// element to its end.  PTRS is not: jax's body writes
// k_out = select(accept, k, k_out) for every element on every pass, until
// the last element has accepted, so an element's draw is its k at its
// last accept within the whole array's N passes (loops.cuh).  Pass 1 runs
// each element's PTRS (on its lam, or on 1e5 for a Knuth element) to its
// first accept, records that pass and the k, and takes the largest pass
// + 1 into N on the card; it also finishes the Knuth elements.  Pass 2
// runs each PTRS element on from its first accept to pass N - 1 and keeps
// its last accept.  Pass j's keys are split(key_j, 3): key_{j+1}, the key
// of the uniforms u and the key of v; each thread rehashes the chain
// rather than reading it.
//
// What bounds it on this card: the threefry hashes.  The draw needs 1 an
// element a Knuth pass (~lam + 1 passes) and 2 a PTRS pass, plus the key
// chain's 2 and 3 a pass for the whole array; each thread here rehashes
// the chain, so it makes 3 and 5.  A PTRS pass adds a log, an lgamma and a
// division, against 12 bytes an element moved.
// State lives in registers; a thread does one atomic at most, after a
// read of N.  Every multiply and add is rounded on its own (built with
// -fmad=false), as the plain version's torch ops round them, and the
// float32 logf, lgammaf and sqrtf are those torch's CUDA ops call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "loops.cuh"

struct Ptrs {
  float lam, log_lam, b, a, inv_alpha, v_r;
};

__device__ __forceinline__ Ptrs ptrs_setup(float lam) {
  Ptrs s;
  s.lam = lam;
  s.log_lam = logf(lam);
  s.b = 0.931f + 2.53f * sqrtf(lam);
  s.a = -0.059f + 0.02483f * s.b;
  s.inv_alpha = 1.1239f + 1.1328f / (s.b - 3.4f);
  s.v_r = 0.9277f - 3.6224f / (s.b - 2.0f);
  return s;
}

// one PTRS pass of element i under the pass's key: whether it accepts,
// and its k
__device__ __forceinline__ bool ptrs_pass(const Ptrs& s, TfKey key, long long i, float& k) {
  const float u = tf_uniform32(tf_hash(key, 1), (unsigned long long)i) - 0.5f;
  const float v = tf_uniform32(tf_hash(key, 2), (unsigned long long)i);
  const float us = 0.5f - fabsf(u);
  k = floorf((2.0f * s.a / us + s.b) * u + s.lam + 0.43f);
  const float lhs = logf(v * s.inv_alpha / (s.a / (us * us) + s.b));
  const float t = -s.lam + k * s.log_lam - lgammaf(k + 1.0f);
  const bool accept1 = (us >= 0.07f) & (v <= s.v_r);
  const bool reject = (k < 0.0f) | ((us < 0.013f) & (v > us));
  return accept1 | (!reject & (lhs <= t));
}

__global__ void __launch_bounds__(LOOP_THREADS)
    poisson_pass1(const long long* __restrict__ key, const float* __restrict__ lam, long long n,
                  long long* __restrict__ out, int* __restrict__ first) {
  const TfKey root{(uint32_t)key[0], (uint32_t)key[1]};
  LOOP_FOR_EACH(i, n) {
    const float l = lam[i];
    const bool use_knuth = (l != l) | (l < 10.0f);
    // PTRS to its first accept, on the dummy 1e5 for a Knuth element
    const Ptrs s = ptrs_setup(use_knuth ? 1e5f : l);
    TfKey kk = root;
    float k = -1.0f;
    int pass = LOOP_MAX_ITERS - 1;
    for (int it = 0; it < LOOP_MAX_ITERS; ++it) {
      float kt;
      if (ptrs_pass(s, kk, i, kt)) {
        k = kt;
        pass = it;
        break;
      }
      kk = tf_hash(kk, 0);
    }
    loop_count_at_least(first + n, pass + 1);
    if (use_knuth) {
      // Knuth's loop on lam (NaN stays at k = 0): rng, subkey = split(rng)
      long long kn = 0;
      float log_prod = 0.0f;
      TfKey rk = root;
      for (int it = 0; it < LOOP_MAX_ITERS && log_prod > -l; ++it) {
        const TfKey sub = tf_hash(rk, 1);
        rk = tf_hash(rk, 0);
        kn += 1;
        log_prod = log_prod + logf(tf_uniform32(sub, (unsigned long long)i));
      }
      out[i] = l == 0.0f ? 0 : kn - 1;
      first[i] = -1;
    } else {
      out[i] = saturating_int64((double)k);
      first[i] = pass;
    }
  }
}

__global__ void __launch_bounds__(LOOP_THREADS)
    poisson_pass2(const long long* __restrict__ key, const float* __restrict__ lam, long long n,
                  long long* __restrict__ out, const int* __restrict__ first) {
  const TfKey root{(uint32_t)key[0], (uint32_t)key[1]};
  const int passes = first[n];
  LOOP_FOR_EACH(i, n) {
    const int from = first[i] + 1;
    if (from <= 0 || from >= passes) continue;
    const Ptrs s = ptrs_setup(lam[i]);
    TfKey kk = chain_key(root, from, 0);
    for (int it = from; it < passes; ++it) {
      float k;
      if (ptrs_pass(s, kk, i, k)) out[i] = saturating_int64((double)k);
      kk = tf_hash(kk, 0);
    }
  }
}

// out[i] <- jax's Poisson draw of lam[i] (float32) under key, on `stream`.
// `first` is scratch of n + 1 int32 (each element's first PTRS accept, or
// -1 for a Knuth element, then N).  `passes` 1 runs pass 1 (after setting
// N to 0), 2 pass 2, 3 both.  Returns cudaGetLastError() after the
// launches.
extern "C" int poisson_draw(const long long* key, const float* lam, long long n, long long* out,
                            int* first, int passes, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = loop_blocks(n);
  if (passes & 1) {
    const int err = (int)cudaMemsetAsync(first + n, 0, sizeof(int), stream);
    if (err != 0) return err;
    LOOP_LAUNCH(poisson_pass1, blocks, stream, key, lam, n, out, first);
  }
  if (passes & 2) LOOP_LAUNCH(poisson_pass2, blocks, stream, key, lam, n, out, first);
  return (int)cudaGetLastError();
}
