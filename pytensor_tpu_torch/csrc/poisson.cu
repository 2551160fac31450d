// jax's Poisson sampler: Knuth's loop and Hormann's transformed rejection
// (PTRS), with jax's whole-array loop semantics, in the three phases of
// csrc/loops.cuh.
//
// Replaces no Pallas kernel: the JAX package draws poisson (and
// negative_binomial's Poisson) through jax.random, whose _poisson
// (jax/_src/random.py:1600) XLA runs as two while_loops over the whole
// array, both on the same key, in float32: Knuth's (:1547) for lam < 10 or
// NaN, PTRS (:1572) for the rest, PTRS running the Knuth elements on the
// dummy lam 1e5.  The port's plain version is tensor/random/samplers.py
// poisson_loops (torch ops, a host read a pass); this kernel draws with no
// host read.
//
// Phase A runs each Knuth element's loop to its end (the loop is
// monotone: an element whose product of uniforms has fallen below
// exp(-lam) never changes again) and each PTRS element to its first
// accept, taken into N; phase B, only where some element takes PTRS, runs
// PTRS on the dummy lam for each Knuth element where it can raise N;
// phase C, the same, searches each PTRS element's passes from N - 1 down
// for its last accept, its draw.  Both loops walk one chain:
// pass j's keys are split(key_j, 3), key_{j+1} and the keys of u and v,
// and Knuth's rng, subkey = split(rng) takes the same key_{j+1} and u's
// key.  So a block keeps one table of pass keys.
//
// What bounds it: not the threefry hashes the draw needs (1 an element a
// Knuth pass, ~lam + 1 passes; 2 a PTRS pass, up to an element's first
// accept and from its last to N - 1; the chain's 3 a pass for the whole
// array), but each element's serial chain of passes (a hash, then a log; a
// log, an lgamma and a division a PTRS pass) and the lanes a warp leaves
// idle while its longest loop runs.  A thread that rehashed the chain itself
// and walked each PTRS element through every pass would make 5.7 times those
// hashes; a dummy search for every Knuth element, both loops in every warp
// and a forward walk of each PTRS element to N - 1 left most lanes idle
// (PERF.md).  So the chain's keys live in shared memory, phases B and C run
// only where a PTRS element is, accept1 alone settles most dummies, a tile's
// elements are queued by branch and each queue drained (a thread takes the
// next element when its own ends), and a PTRS element's draw is found by a
// search down from N - 1 (csrc/loops.cuh).  Every multiply and add is
// rounded on its own (built with -fmad=false), as the plain version's torch
// ops round them, and the float32 logf, lgammaf and sqrtf are those torch's
// CUDA ops call.

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

// one PTRS pass of element i under the pass's u and v keys: whether it
// accepts, and its k
__device__ __forceinline__ bool ptrs_pass(const Ptrs& s, TfKey ku, TfKey kv, long long i,
                                          float& k) {
  const float u = tf_uniform32(ku, (unsigned long long)i) - 0.5f;
  const float v = tf_uniform32(kv, (unsigned long long)i);
  const float us = 0.5f - fabsf(u);
  k = floorf((2.0f * s.a / us + s.b) * u + s.lam + 0.43f);
  const float lhs = logf(v * s.inv_alpha / (s.a / (us * us) + s.b));
  const float t = -s.lam + k * s.log_lam - lgammaf(k + 1.0f);
  const bool accept1 = (us >= 0.07f) & (v <= s.v_r);
  const bool reject = (k < 0.0f) | ((us < 0.013f) & (v > us));
  return accept1 | (!reject & (lhs <= t));
}

// PTRS's first test alone of element i under a pass's u and v keys (the
// same arithmetic as ptrs_pass's): whether it accepts without a log
__device__ __forceinline__ bool ptrs_accept1(const Ptrs& s, TfKey ku, TfKey kv, long long i) {
  const float u = tf_uniform32(ku, (unsigned long long)i) - 0.5f;
  const float v = tf_uniform32(kv, (unsigned long long)i);
  return (0.5f - fabsf(u) >= 0.07f) & (v <= s.v_r);
}

// a tile's queues (loop_queue) and the table, in shared memory
struct PoissonShared {
  PassKeys keys;
  int offset[LOOP_QUEUE];
  float lam[LOOP_QUEUE];
  int counts[2][4][LOOP_WARPS];
  int next[2];
  int go;
};

// the queued elements' loops, for loop_drain: Knuth's loop to its end
// (LOOP_OWN, phase A; NaN stays at k = 0), PTRS forward to the first
// accept (LOOP_FIRST, phase A) and down from N - 1 to the last accept
// (LOOP_LAST, phase C)
struct PoissonDrain {
  const PoissonShared& sh;
  long long base;
  long long* out;
  int* state;
  int mode, slot, hashes, top, pass, first;
  long long i, k;
  float lam, log_prod, kt;
  Ptrs pt;

  __device__ PoissonDrain(const PoissonShared& sh, long long base, long long* out, int* state,
                          int mode, int top = 0)
      : sh(sh), base(base), out(out), state(state), mode(mode),
        slot(mode == LOOP_OWN ? S_OWN : S_REJECT), hashes(mode == LOOP_OWN ? 1 : 2), top(top) {}
  __device__ void start(int q) {
    i = base + sh.offset[q];
    lam = sh.lam[q];
    if (mode == LOOP_OWN) {
      k = 0;
      log_prod = 0.0f;
      pass = 0;
    } else {
      pt = ptrs_setup(lam);
      first = -1;
      kt = -1.0f;
      pass = mode == LOOP_FIRST ? 0 : top;
    }
  }
  __device__ bool live() const {
    if (mode == LOOP_OWN) return log_prod > -lam && pass < LOOP_MAX_ITERS;
    return first < 0 && pass >= 0 && pass < LOOP_MAX_ITERS;
  }
  __device__ void step(TfKey s0, TfKey s1) {
    if (mode == LOOP_OWN) {
      k += 1;
      log_prod = log_prod + logf(tf_uniform32(s0, (unsigned long long)i));
      ++pass;
      return;
    }
    float kp;
    if (ptrs_pass(pt, s0, s1, i, kp)) {
      first = pass;
      kt = kp;
    } else {
      pass += mode == LOOP_FIRST ? 1 : -1;
    }
  }
  __device__ void finish() {
    if (mode == LOOP_OWN)
      out[i] = lam == 0.0f ? 0 : k - 1;
    else if (mode == LOOP_FIRST)
      loop_count_at_least(state + LOOP_STATE_N, first < 0 ? LOOP_MAX_ITERS : first + 1);
    else
      out[i] = saturating_int64((double)kt);
  }
};

__device__ __forceinline__ bool use_knuth(float lam) { return (lam != lam) | (lam < 10.0f); }

__global__ void __launch_bounds__(LOOP_THREADS)
    poisson_kernel(const long long* __restrict__ key, long long* __restrict__ split,
                   const float* __restrict__ lam, long long n, long long* __restrict__ out,
                   int* __restrict__ state) {
  __shared__ PoissonShared sh;
  LOOP_STAMP_BEGIN;
  if (threadIdx.x == 0) keys_init(sh.keys, tf_draw_key(key, split, true), 0, 2, 1, 2);
  if (threadIdx.x == 32) tf_next_key(key, split);
  __syncthreads();
  keys_start(&sh.keys, 1 LOOP_STAMPS_ARG);
  const int spread = loop_spread(n), tile = spread * LOOP_THREADS;
  // a queued element: its offset in the tile and its lam
  const auto store = [&](long long base, long long i, int at) {
    sh.offset[at] = (int)(i - base);
    sh.lam[at] = lam[i];
  };
  LOOP_FOR_EACH_TILE(base, tile, n) {
    // Knuth's elements to queue A, the PTRS elements to queue B
    const LoopQueue q = loop_queue(
        sh.counts, base, n, spread,
        [&](long long i, int& need) {
          const float l = lam[i];
          need = use_knuth(l) ? loop_need(l, float(LOOP_TABLE)) : LOOP_FIRST_NEED;
          return use_knuth(l) ? 1 : 2;
        },
        [&](long long i, int at) { store(base, i, at); });
    if (threadIdx.x == 0) {
      loop_tile_grouped(state, q.b > 0);
      sh.next[0] = 0;
      sh.next[1] = LOOP_QUEUE - q.b;
    }
    // both loops walk the one chain
    if (threadIdx.x < 32)
      keys_extend(sh.keys, q.need[0] > q.need[1] ? q.need[0] : q.need[1] LOOP_STAMPS_ARG);
    __syncthreads();
    LOOP_STAMP(S_REST);
    PoissonDrain knuth(sh, base, out, state, LOOP_OWN);
    loop_drain(&sh.next[0], q.a, sh.keys, knuth LOOP_STAMPS_ARG);
    PoissonDrain first(sh, base, out, state, LOOP_FIRST);
    loop_drain(&sh.next[1], LOOP_QUEUE, sh.keys, first LOOP_STAMPS_ARG);
    __syncthreads();
  }
  // phases B and C only where some tile has a PTRS element
  if (loop_rejection_anywhere(state, n, tile, &sh.go)) {
    // the dummy lam's first accepts, where they can raise N above the N
    // known now (phase A's, or part of it): an accept1 (no log) at a pass
    // below it means a first accept no later, so only a dummy with none
    // runs PTRS to its first accept
    const Ptrs dummy = ptrs_setup(1e5f);
    const int known = loop_state(state, LOOP_STATE_N);
    if (threadIdx.x < 32) keys_extend(sh.keys, known LOOP_STAMPS_ARG);
    __syncthreads();
    LOOP_STAMP(S_CHAIN);
    LOOP_FOR_EACH(i, n) {
      if (!use_knuth(lam[i])) continue;
      TfKey ku, kv;
      int t = 0;
      for (; t < known; ++t) {
        keys_at(sh.keys, t, ku, kv);
        LOOP_COUNT(C_DUMMY, 1);
        LOOP_COUNT(C_HASHES, 2);
        if (ptrs_accept1(dummy, ku, kv, i)) break;
      }
      if (t == known) {
        for (t = 0; t < LOOP_MAX_ITERS; ++t) {
          keys_at(sh.keys, t, ku, kv);
          float k;
          LOOP_COUNT(C_DUMMY, 1);
          LOOP_COUNT(C_HASHES, 2);
          if (ptrs_pass(dummy, ku, kv, i, k)) break;
        }
        loop_count_at_least(state + LOOP_STATE_N, t < LOOP_MAX_ITERS ? t + 1 : LOOP_MAX_ITERS);
      }
    }
    LOOP_STAMP(S_DUMMY);
    loop_grid_sync(state);
    // each PTRS element's last accept before pass N, searched down from
    // N - 1 on the table, built to N first
    const int passes = loop_state(state, LOOP_STATE_N);
    if (threadIdx.x < 32) keys_extend(sh.keys, passes LOOP_STAMPS_ARG);
    __syncthreads();
    LOOP_STAMP(S_CHAIN);
    LOOP_FOR_EACH_TILE(base, tile, n) {
      const LoopQueue q = loop_queue(
          sh.counts, base, n, spread, [&](long long i, int&) { return use_knuth(lam[i]) ? 0 : 1; },
          [&](long long i, int at) { store(base, i, at); });
      if (threadIdx.x == 0) sh.next[0] = 0;
      __syncthreads();
      LOOP_STAMP(S_REST);
      PoissonDrain last(sh, base, out, state, LOOP_LAST, passes - 1);
      loop_drain(&sh.next[0], q.a, sh.keys, last LOOP_STAMPS_ARG);
      __syncthreads();
    }
  }
  LOOP_STAMP_END;
}

// out[i] <- jax's Poisson draw of lam[i] (float32) under key, on `stream`,
// as one cooperative launch; with `split` (four int64 on the card) under
// split(key)[1], a random variable's draw key, with split(key) written
// into `split` (the next key, then the draw key; tf_draw_key).  `state` is
// scratch of LOOP_STATE_WORDS int32 (N, phase A's record, the grid
// barrier's), set to 0 first.  Returns the launch's error.
extern "C" int poisson_draw(const long long* key, long long* split, const float* lam, long long n,
                            long long* out, int* state, cudaStream_t stream) {
  if (n <= 0) return 0;
  int err = (int)cudaMemsetAsync(state, 0, LOOP_STATE_WORDS * sizeof(int), stream);
  if (err == 0) err = LOOP_COOP_LAUNCH(poisson_kernel, n, stream, key, split, lam, n, out, state);
  return err != 0 ? err : (int)cudaGetLastError();
}
