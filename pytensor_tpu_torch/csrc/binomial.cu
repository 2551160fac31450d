// jax's binomial sampler: the inversion loop and BTRS, with jax's
// whole-array loop semantics, in the three phases of csrc/loops.cuh.
//
// Replaces no Pallas kernel: the JAX package draws binomial, betabinom's
// binomial and each category of multinomial through jax.random, whose
// _binomial (jax/_src/random.py:2781) XLA runs as two while_loops over the
// whole array on the same key, in the probability's float dtype: the
// inversion loop (:2707) where count * q <= 10 (q = min(p, 1 - p)) or the
// count is NaN or negative, BTRS (:2734) for the rest, BTRS running the
// inversion elements on the dummy count 1e4 and q 0.5.  The port's plain
// version is tensor/random/samplers.py binomial_loops (torch ops, a host
// read a pass); this kernel draws with no host read.
//
// Phase A runs each inversion element's loop to its end (the loop is
// monotone) and each BTRS element to its first accept, taken into N;
// phase B, only where some element takes BTRS, runs BTRS on the dummy
// parameters for each inversion element where it can raise N; phase C,
// the same, searches each BTRS element's passes from N - 1 down for its
// last accept.  Then jax's edges: NaN for a NaN or
// negative q or count, inf for an infinite count, and count - k where
// p > 0.5.  The inversion chain is subkey, key = split(key); BTRS's is
// key, u's key, v's key = split(key, 3): two tables of pass keys a block.
//
// T is the probability's dtype, the type of every operation; O the draw's:
// jax's dtype argument (float64, or T under multinomial), or int64 for the
// binomial random variables, whose float64 draw XLA casts to int64
// (saturating_int64, written here so that no cast follows the kernel).
//
// What bounds it: not the threefry hashes the draw needs (1 an element an
// inversion pass, ~count q + 1 passes; 2 a BTRS pass, up to an element's
// first accept and from its last to N - 1; the chains' 2 and 3 a pass for
// the whole array), but each element's serial chain of passes (a hash, then
// a log; seven logs and four Stirling tails a BTRS pass) and the lanes a
// warp leaves idle while its longest loop runs.  A thread that rehashed the
// chains itself and walked each BTRS element through every pass would make
// 4.3 times those hashes; a dummy search for every inversion element, read
// or not, was most of a Gibbs draw; both loops in every warp and a forward
// walk of each BTRS element to N - 1 left most lanes idle at 2**20
// (PERF.md).  So the chains' keys live in shared memory, phases B and C run
// only where a BTRS element is, accept1 alone settles most dummies, a tile's
// elements are queued by branch and each queue drained (a thread takes the
// next element when its own ends), and a BTRS element's draw is found by a
// search down from N - 1 (csrc/loops.cuh).  Every multiply and add is
// rounded on its own (built with -fmad=false), as the plain version's torch
// ops round them; log, log1p, floor and ceil are the functions torch's CUDA
// ops call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "loops.cuh"

// jax's table of the Stirling tail at k = 0..9 (random.py:2681)
__device__ const double kStirlingTail[10] = {
    0.0810614667953272,  0.0413406959554092,  0.0276779256849983, 0.02079067210376509,
    0.0166446911898211,  0.0138761288230707,  0.0118967099458917, 0.0104112652619720,
    0.00925546218271273, 0.00833056343336287};

// jax's _stirling_approx_tail: the table at k <= 9, else its formula at k
// clamped to [0, 9] (NaN stays NaN)
template <typename T>
__device__ __forceinline__ T stirling_tail(T k) {
  const T kc = k < T(0) ? T(0) : (k > T(9) ? T(9) : k);
  if (k <= T(9)) return (T)kStirlingTail[(int)m_floor(kc)];
  const T kp1sq = (kc + T(1)) * (kc + T(1));
  return (T(1.0 / 12) - (T(1.0 / 360) - T(1.0 / 1260) / kp1sq) / kp1sq) / (kc + T(1));
}

// an element's parameters and jax's flags
template <typename T>
struct Binom {
  bool p_lt_half, count_nan_or_neg, count_inf, q_is_nan, q_l_0, use_inversion;
  T q, count;
};

template <typename T>
__device__ __forceinline__ Binom<T> binom_setup(T count, T prob) {
  Binom<T> s;
  s.p_lt_half = prob < T(0.5);
  T q = s.p_lt_half ? prob : T(1) - prob;
  s.count_nan_or_neg = m_isnan(count) | (count < T(0));
  s.count_inf = m_fabs(count) == T(INFINITY);
  s.q_is_nan = m_isnan(q);
  s.q_l_0 = q < T(0);
  s.q = (s.q_is_nan | s.q_l_0) ? T(0.01) : q;
  s.use_inversion = s.count_nan_or_neg | (count * s.q <= T(10));
  s.count = m_floor(count);
  return s;
}

// BTRS's constants of one element (random.py:2734)
template <typename T>
struct Btrs {
  T count, prob, b, a, c, v_r, r, alpha, m, tail_m;
};

template <typename T>
__device__ __forceinline__ Btrs<T> btrs_setup(T count, T prob) {
  Btrs<T> s;
  s.count = count;
  s.prob = prob;
  const T stddev = m_sqrt(count * prob * (T(1) - prob));
  s.b = T(1.15) + T(2.53) * stddev;
  s.a = T(-0.0873) + T(0.0248) * s.b + T(0.01) * prob;
  s.c = count * prob + T(0.5);
  s.v_r = T(0.92) - T(4.2) / s.b;
  s.r = prob / (T(1) - prob);
  s.alpha = (T(2.83) + T(5.1) / s.b) * stddev;
  s.m = m_floor((count + T(1)) * prob);
  s.tail_m = stirling_tail(s.m);
  return s;
}

// BTRS's first test alone of element i under a pass's u and v keys (the
// same arithmetic as btrs_pass's): whether it accepts without a log
template <typename T>
__device__ __forceinline__ bool btrs_accept1(const Btrs<T>& s, TfKey ku, TfKey kv, long long i) {
  const T u = tf_uniform(ku, (unsigned long long)i, T(0)) - T(0.5);
  const T v0 = tf_uniform(kv, (unsigned long long)i, T(0));
  return (T(0.5) - m_fabs(u) >= T(0.07)) & (v0 <= s.v_r);
}

// one BTRS pass of element i under the pass's u and v keys: whether it
// accepts, and its k
template <typename T>
__device__ __forceinline__ bool btrs_pass(const Btrs<T>& s, TfKey ku, TfKey kv, long long i,
                                          T& k) {
  const T u = tf_uniform(ku, (unsigned long long)i, T(0)) - T(0.5);
  const T v0 = tf_uniform(kv, (unsigned long long)i, T(0));
  const T us = T(0.5) - m_fabs(u);
  const bool accept1 = (us >= T(0.07)) & (v0 <= s.v_r);
  k = m_floor((T(2) * s.a / us + s.b) * u + s.c);
  const bool reject = (k < T(0)) | (k > s.count);
  const T v = m_log(v0 * s.alpha / (s.a / (us * us) + s.b));
  const T n = s.count, m = s.m;
  const T ub = (m + T(0.5)) * m_log((m + T(1)) / (s.r * (n - m + T(1)))) +
               (n + T(1)) * m_log((n - m + T(1)) / (n - k + T(1))) +
               (k + T(0.5)) * m_log(s.r * (n - k + T(1)) / (k + T(1))) + s.tail_m +
               stirling_tail(n - m) - stirling_tail(k) - stirling_tail(n - k);
  return accept1 | (!reject & (v <= ub));
}

// the float64 draw behind an int64 one (XLA's cast after it), else the draw
template <typename O>
struct Wide {
  typedef O W;
};
template <>
struct Wide<long long> {
  typedef double W;
};
template <typename O>
__device__ __forceinline__ O store_as(double draw) {
  return (O)draw;
}
template <>
__device__ __forceinline__ long long store_as<long long>(double draw) {
  return saturating_int64(draw);
}

// jax's edges on the draw k (in W) of an element
template <typename T, typename W>
__device__ __forceinline__ W binom_finish(const Binom<T>& s, W k) {
  const bool invalid = s.q_l_0 | s.q_is_nan | s.count_nan_or_neg;
  W out = invalid ? W(NAN) : k;
  out = (s.count_inf & !invalid) ? W(INFINITY) : out;
  return (s.p_lt_half | s.count_nan_or_neg | s.q_is_nan | s.count_inf) ? out
                                                                        : (W)s.count - out;
}

// a tile's queues (loop_queue) and the tables, in shared memory
template <typename T>
struct BinomShared {
  PassKeys keys[2];  // 0: the inversion loop's chain, 1: BTRS's
  int offset[LOOP_QUEUE];
  T count[LOOP_QUEUE], prob[LOOP_QUEUE];
  int counts[2][4][LOOP_WARPS];
  int next[2];
  int go;
};

// the queued elements' loops, for loop_drain: the inversion loop to its
// end (LOOP_OWN, phase A), BTRS forward to the first accept (LOOP_FIRST,
// phase A) and down from N - 1 to the last accept (LOOP_LAST, phase C)
template <typename T, typename O>
struct BinomDrain {
  typedef typename Wide<O>::W W;
  const BinomShared<T>& sh;
  long long base;
  O* out;
  int* state;
  int mode, slot, hashes, top, pass, first;
  long long i;
  Binom<T> s;
  T log1minusprob, num_geom, geom_sum;
  Btrs<T> bt;
  W k;

  __device__ BinomDrain(const BinomShared<T>& sh, long long base, O* out, int* state, int mode,
                        int top = 0)
      : sh(sh), base(base), out(out), state(state), mode(mode),
        slot(mode == LOOP_OWN ? S_OWN : S_REJECT), hashes(mode == LOOP_OWN ? 1 : 2), top(top) {}
  __device__ void start(int q) {
    i = base + sh.offset[q];
    s = binom_setup(sh.count[q], sh.prob[q]);
    if (mode == LOOP_OWN) {
      log1minusprob = m_log1p(-s.q);
      num_geom = geom_sum = T(0);
      pass = 0;
    } else {
      bt = btrs_setup(s.count, s.q);
      first = -1;
      k = W(-1);
      pass = mode == LOOP_FIRST ? 0 : top;
    }
  }
  __device__ bool live() const {
    if (mode == LOOP_OWN) return geom_sum <= s.count && pass < LOOP_MAX_ITERS;
    return first < 0 && pass >= 0 && pass < LOOP_MAX_ITERS;
  }
  __device__ void step(TfKey s0, TfKey s1) {
    if (mode == LOOP_OWN) {
      num_geom = num_geom + T(1);
      const T u = tf_uniform(s0, (unsigned long long)i, T(0));
      geom_sum = geom_sum + m_ceil(m_log(u) / log1minusprob);
      ++pass;
      return;
    }
    T kt;
    if (btrs_pass(bt, s0, s1, i, kt)) {
      first = pass;
      k = (W)kt;
    } else {
      pass += mode == LOOP_FIRST ? 1 : -1;
    }
  }
  __device__ void finish() {
    if (mode == LOOP_OWN)
      out[i] = store_as<O>(binom_finish(s, (W)(num_geom - T(1))));
    else if (mode == LOOP_FIRST)
      loop_count_at_least(state + LOOP_STATE_N, first < 0 ? LOOP_MAX_ITERS : first + 1);
    else
      out[i] = store_as<O>(binom_finish(s, k));
  }
};


template <typename T, typename O>
__global__ void __launch_bounds__(LOOP_THREADS)
    binomial_kernel(const long long* __restrict__ key, long long* __restrict__ split,
                    const T* __restrict__ count, const T* __restrict__ prob, long long n,
                    O* __restrict__ out, int* __restrict__ state) {
  const int warp = threadIdx.x >> 5;
  __shared__ BinomShared<T> sh;
  LOOP_STAMP_BEGIN;
  if (threadIdx.x == 0) {
    const TfKey root = tf_draw_key(key, split, true);
    keys_init(sh.keys[0], root, 1, 1, 0, 0);
    keys_init(sh.keys[1], root, 0, 2, 1, 2);
  }
  if (threadIdx.x == 32) tf_next_key(key, split);
  __syncthreads();
  keys_start(sh.keys, 2 LOOP_STAMPS_ARG);
  const int spread = loop_spread(n), tile = spread * LOOP_THREADS;
  // a queued element: its offset in the tile and its parameters
  const auto store = [&](long long base, long long i, int at) {
    sh.offset[at] = (int)(i - base);
    sh.count[at] = count[i];
    sh.prob[at] = prob[i];
  };
  LOOP_FOR_EACH_TILE(base, tile, n) {
    // the inversion elements to queue A, the BTRS elements to queue B
    const LoopQueue q = loop_queue(
        sh.counts, base, n, spread,
        [&](long long i, int& need) {
          const Binom<T> s = binom_setup(count[i], prob[i]);
          // an inversion element's passes are at most floor(count) + 1
          need = !s.use_inversion ? LOOP_FIRST_NEED
                                  : loop_need(s.count_nan_or_neg ? T(-1) : s.count * s.q,
                                              s.count + T(1));
          return s.use_inversion ? 1 : 2;
        },
        [&](long long i, int at) { store(base, i, at); });
    if (threadIdx.x == 0) {
      loop_tile_grouped(state, q.b > 0);
      sh.next[0] = 0;
      sh.next[1] = LOOP_QUEUE - q.b;
    }
    if (warp < 2) keys_extend(sh.keys[warp], q.need[warp] LOOP_STAMPS_ARG);
    __syncthreads();
    LOOP_STAMP(S_REST);
    BinomDrain<T, O> inversion(sh, base, out, state, LOOP_OWN);
    loop_drain(&sh.next[0], q.a, sh.keys[0], inversion LOOP_STAMPS_ARG);
    BinomDrain<T, O> first(sh, base, out, state, LOOP_FIRST);
    loop_drain(&sh.next[1], LOOP_QUEUE, sh.keys[1], first LOOP_STAMPS_ARG);
    __syncthreads();
  }
  // phases B and C only where some tile has a BTRS element
  if (loop_rejection_anywhere(state, n, tile, &sh.go)) {
    // the dummy parameters' first accepts, where they can raise N above
    // the N known now (phase A's, or part of it): an accept1 (no log) at a
    // pass below it means a first accept no later, so only a dummy with
    // none runs BTRS to its first accept
    const Btrs<T> dummy = btrs_setup(T(1e4), T(0.5));
    const int known = loop_state(state, LOOP_STATE_N);
    if (warp == 1) keys_extend(sh.keys[1], known LOOP_STAMPS_ARG);
    __syncthreads();
    LOOP_STAMP(S_CHAIN);
    LOOP_FOR_EACH(i, n) {
      if (!binom_setup(count[i], prob[i]).use_inversion) continue;
      TfKey ku, kv;
      int t = 0;
      for (; t < known; ++t) {
        keys_at(sh.keys[1], t, ku, kv);
        LOOP_COUNT(C_DUMMY, 1);
        LOOP_COUNT(C_HASHES, 2);
        if (btrs_accept1(dummy, ku, kv, i)) break;
      }
      if (t == known) {
        for (t = 0; t < LOOP_MAX_ITERS; ++t) {
          keys_at(sh.keys[1], t, ku, kv);
          T k;
          LOOP_COUNT(C_DUMMY, 1);
          LOOP_COUNT(C_HASHES, 2);
          if (btrs_pass(dummy, ku, kv, i, k)) break;
        }
        loop_count_at_least(state + LOOP_STATE_N, t < LOOP_MAX_ITERS ? t + 1 : LOOP_MAX_ITERS);
      }
    }
    LOOP_STAMP(S_DUMMY);
    loop_grid_sync(state);
    // each BTRS element's last accept before pass N, searched down from
    // N - 1 on the BTRS chain's table, built to N first
    const int passes = loop_state(state, LOOP_STATE_N);
    if (warp == 1) keys_extend(sh.keys[1], passes LOOP_STAMPS_ARG);
    __syncthreads();
    LOOP_STAMP(S_CHAIN);
    LOOP_FOR_EACH_TILE(base, tile, n) {
      const LoopQueue q = loop_queue(
          sh.counts, base, n, spread,
          [&](long long i, int&) { return binom_setup(count[i], prob[i]).use_inversion ? 0 : 1; },
          [&](long long i, int at) { store(base, i, at); });
      if (threadIdx.x == 0) sh.next[0] = 0;
      __syncthreads();
      LOOP_STAMP(S_REST);
      BinomDrain<T, O> last(sh, base, out, state, LOOP_LAST, passes - 1);
      loop_drain(&sh.next[0], q.a, sh.keys[1], last LOOP_STAMPS_ARG);
      __syncthreads();
    }
  }
  LOOP_STAMP_END;
}

template <typename T, typename O>
int binomial_launch(const long long* key, long long* split, const void* count, const void* prob,
                    long long n, void* out, int* state, cudaStream_t stream) {
  const auto kernel = binomial_kernel<T, O>;
  const T* c = (const T*)count;
  const T* p = (const T*)prob;
  int err = (int)cudaMemsetAsync(state, 0, LOOP_STATE_WORDS * sizeof(int), stream);
  if (err == 0) err = LOOP_COOP_LAUNCH(kernel, n, stream, key, split, c, p, n, (O*)out, state);
  return err != 0 ? err : (int)cudaGetLastError();
}

// out[i] <- jax's binomial draw of count[i] trials of prob[i] under key, on
// `stream`, as one cooperative launch; with `split` (four int64 on the
// card) under split(key)[1], a random variable's draw key, with split(key)
// written into `split` (the next key, then the draw key; tf_draw_key).
// count and prob are float32 (`wide` 0) or float64 (`wide` 1); out is
// float32 (`out_kind` 0), float64 (1) or int64 (2, the float64 draw cast
// as XLA casts it).  `state` is scratch of LOOP_STATE_WORDS int32 (N,
// phase A's record, the grid barrier's), set to 0 first.  Returns the
// launch's error, or cudaErrorInvalidValue for float64 probabilities with
// a float32 draw or an unknown out_kind.
extern "C" int binomial_draw(const long long* key, long long* split, const void* count,
                             const void* prob, long long n, int wide, int out_kind, void* out,
                             int* state, cudaStream_t stream) {
  if (n <= 0) return 0;
  if ((wide && out_kind == 0) || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (out_kind == 2)
    return wide ? binomial_launch<double, long long>(key, split, count, prob, n, out, state,
                                                     stream)
                : binomial_launch<float, long long>(key, split, count, prob, n, out, state,
                                                    stream);
  if (out_kind == 1)
    return wide ? binomial_launch<double, double>(key, split, count, prob, n, out, state, stream)
                : binomial_launch<float, double>(key, split, count, prob, n, out, state, stream);
  return binomial_launch<float, float>(key, split, count, prob, n, out, state, stream);
}
