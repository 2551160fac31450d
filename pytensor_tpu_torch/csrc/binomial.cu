// jax's binomial sampler: the inversion loop and BTRS, with jax's
// whole-array loop semantics, in two launches.
//
// Replaces no Pallas kernel: the JAX package draws binomial, betabinom's
// binomial and each category of multinomial through jax.random, whose
// _binomial (jax/_src/random.py:2781) XLA runs as two while_loops over the
// whole array on the same key, in the probability's float dtype: the
// inversion loop (:2707) where count * q <= 10 (q = min(p, 1 - p)) or the
// count is NaN or negative, BTRS (:2734) for the rest, BTRS running the
// inversion elements on the dummy count 1e4 and q 0.5.  The port's plain
// version is tensor/random/samplers.py binomial_loops (torch ops, a host
// read a pass); this kernel is two launches a draw, with no host read.
//
// The inversion loop is monotone (an element whose sum of geometric draws
// has passed its count never changes again), so thread i runs its own
// element to its end.  BTRS is not: jax's body writes
// k_out = select(accept, k, k_out) for every element on every pass, until
// the last element has accepted, so an element's draw is its k at its
// last accept within the whole array's N passes (loops.cuh).  Pass 1 runs
// each element's BTRS (on its count and q, or on the dummy ones) to its
// first accept, records that pass and the k, takes the largest pass + 1
// into N on the card, and finishes the inversion elements; pass 2 runs
// each BTRS element on to pass N - 1, keeps its last accept and writes the
// draw.  Where no element takes BTRS (the Gibbs chain's binomial(1, p)),
// pass 2's threads all return at once.  Then jax's edges: NaN for a NaN or
// negative q or count, inf for an infinite count, and count - k where
// p > 0.5.  The inversion chain is subkey, key = split(key); BTRS's is
// key, u's key, v's key = split(key, 3); each thread rehashes it.
//
// T is the probability's dtype, the type of every operation; O the draw's:
// jax's dtype argument (float64, or T under multinomial), or int64 for the
// binomial random variables, whose float64 draw XLA casts to int64
// (saturating_int64, written here so that no cast follows the kernel).
//
// What bounds it on this card: the threefry hashes.  The draw needs 1 an
// element an inversion pass (~count q + 1 passes) and 2 a BTRS pass, plus
// the key chain's 2 and 3 a pass for the whole array; each thread here
// rehashes the chain, so it makes 3 and 5.  A pass adds a log (seven logs
// and four Stirling tails for BTRS), against 2 sizeof(T) + sizeof(O) bytes
// an element moved.  Every multiply and add
// is rounded on its own (built with -fmad=false), as the plain version's
// torch ops round them; log, log1p, floor and ceil are the functions
// torch's CUDA ops call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "loops.cuh"

// jax's _stirling_approx_tail (random.py:2681): the table at k <= 9, else
// its formula at k clamped to [0, 9] (NaN stays NaN)
template <typename T>
__device__ __forceinline__ T stirling_tail(T k) {
  const double table[10] = {0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                            0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
                            0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
                            0.00833056343336287};
  const T kc = k < T(0) ? T(0) : (k > T(9) ? T(9) : k);
  if (k <= T(9)) return (T)table[(int)m_floor(kc)];
  const T kp1sq = (kc + T(1)) * (kc + T(1));
  return (T(1.0 / 12) - (T(1.0 / 360) - T(1.0 / 1260) / kp1sq) / kp1sq) / (kc + T(1));
}

// an element's parameters and jax's flags
template <typename T>
struct Binom {
  bool p_lt_half, count_nan_or_neg, count_inf, q_is_nan, q_l_0, use_inversion;
  T q, count, count_btrs, q_btrs;
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
  s.count_btrs = s.use_inversion ? T(1e4) : s.count;
  s.q_btrs = s.use_inversion ? T(0.5) : s.q;
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

// one BTRS pass of element i under the pass's key: whether it accepts,
// and its k
template <typename T>
__device__ __forceinline__ bool btrs_pass(const Btrs<T>& s, TfKey key, long long i, T& k) {
  const T u = tf_uniform(tf_hash(key, 1), (unsigned long long)i, T(0)) - T(0.5);
  const T v0 = tf_uniform(tf_hash(key, 2), (unsigned long long)i, T(0));
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

// an element's slot of out, for a draw of type O: a float draw is stored
// as it is (W = O); an int64 draw is the float64 draw (W = double) cast as
// XLA casts it, and its slot keeps pass 1's k as the double's bits until
// pass 2 finishes it
template <typename O>
struct Slot {
  typedef O W;
  __device__ static O keep(W k) { return k; }
  __device__ static W kept(O v) { return v; }
  __device__ static O store(W draw) { return draw; }
};
template <>
struct Slot<long long> {
  typedef double W;
  __device__ static long long keep(double k) { return __double_as_longlong(k); }
  __device__ static double kept(long long v) { return __longlong_as_double(v); }
  __device__ static long long store(double draw) { return saturating_int64(draw); }
};

// jax's edges on the draw k (in W) of an element
template <typename T, typename W>
__device__ __forceinline__ W binom_finish(const Binom<T>& s, W k) {
  const bool invalid = s.q_l_0 | s.q_is_nan | s.count_nan_or_neg;
  W out = invalid ? W(NAN) : k;
  out = (s.count_inf & !invalid) ? W(INFINITY) : out;
  return (s.p_lt_half | s.count_nan_or_neg | s.q_is_nan | s.count_inf) ? out
                                                                        : (W)s.count - out;
}

template <typename T, typename O>
__global__ void __launch_bounds__(LOOP_THREADS)
    binomial_pass1(const long long* __restrict__ key, const T* __restrict__ count,
                   const T* __restrict__ prob, long long n, O* __restrict__ out,
                   int* __restrict__ first) {
  typedef typename Slot<O>::W W;
  const TfKey root{(uint32_t)key[0], (uint32_t)key[1]};
  LOOP_FOR_EACH(i, n) {
    const Binom<T> s = binom_setup(count[i], prob[i]);
    // BTRS to its first accept, on the dummy parameters for an inversion
    // element
    const Btrs<T> bt = btrs_setup(s.count_btrs, s.q_btrs);
    TfKey kk = root;
    T k = T(-1);
    int pass = LOOP_MAX_ITERS - 1;
    for (int it = 0; it < LOOP_MAX_ITERS; ++it) {
      T kt;
      if (btrs_pass(bt, kk, i, kt)) {
        k = kt;
        pass = it;
        break;
      }
      kk = tf_hash(kk, 0);
    }
    loop_count_at_least(first + n, pass + 1);
    if (s.use_inversion) {
      // the inversion loop on (count, q): subkey, key = split(key)
      const T log1minusprob = m_log1p(-s.q);
      T num_geom = T(0), geom_sum = T(0);
      TfKey ik = root;
      for (int it = 0; it < LOOP_MAX_ITERS && geom_sum <= s.count; ++it) {
        const TfKey sub = tf_hash(ik, 0);
        ik = tf_hash(ik, 1);
        num_geom = num_geom + T(1);
        const T u = tf_uniform(sub, (unsigned long long)i, T(0));
        geom_sum = geom_sum + m_ceil(m_log(u) / log1minusprob);
      }
      out[i] = Slot<O>::store(binom_finish(s, (W)(num_geom - T(1))));
      first[i] = -1;
    } else {
      out[i] = Slot<O>::keep((W)k);
      first[i] = pass;
    }
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(LOOP_THREADS)
    binomial_pass2(const long long* __restrict__ key, const T* __restrict__ count,
                   const T* __restrict__ prob, long long n, O* __restrict__ out,
                   const int* __restrict__ first) {
  typedef typename Slot<O>::W W;
  const TfKey root{(uint32_t)key[0], (uint32_t)key[1]};
  const int passes = first[n];
  LOOP_FOR_EACH(i, n) {
    const int from = first[i] + 1;
    if (from <= 0) continue;
    const Binom<T> s = binom_setup(count[i], prob[i]);
    W k = Slot<O>::kept(out[i]);
    if (from < passes) {
      const Btrs<T> bt = btrs_setup(s.count_btrs, s.q_btrs);
      TfKey kk = chain_key(root, from, 0);
      for (int it = from; it < passes; ++it) {
        T kt;
        if (btrs_pass(bt, kk, i, kt)) k = (W)kt;
        kk = tf_hash(kk, 0);
      }
    }
    out[i] = Slot<O>::store(binom_finish(s, k));
  }
}

template <typename T, typename O>
int binomial_launch(const long long* key, const void* count, const void* prob, long long n,
                    void* out, int* first, int passes, cudaStream_t stream) {
  const int blocks = loop_blocks(n);
  if (passes & 1) {
    const int err = (int)cudaMemsetAsync(first + n, 0, sizeof(int), stream);
    if (err != 0) return err;
    const auto pass1 = binomial_pass1<T, O>;
    LOOP_LAUNCH(pass1, blocks, stream, key, (const T*)count, (const T*)prob, n, (O*)out, first);
  }
  if (passes & 2) {
    const auto pass2 = binomial_pass2<T, O>;
    LOOP_LAUNCH(pass2, blocks, stream, key, (const T*)count, (const T*)prob, n, (O*)out, first);
  }
  return (int)cudaGetLastError();
}

// out[i] <- jax's binomial draw of count[i] trials of prob[i] under key, on
// `stream`.  count and prob are float32 (`wide` 0) or float64 (`wide` 1);
// out is float32 (`out_kind` 0), float64 (1) or int64 (2, the float64 draw
// cast as XLA casts it).  `first` is scratch of n + 1 int32 (each
// element's first BTRS accept, or -1 for an inversion element, then N).
// `passes` 1 runs pass 1 (after setting N to 0), 2 pass 2, 3 both.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for float64 probabilities with a float32 draw or an unknown out_kind.
extern "C" int binomial_draw(const long long* key, const void* count, const void* prob,
                             long long n, int wide, int out_kind, void* out, int* first,
                             int passes, cudaStream_t stream) {
  if (n <= 0) return 0;
  if ((wide && out_kind == 0) || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (out_kind == 2)
    return wide ? binomial_launch<double, long long>(key, count, prob, n, out, first, passes,
                                                     stream)
                : binomial_launch<float, long long>(key, count, prob, n, out, first, passes,
                                                    stream);
  if (out_kind == 1)
    return wide ? binomial_launch<double, double>(key, count, prob, n, out, first, passes, stream)
                : binomial_launch<float, double>(key, count, prob, n, out, first, passes, stream);
  return binomial_launch<float, float>(key, count, prob, n, out, first, passes, stream);
}
