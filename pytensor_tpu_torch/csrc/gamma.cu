// jax's gamma sampler: Marsaglia and Tsang's two nested loops, every split,
// normal and uniform hashed in registers, each lane taking the block's next
// element when its own is done.
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
// Element i draws under its key ki = split(key, n)[i] (the hash of the
// counter i), split into the loop's key kk and the boost's subkey, and
// runs the loops of _gamma_one in float64: an outer pass draws (x_key,
// u_key) from a split of kk into three, the inner loop redraws a normal x
// until v = 1 + x c is positive, and the outer loop ends when
// U < 1 - 0.0331 X^2 or log U < X / 2 + d (1 - V + log V) fails (jax's
// test, with X = x^2 and V = v^3).  Alpha below 1 (or NaN) is boosted to
// alpha + 1 and the draw scaled by u^(1/alpha) (in log space, log u /
// alpha), u under the subkey.  Its elements are independent (vmap), so the
// draw of element i is the same whatever the size of the array or the
// thread that runs it: any schedule gives the same bits.
//
// What bounds it on this card: the threefry hashes the draw reads (its key
// and kk; 3 an outer pass and 1 more where another follows; 2 an inner
// pass and 1 more where another follows; the subkey and u where boosted:
// ~7.6 an element), each ~68 integer instructions, then the FP64 pipe
// (erfinv, the test's two logs, pow), against 16 bytes moved.  The first
// design ran one element a thread and hashed every key as soon as it
// could: ~11 hashes an element, and a warp ran until its slowest lane
// ended (a second outer pass in most warps, pow on 8 lanes of 32).  Here
// the grid is cut to the blocks the card holds, a block takes a
// contiguous share of the elements, and each lane runs one step of its
// element an iteration (the element's start and first outer pass, another
// outer pass, or another inner pass), hashing only the keys that step
// reads, and takes the block's next element when its own is done: ~96%
// of the elements end in their first step, and the rest go on in their
// lanes while the other lanes take new ones, so a warp's lanes stay busy
// and no lane waits on another's loops.  A boosted draw's tail (the
// subkey, u, pow) goes to its warp's queue, which runs 32 at a time, so
// that pow runs on full warps.  Every multiply, add and divide is rounded
// on its own (__dmul_rn, __dadd_rn, __ddiv_rn, which nvcc never
// contracts), as the plain version's torch ops round them.  CUDA's
// erfinv, log, log1p and pow are the functions torch's CUDA ops call,
// built with nvcc's default contraction as torch builds them (so not with
// -fmad=false, which changes pow's bits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "loops.cuh"

// The stamped variant's slots of a thread's row (LOOP_SLOTS int64,
// csrc/loops.cuh): cycles, then counts.  "rest" is S_REST's slot, which
// LOOP_STAMP_END closes.
enum {
  G_SETUP,         // cycles: the element's keys, d and c
  G_OUTER,         // cycles: an outer pass's hashes (its two keys, U, the next key)
  G_INNER,         // cycles: an inner pass's hashes and erfinv (the next key)
  G_TEST,          // cycles: the test's logs
  G_REST,          // cycles: loads, stores, taking elements, queueing tails
  G_TAIL,          // cycles: the draw from d and V (the boost's hashes and pow or log1p)
  G_OUTER_PASSES,  // outer passes
  G_INNER_PASSES,  // inner passes
  G_TAILS,         // draws boosted (alpha below 1, or NaN)
  G_HASHES,        // threefry hashes made
  GAMMA_SLOTS
};
static_assert(G_REST == S_REST && GAMMA_SLOTS == LOOP_SLOTS, "gamma's slots fill a stamped row");

// d = alpha' - 1/3 and c = (1/3) / sqrt(d), alpha' = alpha + 1 where the
// draw is boosted (alpha below 1, or NaN)
__device__ __forceinline__ void gamma_setup(double a, double& d, double& c) {
  const double third = 1.0 / 3.0;
  d = __dadd_rn(a >= 1.0 ? a : __dadd_rn(a, 1.0), -third);
  c = __ddiv_rn(third, sqrt(d));
}

// jax's loop condition: another outer pass
__device__ __forceinline__ bool gamma_test(double X, double V, double U, double d) {
  return (U >= __dadd_rn(1.0, -__dmul_rn(0.0331, __dmul_rn(X, X)))) &
         (log(U) >= __dadd_rn(__dmul_rn(X, 0.5),
                              __dmul_rn(d, __dadd_rn(__dadd_rn(1.0, -V), log(V)))));
}

// the draw before the boost: d V, or log d + log V in log space
__device__ __forceinline__ double gamma_base(double d, double V, int log_space) {
  return log_space ? __dadd_rn(log(d), log(V)) : __dmul_rn(d, V);
}

// the draw from its base and the boost's uniform u, which only a boosted
// draw reads (pass boosted false and any u for the others)
__device__ __forceinline__ double gamma_boost(double base, double a, double u, bool boosted,
                                              int log_space) {
  if (log_space) {
    // -exponential(subkey) = -(-log1p(-u))
    const double log_samples = boosted ? -(-log1p(-u)) : 0.0;
    const double log_boost =
        (!boosted || log_samples == 0.0) ? 0.0 : __dmul_rn(log_samples, __ddiv_rn(1.0, a));
    return __dadd_rn(base, log_boost);
  }
  const double boost_by = boosted ? pow(__dadd_rn(1.0, -u), __ddiv_rn(1.0, a)) : 1.0;
  return __dmul_rn(base, boost_by);
}

// an inner pass under xk: v = 1 + x c of the normal x under split(xk)[1]
__device__ __forceinline__ double gamma_inner(TfKey xk, double c, double& x) {
  const TfKey b = tf_hash(tf_hash(xk, 1), 0);
  x = normal64(b.k0, b.k1);
  return __dadd_rn(1.0, __dmul_rn(x, c));
}

// A boosted draw's tail: its element, its key (the subkey's) and its draw
// before the boost.
struct GammaTail {
  long long i;
  TfKey ki;
  double base;
};

// a warp's queue of tails: fewer than 32 wait, and a warp appends at most
// 32 a step
#define GAMMA_TAILS 64

struct GammaShared {
  GammaTail tail[LOOP_WARPS][GAMMA_TAILS];
  int next;    // the block's next element, from the start of its share
  TfKey root;  // the draw's key (tf_draw_key)
};

// a lane's element: what its next step runs
enum {
  GAMMA_TAKE,   // none: take the block's next
  GAMMA_START,  // taken: its keys, d and c, then its first outer pass
  GAMMA_OUTER,  // another outer pass, from the next key of kk
  GAMMA_INNER,  // another inner pass, from the next key of xk
  GAMMA_EXIT    // none left in the block's share
};

// The warp's lanes' tails, `count` of them from tail[0]: one a lane, its
// boost's hashes and pow (or log1p).
__device__ __forceinline__ void gamma_tails(const GammaTail* tail, int count,
                                            const double* __restrict__ alpha, int log_space,
                                            double* __restrict__ out LOOP_STAMPS_PARAM) {
  const int lane = threadIdx.x & 31;
  if (lane < count) {
    const GammaTail t = tail[lane];
    const double u = tf_uniform64(tf_hash(t.ki, 1), 0);
    out[t.i] = gamma_boost(t.base, alpha[t.i], u, true, log_space);
    LOOP_COUNT(G_TAILS, 1);
    LOOP_COUNT(G_HASHES, 2);
  }
  LOOP_STAMP(G_TAIL);
}

// four blocks an SM: nvcc left alone takes 66 registers (three blocks),
// and five or six blocks leave it 48 or 40, which spill; each is slower
// (PERF.md)
__global__ void __launch_bounds__(LOOP_THREADS, 4)
    gamma_kernel(const long long* __restrict__ key, long long* __restrict__ split,
                 const double* __restrict__ alpha, long long n, int log_space,
                 double* __restrict__ out) {
  __shared__ GammaShared sh;
  LOOP_STAMP_BEGIN;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  GammaTail* tail = sh.tail[threadIdx.x >> 5];
  if (threadIdx.x == 0) {
    sh.next = 0;
    sh.root = tf_draw_key(key, split, true);
  }
  if (threadIdx.x == 32) tf_next_key(key, split);
  __syncthreads();
  const TfKey root = sh.root;
  // the block's share of the elements
  const long long share = (n + gridDim.x - 1) / gridDim.x;
  const long long begin = (long long)blockIdx.x * share;
  const long long end = begin + share < n ? begin + share : n;
  long long i = 0;
  TfKey ki{0, 0}, kk{0, 0}, xk{0, 0};
  double a = 0.0, d = 0.0, c = 0.0, U = 0.0;
  int step = GAMMA_TAKE, it = 0, jt = 0, tails = 0;
  while (true) {
    // the lanes whose element is done take the block's next ones: one
    // atomic a warp, a lane's place the count of the takers below it
    const unsigned take = __ballot_sync(0xFFFFFFFFu, step == GAMMA_TAKE);
    if (take) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&sh.next, __popc(take));
      at = __shfl_sync(0xFFFFFFFFu, at, 0);
      if (step == GAMMA_TAKE) {
        i = begin + at + __popc(take & below);
        step = i < end ? GAMMA_START : GAMMA_EXIT;
      }
    }
    if (!__any_sync(0xFFFFFFFFu, step != GAMMA_EXIT)) break;
    LOOP_STAMP(G_REST);
    // One step of the lane's element: the key that each kind of step
    // hashes first (the element's, the next outer key, the next inner
    // key), then what the step reads
    bool done = false;
    double V = 1.0;
    if (step != GAMMA_EXIT) {
      const TfKey first = tf_hash(step == GAMMA_START ? root : step == GAMMA_OUTER ? kk : xk,
                                  step == GAMMA_START ? (unsigned long long)i : 0ull);
      LOOP_COUNT(G_HASHES, 1);
      if (step == GAMMA_START) {
        ki = first;
        a = alpha[i];
        gamma_setup(a, d, c);
        kk = tf_hash(ki, 0);
        it = 0;
        LOOP_COUNT(G_HASHES, 1);
        LOOP_STAMP(G_SETUP);
        done = !gamma_test(0.0, V, 2.0, d);
        LOOP_STAMP(G_TEST);
      } else if (step == GAMMA_OUTER) {
        kk = first;
      } else {
        xk = first;
      }
      if (!done && step != GAMMA_INNER) {
        // an outer pass: its two keys, U
        xk = tf_hash(kk, 1);
        U = tf_uniform64(tf_hash(kk, 2), 0);
        ++it;
        jt = 0;
        LOOP_COUNT(G_OUTER_PASSES, 1);
        LOOP_COUNT(G_HASHES, 3);
        LOOP_STAMP(G_OUTER);
      }
      if (!done) {
        double x;
        const double v = gamma_inner(xk, c, x);
        ++jt;
        LOOP_COUNT(G_INNER_PASSES, 1);
        LOOP_COUNT(G_HASHES, 2);
        LOOP_STAMP(G_INNER);
        if (v <= 0.0 && jt < LOOP_MAX_ITERS) {
          step = GAMMA_INNER;
        } else {
          V = __dmul_rn(__dmul_rn(v, v), v);
          const bool more = gamma_test(__dmul_rn(x, x), V, U, d);
          LOOP_STAMP(G_TEST);
          step = GAMMA_OUTER;
          done = !(more && it < LOOP_MAX_ITERS);
        }
      }
    }
    // a done draw: written, or its tail queued (a boosted draw)
    const bool boosted = done && !(a >= 1.0);
    const double base = done ? gamma_base(d, V, log_space) : 0.0;
    if (done && !boosted) out[i] = gamma_boost(base, a, 0.0, false, log_space);
    if (done) step = GAMMA_TAKE;
    const unsigned queued = __ballot_sync(0xFFFFFFFFu, boosted);
    if (boosted) tail[tails + __popc(queued & below)] = GammaTail{i, ki, base};
    tails += __popc(queued);
    LOOP_STAMP(G_REST);
    if (tails >= 32) {
      // a full warp of tails
      __syncwarp();
      tails -= 32;
      gamma_tails(tail + tails, 32, alpha, log_space, out LOOP_STAMPS_ARG);
      __syncwarp();
    }
  }
  __syncwarp();
  gamma_tails(tail, tails, alpha, log_space, out LOOP_STAMPS_ARG);
  LOOP_STAMP_END;
}

// out[i] <- jax's standard gamma (loggamma with log_space) of alpha[i]
// under split(key, n)[i], float64, on `stream`, by a launch on the blocks
// the card holds; with `split` (four int64 on the card) key is a random
// variable's own key, the draw is under split(key)[1], and split(key) is
// written into `split` (the next key, then the draw key; tf_draw_key).
// Returns the launch's error.
extern "C" int gamma_draw(const long long* key, long long* split, const double* alpha,
                          long long n, int log_space, double* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  return LOOP_RESIDENT_LAUNCH(gamma_kernel, n, stream, key, split, alpha, n, log_space, out);
}

#ifdef LOOP_STAMPS
// The first design, for the split of its time (never on a path): one
// element a thread, every key hashed as soon as it can be.
__global__ void __launch_bounds__(LOOP_THREADS)
    gamma_serial_kernel(const long long* __restrict__ key, long long* __restrict__ split,
                        const double* __restrict__ alpha, long long n, int log_space,
                        double* __restrict__ out) {
  LOOP_STAMP_BEGIN;
  const TfKey root = tf_draw_key(key, split, threadIdx.x == 0);
  if (threadIdx.x == LOOP_THREADS - 1) tf_next_key(key, split);
  LOOP_FOR_EACH(i, n) {
    const double a = alpha[i];
    LOOP_STAMP(G_REST);
    double d, c;
    gamma_setup(a, d, c);
    const TfKey ki = tf_hash(root, (unsigned long long)i);
    TfKey kk = tf_hash(ki, 0);
    const TfKey subkey = tf_hash(ki, 1);
    LOOP_COUNT(G_HASHES, 3);
    LOOP_STAMP(G_SETUP);
    double X = 0.0, V = 1.0, U = 2.0;
    bool more = gamma_test(X, V, U, d);
    LOOP_STAMP(G_TEST);
    for (int it = 0; it < LOOP_MAX_ITERS && more; ++it) {
      const TfKey x_key = tf_hash(kk, 1), u_key = tf_hash(kk, 2);
      kk = tf_hash(kk, 0);
      LOOP_COUNT(G_OUTER_PASSES, 1);
      LOOP_COUNT(G_HASHES, 3);
      LOOP_STAMP(G_OUTER);
      TfKey xk = x_key;
      double x = 0.0, v = -1.0;
      for (int jt = 0; jt < LOOP_MAX_ITERS && v <= 0.0; ++jt) {
        v = gamma_inner(xk, c, x);
        xk = tf_hash(xk, 0);
        LOOP_COUNT(G_INNER_PASSES, 1);
        LOOP_COUNT(G_HASHES, 3);
        LOOP_STAMP(G_INNER);
      }
      X = __dmul_rn(x, x);
      V = __dmul_rn(__dmul_rn(v, v), v);
      U = tf_uniform64(u_key, 0);
      LOOP_COUNT(G_HASHES, 1);
      LOOP_STAMP(G_OUTER);
      more = gamma_test(X, V, U, d);
      LOOP_STAMP(G_TEST);
    }
    const double u = tf_uniform64(subkey, 0);
    const bool boosted = !(a >= 1.0);
    LOOP_COUNT(G_HASHES, 1);
    LOOP_COUNT(G_TAILS, boosted);
    const double o = gamma_boost(gamma_base(d, V, log_space), a, u, boosted, log_space);
    LOOP_STAMP(G_TAIL);
    out[i] = o;
  }
  LOOP_STAMP_END;
}

// gamma_draw's interface
extern "C" int gamma_serial_draw(const long long* key, long long* split, const double* alpha,
                                 long long n, int log_space, double* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  LOOP_LAUNCH(gamma_serial_kernel, loop_blocks(n), stream, key, split, alpha, n, log_space, out);
  return (int)cudaGetLastError();
}
#endif
