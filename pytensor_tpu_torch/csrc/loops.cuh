// What the loop samplers' kernels (csrc/gamma.cu, csrc/poisson.cu,
// csrc/binomial.cu) share: the loops' bound, the block size and launches
// (gamma's a plain launch on the blocks the card holds),
// XLA's saturating conversion of a float to int64, the math functions by
// operand type, the stamped variant's stamps, and for the Poisson and
// binomial kernels the pieces of jax's whole-array rejection loops on
// Hopper: a block's tables of pass keys, its queues of elements by branch,
// the queue's drain, and the one-launch draw's flag and grid barrier.  The
// includer brings <cuda_runtime.h> (or the host tests' emulation of it),
// <stdint.h> and threefry.cuh.
//
// A whole-array rejection loop of jax (PTRS, BTRS) runs until every
// element has accepted, and writes each element's k on every accepting
// pass.  So an element's draw is the k of its last accepting pass before
// the whole array's loop ends, after N passes, where N is one more than
// the largest first-accept pass over the elements, those on jax's dummy
// parameters included.  The other branch (Knuth's loop, the inversion
// loop) is monotone: an element's draw is its own.  The kernels run a draw
// in three phases, with N and a flag in device words, so that N never
// leaves the card and a draw may be captured into a CUDA graph:
//
//   A. each element of the monotone branch runs its loop to its end; each
//      rejection element runs to its first accept, taken into N; a tile
//      with a rejection element sets the flag;
//   B. only if the flag is set: each element of the monotone branch runs
//      the rejection loop on the dummy parameters, but only where it can
//      raise N: an accept1 (the first test, no log) at a pass below the N
//      already known settles it;
//   C. only if the flag is set: each rejection element searches its passes
//      from N - 1 down for its last accept, its draw.  A pass's accept
//      does not depend on the others, so the search ends at the first
//      accept it meets, ~1.3 passes in, where a forward walk would run
//      every pass up to N.
//
// The draw is one cooperative launch (the grid cut to the blocks the card
// holds at once): a block learns after its phase A, from one 64-bit word
// that counts the tiles grouped and those with a rejection element,
// whether B and C run, so where none does (every draw of the RBM's Gibbs
// chain) it ends without a grid barrier; B and C are separated by one
// (loop_grid_sync).  A block may start phase B before the others have
// ended phase A, so from part of N: the accept1 sweep holds for any part.
//
// What bounds the kernels: not the threefry hashes the draw needs but
// each element's serial chain of passes (a hash, then a log) and lanes
// left idle.  Every element of one pass hashes its uniforms under the same
// keys: the pass's key of the chain key_{t+1} = split(key_t)[next] and its
// subkeys.  A block keeps them in shared memory (PassKeys), warp j building
// table j as deep as the tile's elements need (keys_extend), so a thread's
// pass costs only its own uniforms' hashes; past what a table holds a
// thread walks the chain on itself (keys_at).  A block queues a tile's
// elements by branch (loop_queue: a ballot a warp and a prefix sum over the
// warps), so that a warp runs one branch's loop, and its threads drain a
// queue (loop_drain): one pass an iteration, each thread taking the next
// element when its own ends, up to LOOP_SPREAD elements a thread a tile.

#pragma once

// jax bounds its loops by its dtype's largest value; no draw that ends
// comes near this bound (tensor/random/samplers.py MAX_ITERS)
#define LOOP_MAX_ITERS (1 << 16)
#define LOOP_THREADS 256
#define LOOP_WARPS (LOOP_THREADS / 32)
#define LOOP_MAX_BLOCKS (1 << 20)
// pass keys a block keeps of a chain, and its first chunk (the Gibbs
// chain's inversion loop, binomial(1, p), runs two passes at most)
#define LOOP_TABLE 128
#define LOOP_FIRST_CHUNK 2

// the device words of a draw (int32): N; phase A's record, one 64-bit
// word of the tiles grouped (low) and of those with a rejection element
// (high: the flag); the grid barrier's arrivals and generation
#define LOOP_STATE_N 0
#define LOOP_STATE_TILES 2
#define LOOP_STATE_FLAG 3
#define LOOP_STATE_BARRIER 4
#define LOOP_STATE_WORDS 6

// what a thread does while it waits on another block (nothing on the
// card; the host tests' emulation runs another block)
#ifndef LOOP_SPIN
#define LOOP_SPIN()
#endif

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

// A block's tiles: loop_spread(n) elements a thread, so that a queue of
// a tile's elements (loop_queue) outnumbers the block's threads where the
// grid is cut to the blocks the card holds at once, and a thread that has
// run its element's loop to its end takes another (loop_drain).  The same
// tiles for every thread of the block.
#define LOOP_SPREAD 4
#define LOOP_QUEUE (LOOP_SPREAD * LOOP_THREADS)
__device__ __forceinline__ int loop_spread(long long n) {
  const long long per_block = (n + gridDim.x - 1) / gridDim.x;
  const long long spread = (per_block + LOOP_THREADS - 1) / LOOP_THREADS;
  return spread < 1 ? 1 : spread > LOOP_SPREAD ? LOOP_SPREAD : (int)spread;
}
#define LOOP_FOR_EACH_TILE(base, tile, n)                                          \
  for (long long base = (long long)blockIdx.x * (tile); base < (n);               \
       base += (long long)gridDim.x * (tile))

#ifndef LOOP_COOP_LAUNCH
template <typename T>
struct LoopSame {
  typedef T type;
};
// the blocks of `kernel` the card holds at once, into `room`
template <typename K>
__host__ int loop_room(K kernel, int& room) {
  int per_sm = 0, sms = 0, dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LOOP_THREADS, 0);
  room = per_sm * sms;
  return err;
}
// a cooperative launch of `kernel` on at most the blocks the card holds at
// once (every block resident, so that loop_grid_sync cannot wait on a
// block that is not running)
template <typename... A>
__host__ int loop_coop_launch(void (*kernel)(A...), long long n, cudaStream_t stream,
                              typename LoopSame<A>::type... a) {
  int room = 0;
  const int err = loop_room(kernel, room);
  if (err) return err;
  const int need = loop_blocks(n);
  void* args[] = {(void*)&a...};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(need < room ? need : room),
                                          dim3(LOOP_THREADS), args, 0, stream);
}
#define LOOP_COOP_LAUNCH(kernel, n, stream, ...) loop_coop_launch(kernel, n, stream, __VA_ARGS__)
// a plain launch of `kernel` on at most the blocks the card holds at once
// (a kernel whose blocks never wait on each other, each taking its share
// of the elements in tiles); returns cudaGetLastError() after it
template <typename... A>
__host__ int loop_resident_launch(void (*kernel)(A...), long long n, cudaStream_t stream,
                                  typename LoopSame<A>::type... a) {
  int room = 0;
  const int err = loop_room(kernel, room);
  if (err) return err;
  const int need = loop_blocks(n);
  kernel<<<need < room ? need : room, LOOP_THREADS, 0, stream>>>(a...);
  return (int)cudaGetLastError();
}
#define LOOP_RESIDENT_LAUNCH(kernel, n, stream, ...) \
  loop_resident_launch(kernel, n, stream, __VA_ARGS__)
#endif

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

// The stamped variant (built with -DLOOP_STAMPS, for chip_smoke.py phase
// 19's split of a kernel's time; never on a path): each thread adds the
// clock64() cycles since its previous stamp to one of the cycle slots
// (LOOP_STAMP), counts its passes and hashes (LOOP_COUNT), and at its exit
// adds them to its row of LOOP_SLOTS int64 at loop_stamp_rows (set by
// loop_stamps_at before a launch).  Without -DLOOP_STAMPS the stamps are
// nothing.
enum {
  S_CHAIN,   // cycles: the key chain's hashes, and waiting for them
  S_DUMMY,   // cycles: the rejection loop on jax's dummy parameters
  S_OWN,     // cycles: the inversion or Knuth loop
  S_REJECT,  // cycles: the rejection loop's own hashes, logs and lgamma
  S_REST,    // cycles: setup, loads, stores, grouping, atomics, barriers
  C_DUMMY,   // passes on the dummy parameters
  C_OWN,     // passes of the inversion or Knuth loop
  C_REJECT,  // passes of the rejection loop
  C_HASHES,  // threefry hashes the thread made
  C_CHAIN,   // of which the key chain's
  LOOP_SLOTS
};
#ifdef LOOP_STAMPS
__device__ long long* loop_stamp_rows;
extern "C" int loop_stamps_at(long long* rows) {
  return (int)cudaMemcpyToSymbol(loop_stamp_rows, &rows, sizeof rows);
}
#define LOOP_STAMP_BEGIN          \
  long long st_[LOOP_SLOTS] = {}; \
  long long st_t_ = clock64()
#define LOOP_STAMP(slot)            \
  do {                              \
    const long long t_ = clock64(); \
    st_[slot] += t_ - st_t_;        \
    st_t_ = t_;                     \
  } while (0)
#define LOOP_COUNT(slot, v) (st_[slot] += (v))
#define LOOP_STAMP_END                                                                   \
  do {                                                                                   \
    LOOP_STAMP(S_REST);                                                                  \
    long long* r_ = loop_stamp_rows +                                                    \
                    ((long long)blockIdx.x * LOOP_THREADS + threadIdx.x) * LOOP_SLOTS;   \
    for (int s_ = 0; s_ < LOOP_SLOTS; ++s_) r_[s_] += st_[s_];                           \
  } while (0)
#define LOOP_STAMPS_ARG , st_, st_t_
#define LOOP_STAMPS_PARAM , long long *st_, long long &st_t_
// the cycles since the last stamp to an element loop's slot, and its pass
// and hashes (its own, and `chain` of its own walk of the chain)
#define LOOP_STAMP_TO(slot)        \
  do {                             \
    if ((slot) == S_OWN)           \
      LOOP_STAMP(S_OWN);           \
    else if ((slot) == S_REJECT)   \
      LOOP_STAMP(S_REJECT);        \
    else                           \
      LOOP_STAMP(S_DUMMY);         \
  } while (0)
#define LOOP_TALLY(e, chain)                                                           \
  do {                                                                                 \
    if ((e).slot == S_OWN)                                                             \
      LOOP_COUNT(C_OWN, 1);                                                            \
    else if ((e).slot == S_REJECT)                                                     \
      LOOP_COUNT(C_REJECT, 1);                                                         \
    else                                                                               \
      LOOP_COUNT(C_DUMMY, 1);                                                          \
    LOOP_COUNT(C_HASHES, (e).hashes + (chain));                                        \
    LOOP_COUNT(C_CHAIN, (chain));                                                      \
  } while (0)
#else
#define LOOP_STAMP_BEGIN
#define LOOP_STAMP(slot)
#define LOOP_COUNT(slot, v)
#define LOOP_STAMP_END
#define LOOP_STAMPS_ARG
#define LOOP_STAMPS_PARAM
#define LOOP_STAMP_TO(slot)
#define LOOP_TALLY(e, chain)
#endif

// One key chain's pass keys, in a block's shared memory: key[t] is pass
// t's key (key[0] the draw's), sub[j][t] its subkey split(key[t])[sub_at[j]]
// (nsub of them), and key[t + 1] = split(key[t])[next_at]; `built` passes
// have their subkeys.
struct PassKeys {
  TfKey key[LOOP_TABLE];
  TfKey sub[2][LOOP_TABLE];
  int built, nsub, next_at, sub_at[2];
};

// by one thread, before a barrier
__device__ __forceinline__ void keys_init(PassKeys& t, TfKey root, int next_at, int nsub,
                                          int sub0, int sub1) {
  t.key[0] = root;
  t.built = 0;
  t.nsub = nsub;
  t.next_at = next_at;
  t.sub_at[0] = sub0;
  t.sub_at[1] = sub1;
}

// by one warp, the block synchronised after: the table's passes up to
// `to` (at most LOOP_TABLE); lane 0 walks the chain, then the lanes hash
// a pass's subkeys each.  Table j is only ever extended by warp j.  Lane
// 0's `to` holds for the warp: a caller's may come from a word that other
// blocks raise meanwhile (N in phase B), and lanes that disagreed would
// leave passes without subkeys.
__device__ __forceinline__ void keys_extend(PassKeys& t, int to LOOP_STAMPS_PARAM) {
  const int lane = threadIdx.x & 31, from = t.built;
  to = __shfl_sync(0xFFFFFFFFu, to, 0);
  to = to < LOOP_TABLE ? to : LOOP_TABLE;
  if (to <= from) return;
  if (lane == 0) {
    TfKey k = t.key[from > 0 ? from - 1 : 0];
    for (int p = from > 0 ? from : 1; p < to; ++p) {
      k = tf_hash(k, (unsigned long long)t.next_at);
      t.key[p] = k;
      LOOP_COUNT(C_HASHES, 1);
      LOOP_COUNT(C_CHAIN, 1);
    }
  }
  __syncwarp();
  for (int p = from + lane; p < to; p += 32)
    for (int j = 0; j < t.nsub; ++j) {
      t.sub[j][p] = tf_hash(t.key[p], (unsigned long long)t.sub_at[j]);
      LOOP_COUNT(C_HASHES, 1);
      LOOP_COUNT(C_CHAIN, 1);
    }
  __syncwarp();
  if (lane == 0) t.built = to;
  __syncwarp();
}

// the first passes of each of `ntabs` tables, warp j building table j
// while the other warps load their elements (the block synchronised
// after, by the grouping)
__device__ __forceinline__ void keys_start(PassKeys* tabs, int ntabs LOOP_STAMPS_PARAM) {
  if ((int)(threadIdx.x >> 5) < ntabs)
    keys_extend(tabs[threadIdx.x >> 5], LOOP_FIRST_CHUNK LOOP_STAMPS_ARG);
}

// pass t's subkeys, from the table or, past what it holds, by walking the
// chain on from its last key (t - built + 1 hashes: a rare dummy's search)
__device__ __forceinline__ void keys_at(const PassKeys& t, int pass, TfKey& s0, TfKey& s1) {
  if (pass < t.built) {
    s0 = t.sub[0][pass];
    s1 = t.sub[1][pass];
    return;
  }
  TfKey k = t.key[t.built - 1];
  for (int p = t.built; p <= pass; ++p) k = tf_hash(k, (unsigned long long)t.next_at);
  s0 = tf_hash(k, (unsigned long long)t.sub_at[0]);
  s1 = t.nsub > 1 ? tf_hash(k, (unsigned long long)t.sub_at[1]) : s0;
}

// A tile's queues in the block's shared memory: queue A from the front
// (a elements), queue B from the back (b), and the deepest pass each
// table must hold for them.
struct LoopQueue {
  int a, b, need[2];
};

// Queue the tile of `spread` x LOOP_THREADS elements from `base`: element
// i (base + r LOOP_THREADS + thread, r < spread) goes to queue A where
// classify(i, need) gives 1, to queue B where it gives 2, to none where 0,
// each queue in element order, by store(i, position).  Two ballots a warp
// and a prefix sum over the warps for each r (`counts` two buffers, one
// barrier each); the caller synchronises the block before reading.
template <typename Classify, typename Store>
__device__ __forceinline__ LoopQueue loop_queue(int (*counts)[4][LOOP_WARPS], long long base,
                                                long long n, int spread, Classify classify,
                                                Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  LoopQueue q{0, 0, {0, 0}};
  for (int r = 0; r < spread; ++r) {
    const long long i = base + (long long)r * LOOP_THREADS + threadIdx.x;
    int need = 0;
    const int which = i < n ? classify(i, need) : 0;
    const unsigned ba = __ballot_sync(0xFFFFFFFFu, which == 1);
    const unsigned bb = __ballot_sync(0xFFFFFFFFu, which == 2);
    const int need_a = __reduce_max_sync(0xFFFFFFFFu, which == 1 ? need : 0);
    const int need_b = __reduce_max_sync(0xFFFFFFFFu, which == 2 ? need : 0);
    int(*c)[LOOP_WARPS] = counts[r & 1];
    if (lane == 0) {
      c[0][warp] = __popc(ba);
      c[1][warp] = __popc(bb);
      c[2][warp] = need_a;
      c[3][warp] = need_b;
    }
    __syncthreads();
    int pa = q.a, pb = q.b;
    for (int w = 0; w < LOOP_WARPS; ++w) {
      if (w < warp) {
        pa += c[0][w];
        pb += c[1][w];
      }
      q.a += c[0][w];
      q.b += c[1][w];
      q.need[0] = c[2][w] > q.need[0] ? c[2][w] : q.need[0];
      q.need[1] = c[3][w] > q.need[1] ? c[3][w] : q.need[1];
    }
    const unsigned below = (1u << lane) - 1u;
    if (which == 1) store(i, pa + __popc(ba & below));
    if (which == 2) store(i, LOOP_QUEUE - 1 - (pb + __popc(bb & below)));
  }
  return q;
}

// the passes a monotone loop expected to run `expected` passes may need:
// its mean plus five deviations and five, at most `most` (a thread past
// the table walks the chain itself)
template <typename T>
__device__ __forceinline__ int loop_need(T expected, T most) {
  if (!(expected >= T(0)) || !(most >= T(0))) return 0;
  const T need = m_ceil(expected + T(5) * m_sqrt(expected) + T(5));
  const T cap = most < need ? most : need;
  return cap < T(LOOP_TABLE) ? (int)cap : LOOP_TABLE;
}

// Phase A's record of a tile, by one thread: one atomic counts the tile,
// and in the high word the tile with a rejection element (the flag)
__device__ __forceinline__ void loop_tile_grouped(int* state, bool rejection) {
  atomicAdd((unsigned long long*)(state + LOOP_STATE_TILES),
            1ull + ((unsigned long long)rejection << 32));
}

// After a block's phase A: whether phases B and C run, known once the flag is set or every tile has been grouped (so that a
// block waits for the others' grouping, not for their loops)
__device__ __forceinline__ bool loop_rejection_anywhere(int* state, long long n, int tile,
                                                        int* shared) {
  if (threadIdx.x == 0) {
    const unsigned long long tiles = (n + tile - 1) / tile;
    unsigned long long record;
    while (true) {
      record = *(volatile unsigned long long*)(state + LOOP_STATE_TILES);
      if ((record >> 32) != 0 || (record & 0xFFFFFFFFull) >= tiles) break;
      LOOP_SPIN();
    }
    *shared = (record >> 32) != 0;
  }
  __syncthreads();
  return *shared != 0;
}

// what a queued element's loop runs: the monotone loop to its end, the
// rejection loop forward to its first accept, or down from N - 1 to its
// last; and the passes a rejection element's forward search is expected to
// need (a table's depth for it)
enum { LOOP_OWN, LOOP_FIRST, LOOP_LAST };
#define LOOP_FIRST_NEED 8

// Run the queue of elements [*next, end) of the block's order: each
// thread takes the queue's next element when its own has ended, and runs
// one pass an iteration (e.start(k), e.live(), e.step(subkey 0, subkey 1)
// at e.pass, e.finish()), so that a warp's lanes stay busy however long
// their elements' loops are.  The keys come from table t, or past what it
// holds from the chain walked on (keys_at).
template <typename E>
__device__ __forceinline__ void loop_drain(int* next, int end, const PassKeys& t,
                                           E& e LOOP_STAMPS_PARAM) {
  int k = atomicAdd(next, 1);
  if (k < end) e.start(k);
  while (k < end) {
    if (e.live()) {
      TfKey s0, s1;
      keys_at(t, e.pass, s0, s1);
      e.step(s0, s1);
      LOOP_TALLY(e, 0);
    } else {
      e.finish();
      k = atomicAdd(next, 1);
      if (k < end) e.start(k);
    }
  }
  LOOP_STAMP_TO(e.slot);
}

// a barrier of every thread of the grid (every block resident: a
// cooperative launch); state[LOOP_STATE_BARRIER] counts arrivals, the next
// word is the barrier's generation
__device__ __forceinline__ void loop_grid_sync(int* state) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int* arrived = state + LOOP_STATE_BARRIER;
    volatile int* gen = arrived + 1;
    const int g = *gen;
    __threadfence();
    if (atomicAdd(arrived, 1) == (int)gridDim.x - 1) {
      atomicExch(arrived, 0);
      __threadfence();
      atomicAdd(arrived + 1, 1);
    } else {
      while (*gen == g) LOOP_SPIN();
    }
    __threadfence();
  }
  __syncthreads();
}

// N as phases B and C read it, written by other blocks
__device__ __forceinline__ int loop_state(const int* state, int word) {
  return *(const volatile int*)(state + word);
}
