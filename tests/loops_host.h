// Host emulation of what the loop samplers' kernel sources
// (pytensor_tpu_torch/csrc/{gamma,poisson,binomial}.cu) use, for
// tests/test_torch_random_loop_kernels.py: the threefry kernel's host
// header (the funnel shift, bit casts and rounded intrinsics; erfinv), and
// a block's threads as fibers (ucontext), so that a barrier or a warp vote
// runs as on the card: a fiber that reaches __syncthreads() waits until
// every thread of its block that has not exited has reached it, one at
// __syncwarp(), __ballot_sync, __any_sync, __reduce_max_sync or __shfl_sync until its
// warp's have.
// A launch runs its blocks one after another, a resident launch at most
// loops_host_set_grid's.  A cooperative launch runs
// each block of its grid (at most loops_host_set_grid's blocks, 1 unless
// set) on a thread of its own, one at a time: a block runs until it ends
// or waits on a word that another block writes (LOOP_SPIN), then hands on
// to the next block, so a grid barrier and a block that goes on from part
// of the others' work run as on the card, in an order that is the same in
// every run.  Since one block runs at a time, an atomic is a plain read and
// write; `__shared__` is a static of the block's thread.  The test
// includes this header in place of <cuda_runtime.h> and compiles the
// sources with g++ -ffp-contract=off, so that no multiply and add is
// fused, as -fmad=false promises on the card.
#pragma once
#include <ucontext.h>

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "threefry_host.h"

#define __host__
#define __shared__ static thread_local
#undef THREEFRY_LAUNCH

namespace loops_host {

const size_t kStack = 1 << 16;

struct Fiber {
  ucontext_t ctx;
  bool done;
};

// the block running on this thread: its fibers, the scheduler's context,
// and the barriers' arrivals and generations (the block's, and each
// warp's)
struct Block {
  unsigned threads = 0;
  std::vector<Fiber> fibers;
  std::unique_ptr<char[]> stacks;
  size_t stack_threads = 0;
  ucontext_t sched;
  std::function<void()> body;
  unsigned cur = 0;
  unsigned arrived = 0;
  unsigned long gen = 0;
  unsigned warp_arrived[32];
  unsigned long warp_gen[32];
  unsigned long steps = 0;  // barrier arrivals and exits, to see a deadlock
  uint64_t slot[1024];
};

inline Block& block() {
  static thread_local Block b;
  return b;
}

inline void entry() {
  Block& b = block();
  b.body();
  b.fibers[b.cur].done = true;
}

// back to the scheduler until it runs this fiber again
inline void yield() {
  Block& b = block();
  swapcontext(&b.fibers[b.cur].ctx, &b.sched);
}

// the live (not exited) threads of threads [lo, hi)
inline unsigned live(unsigned lo, unsigned hi) {
  Block& b = block();
  unsigned n = 0;
  for (unsigned t = lo; t < hi && t < b.threads; ++t) n += !b.fibers[t].done;
  return n;
}

// arrive at a barrier of threads [lo, hi) and wait until all live ones have
inline void barrier(unsigned& arrived, unsigned long& gen, unsigned lo, unsigned hi) {
  const unsigned long g = gen;
  ++block().steps;
  if (++arrived == live(lo, hi)) {
    arrived = 0;
    ++gen;
    return;
  }
  while (gen == g) yield();
}

inline void block_barrier() {
  Block& b = block();
  barrier(b.arrived, b.gen, 0, b.threads);
}

inline void warp_barrier() {
  Block& b = block();
  const unsigned w = b.cur / 32;
  barrier(b.warp_arrived[w], b.warp_gen[w], w * 32, w * 32 + 32);
}

// a thread's exit releases a barrier its block or warp waits at
inline void release_after_exit(unsigned t) {
  Block& b = block();
  if (b.arrived && b.arrived == live(0, b.threads)) {
    b.arrived = 0;
    ++b.gen;
  }
  const unsigned w = t / 32;
  if (b.warp_arrived[w] && b.warp_arrived[w] == live(w * 32, w * 32 + 32)) {
    b.warp_arrived[w] = 0;
    ++b.warp_gen[w];
  }
}

// run `body` as each thread of block `bi` of a grid of `blocks`
template <typename F>
void run_block(unsigned bi, unsigned blocks, unsigned threads, F& body) {
  Block& b = block();
  b.threads = threads;
  b.body = body;
  b.fibers.resize(threads);
  if (b.stack_threads < threads) {
    b.stacks.reset(new char[threads * kStack]);
    b.stack_threads = threads;
  }
  gridDim.x = blocks;
  blockDim.x = threads;
  blockIdx.x = bi;
  b.arrived = 0;
  std::memset(b.warp_arrived, 0, sizeof b.warp_arrived);
  for (unsigned t = 0; t < threads; ++t) {
    Fiber& f = b.fibers[t];
    f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = &b.stacks[t * kStack];
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &b.sched;
    makecontext(&f.ctx, entry, 0);
  }
  for (unsigned running = threads; running;) {
    const unsigned long steps = b.steps;
    for (unsigned t = 0; t < threads; ++t) {
      if (b.fibers[t].done) continue;
      b.cur = t;
      threadIdx.x = t;
      swapcontext(&b.sched, &b.fibers[t].ctx);
      if (b.fibers[t].done) {
        --running;
        ++b.steps;
        release_after_exit(t);
      }
    }
    // every live thread waits at a barrier that none of the others will
    // reach (a barrier not every thread of the block or warp meets)
    if (running && b.steps == steps) {
      std::fprintf(stderr, "loops_host: block %u deadlocks at its barriers\n", bi);
      std::abort();
    }
  }
}

// run `body` as each thread of each block of the grid, one block after
// another
template <typename F>
void launch(unsigned blocks, unsigned threads, F body) {
  for (unsigned bi = 0; bi < blocks; ++bi) run_block(bi, blocks, threads, body);
}

// A cooperative launch's grid: whose turn it is, and the blocks that have
// ended.  A block's thread runs only in its turn.
struct Grid {
  std::mutex m;
  std::condition_variable cv;
  unsigned blocks = 0, turn = 0;
  std::vector<char> ended;
};

inline Grid& grid() {
  static Grid g;
  return g;
}

// the cooperative launch's block this thread runs (-1: none), and the
// most blocks a cooperative launch runs (loops_host_set_grid)
static thread_local int coop_block = -1;
static unsigned coop_most = 1;

// hand the turn to the next block that has not ended, and, unless this
// block ends, wait until the turn comes back.  A block that waits on the
// others when every other has ended would wait for ever on the card: that
// aborts.
inline void pass_turn(bool ends) {
  Grid& g = grid();
  std::unique_lock<std::mutex> lock(g.m);
  const unsigned me = (unsigned)coop_block;
  if (ends) g.ended[me] = 1;
  for (unsigned k = 1; k <= g.blocks; ++k) {
    const unsigned next = (me + k) % g.blocks;
    if (!g.ended[next]) {
      if (next == me) {
        std::fprintf(stderr, "loops_host: block %u waits on blocks that have ended\n", me);
        std::abort();
      }
      g.turn = next;
      break;
    }
  }
  g.cv.notify_all();
  if (!ends) g.cv.wait(lock, [&] { return g.turn == me; });
}

// a cooperative launch of `blocks` blocks (cut to coop_most), each on a
// thread of its own, block 0 first
template <typename F>
void coop_launch(unsigned blocks, unsigned threads, F body) {
  Grid& g = grid();
  g.blocks = blocks < coop_most ? blocks : coop_most;
  g.turn = 0;
  g.ended.assign(g.blocks, 0);
  std::vector<std::thread> runs;
  for (unsigned bi = 0; bi < g.blocks; ++bi)
    runs.emplace_back([&, bi] {
      coop_block = (int)bi;
      {
        std::unique_lock<std::mutex> lock(g.m);
        g.cv.wait(lock, [&] { return g.turn == bi; });
      }
      run_block(bi, g.blocks, threads, body);
      pass_turn(true);
      coop_block = -1;
    });
  for (std::thread& t : runs) t.join();
}

// a wait on another block's word: the other blocks run in turn
inline void spin() {
  if (coop_block >= 0) pass_turn(false);
}

// each live thread of the warp's value, after a barrier
inline void exchange(uint64_t v) {
  Block& b = block();
  b.slot[b.cur] = v;
  warp_barrier();
}

}  // namespace loops_host

#define LOOP_LAUNCH(kernel, blocks, stream, ...) \
  loops_host::launch(blocks, LOOP_THREADS, [&] { kernel(__VA_ARGS__); })
#define LOOP_COOP_LAUNCH(kernel, n, stream, ...) \
  (loops_host::coop_launch(loop_blocks(n), LOOP_THREADS, [&] { kernel(__VA_ARGS__); }), 0)
// a plain launch on the resident blocks: at most loops_host_set_grid's,
// one after another
#define LOOP_RESIDENT_LAUNCH(kernel, n, stream, ...)                                       \
  (loops_host::launch((unsigned)loop_blocks(n) < loops_host::coop_most                     \
                          ? (unsigned)loop_blocks(n)                                       \
                          : loops_host::coop_most,                                         \
                      LOOP_THREADS, [&] { kernel(__VA_ARGS__); }),                         \
   0)
#define LOOP_SPIN() loops_host::spin()

// the most blocks a cooperative launch runs, for the tests
extern "C" void loops_host_set_grid(unsigned blocks) { loops_host::coop_most = blocks; }

inline void __syncthreads() { loops_host::block_barrier(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { loops_host::warp_barrier(); }
inline unsigned __ballot_sync(unsigned, int p) {
  loops_host::Block& b = loops_host::block();
  loops_host::exchange(p != 0);
  const unsigned w = b.cur / 32 * 32;
  unsigned bits = 0;
  for (unsigned l = 0; l < 32 && w + l < b.threads; ++l)
    if (!b.fibers[w + l].done && b.slot[w + l]) bits |= 1u << l;
  __syncwarp();
  return bits;
}
inline int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p) != 0; }
inline int __reduce_max_sync(unsigned, int v) {
  loops_host::Block& b = loops_host::block();
  loops_host::exchange((uint64_t)(uint32_t)v);
  const unsigned w = b.cur / 32 * 32;
  int most = v;
  for (unsigned l = 0; l < 32 && w + l < b.threads; ++l)
    if (!b.fibers[w + l].done && (int)(uint32_t)b.slot[w + l] > most)
      most = (int)(uint32_t)b.slot[w + l];
  __syncwarp();
  return most;
}
inline int __shfl_sync(unsigned, int v, int src) {
  loops_host::Block& b = loops_host::block();
  loops_host::exchange((uint64_t)(uint32_t)v);
  const int got = (int)(uint32_t)b.slot[b.cur / 32 * 32 + src];
  __syncwarp();
  return got;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __threadfence() {}

inline double __ddiv_rn(double a, double b) { return a / b; }
inline int atomicMax(int* address, int value) {
  const int old = *address;
  if (value > old) *address = value;
  return old;
}
inline int atomicAdd(int* address, int value) {
  const int old = *address;
  *address = old + value;
  return old;
}
inline unsigned long long atomicAdd(unsigned long long* address, unsigned long long value) {
  const unsigned long long old = *address;
  *address = old + value;
  return old;
}
inline int atomicExch(int* address, int value) {
  const int old = *address;
  *address = value;
  return old;
}
// the stamped variant's (-DLOOP_STAMPS): a cycle count from the host's
// clock, and the rows' pointer set as on the card
inline long long clock64() {
  return (long long)std::chrono::steady_clock::now().time_since_epoch().count();
}
template <typename T>
inline int cudaMemcpyToSymbol(T& symbol, const void* src, size_t bytes) {
  std::memcpy(&symbol, src, bytes);
  return 0;
}
inline int cudaMemsetAsync(void* ptr, int value, size_t bytes, cudaStream_t) {
  std::memset(ptr, value, bytes);
  return 0;
}
