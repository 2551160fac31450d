// K3: the radon leapfrog chain in one CUDA kernel.
//
// Replaces pytensor_tpu/models/radon_pallas.py:28 make_radon_leapfrog_pallas,
// which ran n_steps leapfrog steps of the hierarchical radon model inside one
// Pallas program, with the county gather and the per-county segment sum as
// one-hot (1,128)x(128,128) MXU matvecs over lane-padded observations.  The
// one-hot matrices, the lane padding and the n_counties <= 124 and
// n_obs <= 1024 caps exist only because of Mosaic; none of them is here.
//
// What bounds it on Hopper: latency, not bytes or flops.  One block holds one
// chain; the data and the chain state stay on the SM for the whole chain.  A
// step is a walk over each county's observations, a block reduction of four
// sums and a few scalar updates, so its time is the longest county's walk
// plus the round trips between warps.  The design keeps both short:
//
// - The observations are sorted by county on the host, in CSR form
//   (county_ptr[c] .. county_ptr[c+1]).  Thread k owns county k (and k + T,
//   k + 2T, ... for a block of T threads): it walks the county's rows in a
//   fixed order, so the gather a[county[i]] is a register read and the
//   segment sum needs no atomics.  The kernel is deterministic.
// - Owner computes.  A thread kicks and drifts the entries of its own
//   counties right where it walks them, and every thread kicks and drifts
//   the four hyper-parameters itself, in registers, from the reduced sums.
//   The only exchange between threads in a step is the one block reduction,
//   so a step has one __syncthreads: the warps' partials are double-buffered
//   by step parity, and after the barrier every warp finishes the reduction
//   itself.
// - The block is cut to the counties: min(256, 32 * ceil(n_counties / 32))
//   threads, 96 at 85 counties (3 warps to wait for at the barrier, not 8).
// - Where the largest county has at most K3_ROW_CAP rows and every thread
//   owns at most one county, a thread keeps its county's rows, theta, m and
//   gradient in registers for the whole chain (REG); otherwise they are read
//   from shared memory.
// - The gradient at the end of a step is the one the next step starts with,
//   so n_steps steps cost n_steps + 1 gradients (the Pallas kernel paid two a
//   step; the trajectory is the same).
//
// The bits are those of the first design of this kernel (a block of 256
// threads, five barriers a step): the same float operations in the same
// order.  nvcc contracts a product and a sum into one FMA where it sees fit,
// and where it does depends on the shape of the code, so every product that
// meets a sum is written out: fmaf() where the first design's compiled code
// fused it, __fmul_rn() where it rounded the product first.  A thread's
// share of counties is the same at any block size, and the second level of
// the reduction adds the same +0.0s for missing warps, so the totals keep
// their bits.
//
// Everything is float32, as in the TPU kernel.  The analytic gradient is the
// one of radon_pallas.py:101-120 and the final logp that of :122-141.  Built
// by nvcc into a shared library with a plain C interface and called through
// ctypes (models/radon_kernel.py).  One block per chain: a batch of chains is
// a grid of blocks.

#include <cuda_runtime.h>

#define MAX_THREADS 256
static_assert(MAX_THREADS == 256, "block_sum4's second level is written for 8 warps");
// rows of the largest county that a thread keeps in registers (REG)
#ifndef K3_ROW_CAP
#define K3_ROW_CAP 24
#endif
// the length of a thread's register arrays of rows (1 in a build without REG)
#define K3_REG_ROWS (K3_ROW_CAP > 0 ? K3_ROW_CAP : 1)

// the dynamic shared memory, and the launch (a host emulation names its own)
#ifndef K3_SHARED_ARENA
#define K3_SHARED_ARENA extern __shared__ float smem[]
#endif
#ifndef K3_LAUNCH
#define K3_LAUNCH(kernel, blocks, threads, smem, stream, ...) \
  kernel<<<blocks, threads, smem, stream>>>(__VA_ARGS__)
#endif

// The stamped variant (-DK3_STAMPS): block 0's thread 0 records clock64()
// after each part of steps K3_STAMP_FROM.. into `stamps`, K3_N_STAMPS a step.
#define K3_STAMP_FROM 16
#define K3_STAMP_STEPS 16
#define K3_STAMP_LABELS                                                             \
  "step start|kick and drift of the hyper-parameters|county walk|warp sums|barrier|" \
  "second level|hyper-parameter gradients and kick"
#define K3_N_STAMPS 7
#ifdef K3_STAMPS
#define K3_STAMP(k)                                                                  \
  if (threadIdx.x == 0 && blockIdx.x == 0 && step >= K3_STAMP_FROM &&                \
      step < K3_STAMP_FROM + K3_STAMP_STEPS)                                         \
  stamps[(step - K3_STAMP_FROM) * K3_N_STAMPS + (k)] = clock64()
#else
#define K3_STAMP(k)
#endif

namespace {

// Four warp sums side by side, each in the order of a warp_sum of its own:
// lane 0 ends with the totals.
__device__ __forceinline__ void warp_sum4(float v[4]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
}

// Sum four values over the block in a fixed order: warp shuffles, the warps'
// partials into part[parity], one barrier, then every thread sums the
// partials itself.  Every thread returns the totals in v.  `part` is
// double-buffered by `parity`: a warp rewrites a buffer only past the next
// barrier, after every thread has read it; the slots of the warps a block
// does not have hold +0.0 from the kernel's start.
//
// The second level is the sum lane 0 of one warp would get from warp_sum4
// over the MAX_THREADS / 32 = 8 partials, missing warps as +0.0 and lanes
// 8-31 as +0.0: at o = 16 and 8 each of lanes 0-7 adds a +0.0, then
// o = 4, 2, 1 add lane l + o to lane l.  Written out in registers it is
// that tree's sum bit for bit, with no shuffle.
__device__ __forceinline__ void block_sum4(float v[4], float4* part, int parity,
                                           long long* stamps, int step) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* buf = part + parity * (MAX_THREADS / 32);
  warp_sum4(v);
  if (lane == 0) buf[warp] = make_float4(v[0], v[1], v[2], v[3]);
  K3_STAMP(3);
  __syncthreads();
  K3_STAMP(4);
  float w[4][MAX_THREADS / 32];
#pragma unroll
  for (int l = 0; l < MAX_THREADS / 32; ++l) {
    const float4 q = buf[l];
    w[0][l] = (q.x + 0.f) + 0.f;
    w[1][l] = (q.y + 0.f) + 0.f;
    w[2][l] = (q.z + 0.f) + 0.f;
    w[3][l] = (q.w + 0.f) + 0.f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
#pragma unroll
      for (int l = 0; l < o; ++l) w[k][l] += w[k][l + o];
    }
    v[k] = w[k][0];
  }
  K3_STAMP(5);
}

// One observation's residual, (y - a - b * fl) * inv_sy.
__device__ __forceinline__ float residual(float y, float fl, float a, float b, float inv_sy) {
  return fmaf(fl, -b, y - a) * inv_sy;
}

// One observation's terms of the gradient: sum rs, sum rs*floor, sum r^2.
__device__ __forceinline__ void row(float r, float fl, float inv_sy, float& seg, float acc[4]) {
  const float rs = __fmul_rn(r, inv_sy);
  seg = seg + rs;
  acc[0] = fmaf(fl, rs, acc[0]);
  acc[1] = fmaf(r, r, acc[1]);
}

template <bool REG>
__global__ void __launch_bounds__(MAX_THREADS)
radon_leapfrog_kernel(const float* __restrict__ theta0, const float* __restrict__ m0,
                      float* __restrict__ theta_out, float* __restrict__ m_out,
                      float* __restrict__ logp_out, const float* __restrict__ y_sorted,
                      const float* __restrict__ floor_sorted,
                      const int* __restrict__ county_ptr, int n_obs, int n_counties,
                      int n_steps, float eps, long long* __restrict__ stamps) {
  K3_SHARED_ARENA;
  const int nc = n_counties;
  const int n_params = nc + 4;
  const int tid = threadIdx.x;
  const float* th0 = theta0 + blockIdx.x * n_params;
  const float* mm0 = m0 + blockIdx.x * n_params;
  float4* part = reinterpret_cast<float4*>(smem);  // 2 x 8 warps x 4 partials
  float* y = smem + 2 * MAX_THREADS / 32 * 4;
  float* fl = y + n_obs;
  float* th = fl + n_obs;  // the counties' theta, m and gradient (not REG)
  float* m = th + nc;
  float* g = m + nc;
  int* ptr = reinterpret_cast<int*>(g + nc);

  for (int i = tid; i < n_obs; i += blockDim.x) {
    y[i] = y_sorted[i];
    fl[i] = floor_sorted[i];
  }
  for (int k = tid; k <= nc; k += blockDim.x) ptr[k] = county_ptr[k];
  // both buffers of partials start at +0.0, for the warps the block lacks
  if (tid < 2 * MAX_THREADS / 32) part[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  // REG: this thread's county in registers (REG implies nc <= blockDim.x)
  float tk = 0.f, mk = 0.f, gk = 0.f;
  float yr[K3_REG_ROWS], fr[K3_REG_ROWS];
  for (int k = tid; k < nc; k += blockDim.x) {
    if constexpr (REG) {
      tk = th0[k];
      mk = mm0[k];
    } else {
      th[k] = th0[k];
      m[k] = mm0[k];
    }
  }
  // the hyper-parameters, their momenta and gradients, alike in every thread
  float mu = th0[nc], lsa = th0[nc + 1], b = th0[nc + 2], lsy = th0[nc + 3];
  float m_mu = mm0[nc], m_lsa = mm0[nc + 1], m_b = mm0[nc + 2], m_lsy = mm0[nc + 3];
  float g_mu = 0.f, g_lsa = 0.f, g_b = 0.f, g_lsy = 0.f;
  __syncthreads();
  if constexpr (REG) {
    if (tid < nc) {
      const int lo = ptr[tid], len = ptr[tid + 1] - lo;
#pragma unroll
      for (int i = 0; i < K3_ROW_CAP; ++i) {
        yr[i] = i < len ? y[lo + i] : 0.f;
        fr[i] = i < len ? fl[lo + i] : 0.f;
      }
    }
  }

  const float half = 0.5f * eps;
  // step -1 is the first gradient; each step kicks, drifts, takes the
  // gradient and kicks again
  for (int step = -1; step < n_steps; ++step) {
    const bool kick = step >= 0;
    K3_STAMP(0);
    if (kick) {
      m_mu = fmaf(half, g_mu, m_mu);
      mu = fmaf(eps, m_mu, mu);
      m_lsa = fmaf(half, g_lsa, m_lsa);
      lsa = fmaf(eps, m_lsa, lsa);
      m_b = fmaf(half, g_b, m_b);
      b = fmaf(eps, m_b, b);
      m_lsy = fmaf(half, g_lsy, m_lsy);
      lsy = fmaf(eps, m_lsy, lsy);
    }
    K3_STAMP(1);
    const float sig_a = expf(lsa);
    const float inv_sy = expf(-lsy);
    // the quotients of the hyper-parameter gradients, ahead of the barrier
    const float mu100 = mu / 100.f, lsa4 = lsa / 4.f, b100 = b / 100.f;
    // sum rs*floor, sum r^2, sum seg, sum a_raw*seg
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < nc; k += blockDim.x) {
      float t, mo, gr;
      if constexpr (REG) {
        t = tk, mo = mk, gr = gk;
      } else {
        t = th[k], mo = m[k], gr = g[k];
      }
      if (kick) {
        mo = fmaf(half, gr, mo);
        t = fmaf(eps, mo, t);
      }
      const float a_raw = t;
      const float a = fmaf(sig_a, a_raw, mu);
      float seg = 0.f;
      const int lo = ptr[k], len = ptr[k + 1] - lo;
      if constexpr (REG) {
        // each row's r and rs, independent of each other, then the sums
        // in row order: the same operations as row(), side by side
        float r[K3_REG_ROWS];
#pragma unroll
        for (int i = 0; i < K3_ROW_CAP; ++i) r[i] = residual(yr[i], fr[i], a, b, inv_sy);
#pragma unroll
        for (int i = 0; i < K3_ROW_CAP; ++i)
          if (i < len) row(r[i], fr[i], inv_sy, seg, acc);
      } else {
        for (int i = lo; i < lo + len; ++i)
          row(residual(y[i], fl[i], a, b, inv_sy), fl[i], inv_sy, seg, acc);
      }
      gr = fmaf(sig_a, seg, -a_raw);
      acc[2] = acc[2] + seg;
      acc[3] = fmaf(a_raw, seg, acc[3]);
      if (kick) mo = fmaf(half, gr, mo);
      if constexpr (REG) {
        tk = t, mk = mo, gk = gr;
      } else {
        th[k] = t, m[k] = mo, g[k] = gr;
      }
    }
    K3_STAMP(2);
    block_sum4(acc, part, (step + 1) & 1, stamps, step);
    g_mu = acc[2] - mu100;
    g_lsa = fmaf(sig_a, acc[3], -lsa4) + 1.f;
    g_b = acc[0] - b100;
    g_lsy = fmaf(lsy, -0.25f, acc[1] - (float)n_obs) + 1.f;
    if (kick) {
      m_mu = fmaf(half, g_mu, m_mu);
      m_lsa = fmaf(half, g_lsa, m_lsa);
      m_b = fmaf(half, g_b, m_b);
      m_lsy = fmaf(half, g_lsy, m_lsy);
    }
    K3_STAMP(6);
  }

  // logp of the final theta: sum r^2, sum a_raw^2
  const float sig_a = expf(lsa);
  const float inv_sy = expf(-lsy);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = tid; k < nc; k += blockDim.x) {
    const float a_raw = REG ? tk : th[k];
    const float a = fmaf(sig_a, a_raw, mu);
    const int lo = ptr[k], len = ptr[k + 1] - lo;
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < K3_ROW_CAP; ++i) {
        const float r = residual(yr[i], fr[i], a, b, inv_sy);
        if (i < len) acc[0] = fmaf(r, r, acc[0]);
      }
    } else {
      for (int i = lo; i < lo + len; ++i) {
        const float r = residual(y[i], fl[i], a, b, inv_sy);
        acc[0] = fmaf(r, r, acc[0]);
      }
    }
    acc[1] = fmaf(a_raw, a_raw, acc[1]);
    theta_out[blockIdx.x * n_params + k] = a_raw;
    m_out[blockIdx.x * n_params + k] = REG ? mk : m[k];
  }
  block_sum4(acc, part, (n_steps + 1) & 1, nullptr, -1);
  const float half_log_2pi = 0.91893853320467274f;
  const float log10 = 2.30258509299404568f;
  const float log2 = 0.69314718055994531f;
  // -0.5 sum r^2 - n_obs (lsy + log(2 pi) / 2) - 0.5 sum a_raw^2
  // - n_counties log(2 pi) / 2 and the four priors' log densities
  float lp = fmaf(acc[0], -0.5f, -__fmul_rn((float)n_obs, lsy + half_log_2pi));
  lp = fmaf(acc[1], -0.5f, lp);
  lp = fmaf((float)nc, -half_log_2pi, lp);
  const float mu10 = mu / 10.f, b10 = b / 10.f, lsa2 = lsa / 2.f, lsy2 = lsy / 2.f;
  lp = fmaf(0.5f * mu10, -mu10, lp) - log10 - half_log_2pi;
  lp = fmaf(0.5f * b10, -b10, lp) - log10 - half_log_2pi;
  lp = fmaf(0.5f * lsa2, -lsa2, lp) - log2 - half_log_2pi;
  lp = fmaf(0.5f * lsy2, -lsy2, lp) - log2 - half_log_2pi;
  lp = lp + lsa + lsy;
  if (tid == 0) {
    float* t_out = theta_out + blockIdx.x * n_params + nc;
    float* m_o = m_out + blockIdx.x * n_params + nc;
    t_out[0] = mu, t_out[1] = lsa, t_out[2] = b, t_out[3] = lsy;
    m_o[0] = m_mu, m_o[1] = m_lsa, m_o[2] = m_b, m_o[3] = m_lsy;
    logp_out[blockIdx.x] = lp;
  }
}

}  // namespace

extern "C" size_t radon_leapfrog_smem_bytes(int n_obs, int n_counties) {
  return (size_t)(2 * MAX_THREADS / 32 * 4 + 2 * n_obs + 3 * n_counties) * sizeof(float) +
         (size_t)(n_counties + 1) * sizeof(int);
}

// The block of one chain: a warp for each 32 counties, at most MAX_THREADS.
extern "C" int radon_leapfrog_threads(int n_counties) {
  const int t = 32 * ((n_counties + 31) / 32);
  return t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t;
}

// Launches one block per chain on `stream` (`threads` threads, or
// radon_leapfrog_threads(n_counties) when 0; max_rows is the largest
// county's count of observations); returns the first CUDA error.
extern "C" int radon_leapfrog(const float* theta0, const float* m0, float* theta_out,
                              float* m_out, float* logp_out, const float* y_sorted,
                              const float* floor_sorted, const int* county_ptr, int n_obs,
                              int n_counties, int max_rows, int n_chains, int n_steps,
                              float eps, int threads, long long* stamps, void* stream) {
  if (threads == 0) threads = radon_leapfrog_threads(n_counties);
  if (threads < 32 || threads > MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  const size_t smem = radon_leapfrog_smem_bytes(n_obs, n_counties);
  const bool reg = K3_ROW_CAP > 0 && max_rows <= K3_ROW_CAP && n_counties <= threads;
  if (smem > 48 * 1024) {
    cudaError_t e = reg ? cudaFuncSetAttribute(radon_leapfrog_kernel<true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem)
                        : cudaFuncSetAttribute(radon_leapfrog_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (reg)
    K3_LAUNCH(radon_leapfrog_kernel<true>, n_chains, threads, smem, (cudaStream_t)stream,
              theta0, m0, theta_out, m_out, logp_out, y_sorted, floor_sorted, county_ptr,
              n_obs, n_counties, n_steps, eps, stamps);
  else
    K3_LAUNCH(radon_leapfrog_kernel<false>, n_chains, threads, smem, (cudaStream_t)stream,
              theta0, m0, theta_out, m_out, logp_out, y_sorted, floor_sorted, county_ptr,
              n_obs, n_counties, n_steps, eps, stamps);
  return (int)cudaGetLastError();
}

// The stamped variant's stamps of a step, '|'-separated; stamp 0 opens it.
extern "C" const char* radon_leapfrog_stamp_labels() { return K3_STAMP_LABELS; }
