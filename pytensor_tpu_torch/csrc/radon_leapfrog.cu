// K3: the radon leapfrog chain in one CUDA kernel.
//
// Replaces pytensor_tpu/models/radon_pallas.py:28 make_radon_leapfrog_pallas,
// which ran n_steps leapfrog steps of the hierarchical radon model inside one
// Pallas program, with the county gather and the per-county segment sum as
// one-hot (1,128)x(128,128) MXU matvecs over lane-padded observations.  The
// one-hot matrices, the lane padding and the n_counties <= 124 and
// n_obs <= 1024 caps exist only because of Mosaic; none of them is here.
//
// What bounds it on Hopper: barrier latency, not bytes or flops.  One block
// holds one chain; the whole chain state and the data live in shared memory
// (about 12 KB at 919 observations and 85 counties), and each gradient is a
// handful of __syncthreads.  The design keeps the barriers few:
//
// - The observations are sorted by county on the host, in CSR form
//   (county_ptr[c] .. county_ptr[c+1]).  A thread walks its county's range in
//   a fixed order, so the gather a[county[i]] is a register read and the
//   segment sum needs no atomics and no extra pass: the kernel is
//   deterministic.
// - The four sums a gradient needs (sum rs*floor, sum r^2, sum seg,
//   sum a_raw*seg) go through one fused block reduction: warp shuffles, then
//   one warp over the per-warp partials, in a fixed order.
// - The gradient at the end of a step is the one the next step starts with,
//   so n_steps steps cost n_steps + 1 gradients (the Pallas kernel paid two a
//   step; the trajectory is the same).
//
// Everything is float32, as in the TPU kernel.  The analytic gradient is the
// one of radon_pallas.py:101-120 and the final logp that of :122-141.  Built
// by nvcc into a shared library with a plain C interface and called through
// ctypes (models/radon_kernel.py).  One block per chain: a batch of chains is
// a grid of blocks.

#include <cuda_runtime.h>

#define THREADS 256
#define WARPS (THREADS / 32)

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum four values over the block in a fixed order; every thread finds the
// totals in tot[0..3] on return.
__device__ __forceinline__ void block_sum4(float v[4], float* scratch, float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) scratch[warp * 4 + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = lane < WARPS ? scratch[lane * 4 + k] : 0.f;
      s = warp_sum(s);
      if (lane == 0) tot[k] = s;
    }
  }
  __syncthreads();
}

struct Chain {
  const float* y;    // observations, sorted by county
  const float* fl;   // floor indicator, same order
  const int* ptr;    // CSR offsets, n_counties + 1
  float* scratch;    // WARPS * 4
  float* tot;        // 4
  int n_obs;
  int n_counties;
};

// g = dlogp(th), written to shared memory; ends on a barrier.
__device__ void dlogp(const Chain& c, const float* th, float* g) {
  const int nc = c.n_counties;
  const float mu = th[nc], lsa = th[nc + 1], b = th[nc + 2], lsy = th[nc + 3];
  const float sig_a = expf(lsa);
  const float inv_sy = expf(-lsy);
  // sum rs*floor, sum r^2, sum seg, sum a_raw*seg
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    const float a_raw = th[k];
    const float a = mu + sig_a * a_raw;
    float seg = 0.f;
    for (int i = c.ptr[k]; i < c.ptr[k + 1]; ++i) {
      const float r = (c.y[i] - a - b * c.fl[i]) * inv_sy;
      const float rs = r * inv_sy;
      seg += rs;
      acc[0] += rs * c.fl[i];
      acc[1] += r * r;
    }
    g[k] = sig_a * seg - a_raw;
    acc[2] += seg;
    acc[3] += a_raw * seg;
  }
  block_sum4(acc, c.scratch, c.tot);
  if (threadIdx.x == 0) {
    g[nc] = c.tot[2] - mu / 100.f;
    g[nc + 1] = sig_a * c.tot[3] - lsa / 4.f + 1.f;
    g[nc + 2] = c.tot[0] - b / 100.f;
    g[nc + 3] = c.tot[1] - (float)c.n_obs - lsy / 4.f + 1.f;
  }
  __syncthreads();
}

// logp(th), returned by thread 0.
__device__ float logp(const Chain& c, const float* th) {
  const int nc = c.n_counties;
  const float mu = th[nc], lsa = th[nc + 1], b = th[nc + 2], lsy = th[nc + 3];
  const float sig_a = expf(lsa);
  const float inv_sy = expf(-lsy);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // sum r^2, sum a_raw^2
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    const float a_raw = th[k];
    const float a = mu + sig_a * a_raw;
    for (int i = c.ptr[k]; i < c.ptr[k + 1]; ++i) {
      const float r = (c.y[i] - a - b * c.fl[i]) * inv_sy;
      acc[0] += r * r;
    }
    acc[1] += a_raw * a_raw;
  }
  block_sum4(acc, c.scratch, c.tot);
  const float half_log_2pi = 0.91893853320467274f;
  const float log10 = 2.30258509299404568f;
  const float log2 = 0.69314718055994531f;
  return -0.5f * c.tot[0] - (float)c.n_obs * (lsy + half_log_2pi)
         - 0.5f * c.tot[1] - (float)nc * half_log_2pi
         - 0.5f * (mu / 10.f) * (mu / 10.f) - log10 - half_log_2pi
         - 0.5f * (b / 10.f) * (b / 10.f) - log10 - half_log_2pi
         - 0.5f * (lsa / 2.f) * (lsa / 2.f) - log2 - half_log_2pi
         - 0.5f * (lsy / 2.f) * (lsy / 2.f) - log2 - half_log_2pi
         + lsa + lsy;
}

__global__ void __launch_bounds__(THREADS)
radon_leapfrog_kernel(const float* __restrict__ theta0, const float* __restrict__ m0,
                      float* __restrict__ theta_out, float* __restrict__ m_out,
                      float* __restrict__ logp_out, const float* __restrict__ y_sorted,
                      const float* __restrict__ floor_sorted,
                      const int* __restrict__ county_ptr, int n_obs, int n_counties,
                      int n_steps, float eps) {
  extern __shared__ float smem[];
  const int n_params = n_counties + 4;
  const int chain = blockIdx.x;
  float* y = smem;
  float* fl = y + n_obs;
  float* th = fl + n_obs;
  float* m = th + n_params;
  float* g = m + n_params;
  float* scratch = g + n_params;
  float* tot = scratch + WARPS * 4;
  int* ptr = reinterpret_cast<int*>(tot + 4);

  for (int i = threadIdx.x; i < n_obs; i += blockDim.x) {
    y[i] = y_sorted[i];
    fl[i] = floor_sorted[i];
  }
  for (int k = threadIdx.x; k <= n_counties; k += blockDim.x) ptr[k] = county_ptr[k];
  for (int j = threadIdx.x; j < n_params; j += blockDim.x) {
    th[j] = theta0[chain * n_params + j];
    m[j] = m0[chain * n_params + j];
  }
  __syncthreads();

  const Chain c{y, fl, ptr, scratch, tot, n_obs, n_counties};
  const float half = 0.5f * eps;
  dlogp(c, th, g);
  for (int s = 0; s < n_steps; ++s) {
    // each thread updates the entries it reads back, then all wait
    for (int j = threadIdx.x; j < n_params; j += blockDim.x) {
      m[j] += half * g[j];
      th[j] += eps * m[j];
    }
    __syncthreads();
    dlogp(c, th, g);
    for (int j = threadIdx.x; j < n_params; j += blockDim.x) m[j] += half * g[j];
    __syncthreads();
  }
  const float lp = logp(c, th);
  for (int j = threadIdx.x; j < n_params; j += blockDim.x) {
    theta_out[chain * n_params + j] = th[j];
    m_out[chain * n_params + j] = m[j];
  }
  if (threadIdx.x == 0) logp_out[chain] = lp;
}

}  // namespace

extern "C" size_t radon_leapfrog_smem_bytes(int n_obs, int n_counties) {
  return (size_t)(2 * n_obs + 3 * (n_counties + 4) + WARPS * 4 + 4) * sizeof(float) +
         (size_t)(n_counties + 1) * sizeof(int);
}

// Launches one block per chain on `stream`; returns cudaGetLastError().
extern "C" int radon_leapfrog(const float* theta0, const float* m0, float* theta_out,
                              float* m_out, float* logp_out, const float* y_sorted,
                              const float* floor_sorted, const int* county_ptr, int n_obs,
                              int n_counties, int n_chains, int n_steps, float eps,
                              void* stream) {
  const size_t smem = radon_leapfrog_smem_bytes(n_obs, n_counties);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        radon_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  radon_leapfrog_kernel<<<n_chains, THREADS, smem, (cudaStream_t)stream>>>(
      theta0, m0, theta_out, m_out, logp_out, y_sorted, floor_sorted, county_ptr, n_obs,
      n_counties, n_steps, eps);
  return (int)cudaGetLastError();
}
