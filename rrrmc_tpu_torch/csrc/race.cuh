// Device code shared by the race kernels (rejfree_sparse.cu, rejfree_dense.cu):
// one block of kThreads threads per chain, block reductions, the race over
// the sites and the shifted log-sum-exp of the Boltzmann terms. The plain
// versions (rrrmc_tpu_torch/ops/rejfree.py) add in the same order.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace rrrmc {

constexpr int kRaceThreads = 256;
constexpr int kRaceWarps = kRaceThreads / 32;
constexpr int kBkl = 0, kWtm = 1, kRrr = 2;

struct Reduce {
  float f[kRaceWarps];
  int i[kRaceWarps];
};

__device__ __forceinline__ float block_min(float v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.f[w] = v;
  __syncthreads();
  v = r.f[0];
  for (int k = 1; k < kRaceWarps; ++k) v = fminf(v, r.f[k]);
  return v;
}

// the plain version (ops/rejfree.py::block_sum) adds in this same order
__device__ __forceinline__ float block_sum(float v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.f[w] = v;
  __syncthreads();
  v = r.f[0];
  for (int k = 1; k < kRaceWarps; ++k) v += r.f[k];
  return v;
}

// (score, index) minimum, lowest index among equal scores
__device__ __forceinline__ void block_argmin(float& v, int& idx, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
    if (v2 < v || (v2 == v && i2 < idx)) { v = v2; idx = i2; }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { r.f[w] = v; r.i[w] = idx; }
  __syncthreads();
  v = r.f[0];
  idx = r.i[0];
  for (int k = 1; k < kRaceWarps; ++k) {
    if (r.f[k] < v || (r.f[k] == v && r.i[k] < idx)) { v = r.f[k]; idx = r.i[k]; }
  }
}

// beta2s * max(s*lf, 0)
template <typename T>
__device__ __forceinline__ float boltz(int8_t s, T lf, float beta2s) {
  const T half = T(s) * lf;
  return beta2s * (float)(half > T(0) ? half : T(0));
}

// min bE and log z over the N sites, bz(i) the site's Boltzmann exponent bE
template <typename BoltzAt>
__device__ float log_z(int N, BoltzAt bz, Reduce& r) {
  float mbe = INFINITY;
  for (int i = threadIdx.x; i < N; i += kRaceThreads) mbe = fminf(mbe, bz(i));
  mbe = block_min(mbe, r);
  float zs = 0.0f;
  for (int i = threadIdx.x; i < N; i += kRaceThreads) zs += expf(mbe - bz(i));
  zs = block_sum(zs, r);
  return logf(zs) - mbe;
}

// the race: score log(-log u_i) + bE_i over the N sites, u_i from the Philox
// race word of site i at move mv (four sites per call); returns the block's
// minimum score in `best` and its lowest winning index in `win`
template <typename BoltzAt>
__device__ __forceinline__ void race(int N, uint32_t seed, uint32_t chain,
                                     uint32_t mv, BoltzAt bz, float& best,
                                     int& win, Reduce& r) {
  best = INFINITY;
  win = 0x7fffffff;
  for (int g = threadIdx.x; 4 * g < N; g += kRaceThreads) {
    const uint4 w4 = philox4x32_10(make_uint4((uint32_t)g, mv, DRAW_RACE, 0u),
                                   make_uint2(seed, chain));
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * g + j;
      if (i < N) {
        const float u = to_uniform((int32_t)words[j]);
        const float sc = logf(-logf(u)) + bz(i);
        if (sc < best) { best = sc; win = i; }
      }
    }
  }
  block_argmin(best, win, r);
}

__device__ __forceinline__ int32_t geom_skip(float u2, float p) {
  // the TPU kernel's _geom_skip: floor(log(1-u)/log1p(-p)), capped at 1e9
  const float denom = log1pf(-fminf(p, 0.999999f));
  const float sk = floorf(logf(fmaxf(1.0f - u2, 1e-38f)) / denom);
  const int32_t skip = (int32_t)fminf(sk, 1.0e9f);
  return p >= 1.0f ? 0 : skip;
}

// the most dynamic shared memory a block beside a static Reduce may opt in to
inline int race_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin - (int)sizeof(Reduce);
}

}  // namespace rrrmc
