// Device code of the perceptron kernels: the family codes and types and
// g's terms (`perc_terms`, both kernels); for the EO kernel (eo_perc.cu)
// the energy change of every flip from a chain's stabilities Delta [P],
// resident in shared memory beside its spins, and the flip's stability
// update (the race kernel, rejfree_perc.cu, computes both from the pattern
// bits itself). The plain versions are rrrmc_tpu_torch/ops/perc.py and
// ops/eo_perc.py (de_flip).
//
//   g pass   gm_a, gp_a elementwise in Delta_a (step: Delta == 1 and
//            -(Delta == -1); linear: Delta < 2 and -(Delta < 0); xentr: the
//            stable softplus of -c (Delta -+ 2) less that of -c Delta);
//            g_a = gm_a - gp_a and tot = the block sum of gm_a + gp_a, in the
//            order of ops/rejfree.py::block_sum;
//   product  proj_i = sum_a xi_ai g_a, a = 0 .. P-1 in turn, one thread per
//            word of four sites of the padded [P, 4 NW] int8 patterns (one
//            coalesced 32-bit load a pattern); int32 for step and linear,
//            float32 for xentr;
//   dE       dE2_i = tot + sigma_i proj_i; dE_i = dE2_i >> 1 (exact: dE2 is
//            even) or dE2_i * 0.5f.
// The flip of w adds -2 sigma_w xi^T[w, :] to Delta (one row of the [N, P]
// site-major copy).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace rrrmc {

constexpr int kPercStep = 0, kPercLinear = 1, kPercXentr = 2;

// the type of g, dE and E: int32 for step and linear, float for xentr
template <int FAM>
struct PercType {
  using T = int32_t;
};
template <>
struct PercType<kPercXentr> {
  using T = float;
};

struct PercTables {
  const int8_t* __restrict__ xi;   // [P, 4 NW] patterns, zero past N
  const int8_t* __restrict__ xiT;  // [N, P] the same, site-major
  int N, P, NW;
  float c;  // xentr: 2 lam / sqrt(N)
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// (gm, gp) of a pattern at stability d; nc = -c
template <int FAM, typename T>
__device__ __forceinline__ void perc_terms(int32_t d, float nc, T& gm,
                                           T& gp) {
  if constexpr (FAM == kPercStep) {
    gm = d == 1 ? 1 : 0;
    gp = d == -1 ? -1 : 0;
  } else if constexpr (FAM == kPercLinear) {
    gm = d < 2 ? 1 : 0;
    gp = d < 0 ? -1 : 0;
  } else {
    const float x = (float)d;
    const float sp0 = softplus(nc * x);
    gm = softplus(nc * (x - 2.0f)) - sp0;
    gp = softplus(nc * (x + 2.0f)) - sp0;
  }
}

// the block's total of v, in the order of race.cuh's block_sum (warp
// butterfly, then the warps' sums in turn); scratch holds THREADS / 32
// values
template <int THREADS, typename T>
__device__ __forceinline__ T perc_block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[w] = v;
  __syncthreads();
  v = scratch[0];
  for (int k = 1; k < THREADS / 32; ++k) v += scratch[k];
  return v;
}

// dE [N] of every flip from the stabilities delta [P], by the whole block,
// through g [P]; ends with a barrier, so dE is visible to every thread
template <int FAM, int THREADS, typename T>
__device__ void perc_de(const PercTables& t, const int8_t* sig,
                        const int32_t* delta, T* g, T* dE, T* scratch) {
  const float nc = -t.c;
  T part = T(0);
  for (int a = threadIdx.x; a < t.P; a += THREADS) {
    T gm, gp;
    perc_terms<FAM>(delta[a], nc, gm, gp);
    g[a] = gm - gp;
    part += gm + gp;
  }
  const T tot = perc_block_sum<THREADS>(part, scratch);  // publishes g
  const char4* xi4 = reinterpret_cast<const char4*>(t.xi);
  for (int w = threadIdx.x; w < t.NW; w += THREADS) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
    for (int a = 0; a < t.P; ++a) {
      const char4 x = __ldg(xi4 + (size_t)a * t.NW + w);
      const T ga = g[a];
      acc[0] += T(x.x) * ga;
      acc[1] += T(x.y) * ga;
      acc[2] += T(x.z) * ga;
      acc[3] += T(x.w) * ga;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * w + j;
      if (i < t.N) {
        const T d2 = tot + T(sig[i]) * acc[j];
        if constexpr (FAM == kPercXentr) {
          dE[i] = d2 * 0.5f;
        } else {
          dE[i] = d2 >> 1;
        }
      }
    }
  }
  __syncthreads();
}

// Delta += -2 sw xi[:, w], by the whole block (the caller synchronises
// before and after)
template <int THREADS>
__device__ __forceinline__ void perc_flip(const PercTables& t, int w, int sw,
                                          int32_t* delta) {
  const int8_t* col = t.xiT + (size_t)w * t.P;
  const int d = -2 * sw;
  for (int a = threadIdx.x; a < t.P; a += THREADS)
    delta[a] += d * (int)__ldg(col + a);
}

}  // namespace rrrmc
