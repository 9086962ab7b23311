// Device code of the perceptron kernels (rejfree_perc.cu, eo_perc.cu): the
// family codes and types and g's terms, gm_a and gp_a elementwise in the
// stability Delta_a (step: Delta == 1 and -(Delta == -1); linear: Delta < 2
// and -(Delta < 0); xentr: the stable softplus of -c (Delta -+ 2) less that
// of -c Delta), g_a = gm_a - gp_a. Both kernels compute dE from the pattern
// bits themselves. The plain versions are rrrmc_tpu_torch/ops/perc.py and
// ops/eo_perc.py (de_flip).
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

}  // namespace rrrmc
