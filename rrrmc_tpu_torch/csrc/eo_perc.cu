// tau-extremal optimisation on the binary perceptrons, one thread block per
// chain. Replaces rrrmc_tpu/ops/perc_pallas.py::_eo_perc_kernel; the
// wrapper and the plain torch version are rrrmc_tpu_torch/ops/eo_perc.py.
// The rank draw, the select, the tie race and the best-state bookkeeping are
// eo.cuh's, with the key policy that ranks by lf itself: here lf holds dE,
// the energy change of each flip (int32 for step and linear, float for
// xentr), recomputed from the stabilities at every move by perc.cuh's
// perc_de over the int8 patterns (the race kernel, rejfree_perc.cu, reads
// them as bits instead).
//
// Resident in dynamic shared memory for the whole launch: dE, the select's
// counters, the spins and the best spins (eo.cuh: EoChain), then g [P] and
// the stabilities Delta [P] (int32), which come from the caller's [B, P]
// tensor and are written back at the end. Integer keys obey |dE| <= P and
// are counted in nbins = 2 P + 1 histogram bins, refilled at every move
// (every dE may change); nbins = 0 takes the radix select (xentr's float
// keys, or more than kEoHistMax bins).
//
// Bound on the H100: the N P pattern bytes the product streams from L2 at
// every move and its N P multiply-adds, beside the select's and the tie
// race's passes over the N sites.
#include <cuda_runtime.h>
#include <cstdint>

#include "eo.cuh"
#include "perc.cuh"

namespace {

using rrrmc::EoChain;
using rrrmc::EoShared;
using rrrmc::PercTables;
constexpr int kThreads = rrrmc::kEoThreads;

template <int FAM, bool HIST>
__global__ void __launch_bounds__(kThreads) eo_perc_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ delta_g,
    typename rrrmc::PercType<FAM>::T* __restrict__ E_g,
    typename rrrmc::PercType<FAM>::T* __restrict__ emin_g,
    int8_t* __restrict__ smin_g, int32_t* __restrict__ itmin_g, PercTables t,
    const float* __restrict__ cdf, int n_moves, uint32_t seed,
    uint32_t move0, uint32_t chain0, int nbins) {
  using T = typename rrrmc::PercType<FAM>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ EoShared red;
  __shared__ T scratch[kThreads / 32];
  const int N = t.N, P = t.P;
  EoChain<T, false> c(smem, N, nbins);
  T* g = reinterpret_cast<T*>(smem + rrrmc::eo_smem(N, nbins));  // [P]
  int32_t* delta = reinterpret_cast<int32_t*>(g + P);           // [P]
  const int b = blockIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  c.template load<false>(sigma, nullptr, E_g, emin_g, smin_g, itmin_g, row,
                        b);
  for (int a = threadIdx.x; a < P; a += kThreads)
    delta[a] = delta_g[(size_t)b * P + a];
  __syncthreads();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    rrrmc::perc_de<FAM, kThreads>(t, c.sig, delta, g, c.lf, scratch);
    if (HIST) c.fill_hist();
    const int w = c.template winner<HIST>(cdf, seed, chain, mv, red);
    const int sw = c.sig[w];
    c.E += c.lf[w];
    __syncthreads();  // every thread has read sig[w] / lf[w]
    rrrmc::perc_flip<kThreads>(t, w, sw, delta);
    if (threadIdx.x == 0) c.sig[w] = (int8_t)(-sw);
    __syncthreads();
    c.track(mv);
  }
  c.template store<false>(sigma, nullptr, E_g, emin_g, smin_g, itmin_g, row,
                         b);
  for (int a = threadIdx.x; a < P; a += kThreads)
    delta_g[(size_t)b * P + a] = delta[a];
}

template <int FAM, bool HIST>
int launch(int8_t* sigma, int32_t* delta, void* E, void* emin, int8_t* smin,
           int32_t* itmin, const PercTables& t, const float* cdf, int B,
           int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
           int nbins, size_t smem, cudaStream_t st) {
  using T = typename rrrmc::PercType<FAM>::T;
  auto kern = eo_perc_kernel<FAM, HIST>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(sigma, delta, (T*)E, (T*)emin, smin, itmin,
                                  t, cdf, n_moves, seed, move0, chain0,
                                  nbins);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block: EoChain's (eo.cuh), then g [P] (4
// bytes) and the stabilities [P] int32
extern "C" size_t rrrmc_eo_perc_smem(int N, int P, int nbins) {
  return rrrmc::eo_smem(N, nbins) + (size_t)P * 8;
}

// the most dynamic shared memory a block of this kernel may opt in to
// (beside its static EoShared and the block sum's scratch)
extern "C" int rrrmc_eo_perc_max_smem(int device) {
  return rrrmc::eo_max_smem(device) - kThreads / 32 * 4;
}

// fam: 0 step, 1 linear (int32 keys: nbins = 2 P + 1 bins, at most
// kEoHistMax, or 0 for the radix select), 2 xentr (float keys: nbins = 0)
extern "C" int rrrmc_eo_perc(
    int8_t* sigma, int32_t* delta, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const int8_t* xi4, const int8_t* xiT, const float* cdf,
    int N, int P, int NW, int B, int n_moves, uint32_t seed, uint32_t move0,
    uint32_t chain0, int nbins, int fam, float c, void* stream) {
  if (nbins != 0 && (fam == rrrmc::kPercXentr || nbins < 2 * P + 1
                     || nbins > rrrmc::kEoHistMax))
    return -1;
  const PercTables t{xi4, xiT, N, P, NW, c};
  const size_t smem = rrrmc_eo_perc_smem(N, P, nbins);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, delta, E, emin, smin, itmin, t, cdf, B, n_moves, \
                   seed, move0, chain0, nbins, smem, st
  if (fam == rrrmc::kPercXentr)
    return launch<rrrmc::kPercXentr, false>(RRRMC_ARGS);
  if (fam == rrrmc::kPercLinear)
    return nbins ? launch<rrrmc::kPercLinear, true>(RRRMC_ARGS)
                 : launch<rrrmc::kPercLinear, false>(RRRMC_ARGS);
  if (fam == rrrmc::kPercStep)
    return nbins ? launch<rrrmc::kPercStep, true>(RRRMC_ARGS)
                 : launch<rrrmc::kPercStep, false>(RRRMC_ARGS);
  return -1;
#undef RRRMC_ARGS
}
