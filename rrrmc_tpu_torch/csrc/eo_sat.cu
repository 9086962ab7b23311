// tau-extremal optimisation on random K-SAT, one thread block per chain.
// Replaces rrrmc_tpu/ops/sat_pallas.py::_eo_sat_kernel; the wrapper and the
// plain torch version are rrrmc_tpu_torch/ops/eo_sat.py. The rank draw, the
// select, the tie race and the best-state bookkeeping are eo.cuh's, with the
// key policy that ranks by lf itself: here lf holds dE, the exact int32
// energy change of flipping each variable (the TPU kernel's key,
// sat_pallas.py:551-578). The counts and the incremental dE are sat.cuh's.
//
// Resident in dynamic shared memory for the whole launch: dE, the select's
// counters, the spins and the best spins (eo.cuh: EoChain), then the
// per-clause satisfied counts (uint8): 6 bytes a variable and one a clause,
// 102 KB at N = 10^4, alpha = 4.2. The counts come from the caller's
// [B, Mc] int32 tensor and are written back at the end; dE is derived from
// them at the start. |dE| <= Cmax, so the keys take a histogram of
// 2 Cmax + 1 bins, which the flip keeps up to date: each atomic change of a
// dE moves one count from its old bin to its new one.
//
// Bound on the H100: the tie race's pass over the resident variables and
// the block barriers of a move; the flip touches O(Cmax K) shared words.
#include <cuda_runtime.h>
#include <cstdint>

#include "eo.cuh"
#include "sat.cuh"

namespace {

using rrrmc::EoChain;
using rrrmc::EoShared;
using rrrmc::SatTables;
constexpr int kThreads = rrrmc::kEoThreads;

// the keys counted in nbins = 2*Cmax + 1 bins
__global__ void __launch_bounds__(kThreads) eo_sat_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ cnt_g,
    int32_t* __restrict__ E_g, int32_t* __restrict__ emin_g,
    int8_t* __restrict__ smin_g, int32_t* __restrict__ itmin_g, SatTables t,
    const float* __restrict__ cdf, int n_moves, uint32_t seed,
    uint32_t move0, uint32_t chain0, int nbins) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ EoShared red;
  const int N = t.N, Mc = t.Mc;
  EoChain<int32_t, false> c(smem, N, nbins);
  uint8_t* cnt = smem + rrrmc::eo_smem(N, nbins);              // [Mc]
  const int b = blockIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  c.template load<false>(sigma, nullptr, E_g, emin_g, smin_g, itmin_g, row,
                        b);
  for (int a = threadIdx.x; a < Mc; a += kThreads)
    cnt[a] = (uint8_t)cnt_g[(size_t)b * Mc + a];
  __syncthreads();
  rrrmc::sat_init_delta<kThreads>(t, c.sig, cnt, c.lf);
  c.fill_hist();   // starts with a barrier

  int* hist = c.hist;
  auto moved = [&](int from, int to) {
    atomicSub(hist + c.bin_of_key(from), 1);
    atomicAdd(hist + c.bin_of_key(to), 1);
  };
  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    const int w = c.template winner<true>(cdf, seed, chain, mv, red);
    const int sw = c.sig[w];
    c.E += c.lf[w];
    __syncthreads();  // every thread has read sig[w] / lf[w]
    rrrmc::sat_flip<kThreads>(t, w, sw, c.sig, cnt, c.lf, moved);
    if (threadIdx.x == 0) c.sig[w] = (int8_t)(-sw);
    __syncthreads();
    c.track(mv);
  }
  c.template store<false>(sigma, nullptr, E_g, emin_g, smin_g, itmin_g, row,
                         b);
  for (int a = threadIdx.x; a < Mc; a += kThreads)
    cnt_g[(size_t)b * Mc + a] = cnt[a];
}

}  // namespace

// dynamic shared memory of one block: EoChain's (eo.cuh), then the counts
// [Mc] uint8
extern "C" size_t rrrmc_eo_sat_smem(int N, int Mc, int nbins) {
  return rrrmc::eo_smem(N, nbins) + rrrmc::bytes16(Mc);
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_eo_sat_max_smem(int device) {
  return rrrmc::eo_max_smem(device);
}

// the keys counted in nbins = 2*Cmax + 1 bins, at most kEoHistMax
extern "C" int rrrmc_eo_sat(
    int8_t* sigma, int32_t* cnt, int32_t* E, int32_t* emin, int8_t* smin,
    int32_t* itmin, const int32_t* A, const int32_t* L, const int32_t* T,
    const int32_t* TL, const float* cdf, int N, int Mc, int K, int Cmax,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    int nbins, void* stream) {
  if (nbins < 2 * Cmax + 1 || nbins > rrrmc::kEoHistMax) return -1;
  const SatTables t{A, L, T, TL, N, Mc, K, Cmax};
  const size_t smem = rrrmc_eo_sat_smem(N, Mc, nbins);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      eo_sat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  eo_sat_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      sigma, cnt, E, emin, smin, itmin, t, cdf, n_moves, seed, move0, chain0,
      nbins);
  return (int)cudaGetLastError();
}
