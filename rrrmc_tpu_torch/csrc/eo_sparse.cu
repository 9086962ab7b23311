// tau-extremal optimisation on a sparse Pairwise model, one thread block per
// chain. Replaces rrrmc_tpu/ops/eo_pallas.py::_eo_sparse_kernel and, for
// integer EA lattices (to EO a LatticeEA is a sparse Pairwise with K = 2D and
// its padded tables), the lattice branch of that file's _eo_kernel; the
// wrapper and the plain torch version are rrrmc_tpu_torch/ops/eo.py. The
// rank draw, the select, the tie race and the best-state bookkeeping are
// shared with the dense EO kernel (eo.cuh).
//
// The chain's spins, local fields (int32 or f32) and best spins stay resident
// in dynamic shared memory for the whole launch, 6 bytes a site, beside the
// select's counters (eo.cuh: EoChain). Per move: the rank, the select
// (integer keys: one block scan over the histogram; float keys: four radix
// passes over the N sites), one tie-race pass over the N sites, then one
// thread flips the winner and updates its K neighbours' fields through its
// own table row neigh[w*K + k] / J[w*K + k] (padded slots == N are skipped),
// moving the K + 1 changed keys between histogram bins. The TPU kernel found
// the order statistic by up to 32 counting passes and updated lf by
// comparing every site's K inverse columns, because Mosaic has no gather.
//
// With PSPIN the same kernel is tau-EO on a PSpin3 hypergraph (replaces
// _eo_pspin_kernel; wrapper rrrmc_tpu_torch/ops/eo_pspin.py): lf holds the
// cavity sums c, the keys s*c lie in [-K', K'] (2K' + 1 bins), and neigh is
// the partner table A [N, K', 2] read as rows of width K = 2K'; the flip adds
// d * s[partner of the partner] to each partner's sum (rejfree_sparse.cu).
// A site that shares two triangles with the winner is moved between bins
// once per update, so the histogram stays exact.
//
// Bound on the H100: the passes over the resident sites (the tie race's key
// compares, the radix passes for float keys, a Philox call per group of four
// sites that holds a member) and a few block barriers per move; global
// memory is touched for the winner's table row and one cdf binary search.
#include <cuda_runtime.h>
#include <cstdint>

#include "eo.cuh"

namespace {

using rrrmc::EoChain;
using rrrmc::EoShared;
constexpr int kThreads = rrrmc::kEoThreads;

// T: local fields, couplings and energies (int32 / f32); HIST: integer keys
// counted in nbins = 2*half_max + 1 bins, else the radix select; PSPIN: the
// hypergraph flip
template <typename T, bool HIST, bool PSPIN>
__global__ void __launch_bounds__(kThreads) eo_sparse_kernel(
    int8_t* __restrict__ sigma, T* __restrict__ lf_g, T* __restrict__ E_g,
    T* __restrict__ emin_g, int8_t* __restrict__ smin_g,
    int32_t* __restrict__ itmin_g, const int32_t* __restrict__ neigh,
    const T* __restrict__ J, const float* __restrict__ cdf, int N, int K,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0, int nbins) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ EoShared red;
  EoChain<T> c(smem, N, nbins);
  const int b = blockIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  c.load(sigma, lf_g, E_g, emin_g, smin_g, itmin_g, row, b);
  if (HIST) c.fill_hist();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    const int w = c.template winner<HIST>(cdf, seed, chain, mv, red);
    const int8_t sw = c.sig[w];
    c.E += T(2) * (T(sw) * c.lf[w]);
    __syncthreads();  // every thread has read sig[w] / lf[w]
    if (threadIdx.x == 0) {
      // the flip: the winner's K neighbours through its own table row,
      // moving each changed key between histogram bins
      if (HIST) --c.hist[c.bin_of(w)];
      c.sig[w] = (int8_t)(-sw);
      const T d = T(-2 * sw);
      for (int k = 0; k < K; ++k) {
        const int nb = neigh[w * K + k];
        if (nb < N) {
          if (HIST) --c.hist[c.bin_of(nb)];
          c.lf[nb] += PSPIN ? d * T(c.sig[neigh[w * K + (k ^ 1)]])
                            : J[w * K + k] * d;
          if (HIST) ++c.hist[c.bin_of(nb)];
        }
      }
      if (HIST) ++c.hist[c.bin_of(w)];
    }
    c.track(mv);
  }
  c.store(sigma, lf_g, E_g, emin_g, smin_g, itmin_g, row, b);
}

template <typename T, bool HIST, bool PSPIN = false>
int launch(int8_t* sigma, void* lf, void* E, void* emin, int8_t* smin,
           int32_t* itmin, const int32_t* neigh, const void* J,
           const float* cdf, int N, int K, int B, int n_moves, uint32_t seed,
           uint32_t move0, uint32_t chain0, int nbins, size_t smem,
           cudaStream_t st) {
  auto kern = eo_sparse_kernel<T, HIST, PSPIN>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(sigma, (T*)lf, (T*)E, (T*)emin, smin,
                                  itmin, neigh, (const T*)J, cdf, N, K,
                                  n_moves, seed, move0, chain0, nbins);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block (eo.cuh: EoChain)
extern "C" size_t rrrmc_eo_sparse_smem(int N, int nbins) {
  return rrrmc::eo_smem(N, nbins);
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_eo_sparse_max_smem(int device) {
  return rrrmc::eo_max_smem(device);
}

// nbins > 0: integer keys counted in nbins = 2*half_max + 1 bins; 0: radix
// select (float couplings, or integer ones of a wide range)
extern "C" int rrrmc_eo_sparse(
    int8_t* sigma, void* lf, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const int32_t* neigh, const void* J, const float* cdf,
    int N, int K, int B, int n_moves, uint32_t seed, uint32_t move0,
    uint32_t chain0, int nbins, int is_float, void* stream) {
  if (nbins > rrrmc::kEoHistMax || (is_float && nbins > 0)) return -1;
  const size_t smem = rrrmc_eo_sparse_smem(N, nbins);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, lf, E, emin, smin, itmin, neigh, J, cdf, N, K, B, \
                   n_moves, seed, move0, chain0, nbins, smem, st
  if (is_float) return launch<float, false>(RRRMC_ARGS);
  if (nbins > 0) return launch<int32_t, true>(RRRMC_ARGS);
  return launch<int32_t, false>(RRRMC_ARGS);
#undef RRRMC_ARGS
}

// tau-EO on a PSpin3: lf = the cavity sums (int32), neigh = A [N, K/2, 2]
// read as [N, K], no couplings; nbins = K + 1 (the keys' 2 * K/2 + 1 values)
extern "C" int rrrmc_eo_pspin(
    int8_t* sigma, void* c, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const int32_t* A, const float* cdf, int N, int K, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0, int nbins,
    void* stream) {
  if (nbins <= 0 || nbins > rrrmc::kEoHistMax) return -1;
  return launch<int32_t, true, true>(
      sigma, c, E, emin, smin, itmin, A, nullptr, cdf, N, K, B, n_moves,
      seed, move0, chain0, nbins, rrrmc_eo_sparse_smem(N, nbins),
      (cudaStream_t)stream);
}
