// tau-extremal optimisation on a FullyConnected model, one thread block per
// chain. Replaces the dense branch of rrrmc_tpu/ops/eo_pallas.py::_eo_kernel
// (J resident in VMEM: integer N <= 4096, float N <= 2048) and that file's
// _eo_stream_kernel (J streamed from HBM beyond): the TPU split them by VMEM
// size and recomputed lf = J sigma every move, one matmul or one streamed
// pass over J, because Mosaic cannot address a row per lane. Here J is read
// from device memory or L2 at every N, so one kernel serves both. The wrapper
// and the plain torch version are rrrmc_tpu_torch/ops/eo_dense.py; the rank
// draw, the select, the tie race and the best-state bookkeeping are shared
// with the sparse EO kernel (eo.cuh).
//
// The chain's spins, local fields (int32 for int8 J, f32 for f32 J) and best
// spins stay resident in dynamic shared memory for the whole launch, 6 bytes
// a site (196 KB at N = 32768), beside the select's counters (eo.cuh:
// EoChain). Per move: the rank, the select (integer keys: one block scan
// over the histogram; float keys: four radix passes), one tie-race pass,
// then one pass that adds the winner's row of J, d * J[w, :] with
// d = -2 s_w, to every field (the winner flips; its own field is unchanged
// by J's zero diagonal) and moves each changed integer key between
// histogram bins with shared atomics. Integer J is exact; float J adds one
// rounding per site and move where the TPU recomputed lf.
//
// Bound on the H100: the three to six passes over the N resident sites per
// move (the row update, the tie race, the radix passes for float keys) with
// their block barriers, plus one row of J per move from L2 or device memory
// (N bytes for integer J, 4N for float J).
#include <cuda_runtime.h>
#include <cstdint>

#include "eo.cuh"

namespace {

using rrrmc::EoChain;
using rrrmc::EoShared;
constexpr int kThreads = rrrmc::kEoThreads;

// T: local fields and energies (int32 / f32); JT: couplings (int8 / f32);
// HIST: integer keys counted in nbins = 2*half_max + 1 bins, else the radix
// select
template <typename T, typename JT, bool HIST>
__global__ void __launch_bounds__(kThreads) eo_dense_kernel(
    int8_t* __restrict__ sigma, T* __restrict__ lf_g, T* __restrict__ E_g,
    T* __restrict__ emin_g, int8_t* __restrict__ smin_g,
    int32_t* __restrict__ itmin_g, const JT* __restrict__ J,
    const float* __restrict__ cdf, int N, int n_moves, uint32_t seed,
    uint32_t move0, uint32_t chain0, int nbins) {
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
    const T d = T(-2 * sw);
    const JT* jrow = J + (size_t)w * N;
    __syncthreads();  // every thread has read sig[w] / lf[w]
    // the flip: lf += d * J[w, :] at every site, each changed key moved
    // between histogram bins
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const T dj = d * T(__ldg(jrow + i));
      const bool moved = HIST && (i == w || dj != T(0));
      const int old_bin = moved ? c.bin_of(i) : 0;
      c.lf[i] += dj;
      if (i == w) c.sig[i] = (int8_t)(-sw);
      if (moved) {
        const int new_bin = c.bin_of(i);
        if (new_bin != old_bin) {
          atomicSub(c.hist + old_bin, 1);
          atomicAdd(c.hist + new_bin, 1);
        }
      }
    }
    c.track(mv);
  }
  c.store(sigma, lf_g, E_g, emin_g, smin_g, itmin_g, row, b);
}

template <typename T, typename JT, bool HIST>
int launch(int8_t* sigma, void* lf, void* E, void* emin, int8_t* smin,
           int32_t* itmin, const void* J, const float* cdf, int N, int B,
           int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
           int nbins, size_t smem, cudaStream_t st) {
  auto kern = eo_dense_kernel<T, JT, HIST>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(sigma, (T*)lf, (T*)E, (T*)emin, smin,
                                  itmin, (const JT*)J, cdf, N, n_moves, seed,
                                  move0, chain0, nbins);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block (eo.cuh: EoChain)
extern "C" size_t rrrmc_eo_dense_smem(int N, int nbins) {
  return rrrmc::eo_smem(N, nbins);
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_eo_dense_max_smem(int device) {
  return rrrmc::eo_max_smem(device);
}

// is_float: f32 J, lf and E; else int8 J with int32 lf and E. nbins > 0:
// integer keys counted in nbins = 2*half_max + 1 bins; 0: radix select
extern "C" int rrrmc_eo_dense(
    int8_t* sigma, void* lf, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const void* J, const float* cdf, int N, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0, int nbins,
    int is_float, void* stream) {
  if (nbins > rrrmc::kEoHistMax || (is_float && nbins > 0)) return -1;
  const size_t smem = rrrmc_eo_dense_smem(N, nbins);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, lf, E, emin, smin, itmin, J, cdf, N, B, n_moves, \
                   seed, move0, chain0, nbins, smem, st
  if (is_float) return launch<float, float, false>(RRRMC_ARGS);
  if (nbins > 0) return launch<int32_t, int8_t, true>(RRRMC_ARGS);
  return launch<int32_t, int8_t, false>(RRRMC_ARGS);
#undef RRRMC_ARGS
}
