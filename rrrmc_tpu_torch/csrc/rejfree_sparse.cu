// Rejection-free race kernel (bkl / wtm / rrr) on a sparse Pairwise model,
// one thread block per chain (the race, the reductions and log z are shared
// with the dense race kernel through race.cuh). Replaces
// rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_sparse_kernel and, for integer
// EA lattices (a LatticeEA is a sparse Pairwise with K = 2D), that file's
// _rejfree_kernel; the wrapper and the plain torch version are
// rrrmc_tpu_torch/ops/rejfree.py.
//
// The chain's spins (int8) and local fields (int32 or f32) stay resident in
// dynamic shared memory for the whole chunk; sigma / lf are chain-major
// [B, N] in global memory, so the load and the store are one contiguous row
// per block. Per move:
//   pass A  half = s*lf, bE = beta2s*max(half, 0); race score
//           log(-log u) + bE with u from the Philox race word of each site;
//           block argmin (lowest index on ties) and block min of bE;
//   pass B  z = sum exp(min bE - bE), log z = log(z) - min bE;
//   flip    the winner's K neighbours are updated through its own row
//           neigh[w*K + k] / J[w*K + k] (padded slots == N are skipped);
//   rrr     the flip is applied tentatively, log z' is recomputed over the
//           flipped state (passes A' and B'), and it is kept iff
//           log ua < log z - log z'; otherwise the saved lf values are put
//           back in reverse order (exact for float lf too);
//   bkl     coordinate += geometric skip (the TPU kernel's _geom_skip) + 1;
//   wtm     coordinate += exp(min score).
// A chain whose coordinate has reached `target` makes no move; it only
// writes its (coordinate, E) stream rows.
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace {

using rrrmc::Reduce;
using rrrmc::boltz;
constexpr int kThreads = rrrmc::kRaceThreads;
constexpr int kBkl = rrrmc::kBkl, kWtm = rrrmc::kWtm, kRrr = rrrmc::kRrr;

template <typename T, typename CT, int MODE>
__global__ void __launch_bounds__(kThreads) rejfree_sparse_kernel(
    int8_t* __restrict__ sigma, T* __restrict__ lf_g, T* __restrict__ E_g,
    CT* __restrict__ coord_g, int32_t* __restrict__ acc_g,
    float* __restrict__ zacc_g, CT* __restrict__ cs, T* __restrict__ es,
    const int32_t* __restrict__ neigh, const T* __restrict__ J, int N, int K,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta2s, CT target) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lf = reinterpret_cast<T*>(smem);
  T* saved = lf + N;                                   // [K], rrr undo
  int8_t* sig = reinterpret_cast<int8_t*>(saved + K);  // [N]
  __shared__ Reduce red;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  for (int i = tid; i < N; i += kThreads) {
    sig[i] = sigma[row + i];
    lf[i] = lf_g[row + i];
  }
  // per-chain scalars: every thread keeps an identical copy
  T E = E_g[b];
  CT coord = coord_g[b];
  int32_t acc = acc_g[b];
  float zacc = zacc_g[b];
  const float log_n = logf((float)N);
  // the Boltzmann exponent of site i in the resident state
  auto bz = [&](int i) { return boltz(sig[i], lf[i], beta2s); };
  __syncthreads();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    if (coord < target) {
      // pass A: race over the sites, four per Philox call
      float best;
      int win;
      rrrmc::race(N, seed, chain, mv, bz, best, win, red);
      const float logz = rrrmc::log_z(N, bz, red);
      const int8_t sw = sig[win];
      const T dE = T(2) * (T(sw) * lf[win]);
      const float zn = expf(logz - log_n);
      zacc += zn;
      const T d = T(-2 * sw);
      __syncthreads();  // every thread has read sig[win] / lf[win]
      if (tid == 0) {
        sig[win] = (int8_t)(-sw);
        for (int k = 0; k < K; ++k) {
          const int nb = neigh[win * K + k];
          if (nb < N) {
            if (MODE == kRrr) saved[k] = lf[nb];
            lf[nb] += J[win * K + k] * d;
          }
        }
      }
      __syncthreads();
      if (MODE == kRrr) {
        const float logz2 = rrrmc::log_z(N, bz, red);
        const float ua = rrrmc::to_uniform(
            rrrmc::draw_bits(seed, chain, mv, rrrmc::DRAW_ACCEPT));
        if (logf(ua) < logz - logz2) {
          E += dE;
          ++acc;
        } else if (tid == 0) {
          for (int k = K - 1; k >= 0; --k) {
            const int nb = neigh[win * K + k];
            if (nb < N) lf[nb] = saved[k];
          }
          sig[win] = sw;
        }
        coord += CT(1);
        __syncthreads();
      } else {
        E += dE;
        ++acc;
        if (MODE == kWtm) {
          coord += CT(expf(best));
        } else {
          const float u2 = rrrmc::to_uniform(
              rrrmc::draw_bits(seed, chain, mv, rrrmc::DRAW_SKIP));
          coord += CT(rrrmc::geom_skip(u2, zn) + 1);
        }
      }
    }
    if (tid == 0) {
      cs[(size_t)m * B + b] = coord;
      es[(size_t)m * B + b] = E;
    }
  }

  for (int i = tid; i < N; i += kThreads) {
    sigma[row + i] = sig[i];
    lf_g[row + i] = lf[i];
  }
  if (tid == 0) {
    E_g[b] = E;
    coord_g[b] = coord;
    acc_g[b] = acc;
    zacc_g[b] = zacc;
  }
}

template <typename T, typename CT, int MODE>
int launch(int8_t* sigma, void* lf, void* E, void* coord, int32_t* acc,
           float* zacc, void* cs, void* es, const int32_t* neigh,
           const void* J, int N, int K, int B, int n_moves, uint32_t seed,
           uint32_t move0, uint32_t chain0, float beta2s, CT target,
           size_t smem, cudaStream_t st) {
  auto kern = rejfree_sparse_kernel<T, CT, MODE>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(
      sigma, (T*)lf, (T*)E, (CT*)coord, acc, zacc, (CT*)cs, (T*)es, neigh,
      (const T*)J, N, K, B, n_moves, seed, move0, chain0, beta2s, target);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block: lf [N] and saved [K] (int32 and f32
// are both 4 bytes), sigma [N] int8
extern "C" size_t rrrmc_rejfree_sparse_smem(int N, int K) {
  return (size_t)(N + K) * 4 + (size_t)N;
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_rejfree_sparse_max_smem(int device) {
  return rrrmc::race_max_smem(device);
}

extern "C" int rrrmc_rejfree_sparse(
    int8_t* sigma, void* lf, void* E, void* coord, int32_t* acc, float* zacc,
    void* cs, void* es, const int32_t* neigh, const void* J, int N, int K,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta2s, int target_i, float target_f, int mode, int is_float,
    void* stream) {
  const size_t smem = rrrmc_rejfree_sparse_smem(N, K);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, lf, E, coord, acc, zacc, cs, es, neigh, J, N, K, B, \
                   n_moves, seed, move0, chain0, beta2s
  if (is_float) {
    if (mode == kWtm)
      return launch<float, float, kWtm>(RRRMC_ARGS, target_f, smem, st);
    if (mode == kRrr)
      return launch<float, int32_t, kRrr>(RRRMC_ARGS, target_i, smem, st);
    return launch<float, int32_t, kBkl>(RRRMC_ARGS, target_i, smem, st);
  }
  if (mode == kWtm)
    return launch<int32_t, float, kWtm>(RRRMC_ARGS, target_f, smem, st);
  if (mode == kRrr)
    return launch<int32_t, int32_t, kRrr>(RRRMC_ARGS, target_i, smem, st);
  return launch<int32_t, int32_t, kBkl>(RRRMC_ARGS, target_i, smem, st);
#undef RRRMC_ARGS
}
