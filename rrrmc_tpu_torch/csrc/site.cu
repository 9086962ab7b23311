// Single-site Metropolis on a sparse Pairwise model, one thread per chain.
// Replaces rrrmc_tpu/ops/site_pallas.py::_site_kernel; the wrapper and the
// plain torch version are rrrmc_tpu_torch/ops/site.py.
//
// Layout: sigT / lfT are site-major [N, B]. The site schedule is shared by
// the batch, so at move m every thread of a warp reads row i = sites[m] at
// consecutive chains: each access of sigma, lf and the O(K) neighbour update
// is one coalesced row segment. Neighbour ids and couplings come from the
// winner's own row neigh[i*K + k] / J[i*K + k]; padded slots (== N) are
// skipped.
//
// Acceptance is the integer threshold test of the TPU kernel: with the f32
// p = exp(-beta_s * dE), th = clip(p * 2^32 - 2^31) and the move is accepted
// iff dE <= 0 or bits < th, bits being the int32 Philox word of counter
// (0, move0 + m, DRAW_SITE, 0) under key (seed, chain0 + b).
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace {

template <typename T>
__global__ void site_metropolis_kernel(
    const int32_t* __restrict__ sites, int n_moves,
    const int32_t* __restrict__ neigh, const T* __restrict__ J, int N, int K,
    int B, int8_t* __restrict__ sigT, T* __restrict__ lfT,
    T* __restrict__ E, int32_t* __restrict__ acc, uint32_t seed,
    uint32_t move0, uint32_t chain0, float beta_s) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T dE_sum = T(0);
  int32_t n_acc = 0;
  for (int m = 0; m < n_moves; ++m) {
    const int i = sites[m];
    const size_t o = (size_t)i * B + b;
    const int s = sigT[o];
    const T dE = T(2 * s) * lfT[o];
    const float p = expf(-beta_s * (float)dE);
    float thf = p * 4294967296.0f - 2147483648.0f;
    thf = fminf(fmaxf(thf, -2147483648.0f), 2147483520.0f);
    const int32_t th = (int32_t)thf;
    const int32_t bits =
        rrrmc::draw_bits(seed, chain0 + b, move0 + m, rrrmc::DRAW_SITE);
    if (dE <= T(0) || bits < th) {
      sigT[o] = (int8_t)(-s);
      const T d = T(-2 * s);
      for (int k = 0; k < K; ++k) {
        const int nb = neigh[i * K + k];
        if (nb < N) lfT[(size_t)nb * B + b] += J[i * K + k] * d;
      }
      dE_sum += dE;
      ++n_acc;
    }
  }
  E[b] += dE_sum;
  acc[b] += n_acc;
}

}  // namespace

extern "C" int rrrmc_site_metropolis(
    const int32_t* sites, int n_moves, const int32_t* neigh, const void* J,
    int N, int K, int B, int8_t* sigT, void* lfT, void* E, int32_t* acc,
    uint32_t seed, uint32_t move0, uint32_t chain0, float beta_s,
    int is_float, void* stream) {
  const int threads = 32;  // one warp per SM spreads small batches widely
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    site_metropolis_kernel<float><<<blocks, threads, 0, st>>>(
        sites, n_moves, neigh, (const float*)J, N, K, B, sigT, (float*)lfT,
        (float*)E, acc, seed, move0, chain0, beta_s);
  } else {
    site_metropolis_kernel<int32_t><<<blocks, threads, 0, st>>>(
        sites, n_moves, neigh, (const int32_t*)J, N, K, B, sigT,
        (int32_t*)lfT, (int32_t*)E, acc, seed, move0, chain0, beta_s);
  }
  return (int)cudaGetLastError();
}
