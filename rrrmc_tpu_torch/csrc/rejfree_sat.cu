// Rejection-free race kernel (bkl / wtm / rrr) on random K-SAT, one thread
// block per chain. Replaces rrrmc_tpu/ops/sat_pallas.py::_rejfree_sat_kernel;
// the wrapper and the plain torch version are rrrmc_tpu_torch/ops/sat.py.
// The race, the reductions and log z are race.cuh's; the counts and the
// incremental dE are sat.cuh's.
//
// The chain's spins (int8), per-clause satisfied counts (uint8) and dE
// (int32, the exact energy change of flipping each variable) stay resident
// in dynamic shared memory for the whole chunk: 5 bytes a variable and one a
// clause. The counts come from the caller's [B, Mc] int32 tensor and are
// written back to it at the end; dE is derived from them once per launch.
// Per move:
//   race    score log(-log u) + bE, bE = beta_s * max(dE, 0) (dE itself is
//           the key, so beta_s = beta * scale), block argmin and log z;
//   flip    E += dE_w; the counts and dE of w's clauses (sat.cuh: one
//           thread per clause slot, shared atomics on dE);
//   rrr     log z' over the flipped state; kept iff log ua < log z - log z',
//           otherwise the same flip is applied again (exact);
//   bkl     coordinate += geometric skip + 1; wtm: += exp(min score).
// Bound on the H100: the race and log-sum-exp passes over the N resident
// variables (a Philox call per four) and a handful of block barriers per
// move; the flip touches O(Cmax K) shared words. The TPU kernel recomputed
// dE over all Cmax slots of every variable each move (no gather in Mosaic).
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"
#include "sat.cuh"

namespace {

using rrrmc::Reduce;
using rrrmc::SatTables;
constexpr int kThreads = rrrmc::kRaceThreads;
constexpr int kBkl = rrrmc::kBkl, kWtm = rrrmc::kWtm, kRrr = rrrmc::kRrr;

struct NoMove {
  __device__ void operator()(int, int) const {}
};

template <typename CT, int MODE>
__global__ void __launch_bounds__(kThreads) rejfree_sat_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ cnt_g,
    int32_t* __restrict__ E_g, CT* __restrict__ coord_g,
    int32_t* __restrict__ acc_g, float* __restrict__ zacc_g,
    CT* __restrict__ cs, int32_t* __restrict__ es, SatTables t, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta_s, CT target) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = t.N, Mc = t.Mc;
  int32_t* dE = reinterpret_cast<int32_t*>(smem);                 // [N]
  int8_t* sig = reinterpret_cast<int8_t*>(dE + N);                // [N]
  uint8_t* cnt = reinterpret_cast<uint8_t*>(sig + rrrmc::bytes16(N));  // [Mc]
  __shared__ Reduce red;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  for (int i = tid; i < N; i += kThreads) sig[i] = sigma[(size_t)b * N + i];
  for (int a = tid; a < Mc; a += kThreads)
    cnt[a] = (uint8_t)cnt_g[(size_t)b * Mc + a];
  __syncthreads();
  rrrmc::sat_init_delta<kThreads>(t, sig, cnt, dE);
  // per-chain scalars: every thread keeps an identical copy
  int32_t E = E_g[b];
  CT coord = coord_g[b];
  int32_t acc = acc_g[b];
  float zacc = zacc_g[b];
  const float log_n = logf((float)N);
  auto bz = [&](int i) {
    const int32_t k = dE[i];
    return beta_s * (float)(k > 0 ? k : 0);
  };
  __syncthreads();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    if (coord < target) {
      float best;
      int win;
      rrrmc::race(N, seed, chain, mv, bz, best, win, red);
      const float logz = rrrmc::log_z(N, bz, red);
      const int sw = sig[win];
      const int32_t dEw = dE[win];
      const float zn = expf(logz - log_n);
      zacc += zn;
      __syncthreads();  // every thread has read sig[win] / dE[win]
      rrrmc::sat_flip<kThreads>(t, win, sw, sig, cnt, dE, NoMove());
      if (tid == 0) sig[win] = (int8_t)(-sw);
      __syncthreads();
      if (MODE == kRrr) {
        const float logz2 = rrrmc::log_z(N, bz, red);
        const float ua = rrrmc::to_uniform(
            rrrmc::draw_bits(seed, chain, mv, rrrmc::DRAW_ACCEPT));
        if (logf(ua) < logz - logz2) {
          E += dEw;
          ++acc;
        } else {
          __syncthreads();  // log z' has read dE
          rrrmc::sat_flip<kThreads>(t, win, -sw, sig, cnt, dE, NoMove());
          if (tid == 0) sig[win] = (int8_t)sw;
        }
        coord += CT(1);
        __syncthreads();
      } else {
        E += dEw;
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

  __syncthreads();
  for (int i = tid; i < N; i += kThreads) sigma[(size_t)b * N + i] = sig[i];
  for (int a = tid; a < Mc; a += kThreads)
    cnt_g[(size_t)b * Mc + a] = cnt[a];
  if (tid == 0) {
    E_g[b] = E;
    coord_g[b] = coord;
    acc_g[b] = acc;
    zacc_g[b] = zacc;
  }
}

template <typename CT, int MODE>
int launch(int8_t* sigma, int32_t* cnt, int32_t* E, void* coord,
           int32_t* acc, float* zacc, void* cs, int32_t* es,
           const SatTables& t, int B, int n_moves, uint32_t seed,
           uint32_t move0, uint32_t chain0, float beta_s, CT target,
           size_t smem, cudaStream_t st) {
  auto kern = rejfree_sat_kernel<CT, MODE>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(sigma, cnt, E, (CT*)coord, acc, zacc,
                                  (CT*)cs, es, t, B, n_moves, seed, move0,
                                  chain0, beta_s, target);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block: dE [N] int32, sigma [N] int8 and the
// counts [Mc] uint8, each rounded up to 16 bytes
extern "C" size_t rrrmc_rejfree_sat_smem(int N, int Mc) {
  return (size_t)N * 4 + rrrmc::bytes16(N) + rrrmc::bytes16(Mc);
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_rejfree_sat_max_smem(int device) {
  return rrrmc::race_max_smem(device);
}

extern "C" int rrrmc_rejfree_sat(
    int8_t* sigma, int32_t* cnt, int32_t* E, void* coord, int32_t* acc,
    float* zacc, void* cs, int32_t* es, const int32_t* A, const int32_t* L,
    const int32_t* T, const int32_t* TL, int N, int Mc, int K, int Cmax,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta_s, int target_i, float target_f, int mode, void* stream) {
  const SatTables t{A, L, T, TL, N, Mc, K, Cmax};
  const size_t smem = rrrmc_rejfree_sat_smem(N, Mc);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, cnt, E, coord, acc, zacc, cs, es, t, B, n_moves, \
                   seed, move0, chain0, beta_s
  if (mode == kWtm)
    return launch<float, kWtm>(RRRMC_ARGS, target_f, smem, st);
  if (mode == kRrr)
    return launch<int32_t, kRrr>(RRRMC_ARGS, target_i, smem, st);
  return launch<int32_t, kBkl>(RRRMC_ARGS, target_i, smem, st);
#undef RRRMC_ARGS
}
