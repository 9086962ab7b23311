// Rejection-free race kernel (bkl / wtm / rrr) on the binary perceptrons
// (step, linear and xentr losses), one thread block per chain. Replaces
// rrrmc_tpu/ops/perc_pallas.py::_rejfree_perc_kernel; the wrapper and the
// plain torch version are rrrmc_tpu_torch/ops/perc.py. The race, the
// reductions and log z are race.cuh's; dE from the stabilities and the
// stability update are perc.cuh's.
//
// Resident in dynamic shared memory for the whole chunk: dE [N] and g [P]
// (int32, float for xentr), the stabilities Delta [P] (int32) and the spins
// [N] (int8). Delta comes from the caller's [B, P] int32 tensor and is
// written back to it at the end. Per move:
//   dE      perc_de: the g pass, the product xi^T g over the P patterns (read
//           from global memory, shared by every chain) and dE = dE2 / 2;
//   race    score log(-log u) + bE, bE = beta_s * max(dE, 0), block argmin
//           and log z;
//   flip    E += dE_w; Delta += -2 sigma_w xi[:, w]; sigma_w = -sigma_w;
//   rrr     dE and log z' over the flipped state (a second product); kept
//           iff log ua < log z - log z', otherwise the flip is undone (exact,
//           integer stabilities);
//   bkl     coordinate += geometric skip + 1; wtm: += exp(min score).
// Bound on the H100: the N P pattern bytes each product streams from L2
// and the product's N P multiply-adds, beside the race's passes over the N
// sites. The TPU kernel ran the product and the rank-1 stability update on
// its MXU over 128-padded blocks of chains.
#include <cuda_runtime.h>
#include <cstdint>

#include "perc.cuh"
#include "race.cuh"

namespace {

using rrrmc::PercTables;
using rrrmc::Reduce;
constexpr int kThreads = rrrmc::kRaceThreads;
constexpr int kBkl = rrrmc::kBkl, kWtm = rrrmc::kWtm, kRrr = rrrmc::kRrr;

template <int FAM, typename CT, int MODE>
__global__ void __launch_bounds__(kThreads) rejfree_perc_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ delta_g,
    typename rrrmc::PercType<FAM>::T* __restrict__ E_g,
    CT* __restrict__ coord_g, int32_t* __restrict__ acc_g,
    float* __restrict__ zacc_g, CT* __restrict__ cs,
    typename rrrmc::PercType<FAM>::T* __restrict__ es, PercTables t, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta_s, CT target) {
  using T = typename rrrmc::PercType<FAM>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = t.N, P = t.P;
  T* dE = reinterpret_cast<T*>(smem);                          // [N]
  T* g = dE + N;                                               // [P]
  int32_t* delta = reinterpret_cast<int32_t*>(g + P);          // [P]
  int8_t* sig = reinterpret_cast<int8_t*>(delta + P);          // [N]
  __shared__ Reduce red;
  __shared__ T scratch[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  for (int i = tid; i < N; i += kThreads) sig[i] = sigma[(size_t)b * N + i];
  for (int a = tid; a < P; a += kThreads)
    delta[a] = delta_g[(size_t)b * P + a];
  // per-chain scalars: every thread keeps an identical copy
  T E = E_g[b];
  CT coord = coord_g[b];
  int32_t acc = acc_g[b];
  float zacc = zacc_g[b];
  const float log_n = logf((float)N);
  auto bz = [&](int i) {
    const T k = dE[i];
    return beta_s * (float)(k > T(0) ? k : T(0));
  };
  __syncthreads();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    if (coord < target) {
      rrrmc::perc_de<FAM, kThreads>(t, sig, delta, g, dE, scratch);
      float best;
      int win;
      rrrmc::race(N, seed, chain, mv, bz, best, win, red);
      const float logz = rrrmc::log_z(N, bz, red);
      const int sw = sig[win];
      const T dEw = dE[win];
      const float zn = expf(logz - log_n);
      zacc += zn;
      __syncthreads();  // every thread has read sig[win] / dE[win]
      rrrmc::perc_flip<kThreads>(t, win, sw, delta);
      if (tid == 0) sig[win] = (int8_t)(-sw);
      __syncthreads();
      if (MODE == kRrr) {
        rrrmc::perc_de<FAM, kThreads>(t, sig, delta, g, dE, scratch);
        const float logz2 = rrrmc::log_z(N, bz, red);
        const float ua = rrrmc::to_uniform(
            rrrmc::draw_bits(seed, chain, mv, rrrmc::DRAW_ACCEPT));
        if (logf(ua) < logz - logz2) {
          E += dEw;
          ++acc;
        } else {
          rrrmc::perc_flip<kThreads>(t, win, -sw, delta);
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
  for (int a = tid; a < P; a += kThreads)
    delta_g[(size_t)b * P + a] = delta[a];
  if (tid == 0) {
    E_g[b] = E;
    coord_g[b] = coord;
    acc_g[b] = acc;
    zacc_g[b] = zacc;
  }
}

template <int FAM, typename CT, int MODE>
int launch(int8_t* sigma, int32_t* delta, void* E, void* coord, int32_t* acc,
           float* zacc, void* cs, void* es, const PercTables& t, int B,
           int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
           float beta_s, CT target, size_t smem, cudaStream_t st) {
  using T = typename rrrmc::PercType<FAM>::T;
  auto kern = rejfree_perc_kernel<FAM, CT, MODE>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(sigma, delta, (T*)E, (CT*)coord, acc, zacc,
                                  (CT*)cs, (T*)es, t, B, n_moves, seed,
                                  move0, chain0, beta_s, target);
  return (int)cudaGetLastError();
}

template <int FAM>
int launch_mode(int8_t* sigma, int32_t* delta, void* E, void* coord,
                int32_t* acc, float* zacc, void* cs, void* es,
                const PercTables& t, int B, int n_moves, uint32_t seed,
                uint32_t move0, uint32_t chain0, float beta_s, int target_i,
                float target_f, int mode, size_t smem, cudaStream_t st) {
#define RRRMC_ARGS sigma, delta, E, coord, acc, zacc, cs, es, t, B, n_moves, \
                   seed, move0, chain0, beta_s
  if (mode == kWtm)
    return launch<FAM, float, kWtm>(RRRMC_ARGS, target_f, smem, st);
  if (mode == kRrr)
    return launch<FAM, int32_t, kRrr>(RRRMC_ARGS, target_i, smem, st);
  return launch<FAM, int32_t, kBkl>(RRRMC_ARGS, target_i, smem, st);
#undef RRRMC_ARGS
}

}  // namespace

// dynamic shared memory of one block: dE [N] and g [P] (4 bytes each), the
// stabilities [P] int32 and the spins [N] int8, rounded up to 16 bytes
extern "C" size_t rrrmc_rejfree_perc_smem(int N, int P) {
  return (size_t)N * 4 + (size_t)P * 8 + ((size_t)N + 15) / 16 * 16;
}

// the most dynamic shared memory a block of this kernel may opt in to
// (beside its static Reduce and the block sum's scratch)
extern "C" int rrrmc_rejfree_perc_max_smem(int device) {
  return rrrmc::race_max_smem(device) - kThreads / 32 * 4;
}

// fam: 0 step, 1 linear (int32 E and streams), 2 xentr (float)
extern "C" int rrrmc_rejfree_perc(
    int8_t* sigma, int32_t* delta, void* E, void* coord, int32_t* acc,
    float* zacc, void* cs, void* es, const int8_t* xi4, const int8_t* xiT,
    int N, int P, int NW, int B, int n_moves, uint32_t seed, uint32_t move0,
    uint32_t chain0, float beta_s, int target_i, float target_f, int mode,
    int fam, float c, void* stream) {
  const PercTables t{xi4, xiT, N, P, NW, c};
  const size_t smem = rrrmc_rejfree_perc_smem(N, P);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, delta, E, coord, acc, zacc, cs, es, t, B, n_moves, \
                   seed, move0, chain0, beta_s, target_i, target_f, mode,   \
                   smem, st
  if (fam == rrrmc::kPercXentr)
    return launch_mode<rrrmc::kPercXentr>(RRRMC_ARGS);
  if (fam == rrrmc::kPercLinear)
    return launch_mode<rrrmc::kPercLinear>(RRRMC_ARGS);
  if (fam == rrrmc::kPercStep)
    return launch_mode<rrrmc::kPercStep>(RRRMC_ARGS);
  return -1;
#undef RRRMC_ARGS
}
