// Rejection-free race kernel (bkl / wtm / rrr) on a FullyConnected model,
// one thread block per chain. Replaces
// rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_dense_kernel (J resident in VMEM)
// and ::_rejfree_stream_kernel (J streamed from HBM): the TPU split them by
// VMEM size, here J is read from device memory or L2 in both cases, so one
// kernel serves every N. The wrapper and the plain torch version are
// rrrmc_tpu_torch/ops/rejfree_dense.py; the race, the reductions and log z
// are shared with the sparse race kernel (race.cuh).
//
// The TPU kernels recomputed lf = J sigma every move (one matmul, or one
// streamed pass over J) because Mosaic cannot address a row per lane. Here,
// as in the sparse kernel, the chain's spins (int8) and local fields (int32
// for integer J, f32 for float J) stay resident in dynamic shared memory for
// the whole chunk, 5 bytes a site, and a flip adds the winner's row of J,
// d * J[w, :] with d = -2 s_w, read from global memory (int8 for integer J,
// f32 for float J): O(N) per move. Per move:
//   race    score log(-log u) + beta2s*max(s*lf, 0), block argmin (lowest
//           index on ties) and the shifted log-sum-exp log z (race.cuh);
//   rrr     log z' of the flipped state is computed without touching the
//           resident state, site i's field read as lf_i + d*J[w, i] (J has a
//           zero diagonal, so the winner's own field is unchanged and its
//           spin is negated); the flip is applied iff log ua < log z - log z';
//   apply   lf_i += d*J[w, i] for every site, sig[w] = -s_w: for float J the
//           same rounding as the z' pass, so nothing has to be undone;
//   bkl     coordinate += geometric skip + 1; wtm: += exp(min score).
// A chain whose coordinate has reached `target` makes no move; it only
// writes its (coordinate, E) stream rows.
//
// Bound on the H100: the arithmetic of the two to four passes over the N
// resident sites per move (a Philox call per four sites, a log pair and an
// exp per site) with a few block barriers, plus one row of J per applied
// flip from L2 or device memory (N bytes for integer J). Float J drifts by
// one rounding per applied move and site, where the TPU recomputed lf.
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace {

using rrrmc::Reduce;
using rrrmc::boltz;
constexpr int kThreads = rrrmc::kRaceThreads;
constexpr int kBkl = rrrmc::kBkl, kWtm = rrrmc::kWtm, kRrr = rrrmc::kRrr;

// T: local fields and E (int32 / f32); JT: couplings (int8 / f32)
template <typename T, typename JT, typename CT, int MODE>
__global__ void __launch_bounds__(kThreads) rejfree_dense_kernel(
    int8_t* __restrict__ sigma, T* __restrict__ lf_g, T* __restrict__ E_g,
    CT* __restrict__ coord_g, int32_t* __restrict__ acc_g,
    float* __restrict__ zacc_g, CT* __restrict__ cs, T* __restrict__ es,
    const JT* __restrict__ J, int N, int B, int n_moves, uint32_t seed,
    uint32_t move0, uint32_t chain0, float beta2s, CT target) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lf = reinterpret_cast<T*>(smem);                // [N]
  int8_t* sig = reinterpret_cast<int8_t*>(lf + N);   // [N]
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
  auto bz = [&](int i) { return boltz(sig[i], lf[i], beta2s); };
  __syncthreads();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    if (coord < target) {
      float best;
      int win;
      rrrmc::race(N, seed, chain, mv, bz, best, win, red);
      const float logz = rrrmc::log_z(N, bz, red);
      const int8_t sw = sig[win];
      const T dE = T(2) * (T(sw) * lf[win]);
      const float zn = expf(logz - log_n);
      zacc += zn;
      const T d = T(-2 * sw);
      const JT* jrow = J + (size_t)win * N;
      bool apply = true;
      if (MODE == kRrr) {
        auto bz2 = [&](int i) {
          const int8_t s = i == win ? (int8_t)(-sig[i]) : sig[i];
          return boltz(s, T(lf[i] + d * T(jrow[i])), beta2s);
        };
        const float logz2 = rrrmc::log_z(N, bz2, red);
        const float ua = rrrmc::to_uniform(
            rrrmc::draw_bits(seed, chain, mv, rrrmc::DRAW_ACCEPT));
        apply = logf(ua) < logz - logz2;
        coord += CT(1);
      } else if (MODE == kWtm) {
        coord += CT(expf(best));
      } else {
        const float u2 = rrrmc::to_uniform(
            rrrmc::draw_bits(seed, chain, mv, rrrmc::DRAW_SKIP));
        coord += CT(rrrmc::geom_skip(u2, zn) + 1);
      }
      if (apply) {
        E += dE;
        ++acc;
        __syncthreads();  // every thread has read sig[win] and lf
        for (int i = tid; i < N; i += kThreads) lf[i] += d * T(jrow[i]);
        if (tid == 0) sig[win] = (int8_t)(-sw);
        __syncthreads();
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

template <typename T, typename JT, typename CT, int MODE>
int launch(int8_t* sigma, void* lf, void* E, void* coord, int32_t* acc,
           float* zacc, void* cs, void* es, const void* J, int N, int B,
           int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
           float beta2s, CT target, size_t smem, cudaStream_t st) {
  auto kern = rejfree_dense_kernel<T, JT, CT, MODE>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(
      sigma, (T*)lf, (T*)E, (CT*)coord, acc, zacc, (CT*)cs, (T*)es,
      (const JT*)J, N, B, n_moves, seed, move0, chain0, beta2s, target);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block: lf [N] (int32 and f32 are both 4
// bytes) and sigma [N] int8
extern "C" size_t rrrmc_rejfree_dense_smem(int N) {
  return (size_t)N * 4 + (size_t)N;
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_rejfree_dense_max_smem(int device) {
  return rrrmc::race_max_smem(device);
}

// is_float: f32 J, lf and E; else int8 J with int32 lf and E
extern "C" int rrrmc_rejfree_dense(
    int8_t* sigma, void* lf, void* E, void* coord, int32_t* acc, float* zacc,
    void* cs, void* es, const void* J, int N, int B, int n_moves,
    uint32_t seed, uint32_t move0, uint32_t chain0, float beta2s,
    int target_i, float target_f, int mode, int is_float, void* stream) {
  const size_t smem = rrrmc_rejfree_dense_smem(N);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, lf, E, coord, acc, zacc, cs, es, J, N, B, n_moves, \
                   seed, move0, chain0, beta2s
  if (is_float) {
    if (mode == kWtm)
      return launch<float, float, float, kWtm>(RRRMC_ARGS, target_f, smem, st);
    if (mode == kRrr)
      return launch<float, float, int32_t, kRrr>(RRRMC_ARGS, target_i, smem,
                                                 st);
    return launch<float, float, int32_t, kBkl>(RRRMC_ARGS, target_i, smem,
                                               st);
  }
  if (mode == kWtm)
    return launch<int32_t, int8_t, float, kWtm>(RRRMC_ARGS, target_f, smem,
                                                st);
  if (mode == kRrr)
    return launch<int32_t, int8_t, int32_t, kRrr>(RRRMC_ARGS, target_i, smem,
                                                  st);
  return launch<int32_t, int8_t, int32_t, kBkl>(RRRMC_ARGS, target_i, smem,
                                                st);
#undef RRRMC_ARGS
}
