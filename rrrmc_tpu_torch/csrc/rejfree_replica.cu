// Rejection-free race kernel (bkl / wtm / rrr) on the replica composites,
// GraphQuant (the Trotter ring) and GraphRobustEnsemble (the star), over a
// dense (FullyConnected) or a sparse (Pairwise) base; one thread block per
// chain. Replaces rrrmc_tpu/ops/quant_pallas.py::_ring_rejfree_kernel (dense
// base) and ::_sparse_comp_kernel (sparse base). The wrapper and the plain
// torch version are rrrmc_tpu_torch/ops/replica.py; the race, the reductions
// and log z are race.cuh's.
//
// The composite has N = Nk * M spins, replica-major (spin (i, k) is
// j = i + k * Nk). The physical cost of flipping j is
//   ring  dE_j = 2 s_j (sb * lf_j + c4 (s_{i,k-1} + s_{i,k+1}))
//   star  dE_j = 2 s_j (sb * lf_j) + s_j fk[(mu_i - s_j + M - 1) >> 1]
// with lf the BASE local fields of each replica (int32 for an integer base,
// exact; f32 for a float one), sb = base scale * replica weight, c4 = fourK/4
// and mu_i = sum_k s_{i,k}. The TPU kernels recomputed lf every move (M
// matmuls, or composite-indexed inverse columns) because Mosaic has no
// gather. Here a chain's spins (int8), base fields and, for the star, mu
// (int32) stay resident in dynamic shared memory for the whole chunk, and
// the extra term is derived per site as the race reads it. Per move:
//   race    score log(-log u) + beta * max(dE, 0) over the N sites, block
//           argmin (lowest index on ties), shifted log-sum-exp log z;
//   flip    of the winner w = (i, k): s_w negated, mu_i moved by d = -2 s_w,
//           and d * J_base[i, :] added to replica block k's fields, over the
//           Nk entries of the dense row (one per thread) or, by one thread in
//           order, the K entries of the sparse row;
//   rrr     the flip is applied tentatively and log z' computed over the
//           flipped state; it is kept iff log ua < log z - log z', else the
//           saved fields are put back (exact for float fields too);
//   bkl     coordinate += geometric skip + 1; wtm: += exp(min score).
// E (f32 physical) gains the winner's dE. A chain whose coordinate has
// reached `target` makes no move; it only writes its stream rows.
//
// Bound on the H100: the arithmetic of the two to four passes over the N
// resident sites per move (a Philox call per four sites, a log pair and an
// exp per site, the site's dE) with a few block barriers, as the sparse race
// kernel; a flip touches Nk (dense) or K (sparse) fields. The TPU caps
// (Nk % 128, chains % 128, the composite and star size caps) do not apply:
// shared memory is the only limit (rrrmc_rejfree_replica_smem).
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace {

using rrrmc::Reduce;
constexpr int kThreads = rrrmc::kRaceThreads;
constexpr int kBkl = rrrmc::kBkl, kWtm = rrrmc::kWtm, kRrr = rrrmc::kRrr;

struct Args {
  int8_t* sigma;
  void* lf;
  float* E;
  void* coord;
  int32_t* acc;
  float* zacc;
  void* cs;
  float* es;
  const void* J;
  const int32_t* neigh;
  const float* params;  // sb, c4, fk[M]
  int Nk, M, K, B, n_moves;
  uint32_t seed, move0, chain0;
  float beta;
};

// T: base fields (int32 / f32); JT: couplings (dense int8 / f32, sparse
// int32 / f32); CT: coordinate (int32, f32 for wtm)
template <typename T, typename JT, bool SPARSE, bool STAR, typename CT,
          int MODE>
__global__ void __launch_bounds__(kThreads) rejfree_replica_kernel(
    Args a, CT target) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Nk = a.Nk, M = a.M, K = a.K, N = a.Nk * a.M;
  const int n_save = SPARSE ? K : Nk;
  T* lf = reinterpret_cast<T*>(smem);                          // [N]
  T* saved = lf + N;                                           // [n_save]
  int32_t* mu = reinterpret_cast<int32_t*>(saved + n_save);    // [Nk] star
  float* fk = reinterpret_cast<float*>(mu + (STAR ? Nk : 0));  // [M]
  int8_t* sig = reinterpret_cast<int8_t*>(fk + M);             // [N]
  __shared__ Reduce red;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t chain = a.chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  T* lf_g = reinterpret_cast<T*>(a.lf);
  const JT* J = reinterpret_cast<const JT*>(a.J);
  for (int j = tid; j < N; j += kThreads) {
    sig[j] = a.sigma[row + j];
    lf[j] = lf_g[row + j];
  }
  for (int m = tid; m < M; m += kThreads) fk[m] = a.params[2 + m];
  __syncthreads();
  if (STAR) {
    for (int i = tid; i < Nk; i += kThreads) {
      int32_t s = 0;
      for (int k = 0; k < M; ++k) s += sig[k * Nk + i];
      mu[i] = s;
    }
  }
  const float sb = a.params[0], c4 = a.params[1];
  // per-chain scalars: every thread keeps an identical copy
  float E = a.E[b];
  CT coord = reinterpret_cast<CT*>(a.coord)[b];
  int32_t acc = a.acc[b];
  float zacc = a.zacc[b];
  const float log_n = logf((float)N);
  // the physical cost of flipping composite spin j (ops/replica.py's
  // replica_de, in the same float32 operations)
  auto de = [&](int j) {
    const int k = j / Nk;
    const int i = j - k * Nk;
    const float s = (float)sig[j];
    const float t = sb * (float)lf[j];
    if (STAR) {
      const int idx = (mu[i] - (int)sig[j] + M - 1) >> 1;
      return 2.0f * s * t + s * fk[idx];
    }
    const int up = k + 1 == M ? i : j + Nk;
    const int dn = k == 0 ? j + (M - 1) * Nk : j - Nk;
    return 2.0f * s * (t + c4 * (float)(sig[up] + sig[dn]));
  };
  auto bz = [&](int j) {
    const float x = de(j);
    return a.beta * (x > 0.0f ? x : 0.0f);
  };
  __syncthreads();

  for (int m = 0; m < a.n_moves; ++m) {
    const uint32_t mv = a.move0 + (uint32_t)m;
    if (coord < target) {
      float best;
      int win;
      rrrmc::race(N, a.seed, chain, mv, bz, best, win, red);
      const float logz = rrrmc::log_z(N, bz, red);
      const int8_t sw = sig[win];
      const float dE = de(win);
      const float zn = expf(logz - log_n);
      zacc += zn;
      const int kw = win / Nk;
      const int iw = win - kw * Nk;
      const T d = T(-2 * sw);
      T* lfk = lf + kw * Nk;
      __syncthreads();  // every thread has read sig, lf and mu for dE
      // the flip (rrr: tentative, the old fields saved)
      if (SPARSE) {
        if (tid == 0) {
          for (int q = 0; q < K; ++q) {
            const int nb = a.neigh[iw * K + q];
            if (nb < Nk) {
              if (MODE == kRrr) saved[q] = lfk[nb];
              lfk[nb] += T(J[iw * K + q]) * d;
            }
          }
        }
      } else {
        const JT* jrow = J + (size_t)iw * Nk;
        for (int i = tid; i < Nk; i += kThreads) {
          if (MODE == kRrr) saved[i] = lfk[i];
          lfk[i] += d * T(jrow[i]);
        }
      }
      if (tid == 0) {
        sig[win] = (int8_t)(-sw);
        if (STAR) mu[iw] -= 2 * sw;
      }
      __syncthreads();
      if (MODE == kRrr) {
        const float logz2 = rrrmc::log_z(N, bz, red);
        const float ua = rrrmc::to_uniform(
            rrrmc::draw_bits(a.seed, chain, mv, rrrmc::DRAW_ACCEPT));
        if (logf(ua) < logz - logz2) {
          E += dE;
          ++acc;
        } else {
          __syncthreads();  // log z' has read the flipped state
          if (SPARSE) {
            if (tid == 0) {
              for (int q = K - 1; q >= 0; --q) {
                const int nb = a.neigh[iw * K + q];
                if (nb < Nk) lfk[nb] = saved[q];
              }
            }
          } else {
            for (int i = tid; i < Nk; i += kThreads) lfk[i] = saved[i];
          }
          if (tid == 0) {
            sig[win] = sw;
            if (STAR) mu[iw] += 2 * sw;
          }
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
              rrrmc::draw_bits(a.seed, chain, mv, rrrmc::DRAW_SKIP));
          coord += CT(rrrmc::geom_skip(u2, zn) + 1);
        }
      }
    }
    if (tid == 0) {
      reinterpret_cast<CT*>(a.cs)[(size_t)m * a.B + b] = coord;
      a.es[(size_t)m * a.B + b] = E;
    }
  }

  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    a.sigma[row + j] = sig[j];
    lf_g[row + j] = lf[j];
  }
  if (tid == 0) {
    a.E[b] = E;
    reinterpret_cast<CT*>(a.coord)[b] = coord;
    a.acc[b] = acc;
    a.zacc[b] = zacc;
  }
}

template <typename T, typename JT, bool SPARSE, bool STAR, typename CT,
          int MODE>
int launch(const Args& a, CT target, size_t smem, cudaStream_t st) {
  auto kern = rejfree_replica_kernel<T, JT, SPARSE, STAR, CT, MODE>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B, kThreads, smem, st>>>(a, target);
  return (int)cudaGetLastError();
}

template <typename T, typename JT, bool SPARSE, bool STAR>
int by_mode(const Args& a, int mode, int target_i, float target_f,
            size_t smem, cudaStream_t st) {
  if (mode == kWtm)
    return launch<T, JT, SPARSE, STAR, float, kWtm>(a, target_f, smem, st);
  if (mode == kRrr)
    return launch<T, JT, SPARSE, STAR, int32_t, kRrr>(a, target_i, smem, st);
  return launch<T, JT, SPARSE, STAR, int32_t, kBkl>(a, target_i, smem, st);
}

template <typename T, typename JT, bool SPARSE>
int by_term(const Args& a, int star, int mode, int target_i, float target_f,
            size_t smem, cudaStream_t st) {
  if (star)
    return by_mode<T, JT, SPARSE, true>(a, mode, target_i, target_f, smem, st);
  return by_mode<T, JT, SPARSE, false>(a, mode, target_i, target_f, smem, st);
}

}  // namespace

// dynamic shared memory of one block: the base fields [N] and their rrr copy
// (K sparse, Nk dense), mu [Nk] (star), fk [M] (4 bytes each) and the spins
// [N] int8
extern "C" size_t rrrmc_rejfree_replica_smem(int Nk, int M, int K, int sparse,
                                             int star) {
  const size_t N = (size_t)Nk * M;
  return 4 * (N + (sparse ? K : Nk) + (star ? Nk : 0) + M) + N;
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_rejfree_replica_max_smem(int device) {
  return rrrmc::race_max_smem(device);
}

// is_float: f32 fields and couplings; else int32 fields with int8 dense or
// int32 sparse couplings. neigh is null for a dense base.
extern "C" int rrrmc_rejfree_replica(
    int8_t* sigma, void* lf, float* E, void* coord, int32_t* acc, float* zacc,
    void* cs, float* es, const void* J, const int32_t* neigh,
    const float* params, int Nk, int M, int K, int B, int n_moves,
    uint32_t seed, uint32_t move0, uint32_t chain0, float beta, int target_i,
    float target_f, int mode, int is_float, int sparse, int star,
    void* stream) {
  const Args a{sigma, lf, E, coord, acc, zacc, cs, es, J, neigh, params,
               Nk, M, K, B, n_moves, seed, move0, chain0, beta};
  const size_t smem = rrrmc_rejfree_replica_smem(Nk, M, K, sparse, star);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    if (sparse)
      return by_term<float, float, true>(a, star, mode, target_i, target_f,
                                         smem, st);
    return by_term<float, float, false>(a, star, mode, target_i, target_f,
                                        smem, st);
  }
  if (sparse)
    return by_term<int32_t, int32_t, true>(a, star, mode, target_i, target_f,
                                           smem, st);
  return by_term<int32_t, int8_t, false>(a, star, mode, target_i, target_f,
                                         smem, st);
}
