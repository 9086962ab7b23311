// Sequential Metropolis sweeps on the replica composites, GraphQuant (the
// Trotter ring) and GraphRobustEnsemble (the star), over a dense base, one
// warp per chain. Replaces rrrmc_tpu/ops/quant_pallas.py::_ring_sweep_kernel
// (launched by `_pallas_ring_sweep`); the wrapper and the plain torch version
// are rrrmc_tpu_torch/ops/replica_sweep.py.
//
// What it computes: every sweep visits the N = Nk * M composite spins in
// order (replica-major, spin (i, k) = i + k * Nk); spin j = (i, k) is decided
// against its base field plus the corrections of the flips accepted since
// the last commit of the fields, with the physical cost
//   ring  dE = 2 s (sb * lf + c4 (s_{i,k-1} + s_{i,k+1}))
//   star  dE = 2 s (sb * lf) + s fk[(mu_i - s + M - 1) >> 1]
// (ops/replica.py's identity), and accepted iff dE <= 0 or bits < th with
// th = clip(exp(-beta dE) 2^32 - 2^31) computed per decision in float32, the
// TPU kernel's threshold (c4 and fk are irrational: no integer table as in
// sk_sweep.cu). The bits of spin j in sweep t are word j % 4 of Philox
// counter (j / 4, t, DRAW_REPLICA_SWEEP, 0) under key (seed, chain), so
// split launches equal one. E (f32 physical) gains each accepted dE in site
// order; `acc` counts the accepted flips.
//
// Design: sk_sweep.cu's scheme (one warp owns a chain; 32 consecutive spins
// decided at once, the lowest accepting lane is the next flip in site order,
// its row of J corrects the span's later fields, evaluation resumes after
// it), with spans that never cross a replica block: the ring partners and
// mu's other terms lie in other blocks and do not change during a span, so
// each spin's extra term is derived once when the span is loaded (ring:
// c4 times the partners' spins; star: s fk[...] from mu, summed from the
// spins). At the span's end the accepted flips are committed to the mover's
// block of the chain's base fields, lf += sum_j d_j J_base[i_j, :]. An integer
// base keeps int32 fields and multiplies by sb when dE is formed (exact,
// where the TPU kept f32 fields); a float base commits f32 rows. A new
// source, not a template parameter of sk_sweep.cu: the float acceptance,
// the block-bounded spans, the extra term and the float commit would touch
// every part of that kernel.
//
// Bound on the H100: as the dense sweep, the decisions (a Philox call, an
// exp and the threshold per lane and round) and the commits (a row of J per
// accepted flip, Nk entries, on the CUDA cores); the least time is that of
// its bytes (sigma and lf read and written, J read once).
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 512;  // spins decided between two commits of lf

// the per-warp stride of the shared arrays: the span rounded up to 16
__host__ __device__ inline int stride_of(int span) { return (span + 15) & ~15; }

// dynamic shared memory of one warp: lf [stride] (4 bytes), the extra term
// [stride] f32, accepted offsets [stride] int16, spins [stride] int8
__host__ __device__ inline size_t warp_smem(int span) {
  return (size_t)stride_of(span) * 11;
}

// T: base fields (int32 / f32); JT: dense couplings (int8 / f32)
template <typename T, typename JT, bool STAR>
__global__ void __launch_bounds__(kThreads) replica_sweep_kernel(
    int8_t* __restrict__ sigma, T* __restrict__ lf, float* __restrict__ E_g,
    int32_t* __restrict__ acc_g, const JT* __restrict__ J,
    const float* __restrict__ params, int Nk, int M, int B, int span,
    int n_sweeps, float beta, uint32_t seed, uint32_t sweep0,
    uint32_t chain0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp; the kernel has no block barrier
  unsigned char* base = smem + warp_smem(span) * warp;
  const int sp = stride_of(span);
  T* lfw = reinterpret_cast<T*>(base);                        // [sp]
  float* extra = reinterpret_cast<float*>(lfw + sp);          // [sp]
  int16_t* flips = reinterpret_cast<int16_t*>(extra + sp);    // [sp]
  int8_t* sigw = reinterpret_cast<int8_t*>(flips + sp);       // [sp]

  const float sb = params[0], c4 = params[1];
  const float* fk = params + 2;
  const int N = Nk * M;
  const uint2 key = make_uint2(seed, chain0 + (uint32_t)b);
  const size_t row = (size_t)b * N;
  float E = E_g[b];    // lane 0's copy is the one kept
  int32_t acc = 0;

  for (int s = 0; s < n_sweeps; ++s) {
    const uint32_t t = sweep0 + (uint32_t)s;
    for (int k = 0; k < M; ++k) {
      const int blk = k * Nk;
      const int up = (k + 1 == M ? 0 : k + 1) * Nk;
      const int dn = (k == 0 ? M - 1 : k - 1) * Nk;
      for (int i0 = 0; i0 < Nk; i0 += span) {
        const int len = min(span, Nk - i0);
        const size_t s0 = row + blk + i0;
        for (int q = lane; q < len; q += 32) {
          const int sq = sigma[s0 + q];
          lfw[q] = lf[s0 + q];
          sigw[q] = (int8_t)sq;
          if (STAR) {
            int mu = 0;
            for (int kk = 0; kk < M; ++kk) mu += sigma[row + kk * Nk + i0 + q];
            extra[q] = (float)sq * fk[(mu - sq + M - 1) >> 1];
          } else {
            extra[q] = c4 * (float)(sigma[row + up + i0 + q] +
                                    sigma[row + dn + i0 + q]);
          }
        }
        __syncwarp();
        int n_acc = 0;
        int q0 = 0;
        while (q0 < len) {
          const int q = q0 + lane;
          bool ok = false;
          float dE = 0.0f;
          if (q < len) {
            const uint32_t j = (uint32_t)(blk + i0 + q);
            const uint4 w4 = rrrmc::philox4x32_10(
                make_uint4(j >> 2, t, rrrmc::DRAW_REPLICA_SWEEP, 0u), key);
            const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
            const float sf = (float)sigw[q];
            const float tq = sb * (float)lfw[q];
            dE = STAR ? 2.0f * sf * tq + extra[q]
                      : 2.0f * sf * (tq + extra[q]);
            const float p = expf(-beta * dE);
            const float x = fminf(fmaxf(p * 4294967296.0f - 2147483648.0f,
                                        -2147483648.0f),
                                  2147483520.0f);
            ok = dE <= 0.0f || (int32_t)words[j & 3] < (int32_t)x;
          }
          const unsigned mask = __ballot_sync(0xffffffffu, ok);
          if (mask == 0u) {
            q0 += 32;
            continue;
          }
          const int f = __ffs(mask) - 1;
          const int qf = q0 + f;
          const float dE_f = __shfl_sync(0xffffffffu, dE, f);
          const int8_t s_old = sigw[qf];
          const T d = T(-2 * (int)s_old);
          __syncwarp();
          if (lane == 0) {
            sigw[qf] = (int8_t)(-s_old);
            flips[n_acc] = (int16_t)qf;
            E += dE_f;
            ++acc;
          }
          ++n_acc;
          const JT* jrow = J + (size_t)(i0 + qf) * Nk + i0;
          for (int q2 = qf + 1 + lane; q2 < len; q2 += 32)
            lfw[q2] += d * T(jrow[q2]);
          __syncwarp();
          q0 = qf + 1;
        }
        for (int q = lane; q < len; q += 32) sigma[s0 + q] = sigw[q];
        // commit: lf[block k, i] += sum_j d_j J_base[i0 + q_j, i], the
        // accepted flips in site order
        if (n_acc) {
          for (int i = lane; i < Nk; i += 32) {
            T a = T(0);
            for (int jj = 0; jj < n_acc; ++jj) {
              const int qj = flips[jj];
              a += T(2 * (int)sigw[qj]) * T(J[(size_t)(i0 + qj) * Nk + i]);
            }
            lf[row + blk + i] += a;
          }
        }
        __syncwarp();
      }
    }
  }
  if (lane == 0) {
    E_g[b] = E;
    acc_g[b] += acc;
  }
}

// the span of spins between two commits for a base of Nk spins (the plain
// version's rule, ops/replica_sweep.py::SPAN)
inline int span_of(int Nk) { return Nk < kSpan ? Nk : kSpan; }

template <typename T, typename JT, bool STAR>
int launch(int8_t* sigma, void* lf, float* E, int32_t* acc, const void* J,
           const float* params, int Nk, int M, int B, int n_sweeps,
           float beta, uint32_t seed, uint32_t sweep0, uint32_t chain0,
           cudaStream_t st) {
  const int span = span_of(Nk);
  const size_t smem = warp_smem(span) * kWarps;
  auto kern = replica_sweep_kernel<T, JT, STAR>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kWarps - 1) / kWarps;
  kern<<<blocks, kThreads, smem, st>>>(sigma, (T*)lf, E, acc, (const JT*)J,
                                       params, Nk, M, B, span, n_sweeps, beta,
                                       seed, sweep0, chain0);
  return (int)cudaGetLastError();
}

}  // namespace

// is_float: f32 fields and couplings; else int32 fields and int8 couplings
extern "C" int rrrmc_replica_sweep(int8_t* sigma, void* lf, float* E,
                                   int32_t* acc, const void* J,
                                   const float* params, int Nk, int M, int B,
                                   int n_sweeps, float beta, uint32_t seed,
                                   uint32_t sweep0, uint32_t chain0,
                                   int is_float, int star, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, lf, E, acc, J, params, Nk, M, B, n_sweeps, beta, \
                   seed, sweep0, chain0, st
  if (is_float)
    return star ? launch<float, float, true>(RRRMC_ARGS)
                : launch<float, float, false>(RRRMC_ARGS);
  return star ? launch<int32_t, int8_t, true>(RRRMC_ARGS)
              : launch<int32_t, int8_t, false>(RRRMC_ARGS);
#undef RRRMC_ARGS
}
