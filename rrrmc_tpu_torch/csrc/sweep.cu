// Checkerboard Metropolis sweeps on an even-L integer LatticeEA, one thread
// block per chain. Replaces rrrmc_tpu/ops/sweep_pallas.py::_sweep_kernel; the
// wrapper and the plain torch version are rrrmc_tpu_torch/ops/sweep.py.
//
// The chain's N spins (int8) stay in dynamic shared memory for all n_sweeps;
// sigma is chain-major [B, N] in global memory, so the load and the store are
// one contiguous row per block. A sweep is two colour steps (even coordinate
// sum first). In a colour step every thread updates its sites of that colour:
// the 2D neighbours are read from shared memory through periodic index
// arithmetic on the row-major lattice, the couplings from the direction
// tables Jp [N, D(+1)] / Jm [N, D] (96 KB at L=16, D=3, shared by every
// block, so they stay in L1/L2); with a field the h column is Jp[:, D]. Sites
// of one colour share no edge (even L is bipartite), so only a barrier
// separates the two colours.
//
// Acceptance, with half = s*lf (dE = 2*half): accept iff half <= 0 or
// bits < th, bits the int32 Philox word of the site (counter
// ((i/2)/4, 2*sweep + colour, DRAW_SWEEP, 0), word (i/2)%4, key
// (seed, chain0 + b)); th = table[half - 1] from the int32 table computed in
// float64 on the host when max |half| <= 64, else
// clip(expf(-beta2s*half)*2^32 - 2^31) (no FMA contraction: -fmad=false).
// The accepted half values are summed mod 2^32 per thread and reduced per
// block into E += 2*sum, exact int32 arithmetic in any order.
//
// Bound: ALU work, not bytes. Per site a few integer divisions for the
// coordinates, a quarter of a Philox call and six table reads; memory traffic
// is one read and one write of sigma per launch. Making it fast (strided
// neighbour arithmetic without divisions, packed spins) is later work.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// coordinate sum of site i modulo 2; for even L the parity of a coordinate
// x % L is that of x
__device__ __forceinline__ int colour_of(int i, int L, int D) {
  int p = 0;
  for (int d = 0; d < D; ++d) {
    p ^= i & 1;
    i /= L;
  }
  return p;
}

template <bool kField>
__device__ __forceinline__ int32_t local_field(const int8_t* sig, int i,
                                               const int32_t* __restrict__ Jp,
                                               const int32_t* __restrict__ Jm,
                                               int L, int D) {
  const int DP = kField ? D + 1 : D;
  int32_t lf = kField ? Jp[i * DP + D] : 0;
  int x = i, stride = 1;
  for (int d = D - 1; d >= 0; --d) {
    const int c = x % L;
    x /= L;
    const int ip = c == L - 1 ? i - (L - 1) * stride : i + stride;
    const int im = c == 0 ? i + (L - 1) * stride : i - stride;
    lf += Jp[i * DP + d] * (int32_t)sig[ip] + Jm[i * D + d] * (int32_t)sig[im];
    stride *= L;
  }
  return lf;
}

template <bool kTable, bool kField>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ E_g,
    const int32_t* __restrict__ Jp, const int32_t* __restrict__ Jm,
    const int32_t* __restrict__ th_g, int L, int D, int N, int n_th,
    int n_sweeps, uint32_t seed, uint32_t sweep0, uint32_t chain0,
    float beta2s) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* th = reinterpret_cast<int32_t*>(smem);      // [n_th]
  int8_t* sig = reinterpret_cast<int8_t*>(th + n_th);  // [N]
  __shared__ uint32_t red[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t chain = chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  for (int i = tid; i < N; i += kThreads) sig[i] = sigma[row + i];
  for (int v = tid; v < n_th; v += kThreads) th[v] = th_g[v];
  const int n_half = N / 2;  // sites of one colour
  uint32_t dE = 0;           // accepted half values, mod 2^32
  __syncthreads();

  for (int s = 0; s < n_sweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      const uint32_t t = 2u * (sweep0 + (uint32_t)s) + (uint32_t)c;
      for (int g = tid; 4 * g < n_half; g += kThreads) {
        const uint4 r = rrrmc::philox4x32_10(
            make_uint4((uint32_t)g, t, rrrmc::DRAW_SWEEP, 0u),
            make_uint2(seed, chain));
        const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * g + j;
          if (k >= n_half) break;
          // sites 2k and 2k+1 differ in colour: take the one of colour c
          const int i = 2 * k + (colour_of(2 * k, L, D) != c);
          const int s_i = sig[i];
          const int32_t half = s_i * local_field<kField>(sig, i, Jp, Jm, L, D);
          bool acc = half <= 0;
          if (!acc) {
            int32_t thr;
            if (kTable) {
              thr = th[min(half, n_th) - 1];  // the TPU kernel's select chain
            } else {
              const float p = expf(-beta2s * (float)half);
              float thf = p * 4294967296.0f - 2147483648.0f;
              thf = fminf(fmaxf(thf, -2147483648.0f), 2147483520.0f);
              thr = (int32_t)thf;
            }
            acc = (int32_t)words[j] < thr;
          }
          if (acc) {
            sig[i] = (int8_t)(-s_i);
            dE += (uint32_t)half;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int o = 16; o > 0; o >>= 1) dE += __shfl_xor_sync(0xffffffffu, dE, o);
  if ((tid & 31) == 0) red[tid >> 5] = dE;
  for (int i = tid; i < N; i += kThreads) sigma[row + i] = sig[i];
  __syncthreads();
  if (tid == 0) {
    uint32_t tot = 0;
    for (int w = 0; w < kWarps; ++w) tot += red[w];
    E_g[b] = (int32_t)((uint32_t)E_g[b] + 2u * tot);
  }
}

template <bool kTable, bool kField>
int launch(int8_t* sigma, int32_t* E, const int32_t* Jp, const int32_t* Jm,
           const int32_t* th, int L, int D, int N, int B, int n_th,
           int n_sweeps, uint32_t seed, uint32_t sweep0, uint32_t chain0,
           float beta2s, size_t smem, cudaStream_t st) {
  auto kern = sweep_kernel<kTable, kField>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, kThreads, smem, st>>>(sigma, E, Jp, Jm, th, L, D, N, n_th,
                                  n_sweeps, seed, sweep0, chain0, beta2s);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block: the threshold table [n_th] int32 and
// the spins [N] int8
extern "C" size_t rrrmc_sweep_smem(int N, int n_th) {
  return (size_t)n_th * 4 + (size_t)N;
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_sweep_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin - (int)(kWarps * sizeof(uint32_t));
}

// n_th > 0: threshold-table path with that many entries; n_th == 0: exp path
extern "C" int rrrmc_sweep(int8_t* sigma, int32_t* E, const int32_t* Jp,
                           const int32_t* Jm, const int32_t* th, int L, int D,
                           int B, int n_th, int has_field, int n_sweeps,
                           uint32_t seed, uint32_t sweep0, uint32_t chain0,
                           float beta2s, void* stream) {
  int N = 1;
  for (int d = 0; d < D; ++d) N *= L;
  const size_t smem = rrrmc_sweep_smem(N, n_th);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, E, Jp, Jm, th, L, D, N, B, n_th, n_sweeps, seed, \
                   sweep0, chain0, beta2s, smem, st
  if (n_th > 0)
    return has_field ? launch<true, true>(RRRMC_ARGS)
                     : launch<true, false>(RRRMC_ARGS);
  return has_field ? launch<false, true>(RRRMC_ARGS)
                   : launch<false, false>(RRRMC_ARGS);
#undef RRRMC_ARGS
}
