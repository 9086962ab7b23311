// Rejection-free race kernel (bkl / wtm / rrr) on a sparse Pairwise model,
// one thread block per chain. Replaces
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

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBkl = 0, kWtm = 1, kRrr = 2;

struct Reduce {
  float f[kWarps];
  int i[kWarps];
};

__device__ __forceinline__ float block_min(float v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.f[w] = v;
  __syncthreads();
  v = r.f[0];
  for (int k = 1; k < kWarps; ++k) v = fminf(v, r.f[k]);
  return v;
}

// the plain version (ops/rejfree.py::block_sum) adds in this same order
__device__ __forceinline__ float block_sum(float v, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) r.f[w] = v;
  __syncthreads();
  v = r.f[0];
  for (int k = 1; k < kWarps; ++k) v += r.f[k];
  return v;
}

// (score, index) minimum, lowest index among equal scores
__device__ __forceinline__ void block_argmin(float& v, int& idx, Reduce& r) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
    if (v2 < v || (v2 == v && i2 < idx)) { v = v2; idx = i2; }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { r.f[w] = v; r.i[w] = idx; }
  __syncthreads();
  v = r.f[0];
  idx = r.i[0];
  for (int k = 1; k < kWarps; ++k) {
    if (r.f[k] < v || (r.f[k] == v && r.i[k] < idx)) { v = r.f[k]; idx = r.i[k]; }
  }
}

template <typename T>
__device__ __forceinline__ float boltz(int8_t s, T lf, float beta2s) {
  const T half = T(s) * lf;
  return beta2s * (float)(half > T(0) ? half : T(0));
}

// min bE and log z over the resident state
template <typename T>
__device__ float log_z(const int8_t* sig, const T* lf, int N, float beta2s,
                       Reduce& r) {
  float mbe = INFINITY;
  for (int i = threadIdx.x; i < N; i += kThreads)
    mbe = fminf(mbe, boltz(sig[i], lf[i], beta2s));
  mbe = block_min(mbe, r);
  float zs = 0.0f;
  for (int i = threadIdx.x; i < N; i += kThreads)
    zs += expf(mbe - boltz(sig[i], lf[i], beta2s));
  zs = block_sum(zs, r);
  return logf(zs) - mbe;
}

__device__ __forceinline__ int32_t geom_skip(float u2, float p) {
  // the TPU kernel's _geom_skip: floor(log(1-u)/log1p(-p)), capped at 1e9
  const float denom = log1pf(-fminf(p, 0.999999f));
  const float sk = floorf(logf(fmaxf(1.0f - u2, 1e-38f)) / denom);
  const int32_t skip = (int32_t)fminf(sk, 1.0e9f);
  return p >= 1.0f ? 0 : skip;
}

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
  __syncthreads();

  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    if (coord < target) {
      // pass A: race over the sites, four per Philox call
      float best = INFINITY;
      int win = 0x7fffffff;
      for (int g = tid; 4 * g < N; g += kThreads) {
        const uint4 r = rrrmc::philox4x32_10(
            make_uint4((uint32_t)g, mv, rrrmc::DRAW_RACE, 0u),
            make_uint2(seed, chain));
        const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * g + j;
          if (i < N) {
            const float u = rrrmc::to_uniform((int32_t)words[j]);
            const float sc = logf(-logf(u)) + boltz(sig[i], lf[i], beta2s);
            if (sc < best) { best = sc; win = i; }
          }
        }
      }
      block_argmin(best, win, red);
      const float logz = log_z(sig, lf, N, beta2s, red);
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
        const float logz2 = log_z(sig, lf, N, beta2s, red);
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
          coord += CT(geom_skip(u2, zn) + 1);
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
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin - (int)sizeof(Reduce);
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
