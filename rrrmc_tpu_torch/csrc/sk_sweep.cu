// Dense (SK) sequential Metropolis sweeps on a FullyConnected model with
// integer couplings (|J| <= 127, stored int8), one warp per chain. Replaces
// rrrmc_tpu/ops/sk_pallas.py::_sk_kernel and ::_sk_kernel_hbm (the TPU split
// them by whether J fits VMEM; here J is read from device memory or L2 in
// both cases, so one kernel serves every N). The wrapper and the plain torch
// version are rrrmc_tpu_torch/ops/sk.py.
//
// What it computes (the TPU kernels' move semantics): every sweep visits the
// sites 0..N-1 in order; site i is decided against its local field plus the
// corrections of the flips already accepted in this sweep since the last
// commit of lf, and is accepted iff half = s_i*lf_i <= 0 or bits < th, th the
// int32 table entry th[half - 1] computed on the host with the TPU kernel's
// float32 formula clip(exp(-beta_s*2*half)*2^32 - 2^31) (a half beyond the
// table's end is always rejected: its threshold is INT32_MIN). The bits of
// site i are the Philox word of row r = i % 128 of window w = i / 128 at
// window step t = sweep*n_win + w (counter (r/4, t, DRAW_SK, 0), word r%4,
// key (seed, chain0 + b)), so a ragged last window needs no padding spins.
// E gains 2*half of every accepted flip, exact in int32.
//
// Design. sigma [B, N] int8 and lf [B, N] int32 are chain-major in global
// memory and updated in place. A warp owns one chain and walks the sweep in
// spans of up to kSpan sites; per span it loads the span's lf and spins into
// shared memory, then decides 32 consecutive sites at once, one per lane:
// the lowest lane that accepts (a ballot) is the next flip in site order,
// its row of J corrects the span's later fields (lanes stride over them),
// and evaluation resumes at the next site. Each site's bits are fixed by its
// counter, so re-deciding a site whose field did not change gives the same
// answer: this is exact sequential Metropolis, with one round per 32 sites
// plus one per accepted flip. At the span's end the accepted flips are
// committed to the chain's whole lf row, lf += sum_j d_j J[site_j, :]: the
// TPU kernel's rank-W product (_rank_w_update) written by hand over the
// accepted columns only (d is 0 elsewhere), 16 sites per lane in registers,
// J read as char4 and lf as int4 when N % 4 == 0.
//
// Bound on the H100: the least time for a sweep is that of its bytes (sigma
// and lf read and written, J read once); the commits' products at the int8
// tensor-core rate take less. This kernel is far from it (PERF.md): at
// N=1024 the decisions (a Philox call and a table lookup per lane and
// round) and the commits limit it; at N=8192 (B=2048: lf 64 MB and J 64 MB,
// beyond L2) the commits, which read each accepted flip's row of J once per
// chain (N bytes) and lf once per span, on the CUDA cores. A block-wide
// int8 tensor-core product of the span's J rows with all of the block's
// flips would read J once per block instead; the decisions themselves stay
// sequential per chain.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 128;  // rows of one Philox window step
constexpr int kSpan = 512;    // sites decided between two commits of lf
constexpr int kVec = 16;      // lf values a lane accumulates per commit tile

// the per-warp stride of the shared arrays: the span rounded up to 16 sites,
// so that every warp's int32 array stays aligned
__host__ __device__ inline int stride_of(int span) { return (span + 15) & ~15; }

// dynamic shared memory of one warp: lf [stride] int32, accepted offsets
// [stride] int16, spins [stride] int8
__host__ __device__ inline size_t warp_smem(int span) {
  return (size_t)stride_of(span) * 7;
}

__global__ void __launch_bounds__(kThreads) sk_sweep_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ lf,
    int32_t* __restrict__ E_g, const int8_t* __restrict__ J,
    const int32_t* __restrict__ th, int n_th, int N, int B, int span,
    int n_sweeps, uint32_t seed, uint32_t sweep0, uint32_t chain0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp; the kernel has no block barrier
  unsigned char* base = smem + warp_smem(span) * warp;
  const int sp = stride_of(span);
  int32_t* lfw = reinterpret_cast<int32_t*>(base);       // [sp]
  int16_t* flips = reinterpret_cast<int16_t*>(lfw + sp);  // [sp]
  int8_t* sigw = reinterpret_cast<int8_t*>(flips + sp);  // [sp]

  const uint32_t chain = chain0 + (uint32_t)b;
  const uint2 key = make_uint2(seed, chain);
  const size_t row = (size_t)b * N;
  const uint32_t n_win = (uint32_t)((N + kWindow - 1) / kWindow);
  uint32_t dE = 0;  // accepted half values mod 2^32 (lane 0's is used)
  // the commit reads J as char4 and lf as int4 when N % 4 == 0 and the rows
  // are aligned for it
  const bool vec = (N & 3) == 0 && ((uintptr_t)lf & 15) == 0 &&
                   ((uintptr_t)J & 3) == 0;

  for (int s = 0; s < n_sweeps; ++s) {
    const uint32_t t0 = (sweep0 + (uint32_t)s) * n_win;
    for (int s0 = 0; s0 < N; s0 += span) {
      const int len = min(span, N - s0);
      for (int k = lane; k < len; k += 32) {
        lfw[k] = lf[row + s0 + k];
        sigw[k] = sigma[row + s0 + k];
      }
      __syncwarp();
      int n_acc = 0;
      int k0 = 0;
      while (k0 < len) {
        const int k = k0 + lane;
        bool acc = false;
        int32_t half = 0;
        if (k < len) {
          const int i = s0 + k;
          const int r = i % kWindow;
          const uint4 w4 = rrrmc::philox4x32_10(
              make_uint4((uint32_t)(r >> 2), t0 + (uint32_t)(i / kWindow),
                         rrrmc::DRAW_SK, 0u),
              key);
          const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
          half = (int32_t)sigw[k] * lfw[k];
          acc = half <= 0 ||
                (half <= n_th && (int32_t)words[r & 3] < th[half - 1]);
        }
        const unsigned mask = __ballot_sync(0xffffffffu, acc);
        if (mask == 0u) {
          k0 += 32;
          continue;
        }
        const int f = __ffs(mask) - 1;
        const int kf = k0 + f;
        const int32_t half_f = __shfl_sync(0xffffffffu, half, f);
        const int8_t s_old = sigw[kf];
        const int32_t d = -2 * (int32_t)s_old;
        __syncwarp();
        if (lane == 0) {
          sigw[kf] = (int8_t)(-s_old);
          flips[n_acc] = (int16_t)kf;
          dE += (uint32_t)half_f;
        }
        ++n_acc;
        const int8_t* jrow = J + (size_t)(s0 + kf) * N + s0;
        for (int k2 = kf + 1 + lane; k2 < len; k2 += 32)
          lfw[k2] += d * (int32_t)jrow[k2];
        __syncwarp();
        k0 = kf + 1;
      }
      for (int k = lane; k < len; k += 32) sigma[row + s0 + k] = sigw[k];
      // commit: lf[i] += sum_j 2*s_new_j * J[s0 + k_j, i] over the whole row
      if (n_acc && vec) {
        // tiles of 512 sites, 16 per lane in registers: four char4 loads of
        // each accepted row per lane, one int4 read-modify-write of lf
        for (int i0 = 0; i0 < N; i0 += 32 * kVec) {
          int32_t a[kVec] = {};
          for (int j = 0; j < n_acc; ++j) {
            const int kj = flips[j];
            const int32_t dj = 2 * (int32_t)sigw[kj];
            const char4* jr = reinterpret_cast<const char4*>(
                J + (size_t)(s0 + kj) * N + i0);
#pragma unroll
            for (int q = 0; q < kVec / 4; ++q) {
              if (i0 + 4 * (lane + 32 * q) < N) {
                const char4 c = jr[lane + 32 * q];
                a[4 * q] += dj * c.x;
                a[4 * q + 1] += dj * c.y;
                a[4 * q + 2] += dj * c.z;
                a[4 * q + 3] += dj * c.w;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kVec / 4; ++q) {
            const int i = i0 + 4 * (lane + 32 * q);
            if (i < N) {
              int4* p = reinterpret_cast<int4*>(lf + row + i);
              int4 v = *p;
              v.x += a[4 * q];
              v.y += a[4 * q + 1];
              v.z += a[4 * q + 2];
              v.w += a[4 * q + 3];
              *p = v;
            }
          }
        }
      } else if (n_acc) {
        for (int i = lane; i < N; i += 32) {
          int32_t a = 0;
          for (int j = 0; j < n_acc; ++j) {
            const int kj = flips[j];
            a += 2 * (int32_t)sigw[kj] *
                 (int32_t)J[(size_t)(s0 + kj) * N + i];
          }
          lf[row + i] += a;
        }
      }
      __syncwarp();
    }
  }
  if (lane == 0) E_g[b] = (int32_t)((uint32_t)E_g[b] + 2u * dE);
}

// the span of sites between two commits for a model of N spins
inline int span_of(int N) { return N < kSpan ? N : kSpan; }

}  // namespace

// dynamic shared memory of one block (kWarps chains)
extern "C" size_t rrrmc_sk_smem(int N) {
  return warp_smem(span_of(N)) * kWarps;
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_sk_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

extern "C" int rrrmc_sk_sweep(int8_t* sigma, int32_t* lf, int32_t* E,
                              const int8_t* J, const int32_t* th, int n_th,
                              int N, int B, int n_sweeps, uint32_t seed,
                              uint32_t sweep0, uint32_t chain0, void* stream) {
  const int span = span_of(N);
  const size_t smem = rrrmc_sk_smem(N);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      sk_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kWarps - 1) / kWarps;
  sk_sweep_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      sigma, lf, E, J, th, n_th, N, B, span, n_sweeps, seed, sweep0, chain0);
  return (int)cudaGetLastError();
}
