// Dense (SK) sequential Metropolis sweeps on a FullyConnected model with
// integer couplings (|J| <= 127, stored int8). Replaces
// rrrmc_tpu/ops/sk_pallas.py::_sk_kernel and ::_sk_kernel_hbm (the TPU split
// them by whether J fits VMEM; here J is read from device memory or L2 in
// both cases, so one kernel serves every N). The wrapper, the launch plan
// and the plain torch version are rrrmc_tpu_torch/ops/sk.py.
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
// memory and updated in place. A block of kChains = 16 chains (one warp
// each) walks the sweep in spans of kSpanMax sites (N below it), all its
// chains on the same span:
// - Load: each warp copies its chain's span of lf and spins to shared
//   memory and draws the span's Philox words once, a quarter of a call a
//   site, all lanes working. Each word u is resolved against the table at
//   once: th does not increase with half (SKSweeper checks it), so with
//   hmax(u) = #{v : th[v - 1] > u} the test u < th[half - 1] is half <=
//   hmax(u), and the decision is half <= hmax (half <= 0 included), one
//   compare. hmax is kept a site, 16 bits where the table fits (HT). The
//   block copies the span's diagonal block of J (span x span int8) with
//   cp.async while the warps load, 4 sites a lane where the rows allow.
// - Decide: a warp decides 32 consecutive sites at once, one a lane; the
//   lowest lane that accepts (a ballot) is the next flip in site order, its
//   row of the diagonal block (shared memory) corrects the span's later
//   fields, and evaluation resumes at the next site. Each site's bits are
//   fixed, so re-deciding a site whose field did not change gives the same
//   answer: this is exact sequential Metropolis.
// - Commit: at the span's end the block's warps meet at a barrier and
//   commit every chain's flips at once, lf[chains, :] += dlt[chains, span]
//   J[span, :], dlt = -2 s_old on the accepted sites: an int8 tensor-core
//   product (sweep_block.cuh::commit_mma), J read once a block and span
//   (the warp-per-chain kernel it replaces read an accepted flip's row once
//   per chain). Warps past B stay for the barriers and commit a zero row.
//
// Bound on the H100: the least time for a sweep is that of its bytes (sigma
// and lf read and written, J read once); the commits' products at the int8
// tensor-core rate take less. What remains (PERF.md): the decisions, one
// round a 32 sites plus one an accepted flip, sequential per chain; the
// commits' J tiles from L2 (a block and span reads span x N bytes) and lf
// (2 B N 4 bytes a span, from device memory when lf is beyond L2).
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"
#include "sweep_block.cuh"

namespace {

using rrrmc::kChains;
using rrrmc::kSpanMax;
using rrrmc::span_stride;

constexpr int kWindow = 128;  // rows of one Philox window step

// dynamic shared memory of a block: the span's diagonal block of J
// [span][sp] int8, then per chain dlt [sp] int8, spins [sp] int8, lf [sp]
// int32 and hmax [sp] (hbytes each)
__host__ __device__ inline size_t block_smem(int span, int hbytes) {
  const size_t sp = span_stride(span);
  return (size_t)span * sp + (size_t)kChains * sp * (6 + hbytes);
}

// #{v : th[v] > u} over the non-increasing th[0..n_th)
__device__ __forceinline__ int hmax_of(int32_t u,
                                       const int32_t* __restrict__ th,
                                       int n_th) {
  int lo = 0, n = n_th;
  while (n > 0) {
    const int h = n >> 1;
    if (__ldg(th + lo + h) > u) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

template <typename HT, int VEC>
__global__ void __launch_bounds__(32 * kChains, 1) sk_sweep_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ lf,
    int32_t* __restrict__ E_g, const int8_t* __restrict__ J,
    const int32_t* __restrict__ th, int n_th, int N, int B, int span,
    int n_sweeps, uint32_t seed, uint32_t sweep0, uint32_t chain0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flipped[kChains];
  constexpr int C = kChains;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cb = blockIdx.x * C;
  const int b = cb + warp;
  const bool live = b < B;
  const int sp = span_stride(span);
  int8_t* Jd = reinterpret_cast<int8_t*>(smem);            // [span][sp]
  int8_t* dlt_all = Jd + (size_t)span * sp;                  // [C][sp]
  int8_t* sig = dlt_all + C * sp + warp * sp;                // [sp]
  int32_t* lfw = reinterpret_cast<int32_t*>(dlt_all + 2 * C * sp) +
                 warp * sp;                                  // [sp]
  HT* hm = reinterpret_cast<HT*>(dlt_all + 6 * C * sp) + warp * sp;
  int8_t* dlt = dlt_all + warp * sp;

  const uint2 key = make_uint2(seed, chain0 + (uint32_t)b);
  const size_t row = (size_t)(live ? b : 0) * N;
  const uint32_t n_win = (uint32_t)((N + kWindow - 1) / kWindow);
  uint32_t dE = 0;  // accepted half values mod 2^32 (lane 0's is used)

  for (int s = 0; s < n_sweeps; ++s) {
    const uint32_t t0 = (sweep0 + (uint32_t)s) * n_win;
    for (int s0 = 0; s0 < N; s0 += span) {
      const int len = min(span, N - s0);
      rrrmc::load_diag<VEC>(Jd, sp, J, N, s0, len);
      for (int k = lane; k < sp; k += 32) dlt[k] = 0;
      if (live) {
        rrrmc::copy_row<VEC>(lfw, lf + row + s0, len, lane);
        rrrmc::copy_row<VEC>(sig, sigma + row + s0, len, lane);
        // sites 4g..4g+3 share one Philox call (window row r = i % 128)
        for (int g = (s0 >> 2) + lane; g <= (s0 + len - 1) >> 2; g += 32) {
          const uint4 w4 = rrrmc::philox4x32_10(
              make_uint4((uint32_t)(g & 31), t0 + (uint32_t)(g >> 5),
                         rrrmc::DRAW_SK, 0u),
              key);
          const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = 4 * g + j - s0;
            if (k >= 0 && k < len)
              hm[k] = (HT)hmax_of((int32_t)words[j], th, n_th);
          }
        }
      }
      rrrmc::wait_diag<VEC>();
      __syncthreads();
      int n_acc = 0;
      if (live) {
        int k0 = 0;
        while (k0 < len) {
          const int k = k0 + lane;
          int32_t half = 0, sv = 0;
          bool acc = false;
          if (k < len) {
            sv = sig[k];
            half = sv * lfw[k];
            acc = half <= (int32_t)hm[k];
          }
          const unsigned mask = __ballot_sync(0xffffffffu, acc);
          if (mask == 0u) {
            k0 += 32;
            continue;
          }
          const int f = __ffs(mask) - 1;
          const int kf = k0 + f;
          const int32_t half_f = __shfl_sync(0xffffffffu, half, f);
          const int32_t d = -2 * __shfl_sync(0xffffffffu, sv, f);
          __syncwarp();
          if (lane == f) {
            sig[kf] = (int8_t)(-sv);
            dlt[kf] = (int8_t)d;
          }
          dE += (uint32_t)half_f;
          ++n_acc;
          rrrmc::correct_span(lfw, Jd + kf * sp, d, kf + 1, len, lane);
          __syncwarp();
          k0 = kf + 1;
        }
        rrrmc::copy_row<VEC>(sigma + row + s0, sig, len, lane);
      }
      if (lane == 0) flipped[warp] = n_acc;
      __syncthreads();
      bool live0 = false, live1 = false;
      int n_flips = 0;
      for (int c = 0; c < C; ++c) {
        if (c < 8) live0 |= flipped[c] != 0;
        else live1 |= flipped[c] != 0;
        n_flips += flipped[c];
      }
      if (n_flips > rrrmc::kRowFlips)
        rrrmc::commit_mma<VEC>(lf, (size_t)N, 0, J, N, N, s0, len, dlt_all,
                               sp, cb, B, live0, live1, warp, C, lane);
      else if (n_flips)
        rrrmc::commit_rows<VEC>(lf, (size_t)N, 0, J, N, N, s0, len, dlt_all,
                                sp, cb, C, flipped, warp, lane);
      __syncthreads();
    }
  }
  if (live && lane == 0) E_g[b] = (int32_t)((uint32_t)E_g[b] + 2u * dE);
}

using Kern = void (*)(int8_t*, int32_t*, int32_t*, const int8_t*,
                      const int32_t*, int, int, int, int, int, uint32_t,
                      uint32_t, uint32_t);

// hbytes: 2 (hmax as uint16) or 4 (int32); vec: 16, 4 or 1
Kern kernel_of(int hbytes, int vec) {
  if (hbytes == 2) {
    if (vec == 16) return sk_sweep_kernel<uint16_t, 16>;
    if (vec == 4) return sk_sweep_kernel<uint16_t, 4>;
    if (vec == 1) return sk_sweep_kernel<uint16_t, 1>;
  } else if (hbytes == 4) {
    if (vec == 16) return sk_sweep_kernel<int32_t, 16>;
    if (vec == 4) return sk_sweep_kernel<int32_t, 4>;
    if (vec == 1) return sk_sweep_kernel<int32_t, 1>;
  }
  return nullptr;
}

}  // namespace

// dynamic shared memory of a block of the launch on N sites
extern "C" size_t rrrmc_sk_smem(int N, int hbytes) {
  return block_smem(min(N, kSpanMax), hbytes);
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_sk_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// out[5]: registers, local bytes a thread, max threads a block, the
// instantiation's static shared bytes, and the multiprocessors of the card
extern "C" int rrrmc_sk_info(int hbytes, int vec, int device, int* out) {
  const Kern k = kernel_of(hbytes, vec);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = sms;
  return 0;
}

// the plan (ops/sk.py::sweep_plan): kChains warps a block, spans of
// kSpanMax sites (N below it), hmax in `hbytes` bytes, J loads of `vec`
// bytes
extern "C" int rrrmc_sk_sweep(int8_t* sigma, int32_t* lf, int32_t* E,
                              const int8_t* J, const int32_t* th, int n_th,
                              int N, int B, int n_sweeps, uint32_t seed,
                              uint32_t sweep0, uint32_t chain0, int hbytes,
                              int vec, void* stream) {
  const Kern k = kernel_of(hbytes, vec);
  if (k == nullptr || N < 1 || (hbytes == 2 && n_th > 65535))
    return (int)cudaErrorInvalidValue;
  const int span = min(N, kSpanMax);
  const size_t smem = block_smem(span, hbytes);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kChains - 1) / kChains;
  k<<<blocks, 32 * kChains, smem, (cudaStream_t)stream>>>(
      sigma, lf, E, J, th, n_th, N, B, span, n_sweeps, seed, sweep0, chain0);
  return (int)cudaGetLastError();
}
