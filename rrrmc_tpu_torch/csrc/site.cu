// Single-site Metropolis on a sparse Pairwise model. Replaces
// rrrmc_tpu/ops/site_pallas.py::_site_kernel; the wrapper, its launch plan
// and the plain torch version are rrrmc_tpu_torch/ops/site.py.
//
// What bounds it: latency. A move is a chain of dependent steps (the site,
// its spin and field, exp and a 10-round Philox call, then the K neighbour
// fields), and the bytes and operations of the work are tiny beside it.
// Two routes, chosen by the plan on size alone:
//
// * resident (`site_resident_kernel`): one warp per chain, a block of W
//   chains, each chain's spins (int8) and fields (int8, int16, int32 or
//   float32, the narrowest that holds the model's bound on |lf|) in shared
//   memory for the whole launch. The block loads them once from the
//   site-major sigT / lfT [N, B] (its W chains' entries of a row side by
//   side) and writes them back widened at the end. The schedule is shared
//   by every chain, so it is cut once a launch (`site_cut_kernel`) into
//   groups: maximal runs of at most 32 consecutive moves whose closed
//   neighbourhoods {i} + N(i) are pairwise disjoint (padding == N is not a
//   neighbour; a repeated site cuts). Moves of one group touch disjoint
//   spins and fields, so they commute exactly: lane l of the warp runs move
//   l of the group, each lane draws its own move's Philox word, and
//   __syncwarp() separates the groups. Every field gets at most one add a
//   group, in schedule order, so float32 fields round as the serial run;
//   float32 E is summed in schedule order (the group's accepted dE, lane by
//   lane), integer E and the counts in any order.
// * global (`site_global_kernel`): a chain whose state does not fit in
//   shared memory keeps it in global memory, one thread per chain, the
//   moves in order.
//
// Acceptance is the integer threshold test of the TPU kernel: with the f32
// p = exp(-beta_s[b] * dE), th = clip(p * 2^32 - 2^31) and the move is
// accepted iff dE <= 0 or bits < th, bits being the int32 Philox word of
// counter (0, move0 + m, DRAW_SITE, 0) under key (seed, chain0 + b).
// beta_s [B] holds each chain's beta * scale, read once a chain: a launch
// of one beta passes it B times, a tempering ladder each chain's rung, so
// the ladder's T * B chains run as one launch with the thresholds of T
// launches of one beta each.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"
#include "race.cuh"

namespace {

// the most moves of a group: one a lane
constexpr int kGroupMax = 32;
// moves whose groups one block of the cut kernel finds
constexpr int kCutThreads = 128;
// neighbour slots of a move read ahead of its acceptance (the rest after)
constexpr int kAhead = 4;
// closed-neighbourhood members of a move the cut kernel keeps in registers
constexpr int kCutRegs = 8;
// entries of the state a thread of the resident kernel loads at once
constexpr int kCopyAhead = 8;

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// shared bytes of one chain on the resident route: spins, then fields
__host__ __device__ __forceinline__ size_t chain_bytes(int N, int fbytes) {
  return align16((size_t)N) + align16((size_t)N * fbytes);
}

__device__ __forceinline__ float th_of(float p) {
  float thf = p * 4294967296.0f - 2147483648.0f;
  return fminf(fmaxf(thf, -2147483648.0f), 2147483520.0f);
}

// ---- global route: one thread per chain, the state in global memory ----

template <typename T>
__global__ void site_global_kernel(
    const int32_t* __restrict__ sites, int n_moves,
    const int32_t* __restrict__ neigh, const T* __restrict__ J, int N, int K,
    int B, int8_t* __restrict__ sigT, T* __restrict__ lfT,
    T* __restrict__ E, int32_t* __restrict__ acc, uint32_t seed,
    uint32_t move0, uint32_t chain0, const float* __restrict__ beta_s) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float bs = beta_s[b];
  T dE_sum = T(0);
  int32_t n_acc = 0;
  for (int m = 0; m < n_moves; ++m) {
    const int i = sites[m];
    const size_t o = (size_t)i * B + b;
    const int s = sigT[o];
    const T dE = T(2 * s) * lfT[o];
    const int32_t th = (int32_t)th_of(expf(-bs * (float)dE));
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

// ---- the groups: glen[m] is the length of the greedy group that starts at
// move m (ops/site.py::site_groups walks them from move 0) ----

__device__ __forceinline__ int member(const int32_t* __restrict__ sites,
                                      const int32_t* __restrict__ neigh,
                                      int K, int p, int a) {
  const int i = __ldg(sites + p);
  return a == 0 ? i : __ldg(neigh + (size_t)i * K + a - 1);
}

__global__ void __launch_bounds__(kCutThreads) site_cut_kernel(
    const int32_t* __restrict__ sites, int n, const int32_t* __restrict__ neigh,
    int N, int K, int cap, int32_t* __restrict__ glen) {
  // the block's moves t0 + x, x < kSpan: those whose groups it finds and
  // the kGroupMax - 1 after them
  constexpr int kSpan = kCutThreads + kGroupMax - 1;
  // prev[x]: the latest move q in [t0, t0 + x) within kGroupMax - 1 of
  // t0 + x whose closed neighbourhood meets its own, -1 if none (earlier
  // moves cannot cut a group that starts at t0 or later)
  __shared__ int prev[kSpan];
  const int t0 = blockIdx.x * kCutThreads;
  for (int x = threadIdx.x; x < kSpan; x += kCutThreads) {
    const int p = t0 + x;
    int pv = -1;
    if (p < n) {
      int mine[kCutRegs];
#pragma unroll
      for (int c = 0; c < kCutRegs; ++c)
        mine[c] = c <= K ? member(sites, neigh, K, p, c) : N;
      for (int q = p - 1; q >= max(t0, p - (kGroupMax - 1)) && pv < 0; --q) {
        bool meet = false;
        for (int a = 0; a <= K && !meet; ++a) {
          const int v = member(sites, neigh, K, q, a);
          if (v == N) continue;  // padding is no neighbour
#pragma unroll
          for (int c = 0; c < kCutRegs; ++c) meet |= mine[c] == v;
          for (int c = kCutRegs; c <= K && !meet; ++c)
            meet = member(sites, neigh, K, p, c) == v;
        }
        if (meet) pv = q;
      }
    }
    prev[x] = pv;
  }
  __syncthreads();
  const int m = t0 + threadIdx.x;
  if (m < n) {
    const int lim = min(cap, n - m);
    int len = 1;
    while (len < lim && prev[threadIdx.x + len] < m) ++len;
    glen[m] = len;
  }
}

// ---- resident route: one warp per chain, W chains a block ----

// the first kAhead neighbours of site i and their couplings (padding N and
// 0 past K)
template <typename TC>
__device__ __forceinline__ void rows_of(const int32_t* __restrict__ neigh,
                                        const TC* __restrict__ J, int N,
                                        int K, int i, int* nb, TC* jk) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    nb[k] = k < K ? __ldg(neigh + (size_t)i * K + k) : N;
    jk[k] = k < K ? __ldg(J + (size_t)i * K + k) : TC(0);
  }
}

template <typename TF, typename TC>
__global__ void site_resident_kernel(
    const int32_t* __restrict__ sites, const int32_t* __restrict__ glen,
    int n_moves, const int32_t* __restrict__ neigh, const TC* __restrict__ J,
    int N, int K, int B, int8_t* __restrict__ sigT, TC* __restrict__ lfT,
    TC* __restrict__ E, int32_t* __restrict__ acc, uint32_t seed,
    uint32_t move0, uint32_t chain0, const float* __restrict__ beta_s) {
  constexpr bool kFloat = std::is_same<TC, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * W;
  const int nc = min(W, B - b0);  // chains of this block
  const size_t stride = chain_bytes(N, (int)sizeof(TF));
  const size_t fo = align16((size_t)N);

  // the block's chains read and write their entries of a row together,
  // kCopyAhead entries a thread in flight (W is a power of two)
  const int lw = __ffs(W) - 1;
  for (int x0 = threadIdx.x; x0 < N * W; x0 += kCopyAhead * blockDim.x) {
    int8_t sv[kCopyAhead];
    TC fv[kCopyAhead];
#pragma unroll
    for (int u = 0; u < kCopyAhead; ++u) {
      const int x = x0 + u * blockDim.x, i = x >> lw, c = x & (W - 1);
      if (x < N * W && c < nc) {
        const size_t o = (size_t)i * B + b0 + c;
        sv[u] = sigT[o];
        fv[u] = lfT[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyAhead; ++u) {
      const int x = x0 + u * blockDim.x, i = x >> lw, c = x & (W - 1);
      if (x < N * W && c < nc) {
        unsigned char* base = smem + c * stride;
        base[i] = (unsigned char)sv[u];
        reinterpret_cast<TF*>(base + fo)[i] = (TF)fv[u];
      }
    }
  }
  __syncthreads();

  if (warp < nc) {
    int8_t* sig = reinterpret_cast<int8_t*>(smem + warp * stride);
    TF* lf = reinterpret_cast<TF*>(smem + warp * stride + fo);
    const uint32_t chain = chain0 + (uint32_t)(b0 + warp);
    const float bs = __ldg(beta_s + b0 + warp);
    TC dE_sum = TC(0);  // float: the same schedule-order sum on every lane
    int32_t n_acc = 0;
    // Every global load is in flight a group before it is used: at group
    // g the lane holds its site and neighbour rows, and the length and its
    // site of group g + 1; it reads the rows of g + 1 and the length and
    // sites of g + 2 while g runs.
    int g = 0;
    int len = n_moves > 0 ? __ldg(glen) : 0;
    int i = lane < n_moves ? __ldg(sites + lane) : 0;
    int len1 = 0, i1 = 0;
    if (len < n_moves) {
      len1 = __ldg(glen + len);
      if (len + lane < n_moves) i1 = __ldg(sites + len + lane);
    }
    int nb[kAhead];
    TC jk[kAhead];
    rows_of(neigh, J, N, K, i, nb, jk);
    while (g < n_moves) {
      const int g1 = g + len, g2 = g1 + len1;
      int len2 = 0, i2 = 0;
      if (g2 < n_moves) {
        len2 = __ldg(glen + g2);
        if (g2 + lane < n_moves) i2 = __ldg(sites + g2 + lane);
      }
      int nb1[kAhead];
      TC jk1[kAhead];
      rows_of(neigh, J, N, K, i1, nb1, jk1);
      bool accepted = false;
      TC dE = TC(0);
      if (lane < len) {
        const uint32_t m = (uint32_t)(g + lane);
        const int32_t bits =
            rrrmc::draw_bits(seed, chain, move0 + m, rrrmc::DRAW_SITE);
        const int s = sig[i];
        dE = TC(2 * s) * TC(lf[i]);
        const int32_t th = (int32_t)th_of(expf(-bs * (float)dE));
        accepted = dE <= TC(0) || bits < th;
        if (accepted) {
          sig[i] = (int8_t)(-s);
          const TC d = TC(-2 * s);
#pragma unroll
          for (int k = 0; k < kAhead; ++k)
            if (nb[k] < N) lf[nb[k]] = (TF)(TC(lf[nb[k]]) + jk[k] * d);
          for (int k = kAhead; k < K; ++k) {
            const int v = __ldg(neigh + (size_t)i * K + k);
            if (v < N)
              lf[v] = (TF)(TC(lf[v]) + __ldg(J + (size_t)i * K + k) * d);
          }
          ++n_acc;
        }
      }
      if constexpr (kFloat) {
        unsigned msk = __ballot_sync(0xffffffffu, accepted);
        while (msk) {
          dE_sum += __shfl_sync(0xffffffffu, dE, __ffs(msk) - 1);
          msk &= msk - 1;
        }
      } else if (accepted) {
        dE_sum += dE;
      }
      __syncwarp();
      g = g1;
      len = len1;
      len1 = len2;
      i = i1;
      i1 = i2;
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        nb[k] = nb1[k];
        jk[k] = jk1[k];
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      n_acc += __shfl_xor_sync(0xffffffffu, n_acc, o);
      if (!kFloat) dE_sum += __shfl_xor_sync(0xffffffffu, dE_sum, o);
    }
    if (lane == 0) {
      E[b0 + warp] += dE_sum;
      acc[b0 + warp] += n_acc;
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < N * W; x += blockDim.x) {
    const int i = x >> lw, c = x & (W - 1);
    if (c < nc) {
      const size_t o = (size_t)i * B + b0 + c;
      const unsigned char* base = smem + c * stride;
      sigT[o] = (int8_t)base[i];
      lfT[o] = (TC)reinterpret_cast<const TF*>(base + fo)[i];
    }
  }
}

template <typename TF, typename TC>
int launch_resident(const int32_t* sites, const int32_t* glen, int n_moves,
                    const int32_t* neigh, const void* J, int N, int K, int B,
                    int8_t* sigT, void* lfT, void* E, int32_t* acc,
                    uint32_t seed, uint32_t move0, uint32_t chain0,
                    const float* beta_s, int chains, cudaStream_t st) {
  auto k = site_resident_kernel<TF, TC>;
  const size_t smem = (size_t)chains * chain_bytes(N, (int)sizeof(TF));
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(B + chains - 1) / chains, 32 * chains, smem, st>>>(
      sites, glen, n_moves, neigh, (const TC*)J, N, K, B, sigT, (TC*)lfT,
      (TC*)E, acc, seed, move0, chain0, beta_s);
  return (int)cudaGetLastError();
}

// field: 0 int8, 1 int16, 2 int32, 3 float32 (ops/rejfree.py FIELD_CODES)
const void* resident_of(int field) {
  switch (field) {
    case 0: return (const void*)site_resident_kernel<int8_t, int32_t>;
    case 1: return (const void*)site_resident_kernel<int16_t, int32_t>;
    case 2: return (const void*)site_resident_kernel<int32_t, int32_t>;
    case 3: return (const void*)site_resident_kernel<float, float>;
  }
  return nullptr;
}

}  // namespace

// out[5] of the resident kernel of `field` at `chains` warps and `smem`
// dynamic bytes (race.cuh's kernel_info); chains == 0: the global kernel
// (float for field 3) at 32 threads
extern "C" int rrrmc_site_info(int chains, int field, size_t smem, int device,
                               int* out) {
  if (chains == 0)
    return rrrmc::kernel_info(
        field == 3 ? (const void*)site_global_kernel<float>
                   : (const void*)site_global_kernel<int32_t>,
        32, 0, device, out);
  const void* k = resident_of(field);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info(k, 32 * chains, smem, device, out);
}

// the groups of the schedule alone: glen[m] for every move m
extern "C" int rrrmc_site_cut(const int32_t* sites, int n_moves,
                              const int32_t* neigh, int N, int K, int cap,
                              int32_t* glen, void* stream) {
  if (cap < 1 || cap > kGroupMax) return (int)cudaErrorInvalidValue;
  if (n_moves > 0)
    site_cut_kernel<<<(n_moves + kCutThreads - 1) / kCutThreads, kCutThreads,
                      0, (cudaStream_t)stream>>>(sites, n_moves, neigh, N, K,
                                                 cap, glen);
  return (int)cudaGetLastError();
}

// chains == 0: the global route; else the resident route with `chains`
// warps a block, fields of type `field`, groups of at most kGroupMax moves
// (scratch glen [n_moves]); beta_s [B] float32, each chain's beta * scale
extern "C" int rrrmc_site_metropolis(
    const int32_t* sites, int n_moves, const int32_t* neigh, const void* J,
    int N, int K, int B, int8_t* sigT, void* lfT, void* E, int32_t* acc,
    uint32_t seed, uint32_t move0, uint32_t chain0, const float* beta_s,
    int field, int chains, int32_t* glen, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chains == 0) {
    const int blocks = (B + 31) / 32;
    if (field == 3)
      site_global_kernel<float><<<blocks, 32, 0, st>>>(
          sites, n_moves, neigh, (const float*)J, N, K, B, sigT, (float*)lfT,
          (float*)E, acc, seed, move0, chain0, beta_s);
    else
      site_global_kernel<int32_t><<<blocks, 32, 0, st>>>(
          sites, n_moves, neigh, (const int32_t*)J, N, K, B, sigT,
          (int32_t*)lfT, (int32_t*)E, acc, seed, move0, chain0, beta_s);
    return (int)cudaGetLastError();
  }
  if (field < 0 || field > 3 || chains < 1 || chains > 32)
    return (int)cudaErrorInvalidValue;
  int err =
      rrrmc_site_cut(sites, n_moves, neigh, N, K, kGroupMax, glen, stream);
  if (err) return err;
#define RRRMC_ARGS sites, glen, n_moves, neigh, J, N, K, B, sigT, lfT, E, \
                   acc, seed, move0, chain0, beta_s, chains, st
  switch (field) {
    case 0: return launch_resident<int8_t, int32_t>(RRRMC_ARGS);
    case 1: return launch_resident<int16_t, int32_t>(RRRMC_ARGS);
    case 2: return launch_resident<int32_t, int32_t>(RRRMC_ARGS);
    default: return launch_resident<float, float>(RRRMC_ARGS);
  }
#undef RRRMC_ARGS
}
