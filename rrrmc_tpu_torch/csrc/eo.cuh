// Device code shared by the tau-EO kernels (eo_sparse.cu, eo_dense.cu): one
// block of kEoThreads threads per chain. Per move m (mv = move0 + m):
//   rank     u from the Philox word (0, mv, DRAW_EO_RANK, 0), rank =
//            #{i < N : cdf_i < u} by a binary search on the nondecreasing
//            float32 table (every thread runs it alike);
//   select   v = the (rank+1)-th smallest key, key_i = sigma_i * lf_i for
//            integer couplings, the monotone int32 key of that float32
//            product for float ones (-0.0 sorts below +0.0). Integer keys of
//            a small range are counted in a shared histogram of 2*half_max+1
//            bins that the flips keep up to date, so the select is one block
//            scan over the bins; other keys take an MSB-first radix select
//            on the biased keys, 8 bits a pass, 4 passes;
//   tie race among the sites whose key equals v: score_i =
//            min(bits_i, INT32_MAX - 1), bits_i the signed word i % 4 of
//            (i // 4, mv, DRAW_EO_TIE, 0), drawn only for the groups of four
//            sites that hold a member; the smallest score wins, the lowest
//            index among equal scores;
//   track    after the unconditional flip, E < Emin (strict) sets Emin = E,
//            sigma_min = sigma (a shared-memory copy) and itmin = mv + 1.
// Every block-level helper starts with __syncthreads(), so what the threads
// wrote before the call (the flip's histogram and field updates) is visible
// to it and the shared scratch of the previous helper is free again. The
// plain version is rrrmc_tpu_torch/ops/eo.py::eo_chunk_reference.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace rrrmc {

constexpr int kEoThreads = 256;
constexpr int kEoWarps = kEoThreads / 32;
// the most bins of the integer histogram (the wrapper's HIST_MAX)
constexpr int kEoHistMax = 4096;
constexpr int kRadixBins = 256;
constexpr int32_t kI32Max = 0x7fffffff;

struct EoShared {
  int warp[kEoWarps];
  int idx[kEoWarps];
  int bin, before;
};

__device__ __forceinline__ int32_t eo_key(int32_t half) { return half; }

// the IEEE-754 total-order trick of the TPU kernels (eo_pallas.py:132-133)
__device__ __forceinline__ int32_t eo_key(float half) {
  const int32_t b = __float_as_int(half);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// #{i < N : cdf[i] < u}
__device__ __forceinline__ int eo_rank(const float* __restrict__ cdf, int N,
                                       float u) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cdf + mid) < u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// hist[bin] += 1 for each lane with `ok`; the lanes of one bin are merged
// into one shared atomic. The whole warp must make the call.
__device__ __forceinline__ void hist_add_warp(int* hist, int bin, bool ok) {
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? bin : -1);
  if (ok && __ffs(peers) - 1 == (int)(threadIdx.x & 31))
    atomicAdd(hist + bin, __popc(peers));
}

// The bin b with sum(hist[:b]) <= r < sum(hist[:b+1]), returned with that
// sum below it; 0 <= r < sum(hist). Thread t scans a contiguous run of
// ceil(nbins / kEoThreads) bins.
__device__ inline void hist_select(const int* hist, int nbins, int r,
                                   EoShared& s, int& bin, int& before) {
  __syncthreads();
  const int per = (nbins + kEoThreads - 1) / kEoThreads;
  const int lo = min((int)threadIdx.x * per, nbins);
  const int hi = min(lo + per, nbins);
  int c = 0;
  for (int k = lo; k < hi; ++k) c += hist[k];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s.warp[w] = incl;
  __syncthreads();
  int excl = incl - c;
  for (int k = 0; k < w; ++k) excl += s.warp[k];
  if (excl <= r && r < excl + c) {
    int k = lo;
    while (excl + hist[k] <= r) excl += hist[k++];
    s.bin = k;
    s.before = excl;
  }
  __syncthreads();
  bin = s.bin;
  before = s.before;
}

// The (r+1)-th smallest of the N keys key(i): MSB-first radix select over the
// biased keys key ^ 0x80000000 (unsigned order = signed order), 8 bits a
// pass; hist holds kRadixBins counters.
template <typename KeyAt>
__device__ int32_t radix_select(int N, int r, KeyAt key, int* hist,
                                EoShared& s) {
  uint32_t prefix = 0u, pmask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    __syncthreads();
    for (int k = threadIdx.x; k < kRadixBins; k += kEoThreads) hist[k] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += kEoThreads) {
      const int i = base + threadIdx.x;
      uint32_t ku = 0u;
      bool ok = false;
      if (i < N) {
        ku = (uint32_t)key(i) ^ 0x80000000u;
        ok = (ku & pmask) == prefix;
      }
      hist_add_warp(hist, (int)((ku >> shift) & 255u), ok);
    }
    int bin, before;
    hist_select(hist, kRadixBins, r, s, bin, before);
    r -= before;
    prefix |= (uint32_t)bin << shift;
    pmask |= 255u << shift;
  }
  return (int32_t)(prefix ^ 0x80000000u);
}

// (score, index) minimum over the block, lowest index among equal scores
__device__ __forceinline__ void block_argmin_int(int32_t& v, int& idx,
                                                 EoShared& s) {
  for (int o = 16; o > 0; o >>= 1) {
    const int32_t v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
    if (v2 < v || (v2 == v && i2 < idx)) { v = v2; idx = i2; }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { s.warp[w] = v; s.idx[w] = idx; }
  __syncthreads();
  v = s.warp[0];
  idx = s.idx[0];
  for (int k = 1; k < kEoWarps; ++k) {
    if (s.warp[k] < v || (s.warp[k] == v && s.idx[k] < idx)) {
      v = s.warp[k];
      idx = s.idx[k];
    }
  }
}

// the tie race among the sites i < N with key(i) == v at move mv
template <typename KeyAt>
__device__ int tie_race(int N, int32_t v, uint32_t seed, uint32_t chain,
                        uint32_t mv, KeyAt key, EoShared& s) {
  int32_t best = kI32Max;
  int win = kI32Max;
  for (int g = threadIdx.x; 4 * g < N; g += kEoThreads) {
    bool member[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * g + j;
      member[j] = i < N && key(i) == v;
      any |= member[j];
    }
    if (!any) continue;
    const uint4 w4 = philox4x32_10(
        make_uint4((uint32_t)g, mv, DRAW_EO_TIE, 0u), make_uint2(seed, chain));
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t sc = min((int32_t)words[j], kI32Max - 1);
      if (member[j] && sc < best) { best = sc; win = 4 * g + j; }
    }
  }
  block_argmin_int(best, win, s);
  return win;
}

// bytes of N spins in shared memory, rounded up to 16
__host__ __device__ __forceinline__ size_t spin_bytes(int N) {
  return ((size_t)N + 15) / 16 * 16;
}

// counters of the select: the histogram's bins, or the radix select's 256
__host__ __device__ __forceinline__ int select_bins(int nbins) {
  return nbins > 0 ? nbins : kRadixBins;
}

// dynamic shared memory of one chain: lf [N] (int32 and f32 are both 4
// bytes), the select's counters, sigma and sigma_min [N] int8 each
__host__ __device__ __forceinline__ size_t eo_smem(int N, int nbins) {
  return (size_t)N * 4 + (size_t)select_bins(nbins) * 4 + 2 * spin_bytes(N);
}

// One chain's resident state: lf, the select's counters, sigma and
// sigma_min in dynamic shared memory (lf first, so every array is aligned),
// and E, Emin and itmin, of which every thread keeps an identical copy.
// sigma / lf / sigma_min are chain-major [B, N] in global memory: one
// contiguous row per block, read at the start and written at the end (lf
// only with LF: the K-SAT kernel derives its lf in shared memory; a
// run-time test there cost the sparse kernel 8 registers, and the
// occupancy of small lattices). T is the type of lf and the energies
// (int32 / f32). The key policy HALF_KEY: the sort key is half = sigma_i lf_i
// (pairwise models, PSpin3: lf is a local field); without it the key is
// lf_i itself (K-SAT: lf holds the energy change of each flip).
template <typename T, bool HALF_KEY = true>
struct EoChain {
  T* lf;
  int* hist;
  int8_t* sig;
  int8_t* smin;
  T E, emin;
  int32_t itmin;
  int N, nbins;

  __device__ EoChain(unsigned char* smem, int N_, int nbins_)
      : lf(reinterpret_cast<T*>(smem)),
        hist(reinterpret_cast<int*>(lf + N_)),
        sig(reinterpret_cast<int8_t*>(hist + select_bins(nbins_))),
        smin(sig + spin_bytes(N_)), N(N_), nbins(nbins_) {}

  // the sort key of site i: half_i = sigma_i lf_i, or lf_i
  __device__ __forceinline__ int32_t key(int i) const {
    return HALF_KEY ? eo_key(T(sig[i]) * lf[i]) : eo_key(lf[i]);
  }

  // the histogram bin of an integer key, clamped so that a wrong half_max
  // cannot write outside hist
  __device__ __forceinline__ int bin_of_key(int32_t k) const {
    return min(max(k + (nbins - 1) / 2, 0), nbins - 1);
  }

  __device__ __forceinline__ int bin_of(int i) const {
    return bin_of_key(key(i));
  }

  template <bool LF = true>
  __device__ void load(const int8_t* sigma, const T* lf_g, const T* E_g,
                       const T* emin_g, const int8_t* smin_g,
                       const int32_t* itmin_g, size_t row, int b) {
    for (int i = threadIdx.x; i < N; i += kEoThreads) {
      sig[i] = sigma[row + i];
      smin[i] = smin_g[row + i];
      if (LF) lf[i] = lf_g[row + i];
    }
    E = E_g[b];
    emin = emin_g[b];
    itmin = itmin_g[b];
  }

  // with a histogram: count every site's key (after the load)
  __device__ void fill_hist() {
    __syncthreads();
    for (int k = threadIdx.x; k < nbins; k += kEoThreads) hist[k] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += kEoThreads) {
      const int i = base + threadIdx.x;
      hist_add_warp(hist, i < N ? bin_of(i) : 0, i < N);
    }
  }

  // the winner of move mv: the rank draw, the select (HIST: the histogram,
  // else the radix select over hist's 256 counters) and the tie race
  template <bool HIST>
  __device__ int winner(const float* __restrict__ cdf, uint32_t seed,
                        uint32_t chain, uint32_t mv, EoShared& s) {
    const float u = to_uniform(draw_bits(seed, chain, mv, DRAW_EO_RANK));
    const int r = eo_rank(cdf, N, u);
    auto k = [this](int i) { return key(i); };
    int32_t v;
    if (HIST) {
      int bin, before;
      hist_select(hist, nbins, r, s, bin, before);
      v = bin - (nbins - 1) / 2;
    } else {
      v = radix_select(N, r, k, hist, s);
    }
    return tie_race(N, v, seed, chain, mv, k, s);
  }

  // after the flip of move mv: E < Emin (strict) sets Emin = E, itmin =
  // mv + 1 and sigma_min = sigma (32-bit words; both arrays hold a
  // multiple of 16 bytes). E is identical in every thread, so the branch is
  // uniform.
  __device__ void track(uint32_t mv) {
    if (!(E < emin)) return;
    emin = E;
    itmin = (int32_t)(mv + 1u);
    __syncthreads();  // the flip is written
    const int n4 = (N + 3) >> 2;
    for (int k = threadIdx.x; k < n4; k += kEoThreads)
      reinterpret_cast<int32_t*>(smin)[k] =
          reinterpret_cast<const int32_t*>(sig)[k];
  }

  template <bool LF = true>
  __device__ void store(int8_t* sigma, T* lf_g, T* E_g, T* emin_g,
                        int8_t* smin_g, int32_t* itmin_g, size_t row, int b) {
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += kEoThreads) {
      sigma[row + i] = sig[i];
      smin_g[row + i] = smin[i];
      if (LF) lf_g[row + i] = lf[i];
    }
    if (threadIdx.x == 0) {
      E_g[b] = E;
      emin_g[b] = emin;
      itmin_g[b] = itmin;
    }
  }
};

// the most dynamic shared memory a block beside a static EoShared may opt in
// to
inline int eo_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin - (int)sizeof(EoShared);
}

}  // namespace rrrmc
