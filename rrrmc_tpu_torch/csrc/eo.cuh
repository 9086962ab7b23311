// The law of the tau-EO kernels and the block-level helpers of the
// perceptron EO kernel's radix route (eo_perc.cu: one block of kEoThreads
// threads per chain). The redesigned kernels (eo_chain.cuh's move loop:
// eo_sparse.cu, eo_dense.cu, eo_sat.cu; and eo_perc.cu's histogram route)
// take eo_group.cuh's warp-level steps for the same law. Per move m
// (mv = move0 + m):
//   rank     u from the Philox word (0, mv, DRAW_EO_RANK, 0), rank =
//            #{i < N : cdf_i < u} by a binary search on the nondecreasing
//            float32 table;
//   select   v = the (rank+1)-th smallest key, key_i = sigma_i * lf_i for
//            integer couplings, the monotone int32 key of that float32
//            product for float ones (-0.0 sorts below +0.0), K-SAT's dE_i
//            and the perceptrons' dE_i. Here: an MSB-first radix select on
//            the biased keys, 8 bits a pass, 4 passes (radix_select), each a
//            block scan of 256 counters (hist_select);
//   tie race among the sites whose key equals v: score_i =
//            min(bits_i, INT32_MAX - 1), bits_i the signed word i % 4 of
//            (i // 4, mv, DRAW_EO_TIE, 0), drawn only for the groups of four
//            sites that hold a member; the smallest score wins, the lowest
//            index among equal scores (tie_race, block_argmin_int);
//   track    after the unconditional flip, E < Emin (strict) sets Emin = E,
//            sigma_min = sigma and itmin = mv + 1.
// Every block-level helper starts with __syncthreads(), so what the threads
// wrote before the call is visible to it and the shared scratch of the
// previous helper is free again. The plain version is
// rrrmc_tpu_torch/ops/eo.py::eo_chunk_reference.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"

namespace rrrmc {

constexpr int kEoThreads = 256;
constexpr int kEoWarps = kEoThreads / 32;
// the most bins of an integer histogram (the wrappers' HIST_MAX)
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

}  // namespace rrrmc
