// Warp-level device code of the redesigned tau-EO kernels (eo_chain.cuh's
// move loop of eo_sparse.cu, eo_dense.cu and eo_sat.cu; eo_perc.cu), beside
// the block-level helpers of eo.cuh, which only eo_perc.cu's radix route
// keeps. A chain is run by a group of W warps: one warp (W = 1, several
// chains a block) or a whole block. The law is eo.cuh's, bit for bit; what
// changes is who does each step:
//   rank     drawn ahead: at every 32nd move each warp draws the rank of the
//            next 32 moves, a lane a move, and runs their binary searches
//            side by side; move m takes lane m % 32's by a shuffle;
//   select   a histogram over the keys' bins (exact bins for narrow integer
//            keys, coarse monotone bins otherwise), with a second level of
//            32-bin super-bins when there are more than 32 bins; every warp
//            scans it alike (one or a few counters a lane, a warp scan), so
//            no barrier is needed;
//   tie race each warp reads 16-byte vectors of packed int8 / int16 keys, a
//            lane a vector (four or two groups of four sites), or for
//            other keys 32 groups at a time (the next round read ahead),
//            queues the groups that hold a member in its shared queue and
//            draws their Philox calls once 64 are queued, two a lane side
//            by side, so every lane of a call has a group; the warp's
//            (score, index) minimum is two redux.sync minima, the chain's
//            the minimum over its warps' (one barrier).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "eo.cuh"

namespace rrrmc {

constexpr unsigned kAll = 0xffffffffu;
// entries of a warp's queue of member groups: fewer than 64 pending and up
// to 128 arriving (four groups a lane)
constexpr int kTieQueue = 192;

__device__ __forceinline__ int lane_of() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << lane_of()) - 1u;
}

// The index b of counts[0 .. n) with sum(counts[:b]) <= r < sum(counts[:b+1])
// and that sum below it, by one warp (every lane gets both); 0 <= r <
// sum(counts). Lane l adds a contiguous run of ceil(n / 32) counters.
__device__ __forceinline__ void warp_select(const int* counts, int n, int r,
                                            int& idx, int& before) {
  const int lane = lane_of();
  const int per = (n + 31) >> 5;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  int c = 0;
  if (per == 1) {
    c = lane < n ? counts[lane] : 0;
  } else {
    for (int k = lo; k < hi; ++k) c += counts[k];
  }
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += y;
  }
  const int L = __ffs(__ballot_sync(kAll, incl > r)) - 1;
  int k = lo, e = incl - c;
  if (per > 1 && lane == L)
    while (e + counts[k] <= r) e += counts[k++];
  idx = per > 1 ? __shfl_sync(kAll, k, L) : L;
  before = __shfl_sync(kAll, e, L);
}

// the two-level select over nb bins (super-bins of 32 where nb > 32)
__device__ __forceinline__ void hist2_select(const int* hist, const int* sup,
                                             int nb, int r, int& bin,
                                             int& before) {
  if (nb <= 32) {
    warp_select(hist, nb, r, bin, before);
    return;
  }
  int s, b1, j, b2;
  warp_select(sup, (nb + 31) >> 5, r, s, b1);
  warp_select(hist + 32 * s, min(32, nb - 32 * s), r - b1, j, b2);
  bin = 32 * s + j;
  before = b1 + b2;
}

// hist[bin] += d, and its super-bin's
__device__ __forceinline__ void hist2_add(int* hist, int* sup, int nb,
                                          int bin, int d) {
  atomicAdd(hist + bin, d);
  if (nb > 32) atomicAdd(sup + (bin >> 5), d);
}

// the rank of move mv: #{i < N : cdf_i < u}, u from the Philox rank draw
__device__ __forceinline__ int rank_of(const float* __restrict__ cdf, int N,
                                       uint32_t seed, uint32_t chain,
                                       uint32_t mv) {
  return eo_rank(cdf, N, to_uniform(draw_bits(seed, chain, mv, DRAW_EO_RANK)));
}

// (score, index) of the tie race, the lower score first, then the lower
// index
__device__ __forceinline__ void tie_keep(int32_t sc, int idx, int32_t& best,
                                         int& win) {
  if (sc < best || (sc == best && idx < win)) {
    best = sc;
    win = idx;
  }
}

// the members of group g (mask bit j: site 4 g + j) scored with their
// Philox words
__device__ __forceinline__ void tie_group(uint32_t g, uint32_t mask,
                                          uint32_t seed, uint32_t chain,
                                          uint32_t mv, int32_t& best,
                                          int& win) {
  const uint4 w4 = philox4x32_10(make_uint4(g, mv, DRAW_EO_TIE, 0u),
                                 make_uint2(seed, chain));
  const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((mask >> j) & 1u)
      tie_keep(min((int32_t)words[j], kI32Max - 1), (int)(4 * g + j), best,
               win);
}

// the warp's (score, index) minimum, in every lane
__device__ __forceinline__ void warp_argmin(int32_t& best, int& win) {
  const uint32_t ub = (uint32_t)best ^ 0x80000000u;
  const uint32_t m = __reduce_min_sync(kAll, ub);
  const uint32_t wi =
      __reduce_min_sync(kAll, ub == m ? (uint32_t)win : 0xffffffffu);
  best = (int32_t)(m ^ 0x80000000u);
  win = (int)wi;
}

// A warp's queue of the tie race's member groups, q [kTieQueue] in shared
// memory, n of them queued: add() takes a lane's groups at its place among
// the warp's (a prefix of the lanes' counts, at most 4 a lane, by three
// ballots); drain() draws every queued group's Philox call, two a lane side
// by side, so every lane of a call has a group. Each lane keeps its (best,
// win).
struct TieQueue {
  uint32_t* q;
  uint32_t seed, chain, mv;
  int n;

  // this lane's c groups gs[j] (with masks ms[j], 0: none; j < C)
  template <int C>
  __device__ __forceinline__ void add(const uint32_t (&ms)[C],
                                      const int (&gs)[C]) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) c += ms[j] != 0u;
    const unsigned lt = lanes_below();
    const unsigned c0 = __ballot_sync(kAll, c & 1);
    const unsigned c1 = C > 1 ? __ballot_sync(kAll, c & 2) : 0u;
    const unsigned c2 = C > 3 ? __ballot_sync(kAll, c & 4) : 0u;
    int at = n + __popc(c0 & lt) + 2 * __popc(c1 & lt) + 4 * __popc(c2 & lt);
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (ms[j]) q[at++] = ((uint32_t)gs[j] << 4) | ms[j];
    n += __popc(c0) + 2 * __popc(c1) + 4 * __popc(c2);
  }

  __device__ __forceinline__ void drain(int32_t& best, int& win) {
    const int lane = lane_of();
    __syncwarp();
    for (int k = 0; k < n; k += 64) {
      const uint32_t e0 = lane + k < n ? q[lane + k] : 0u;
      const uint32_t e1 = lane + k + 32 < n ? q[lane + k + 32] : 0u;
      if (k + 32 < n) {
        tie_group(e0 >> 4, e0 & 15u, seed, chain, mv, best, win);
        tie_group(e1 >> 4, e1 & 15u, seed, chain, mv, best, win);
      } else {
        tie_group(e0 >> 4, e0 & 15u, seed, chain, mv, best, win);
      }
    }
    __syncwarp();
    n = 0;
  }
};

// One warp's part of the tie race: groups g = first + lane, first + lane +
// stride, ... below NG (`first`, `stride` multiples of 32, warp-uniform);
// mask_at(g) gives the 4-bit member mask of group g, read one round ahead.
template <typename MaskAt>
__device__ __forceinline__ void warp_tie(int NG, int first, int stride,
                                         MaskAt mask_at, uint32_t* q,
                                         uint32_t seed, uint32_t chain,
                                         uint32_t mv, int32_t& best,
                                         int& win) {
  const int lane = lane_of();
  TieQueue tq{q, seed, chain, mv, 0};
  uint32_t mask = first + lane < NG ? mask_at(first + lane) : 0u;
  for (int base = first; base < NG; base += stride) {
    const int gn = base + lane + stride;
    const uint32_t next = gn < NG ? mask_at(gn) : 0u;
    const uint32_t ms[1] = {mask};
    const int gs[1] = {base + lane};
    tq.add(ms, gs);
    if (tq.n >= 64) tq.drain(best, win);
    mask = next;
  }
  tq.drain(best, win);
}

// the member mask of four int8 keys packed in a word, equal to v (the
// bytes' low bits gathered by one product)
__device__ __forceinline__ uint32_t word_mask(uint32_t w, int32_t v) {
  const uint32_t eq = __vcmpeq4(w, (uint32_t)(uint8_t)v * 0x01010101u);
  return (((eq & 0x01010101u) * 0x00204081u) >> 21) & 15u;
}

// the member mask of two int16 keys packed in a word, equal to v
__device__ __forceinline__ uint32_t half_mask(uint32_t w, int32_t v) {
  const uint32_t eq = __vcmpeq2(w, (uint32_t)(uint16_t)v * 0x00010001u);
  return (((eq & 0x00010001u) * 0x00008001u) >> 15) & 3u;
}

// The tie race over packed 8-bit or 16-bit keys (sentinels past N never
// equal v; v is given as the keys' own bits, so biased keys compare with
// the biased v), by one warp: 16-byte vectors vi = first + lane, first +
// lane + stride, ... below NV, each holding G = 4 (8-bit) or 2 (16-bit)
// groups of four sites; a lane queues its vector's member groups. A class of one
// site (`single`) needs no draw: that site wins whatever its word, and the
// lane that finds it keeps it with score 0.
template <typename KT>
__device__ __forceinline__ void warp_tie_packed(
    const KT* keys, int NV, int first, int stride, int32_t v, bool single,
    uint32_t* q, uint32_t seed, uint32_t chain, uint32_t mv, int32_t& best,
    int& win) {
  constexpr int G = 4 / (int)sizeof(KT);
  const int lane = lane_of();
  TieQueue tq{q, seed, chain, mv, 0};
  for (int base = first; base < NV; base += stride) {
    const int vi = base + lane;
    uint32_t ms[G];
    int gs[G];
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (vi < NV) x = reinterpret_cast<const uint4*>(keys)[vi];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < G; ++j) {
      gs[j] = G * vi + j;
      if (vi >= NV) ms[j] = 0u;
      else if constexpr (sizeof(KT) == 1) ms[j] = word_mask(w[j], v);
      else ms[j] = half_mask(w[2 * j], v) | (half_mask(w[2 * j + 1], v) << 2);
    }
    if (single) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (ms[j]) {
          best = 0;
          win = 4 * gs[j] + __ffs(ms[j]) - 1;
        }
      continue;
    }
    tq.add(ms, gs);
    if (tq.n >= 64) tq.drain(best, win);
  }
  tq.drain(best, win);
}

}  // namespace rrrmc
