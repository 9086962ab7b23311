// The move loop of the redesigned tau-EO kernels (eo_sparse.cu, eo_dense.cu,
// eo_sat.cu): a chain's resident state, the rank drawn ahead, the select,
// the tie race and the strict-improvement tracking, with the flip left to
// a policy class of each kernel file. The law is eo.cuh's; the plain
// versions are rrrmc_tpu_torch/ops/eo.py::eo_chunk_reference and its
// callers.
//
// A chain is run by W warps (eo_group.cuh): W = 1, four chains a block, for
// small chains, whose moves then take no block barrier at all; W = 4, 8 or
// 32, one chain a block, where a chain has many sites and few chains share
// an SM (the plan, ops/eo.py::eo_plan). Resident in shared memory for the
// whole launch, a chain's:
//   keys     in the narrowest type the bound on |key| allows: the pairwise
//            kernels' half_i = sigma_i lf_i (int8 or int16 with exact
//            histogram bins; int32 or float32 with coarse bins; lf is
//            sigma_i half_i, so the caller's lf is rebuilt at the end, and a
//            float field update is done on lf = sigma * half, so it rounds
//            as the plain version's lf += J d does, -0.0 included), or
//            K-SAT's dE_i biased by 128 in a uint8 (by 32768 in a uint16
//            where Cmax > 127), so that a 32-bit atomicAdd of a change
//            shifted into one byte never carries into the next; the tie
//            race reads one word for four 8-bit keys and compares them with
//            __vcmpeq4;
//   spins    and best spins as bits (bit set: spin -1);
//   bins     the histogram of the keys and its super-bins (eo_group.cuh);
//   extra    the policy's own state (K-SAT: the clause counts, uint8).
// Per move: the rank (drawn ahead), the select, then
//   HIST     v = the selected bin's key; the tie race over the groups of
//            four packed keys (eo_group.cuh::warp_tie_packed), with no draw
//            where the bin holds one site;
//   COARSE   the bins are a monotone coarse map of the key, floor((x - lo)
//            * scale) clamped to [0, nb), x = float(key); one pass collects
//            the sites of the selected bin (at most 32 are listed); where it
//            holds at most 32, every warp selects the key of rank r - before
//            among them and races its members itself (no barrier; a class of
//            one site needs no draw); else an exact radix select over the
//            sites of that bin (8 bits a pass, two passes for 16-bit keys,
//            four for 32-bit ones) and a tie race over all sites. The result
//            is the same v and winner by construction, -0.0 below +0.0 and
//            equal floats included;
// then the policy's flip, each changed key moved between bins by shared
// atomics (the super-bins only where the key crosses one), and the
// strict-improvement tracking (a copy of the spin words; a whole-block
// chain's warps share it at the next move). A whole-block chain has two
// barriers a move: after its warps' tie minima are posted, and after the
// flip.
//
// A policy P gives: Tables (its read-only tables, a kernel argument);
// kDerived (the keys are derived from the extra state after a barrier);
// load_key(c, a, i, s) (the key of site i from the
// caller's state, spin s); load_extra(c, a, tab); derive(c, tab);
// de<T>(v) (the energy change of flipping a site of key v); flip(c, a, tab,
// w, v) (every thread of the chain calls it; the policy picks who works);
// kSpinAfter (more than one warp reads the winner's spin in the flip: the
// loop flips its bit after the move's barrier, else the flip does);
// store(c, a, tab) (the caller's state back).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "eo_group.cuh"
#include "race.cuh"

namespace rrrmc {

constexpr int kEoHist = 0, kEoCoarse = 1;
// chains a block of the one-warp route
constexpr int kWarpChains = 4;

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// byte offsets within one chain's part of the block's dynamic shared memory
struct EoLayout {
  uint32_t keys, sig, smin, hist, sup, queue, slots, list, rh, extra, chain;
};

__host__ __device__ inline EoLayout eo_layout(int N, int key_bytes, int nb,
                                              int W, bool coarse,
                                              size_t extra) {
  const size_t np = ((size_t)N + 3) / 4 * 4, nw = ((size_t)N + 31) / 32;
  const size_t nsup = nb > 32 ? ((size_t)nb + 31) / 32 : 0;
  size_t at = 0;
  EoLayout l;
  l.keys = 0;
  at += round16(np * key_bytes);
  l.sig = (uint32_t)at;
  at += round16(nw * 4);
  l.smin = (uint32_t)at;
  at += round16(nw * 4);
  l.hist = (uint32_t)at;
  at += round16((size_t)nb * 4);
  l.sup = (uint32_t)at;
  at += round16(nsup * 4);
  l.queue = (uint32_t)at;
  at += (size_t)W * kTieQueue * 4;
  l.slots = (uint32_t)at;
  at += round16((size_t)W * 8);
  l.list = (uint32_t)at;
  if (coarse) at += round16(2 * 32 * 8 + 2 * 4);
  l.rh = (uint32_t)at;
  if (coarse) at += 256 * 4;
  l.extra = (uint32_t)at;
  at += round16(extra);
  l.chain = (uint32_t)at;
  return l;
}

// the arguments every EO kernel of this loop takes; lf is the caller's
// resident state (local fields or cavity sums, [B, N]; K-SAT: the clause
// counts [B, Mc] int32)
struct EoArgs {
  int8_t* sigma;
  void* lf;
  void* E;
  void* emin;
  int8_t* smin;
  int32_t* itmin;
  const float* cdf;
  int N, B, n_moves, nb;
  uint32_t seed, move0, chain0;
  float lo, scale;  // COARSE: the bin map
  EoLayout l;
};

__device__ __forceinline__ int spin_at(const uint32_t* sig, int i) {
  return 1 - 2 * (int)((sig[i >> 5] >> (i & 31)) & 1u);
}

// spins as bits, read as +-1 by index (sat.cuh's flip reads them so)
struct BitSpins {
  const uint32_t* w;
  __device__ __forceinline__ int operator[](int i) const {
    return spin_at(w, i);
  }
};

// the sort key of a resident key: int8 / int16 / int32 themselves, the
// monotone int32 key of a float32, and a biased uint8 / uint16 less its bias
__device__ __forceinline__ int32_t key_of(int8_t h) { return h; }
__device__ __forceinline__ int32_t key_of(int16_t h) { return h; }
__device__ __forceinline__ int32_t key_of(int32_t h) { return h; }
__device__ __forceinline__ int32_t key_of(float h) { return eo_key(h); }
__device__ __forceinline__ int32_t key_of(uint8_t h) { return (int)h - 128; }
__device__ __forceinline__ int32_t key_of(uint16_t h) {
  return (int)h - 32768;
}

// the resident key of a selected key (eo_key is its own inverse)
template <typename KT>
__device__ __forceinline__ KT half_of(int32_t k) {
  if constexpr (std::is_same<KT, float>::value) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  } else if constexpr (std::is_unsigned<KT>::value) {
    return KT(k + (1 << (8 * sizeof(KT) - 1)));
  } else {
    return KT(k);
  }
}

// the keys' tail past N: a sentinel never selected (the least key of an
// exact type, whose bin no site reaches; 0 for coarse keys, which the tie
// race reads only through the sites below N)
template <typename KT, int SEL>
__device__ __forceinline__ KT key_sentinel() {
  if constexpr (SEL == kEoCoarse) return KT(0);
  else if constexpr (std::is_unsigned<KT>::value) return KT(0);
  else return KT(sizeof(KT) == 1 ? -128 : -32768);
}

// lf, couplings and energies: float for float keys, else int32
template <typename KT>
using eo_energy_t = typename std::conditional<std::is_same<KT, float>::value,
                                              float, int32_t>::type;

// One thread's view of its chain: the shared arrays, the bin map and who it
// is within the chain.
template <typename KT, int SEL, int W>
struct EoChainView {
  using Key = KT;
  static constexpr int kSel = SEL;
  static constexpr int kT = 32 * W;  // threads a chain
  KT* keys;
  uint32_t* sig;
  uint32_t* smin;
  int* hist;
  int* sup;
  unsigned char* extra;
  int N, nb, off, lane, cw, tid, b;
  int nkv;  // 16-byte vectors of keys (the tail's sentinels included)
  uint32_t chain;
  size_t row;
  float lo, scale;

  // the exact bin of a sort key (HIST), clamped so that a wrong bound
  // cannot write outside hist
  __device__ __forceinline__ int bin_key(int32_t k) const {
    return min(max(k + off, 0), nb - 1);
  }

  // the histogram bin of a key (HIST) or of its value (COARSE)
  __device__ __forceinline__ int bin_of(KT h) const {
    if constexpr (SEL == kEoHist) {
      return bin_key(key_of(h));
    } else {
      const int c = __float2int_rd(((float)h - lo) * scale);
      return min(max(c, 0), nb - 1);
    }
  }

  // a key that moved from bin b0 to b1: the histogram and, where it crosses
  // one, the super-bins
  __device__ __forceinline__ void move_bins(int b0, int b1) const {
    if (b0 == b1) return;
    atomicAdd(hist + b0, -1);
    atomicAdd(hist + b1, 1);
    if (nb > 32 && (b0 >> 5) != (b1 >> 5)) {
      atomicAdd(sup + (b0 >> 5), -1);
      atomicAdd(sup + (b1 >> 5), 1);
    }
  }

  // site i's key moves from oh to nh, and between bins
  __device__ __forceinline__ void put(int i, KT oh, KT nh) const {
    keys[i] = nh;
    move_bins(bin_of(oh), bin_of(nh));
  }

  __device__ __forceinline__ void flip_spin(int w) const {
    sig[w >> 5] ^= 1u << (w & 31);
  }
};

// The pairwise policies' keys half = sigma lf, loaded from and stored to
// the caller's lf (eo_sparse.cu's and eo_dense.cu's)
struct HalfKeys {
  static constexpr bool kDerived = false;
  static constexpr bool kSpinAfter = false;

  template <class C>
  __device__ __forceinline__ static void load_key(const C& c,
                                                  const EoArgs& a, int i,
                                                  int s) {
    using KT = typename C::Key;
    using T = eo_energy_t<KT>;
    c.keys[i] = KT(T(s) * reinterpret_cast<const T*>(a.lf)[c.row + i]);
  }

  template <class C, class Tab>
  __device__ __forceinline__ static void load_extra(const C&, const EoArgs&,
                                                    const Tab&) {}

  template <class C, class Tab>
  __device__ __forceinline__ static void derive(const C&, const Tab&) {}

  // dE of a site of key v: 2 half
  template <typename T, typename KT>
  __device__ __forceinline__ static T de(int32_t v) {
    return T(2) * T(half_of<KT>(v));
  }

  // lf = sigma * half
  template <class C, class Tab>
  __device__ __forceinline__ static void store(const C& c, const EoArgs& a,
                                               const Tab&) {
    using KT = typename C::Key;
    using T = eo_energy_t<KT>;
    T* lf_o = reinterpret_cast<T*>(a.lf);
    for (int i = c.tid; i < c.N; i += C::kT)
      lf_o[c.row + i] = T(spin_at(c.sig, i)) * T(c.keys[i]);
  }
};

// KT: resident keys; SEL: kEoHist or kEoCoarse; P: the flip policy; W:
// warps a chain
template <class P, typename KT, int SEL, int W>
__global__ void __launch_bounds__(W == 1 ? 32 * kWarpChains : 32 * W, 1)
    eo_chain_kernel(EoArgs a, typename P::Tables tab) {
  using T = eo_energy_t<KT>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = 32 * W;  // threads a chain
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw = W == 1 ? 0 : warp;        // the warp within its chain
  const int cib = W == 1 ? warp : 0;       // the chain within the block
  const int b = W == 1 ? blockIdx.x * kWarpChains + cib : blockIdx.x;
  if (b >= a.B) return;  // the one-warp route only: a whole warp leaves
  const int tid = cw * 32 + lane;
  const int N = a.N, nb = a.nb;
  const EoLayout l = a.l;
  unsigned char* base = smem + (size_t)cib * l.chain;
  EoChainView<KT, SEL, W> c;
  c.keys = reinterpret_cast<KT*>(base + l.keys);
  c.sig = reinterpret_cast<uint32_t*>(base + l.sig);
  c.smin = reinterpret_cast<uint32_t*>(base + l.smin);
  c.hist = reinterpret_cast<int*>(base + l.hist);
  c.sup = reinterpret_cast<int*>(base + l.sup);
  c.extra = base + l.extra;
  c.N = N;
  c.nb = nb;
  c.off = (nb - 1) / 2;
  c.lane = lane;
  c.cw = cw;
  c.tid = tid;
  c.b = b;
  c.chain = a.chain0 + (uint32_t)b;
  c.row = (size_t)b * N;
  c.lo = a.lo;
  c.scale = a.scale;
  KT* keys = c.keys;
  uint32_t* sig = c.sig;
  uint32_t* smin = c.smin;
  int* hist = c.hist;
  int* sup = c.sup;
  uint32_t* q = reinterpret_cast<uint32_t*>(base + l.queue) + cw * kTieQueue;
  int2* slots = reinterpret_cast<int2*>(base + l.slots);
  // the listed sites of the selected bin and their keys [2][32], then the
  // counts [2], by move parity
  int2* list = reinterpret_cast<int2*>(base + l.list);
  int* cnt = reinterpret_cast<int*>(list + 64);
  int* rh = reinterpret_cast<int*>(base + l.rh);
  const uint32_t chain = c.chain;
  const size_t row = c.row;
  const int nw = (N + 31) >> 5, np = (N + 3) & ~3;
  // 16-byte vectors of keys (the keys' part is 16-byte aligned, its tail
  // filled with sentinels)
  const int NV = (int)(round16((size_t)np * sizeof(KT)) / 16);
  c.nkv = NV;
  auto sync = [] {
    if constexpr (W == 1) __syncwarp(); else __syncthreads();
  };

  // load: spins and best spins as bits, the keys, the histogram
  for (int i0 = cw * 32; i0 < 32 * nw; i0 += kT) {
    const int i = i0 + lane;
    const int s = i < N ? a.sigma[row + i] : 1;
    const int sm = i < N ? a.smin[row + i] : 1;
    const unsigned bs = __ballot_sync(kAll, s < 0);
    const unsigned bm = __ballot_sync(kAll, sm < 0);
    if (lane == 0) {
      sig[i0 >> 5] = bs;
      smin[i0 >> 5] = bm;
    }
    if (i < N) P::load_key(c, a, i, s);
  }
  P::load_extra(c, a, tab);
  for (int i = N + tid; i < (int)(round16((size_t)np * sizeof(KT)) /
                                  sizeof(KT)); i += kT)
    keys[i] = key_sentinel<KT, SEL>();
  for (int k = tid; k < nb; k += kT) hist[k] = 0;
  if (nb > 32)
    for (int k = tid; k < (nb + 31) / 32; k += kT) sup[k] = 0;
  if (SEL == kEoCoarse && tid == 0) cnt[0] = cnt[1] = 0;
  sync();
  if constexpr (P::kDerived) {
    P::derive(c, tab);
    sync();
  }
  for (int i = tid; i < N; i += kT) hist2_add(hist, sup, nb, c.bin_of(keys[i]),
                                              1);
  T E = reinterpret_cast<const T*>(a.E)[b];
  T emin = reinterpret_cast<const T*>(a.emin)[b];
  int32_t itmin = a.itmin[b];
  sync();

  const int NG = np >> 2;
  int rl = 0;
  // a whole-block chain copies its best spins at the next move, every warp
  // a share (before the flip of that move, which a barrier keeps after it);
  // under kSpinAfter it copies them at the move's end
  bool copy = false;
  for (int m = 0; m < a.n_moves; ++m) {
    const uint32_t mv = a.move0 + (uint32_t)m;
    if (W > 1 && copy) {
      for (int k = tid; k < nw; k += kT) smin[k] = sig[k];
      copy = false;
    }
    // the next move's list count (its last reader passed the previous
    // move's closing barrier)
    if (SEL == kEoCoarse && tid == 0) cnt[(m + 1) & 1] = 0;
    if ((m & 31) == 0) rl = rank_of(a.cdf, N, a.seed, chain, mv + lane);
    const int r = __shfl_sync(kAll, rl, m & 31);
    int bin, before;
    hist2_select(hist, sup, nb, r, bin, before);
    int32_t best = kI32Max;
    int win = kI32Max;
    int32_t v;  // the selected key
    bool exchange = W > 1;  // the warps' minima go through shared memory
    if constexpr (SEL == kEoHist) {
      v = bin - c.off;
      // the tie race compares the resident words with v's own
      warp_tie_packed(keys, NV, cw * 32, kT, v - key_of(KT(0)),
                      hist[bin] == 1, q, a.seed, chain, mv, best, win);
    } else {
      // the sites of the selected bin: counted, and listed up to 32 (the
      // loop as written: unrolled, it took GraphRRGNormal(10^4) 12% longer)
      int2* li = list + 32 * (m & 1);
      int* cn = cnt + (m & 1);
#pragma unroll 1
      for (int i0 = cw * 32; i0 < N; i0 += kT) {
        const int i = i0 + lane;
        const bool in = i < N && c.bin_of(keys[i]) == bin;
        const unsigned bal = __ballot_sync(kAll, in);
        if (bal) {
          int at0 = 0;
          if (lane == 0) at0 = atomicAdd(cn, __popc(bal));
          const int at = __shfl_sync(kAll, at0, 0) + __popc(bal &
                                                            lanes_below());
          if (in && at < 32) li[at] = make_int2(i, key_of(keys[i]));
        }
      }
      sync();
      const int cl = *reinterpret_cast<volatile int*>(cn);
      const int rr = r - before;
      if (cl <= 32) {
        // every warp alike: the key of rank rr among the cl listed, and the
        // race of its members (from the list: the flip may already be
        // changing the keys)
        exchange = false;
        const bool ok = lane < cl;
        const int2 e = ok ? li[lane] : make_int2(0, 0);
        const int idx = e.x;
        const int32_t k = e.y;
        int lt = 0, eq = 0;
        for (int t = 0; t < 32; ++t) {
          const int32_t kt = __shfl_sync(kAll, k, t);
          if (t < cl) {
            lt += kt < k;
            eq += kt == k;
          }
        }
        const bool sel = ok && lt <= rr && rr < lt + eq;
        const int L = __ffs(__ballot_sync(kAll, sel)) - 1;
        v = __shfl_sync(kAll, k, L);
        const int members = __shfl_sync(kAll, eq, L);
        if (ok && k == v && members == 1) {
          best = 0;  // the class's one site: no draw
          win = idx;
        } else if (ok && k == v) {
          const uint4 w4 = philox4x32_10(
              make_uint4((uint32_t)idx >> 2, mv, DRAW_EO_TIE, 0u),
              make_uint2(a.seed, chain));
          const int j = idx & 3;
          const uint32_t word = j == 0 ? w4.x : j == 1 ? w4.y
                                : j == 2 ? w4.z : w4.w;
          best = min((int32_t)word, kI32Max - 1);
          win = idx;
        }
      } else {
        // crowded bin: the radix select over its sites' biased keys
        // (unsigned order = signed order), 8 bits a pass over the key's
        // width
        constexpr int kTop = sizeof(KT) == 2 ? 8 : 24;
        auto biased = [](int32_t k) {
          return sizeof(KT) == 2 ? (uint32_t)(k + 32768)
                                 : (uint32_t)k ^ 0x80000000u;
        };
        uint32_t prefix = 0u, pmask = 0u;
        int rk = rr;
        for (int shift = kTop; shift >= 0; shift -= 8) {
          sync();
          for (int k = tid; k < 256; k += kT) rh[k] = 0;
          sync();
          for (int i0 = cw * 32; i0 < N; i0 += kT) {
            const int i = i0 + lane;
            uint32_t ku = 0u;
            bool in = false;
            if (i < N) {
              ku = biased(key_of(keys[i]));
              in = (ku & pmask) == prefix && c.bin_of(keys[i]) == bin;
            }
            hist_add_warp(rh, (int)((ku >> shift) & 255u), in);
          }
          sync();
          int sb, sbefore;
          warp_select(rh, 256, rk, sb, sbefore);
          rk -= sbefore;
          prefix |= (uint32_t)sb << shift;
          pmask |= 255u << shift;
        }
        v = sizeof(KT) == 2 ? (int32_t)prefix - 0x8000
                            : (int32_t)(prefix ^ 0x80000000u);
        warp_tie(
            NG, cw * 32, kT,
            [&](int g) {
              uint32_t mk = 0u;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int i = 4 * g + j;
                if (i < N && key_of(keys[i]) == v) mk |= 1u << j;
              }
              return mk;
            },
            q, a.seed, chain, mv, best, win);
      }
    }
    warp_argmin(best, win);
    if (exchange) {
      // the chain's minimum over its warps' minima
      if (lane == 0) slots[cw] = make_int2(best, win);
      __syncthreads();
      const int2 s = lane < W ? slots[lane] : make_int2(kI32Max, kI32Max);
      best = s.x;
      win = s.y;
      warp_argmin(best, win);
    }
    const int w = win;
    E += P::template de<T, KT>(v);
    P::flip(c, a, tab, w, v);
    // strict improvement (E is the same in every thread: a uniform branch)
    const bool better = E < emin;
    if (better) {
      emin = E;
      itmin = (int32_t)(mv + 1u);
    }
    if constexpr (P::kSpinAfter) {
      // the winner's bit flips once every read of it is done, by the thread
      // that copies its word to the best spins (the next move reads sig only
      // after a barrier)
      sync();
      if (tid == (w >> 5) % kT) c.flip_spin(w);
      if (better)
        for (int k = tid; k < nw; k += kT) smin[k] = sig[k];
      if (W == 1) __syncwarp();
    } else {
      if (better) {
        if (W == 1) {
          __syncwarp();
          for (int k = lane; k < nw; k += 32) smin[k] = sig[k];
        } else {
          copy = true;
        }
      }
      sync();
    }
  }
  if constexpr (P::kSpinAfter) {
    sync();
  } else if (W > 1 && copy) {
    for (int k = tid; k < nw; k += kT) smin[k] = sig[k];
    sync();
  }

  // store: spins, best spins, the policy's state
  for (int i = tid; i < N; i += kT) {
    a.sigma[row + i] = (int8_t)spin_at(sig, i);
    a.smin[row + i] = (int8_t)spin_at(smin, i);
  }
  P::store(c, a, tab);
  if (tid == 0) {
    reinterpret_cast<T*>(a.E)[b] = E;
    reinterpret_cast<T*>(a.emin)[b] = emin;
    a.itmin[b] = itmin;
  }
}

// the threads and chains of a block on W warps a chain
inline int eo_threads_of(int W) { return W == 1 ? 32 * kWarpChains : 32 * W; }
inline int eo_chains_of(int W) { return W == 1 ? kWarpChains : 1; }

// Launch an instantiation k of eo_chain_kernel: the block's dynamic shared
// memory opted in, the grid of its chains.
template <typename Tables>
int eo_chain_launch(void (*k)(EoArgs, Tables), const EoArgs& a,
                    const Tables& tab, int W, cudaStream_t st) {
  const size_t smem = (size_t)eo_chains_of(W) * a.l.chain;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.B + eo_chains_of(W) - 1) / eo_chains_of(W);
  k<<<grid, eo_threads_of(W), smem, st>>>(a, tab);
  return (int)cudaGetLastError();
}

}  // namespace rrrmc
