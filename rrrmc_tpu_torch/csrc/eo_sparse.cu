// tau-extremal optimisation on a sparse Pairwise model. Replaces
// rrrmc_tpu/ops/eo_pallas.py::_eo_sparse_kernel and, for integer EA lattices
// (to EO a LatticeEA is a sparse Pairwise with K = 2D and its padded
// tables), the lattice branch of that file's _eo_kernel; with PSPIN it is
// tau-EO on a PSpin3 hypergraph (_eo_pspin_kernel). The wrappers, the
// launch plan and the plain torch versions are rrrmc_tpu_torch/ops/eo.py and
// ops/eo_pspin.py; the law is eo.cuh's.
//
// A chain is run by W warps (eo_group.cuh): W = 1, four chains a block, for
// small chains (the EA-3D L=8 lattice, 16 sites a lane), whose moves then
// take no block barrier at all; W = 4, 8 or 32, one chain a block, where a
// chain has many sites and few chains share an SM (the plan, ops/eo.py
// eo_plan). Resident in shared memory for the whole launch, a chain's:
//   keys     half_i = sigma_i lf_i itself, in the narrowest type the bound
//            on |half| allows (int8 or int16 with exact histogram bins;
//            int32 or float32 with coarse bins): the tie race reads one
//            word for four int8 keys and compares them with __vcmpeq4. lf
//            is sigma_i half_i, so the caller's lf is rebuilt at the end;
//            a float field update is done on lf = sigma * half, so it rounds
//            as the plain version's lf += J d does, -0.0 included;
//   spins    and best spins as bits (bit set: spin -1);
//   bins     the histogram of the keys and its super-bins (eo_group.cuh).
// Per move: the rank (drawn ahead), the select, then
//   HIST     v = the selected bin's key; the tie race over the groups of
//            four packed keys (eo_group.cuh::warp_tie_packed), with no draw
//            where the bin holds one site;
//   COARSE   the bins are a monotone coarse map of the key, floor((x - lo)
//            * scale) clamped to [0, nb), x = float(half); one pass collects
//            the sites of the selected bin (at most 32 are listed); where it
//            holds at most 32, every warp selects the key of rank r - before
//            among them and races its members itself (no barrier; a class of
//            one site needs no draw); else an
//            exact radix select over the sites of that bin (four 8-bit
//            passes) and a tie race over all sites. The result is the same
//            v and winner by construction, -0.0 below +0.0 and equal floats
//            included;
// then the flip by the chain's first warp: lanes k < K the winner's K
// neighbours and lane K the winner, at once (neigh / J from global memory);
// a row that lists a site twice, or the winner, takes the winner first and
// then each site's adds in row order from one lane, so fields stay
// bit-equal, float ones too; each changed key moves between bins by shared
// atomics; and the strict-improvement tracking (a copy of the
// spin words; a whole-block chain's warps share it at the next move). A
// whole-block chain has two barriers a move: after its warps' tie minima are
// posted, and after the flip.
//
// Bound on the H100: the tie race's Philox calls, one a group of four sites
// that holds a member of the selected class (about 1 700 a move on
// GraphRRG(10^4) near the EO optimum), and the pass over the resident keys;
// global memory is touched for the winner's table row and, every 32 moves,
// the rank table.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "eo_group.cuh"
#include "race.cuh"

namespace {

using rrrmc::kAll;
using rrrmc::kI32Max;
using rrrmc::kTieQueue;
constexpr int kHist = 0, kCoarse = 1;
// chains a block of the one-warp route
constexpr int kWarpChains = 4;

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// byte offsets within one chain's part of the block's dynamic shared memory
struct Layout {
  uint32_t keys, sig, smin, hist, sup, queue, slots, list, rh, chain;
};

__host__ __device__ inline Layout eo_layout(int N, int key_bytes, int nb,
                                            int W, bool coarse) {
  const size_t np = ((size_t)N + 3) / 4 * 4, nw = ((size_t)N + 31) / 32;
  const size_t nsup = nb > 32 ? ((size_t)nb + 31) / 32 : 0;
  size_t at = 0;
  Layout l;
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
  l.chain = (uint32_t)at;
  return l;
}

struct EoArgs {
  int8_t* sigma;
  void* lf;
  void* E;
  void* emin;
  int8_t* smin;
  int32_t* itmin;
  const int32_t* neigh;
  const void* J;
  const float* cdf;
  int N, K, B, n_moves, nb;
  uint32_t seed, move0, chain0;
  float lo, scale;  // COARSE: the bin map
  Layout l;
};

__device__ __forceinline__ int spin_at(const uint32_t* sig, int i) {
  return 1 - 2 * (int)((sig[i >> 5] >> (i & 31)) & 1u);
}

// the sort key of a resident half
__device__ __forceinline__ int32_t key_of(int8_t h) { return h; }
__device__ __forceinline__ int32_t key_of(int16_t h) { return h; }
__device__ __forceinline__ int32_t key_of(int32_t h) { return h; }
__device__ __forceinline__ int32_t key_of(float h) { return rrrmc::eo_key(h); }

// the half of a selected key (eo_key is its own inverse)
template <typename KT>
__device__ __forceinline__ KT half_of(int32_t k) {
  if constexpr (std::is_same<KT, float>::value) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  } else {
    return KT(k);
  }
}

// KT: resident keys (int8 / int16: HIST; int32 / float: COARSE); SEL: kHist
// or kCoarse; PSPIN: the hypergraph flip; W: warps a chain
template <typename KT, int SEL, bool PSPIN, int W>
__global__ void __launch_bounds__(W == 1 ? 32 * kWarpChains : 32 * W, 1)
    eo_sparse_kernel(EoArgs a) {
  // lf, couplings and energies: float for float keys, else int32
  using T = typename std::conditional<std::is_same<KT, float>::value,
                                      float, int32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = 32 * W;  // threads a chain
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw = W == 1 ? 0 : warp;        // the warp within its chain
  const int cib = W == 1 ? warp : 0;       // the chain within the block
  const int b = W == 1 ? blockIdx.x * kWarpChains + cib : blockIdx.x;
  if (b >= a.B) return;  // the one-warp route only: a whole warp leaves
  const int tid = cw * 32 + lane;
  const int N = a.N, K = a.K, nb = a.nb;
  const Layout l = a.l;
  unsigned char* base = smem + (size_t)cib * l.chain;
  KT* keys = reinterpret_cast<KT*>(base + l.keys);
  uint32_t* sig = reinterpret_cast<uint32_t*>(base + l.sig);
  uint32_t* smin = reinterpret_cast<uint32_t*>(base + l.smin);
  int* hist = reinterpret_cast<int*>(base + l.hist);
  int* sup = reinterpret_cast<int*>(base + l.sup);
  uint32_t* q = reinterpret_cast<uint32_t*>(base + l.queue) + cw * kTieQueue;
  int2* slots = reinterpret_cast<int2*>(base + l.slots);
  // the listed sites of the selected bin and their keys [2][32], then the
  // counts [2], by move parity
  int2* list = reinterpret_cast<int2*>(base + l.list);
  int* cnt = reinterpret_cast<int*>(list + 64);
  int* rh = reinterpret_cast<int*>(base + l.rh);
  const uint32_t chain = a.chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  const int nw = (N + 31) >> 5, np = (N + 3) & ~3;
  auto sync = [] {
    if constexpr (W == 1) __syncwarp(); else __syncthreads();
  };
  const int off = (nb - 1) / 2;
  // the histogram bin of a key (HIST) or of a half (COARSE)
  auto bin_of = [&](KT h) -> int {
    if constexpr (SEL == kHist) {
      return min(max((int)h + off, 0), nb - 1);
    } else {
      const int c = __float2int_rd(((float)h - a.lo) * a.scale);
      return min(max(c, 0), nb - 1);
    }
  };

  // load: spins and best spins as bits, the keys, the histogram
  const T* lf_g = reinterpret_cast<const T*>(a.lf);
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
    if (i < N) keys[i] = KT(T(s) * lf_g[row + i]);
  }
  // the keys' tail past N: sentinels, never a selected key
  for (int i = N + tid; i < (int)(round16((size_t)np * sizeof(KT)) /
                                  sizeof(KT)); i += kT)
    keys[i] = SEL == kHist ? KT(sizeof(KT) == 1 ? -128 : -32768) : KT(0);
  for (int k = tid; k < nb; k += kT) hist[k] = 0;
  if (nb > 32)
    for (int k = tid; k < (nb + 31) / 32; k += kT) sup[k] = 0;
  if (SEL == kCoarse && tid == 0) cnt[0] = cnt[1] = 0;
  sync();
  for (int i = tid; i < N; i += kT) rrrmc::hist2_add(hist, sup, nb,
                                                     bin_of(keys[i]), 1);
  T E = reinterpret_cast<const T*>(a.E)[b];
  T emin = reinterpret_cast<const T*>(a.emin)[b];
  int32_t itmin = a.itmin[b];
  sync();

  const int NG = np >> 2;
  // 16-byte vectors of keys (the keys' part is 16-byte aligned, its tail
  // filled with sentinels)
  const int NV = (int)(round16((size_t)np * sizeof(KT)) / 16);
  int rl = 0;
  // a whole-block chain copies its best spins at the next move, every warp
  // a share (before the flip of that move, which a barrier keeps after it)
  bool copy = false;
  for (int m = 0; m < a.n_moves; ++m) {
    const uint32_t mv = a.move0 + (uint32_t)m;
    if (W > 1 && copy) {
      for (int k = tid; k < nw; k += kT) smin[k] = sig[k];
      copy = false;
    }
    if ((m & 31) == 0) rl = rrrmc::rank_of(a.cdf, N, a.seed, chain, mv + lane);
    const int r = __shfl_sync(kAll, rl, m & 31);
    int bin, before;
    rrrmc::hist2_select(hist, sup, nb, r, bin, before);
    int32_t best = kI32Max;
    int win = kI32Max;
    int32_t v;  // the selected key
    bool exchange = W > 1;  // the warps' minima go through shared memory
    if constexpr (SEL == kHist) {
      v = bin - off;
      rrrmc::warp_tie_packed(keys, NV, cw * 32, kT, v, hist[bin] == 1, q,
                             a.seed, chain, mv, best, win);
    } else {
      // the sites of the selected bin: counted, and listed up to 32
      int2* li = list + 32 * (m & 1);
      int* cn = cnt + (m & 1);
      for (int i0 = cw * 32; i0 < N; i0 += kT) {
        const int i = i0 + lane;
        const bool in = i < N && bin_of(keys[i]) == bin;
        const unsigned bal = __ballot_sync(kAll, in);
        if (bal) {
          int at0 = 0;
          if (lane == 0) at0 = atomicAdd(cn, __popc(bal));
          const int at = __shfl_sync(kAll, at0, 0) + __popc(bal &
                                                            rrrmc::lanes_below());
          if (in && at < 32) li[at] = make_int2(i, key_of(keys[i]));
        }
      }
      sync();
      const int c = *reinterpret_cast<volatile int*>(cn);
      const int rr = r - before;
      if (c <= 32) {
        // every warp alike: the key of rank rr among the c listed, and the
        // race of its members (from the list: the flip may already be
        // changing the keys)
        exchange = false;
        const bool ok = lane < c;
        const int2 e = ok ? li[lane] : make_int2(0, 0);
        const int idx = e.x;
        const int32_t k = e.y;
        int lt = 0, eq = 0;
        for (int t = 0; t < 32; ++t) {
          const int32_t kt = __shfl_sync(kAll, k, t);
          if (t < c) {
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
          const uint4 w4 = rrrmc::philox4x32_10(
              make_uint4((uint32_t)idx >> 2, mv, rrrmc::DRAW_EO_TIE, 0u),
              make_uint2(a.seed, chain));
          const int j = idx & 3;
          const uint32_t word = j == 0 ? w4.x : j == 1 ? w4.y
                                : j == 2 ? w4.z : w4.w;
          best = min((int32_t)word, kI32Max - 1);
          win = idx;
        }
      } else {
        // crowded bin: the radix select over its sites, 8 bits a pass
        uint32_t prefix = 0u, pmask = 0u;
        int rk = rr;
        for (int shift = 24; shift >= 0; shift -= 8) {
          sync();
          for (int k = tid; k < 256; k += kT) rh[k] = 0;
          sync();
          for (int i0 = cw * 32; i0 < N; i0 += kT) {
            const int i = i0 + lane;
            uint32_t ku = 0u;
            bool in = false;
            if (i < N) {
              ku = (uint32_t)key_of(keys[i]) ^ 0x80000000u;
              in = (ku & pmask) == prefix && bin_of(keys[i]) == bin;
            }
            rrrmc::hist_add_warp(rh, (int)((ku >> shift) & 255u), in);
          }
          sync();
          int sb, sbefore;
          rrrmc::warp_select(rh, 256, rk, sb, sbefore);
          rk -= sbefore;
          prefix |= (uint32_t)sb << shift;
          pmask |= 255u << shift;
        }
        v = (int32_t)(prefix ^ 0x80000000u);
        rrrmc::warp_tie(
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
    rrrmc::warp_argmin(best, win);
    if (exchange) {
      // the chain's minimum over its warps' minima
      if (lane == 0) slots[cw] = make_int2(best, win);
      __syncthreads();
      const int2 s = lane < W ? slots[lane] : make_int2(kI32Max, kI32Max);
      best = s.x;
      win = s.y;
      rrrmc::warp_argmin(best, win);
    }
    const int w = win;
    const KT hw = half_of<KT>(v);
    E += T(2) * T(hw);

    // the flip, by the chain's first warp
    if (cw == 0) {
      const int sw = spin_at(sig, w);
      const T d = T(-2 * sw);
      // slot k of the winner's row: its site (N: none) and the add to that
      // site's lf (PSpin3: from the partner's spin before the flip, as the
      // plain version reads it)
      auto slot = [&](int k, int& x, T& add) {
        x = __ldg(a.neigh + (size_t)w * K + k);
        if (x >= N) return;
        if constexpr (PSPIN)
          add = d * T(spin_at(sig, __ldg(a.neigh + (size_t)w * K + (k ^ 1))));
        else
          add = __ldg(reinterpret_cast<const T*>(a.J) + (size_t)w * K + k) * d;
      };
      // lane k takes slot k (K <= 32), its loads issued before the winner's
      // own update
      int x = -1 - lane;  // distinct for the idle lanes
      T add = T(0);
      if (K <= 32 && lane < K) {
        slot(lane, x, add);
        if (x >= N) x = -1 - lane;
      }
      // site i's key moves from oh to nh, and between bins
      auto put = [&](int i, KT oh, KT nh) {
        keys[i] = nh;
        const int b0 = bin_of(oh), b1 = bin_of(nh);
        if (b0 != b1) {
          rrrmc::hist2_add(hist, sup, nb, b0, -1);
          rrrmc::hist2_add(hist, sup, nb, b1, 1);
        }
      };
      // a row that lists a site twice, or the winner, takes the ordered path
      bool twice = x == w;
      for (int k = 0; k < K && k < 32; ++k) {
        const int xk = __shfl_sync(kAll, x, k);
        twice |= k != lane && xk == x;
      }
      if (K < 32 && !__any_sync(kAll, twice)) {
        // a row of distinct sites without the winner: lanes k < K its
        // slots and lane K the winner ((-sigma_w) lf_w), in one step
        int site = lane == K ? w : x;
        KT oh = hw, nh = KT(-T(hw));
        if (lane < K && x >= 0) {
          const int s = spin_at(sig, x);
          oh = keys[x];
          nh = KT(T(s) * (T(s) * T(oh) + add));
        }
        if (lane == K) {
          sig[w >> 5] ^= 1u << (w & 31);
          if (SEL == kCoarse) cnt[(m + 1) & 1] = 0;
        }
        if (site >= 0 && lane <= K) put(site, oh, nh);
      } else {
        // the winner first, then its row's sites in slot order
        __syncwarp();
        if (lane == 0) {
          sig[w >> 5] ^= 1u << (w & 31);
          put(w, hw, KT(-T(hw)));
          if (SEL == kCoarse) cnt[(m + 1) & 1] = 0;
        }
        __syncwarp();
        // site x's new lf: its key s * lf is stored and moves bins
        auto store = [&](int x, T x_lf) {
          const int s = spin_at(sig, x);
          const KT oh = keys[x];
          put(x, oh, KT(T(s) * x_lf));
        };
        if (K <= 32) {
          // a site listed in several slots is updated by the lowest of
          // them, with the adds in slot order
          T f = x >= 0 ? T(spin_at(sig, x)) * T(keys[x]) : T(0);
          bool lead = x >= 0;
          for (int k = 0; k < K; ++k) {
            const int xk = __shfl_sync(kAll, x, k);
            const T ak = __shfl_sync(kAll, add, k);
            if (xk == x) {
              if (k < lane) lead = false;
              f = f + ak;
            }
          }
          if (lead) store(x, f);
        } else if (lane == 0) {
          // more slots than lanes: one after another
          for (int k = 0; k < K; ++k) {
            int x;
            T add = T(0);
            slot(k, x, add);
            if (x < N) store(x, T(spin_at(sig, x)) * T(keys[x]) + add);
          }
        }
      }
    }
    // strict improvement (E is the same in every thread: a uniform branch)
    if (E < emin) {
      emin = E;
      itmin = (int32_t)(mv + 1u);
      if (W == 1) {
        __syncwarp();
        for (int k = lane; k < nw; k += 32) smin[k] = sig[k];
      } else {
        copy = true;
      }
    }
    sync();
  }
  if (W > 1 && copy) {
    for (int k = tid; k < nw; k += kT) smin[k] = sig[k];
    sync();
  }

  // store: spins, best spins, lf = sigma * half
  T* lf_o = reinterpret_cast<T*>(a.lf);
  for (int i = tid; i < N; i += kT) {
    const int s = spin_at(sig, i);
    a.sigma[row + i] = (int8_t)s;
    a.smin[row + i] = (int8_t)spin_at(smin, i);
    lf_o[row + i] = T(s) * T(keys[i]);
  }
  if (tid == 0) {
    reinterpret_cast<T*>(a.E)[b] = E;
    reinterpret_cast<T*>(a.emin)[b] = emin;
    a.itmin[b] = itmin;
  }
}

using Kern = void (*)(EoArgs);

template <typename KT, int SEL, bool PSPIN>
Kern by_warps(int W) {
  switch (W) {
    case 1: return eo_sparse_kernel<KT, SEL, PSPIN, 1>;
    case 4: return eo_sparse_kernel<KT, SEL, PSPIN, 4>;
    case 8: return eo_sparse_kernel<KT, SEL, PSPIN, 8>;
    case 32: return eo_sparse_kernel<KT, SEL, PSPIN, 32>;
  }
  return nullptr;
}

// key codes: 0 int8, 1 int16 (HIST); 2 int32, 3 float32 (COARSE); PSpin3
// keys are int8 or int16
Kern kernel_of(int key, int pspin, int W) {
  if (pspin)
    return key == 0   ? by_warps<int8_t, kHist, true>(W)
           : key == 1 ? by_warps<int16_t, kHist, true>(W)
                      : nullptr;
  switch (key) {
    case 0: return by_warps<int8_t, kHist, false>(W);
    case 1: return by_warps<int16_t, kHist, false>(W);
    case 2: return by_warps<int32_t, kCoarse, false>(W);
    case 3: return by_warps<float, kCoarse, false>(W);
  }
  return nullptr;
}

constexpr int kKeyBytes[4] = {1, 2, 4, 4};

int threads_of(int W) { return W == 1 ? 32 * kWarpChains : 32 * W; }
int chains_of(int W) { return W == 1 ? kWarpChains : 1; }

}  // namespace

// dynamic shared memory of one block: chains_of(W) chains' parts
extern "C" size_t rrrmc_eo_sparse_smem(int N, int key, int nb, int W) {
  if (key < 0 || key > 3) return 0;
  return (size_t)chains_of(W) * eo_layout(N, kKeyBytes[key], nb, W,
                                          key >= 2).chain;
}

// the launch facts of an instantiation at `smem` dynamic bytes into out[5]
// (blocks per SM, registers, local bytes, static shared bytes, most dynamic
// shared bytes); cudaErrorInvalidValue if there is none
extern "C" int rrrmc_eo_sparse_info(int W, int key, int pspin, size_t smem,
                                    int device, int* out) {
  const Kern k = kernel_of(key, pspin, W);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads_of(W), smem, device, out);
}

// key: 0 int8 / 1 int16 keys with nb = 2 half_max + 1 exact bins; 2 int32 /
// 3 float32 keys with nb coarse bins, bin = floor((x - lo) * scale) clamped;
// W warps a chain (1: four chains a block); neigh [N, K] (PSpin3: A [N,
// K/2, 2] read as [N, K]); J [N, K] (none for PSpin3)
extern "C" int rrrmc_eo_sparse(
    int8_t* sigma, void* lf, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const int32_t* neigh, const void* J, const float* cdf,
    int N, int K, int B, int n_moves, uint32_t seed, uint32_t move0,
    uint32_t chain0, int key, int pspin, int nb, float lo, float scale, int W,
    void* stream) {
  const Kern k = kernel_of(key, pspin, W);
  if (k == nullptr || nb <= 0 || (key < 2 && nb > rrrmc::kEoHistMax))
    return (int)cudaErrorInvalidValue;
  const Layout l = eo_layout(N, kKeyBytes[key], nb, W, key >= 2);
  const size_t smem = (size_t)chains_of(W) * l.chain;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const EoArgs a{sigma, lf, E, emin, smin, itmin, neigh, J, cdf, N, K, B,
                 n_moves, nb, seed, move0, chain0, lo, scale, l};
  const int grid = (B + chains_of(W) - 1) / chains_of(W);
  k<<<grid, threads_of(W), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
