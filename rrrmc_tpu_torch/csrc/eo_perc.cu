// tau-extremal optimisation on the binary perceptrons, one thread block of
// kEoThreads = 256 threads per chain. Replaces
// rrrmc_tpu/ops/perc_pallas.py::_eo_perc_kernel; the wrapper and the plain
// torch version are rrrmc_tpu_torch/ops/eo_perc.py. The law is eo.cuh's,
// with the key policy that ranks by dE itself.
//
// The patterns are read as the race kernel reads them (rejfree_perc.cu):
// +-1, one bit each, xb [W, N] uint32, W = ceil(P / 32), word-major, bit
// a % 32 of xb[a / 32, i] set where xi_ai = +1, in shared memory (64 KB at
// N = 1023, P = 511; SX) or, where they do not fit beside the state, from
// global memory (the wrapper's plan, "shared" or "global"). Resident beside
// them for the whole launch: dE [N] (int32, float32 for xentr), the spins
// and best spins [N] int8, the stabilities Delta [P] int32 (from the
// caller's [B, P] tensor, written back at the end), g's state (step: the
// bit plane [Delta == 1] | [Delta == -1]; linear: [Delta < 2] and
// [Delta < 0]; xentr: g [32 W] float32, zero past P), and the select's
// counters. Per move:
//   dE       every site's, from the bits: step and linear 2 popc(x_i & m) -
//            popc(m) over the planes' words, exact integers; xentr +-g_a in
//            pattern order (the sign from the bit), equal to float(xi_ai)
//            g_a; a thread takes four sites at once. HIST: the same pass
//            counts each dE in its histogram bin (2 P + 1 bins, and 32-bin
//            super-bins; two sets, by move parity, the other one zeroed);
//   select   HIST: every warp scans the histogram alike (eo_group.cuh), and
//            the tie race takes the groups of four dE that hold a member
//            from a warp's queue, one barrier for the warps' minima; else
//            (xentr's float keys, or more than kEoHistMax bins) eo.cuh's
//            block radix select and tie race;
//   flip     Delta += -2 sigma_w xi[:, w], a thread a pattern reading the bit
//            of column w (one word a warp), and g's state rebuilt in the same
//            pass (planes by warp ballots, xentr's g), the warps' partial
//            totals summed in ops/rejfree.py::block_sum's order after the
//            barrier that ends the move;
//   track    E < Emin (strict) copies the spins.
// Bound on the H100: the dE pass (W AND + POPC a plane and a site for step
// and linear, P float adds a site for xentr) and the tie race's Philox calls
// on member groups. The earlier kernel streamed the int8 patterns (N P
// bytes) from L2 for every chain's product at every move, which set its
// pace; the TPU kernel ran the product and the rank-1 stability update on
// its MXU over 128-padded blocks of chains.
#include <cuda_runtime.h>
#include <cstdint>

#include "eo_group.cuh"
#include "perc.cuh"
#include "race.cuh"

namespace {

using rrrmc::kAll;
using rrrmc::kI32Max;
using rrrmc::kTieQueue;
constexpr int kThreads = rrrmc::kEoThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = rrrmc::kPercStep, kLinear = rrrmc::kPercLinear,
              kXentr = rrrmc::kPercXentr;

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// byte offsets of the block's dynamic shared memory
struct Layout {
  uint32_t xb, de, sig, smin, delta, g, hist, sup, queue, slots, parts,
      total;
};

// xb [W N] (sx), dE [N rounded up to 4], the spins and best spins [N],
// Delta [P], g's state (xentr: g [32 W]; else the planes [2 W]), the select's
// counters (HIST: two sets of nb bins and their super-bins; else eo.cuh's
// radix counters), the warps' queues and (score, index) slots, and the
// warps' partial totals (value and plane count)
inline Layout layout(int N, int P, int fam, int nb, bool sx) {
  const size_t W = ((size_t)P + 31) / 32;
  const size_t nsup = nb > 32 ? ((size_t)nb + 31) / 32 : 0;
  Layout l;
  size_t at = 0;
  l.xb = (uint32_t)at;
  if (sx) at += round16(W * N * 4);
  l.de = (uint32_t)at;
  at += round16(((size_t)N + 3) / 4 * 16);
  l.sig = (uint32_t)at;
  at += round16(N);
  l.smin = (uint32_t)at;
  at += round16(N);
  l.delta = (uint32_t)at;
  at += round16((size_t)P * 4);
  l.g = (uint32_t)at;
  at += round16(fam == kXentr ? W * 32 * 4 : W * 2 * 4);
  l.hist = (uint32_t)at;
  at += nb > 0 ? 2 * round16((size_t)nb * 4) : round16(rrrmc::kRadixBins * 4);
  l.sup = (uint32_t)at;
  at += 2 * round16(nsup * 4);
  l.queue = (uint32_t)at;
  at += (size_t)kWarps * kTieQueue * 4;
  l.slots = (uint32_t)at;
  at += round16(kWarps * 16);
  l.parts = (uint32_t)at;
  at += round16(kWarps * 8);
  l.total = (uint32_t)at;
  return l;
}

struct EoPercArgs {
  int8_t* sigma;
  int32_t* delta;
  void* E;
  void* emin;
  int8_t* smin;
  int32_t* itmin;
  const uint32_t* xb;  // [W, N] pattern bits in global memory
  const float* cdf;
  int N, P, W, n_moves, nb;
  uint32_t seed, move0, chain0;
  float c;  // xentr: 2 lam / sqrt(N)
  Layout l;
};

// +-g: g's sign bit flipped where the pattern bit b of nx (the complement
// of the word) is set, i.e. where xi = -1
__device__ __forceinline__ float signed_term(float g, uint32_t nx, int b) {
  return __int_as_float(__float_as_int(g) ^ ((nx << (31 - b)) & 0x80000000u));
}

template <bool SX>
__device__ __forceinline__ uint32_t bits_at(const uint32_t* p) {
  if constexpr (SX) return *p;
  else return __ldg(p);
}

// FAM: step, linear or xentr; HIST: integer keys counted in nb bins, else
// eo.cuh's radix select; SX: the pattern bits resident in shared memory
template <int FAM, bool HIST, bool SX>
__global__ void __launch_bounds__(kThreads, 2) eo_perc_kernel(EoPercArgs a) {
  using T = typename rrrmc::PercType<FAM>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ rrrmc::EoShared red;
  const int N = a.N, P = a.P, W = a.W, nb = a.nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout l = a.l;
  const uint32_t* xb =
      SX ? reinterpret_cast<const uint32_t*>(smem + l.xb) : a.xb;
  T* dE = reinterpret_cast<T*>(smem + l.de);
  int8_t* sig = reinterpret_cast<int8_t*>(smem + l.sig);
  int8_t* smin = reinterpret_cast<int8_t*>(smem + l.smin);
  int32_t* delta = reinterpret_cast<int32_t*>(smem + l.delta);
  float* g = reinterpret_cast<float*>(smem + l.g);         // xentr
  uint32_t* mk = reinterpret_cast<uint32_t*>(smem + l.g);  // step, linear
  int* hist0 = reinterpret_cast<int*>(smem + l.hist);
  int* sup0 = reinterpret_cast<int*>(smem + l.sup);
  const int hstride = (int)(round16((size_t)nb * 4) / 4);
  const int sstride = (int)(round16((size_t)(nb > 32 ? (nb + 31) / 32 : 0) *
                                    4) / 4);
  uint32_t* q = reinterpret_cast<uint32_t*>(smem + l.queue) + warp * kTieQueue;
  int4* slots = reinterpret_cast<int4*>(smem + l.slots);
  T* tpart = reinterpret_cast<T*>(smem + l.parts);
  int32_t* spart = reinterpret_cast<int32_t*>(smem + l.parts) + kWarps;
  const int b = blockIdx.x;
  const uint32_t chain = a.chain0 + (uint32_t)b;
  const size_t row = (size_t)b * N;
  const int np = (N + 3) & ~3, off = (nb - 1) / 2;

  // g's state from the stabilities, with `apply` first Delta += -2 sw xi[:,
  // w] (a thread a pattern, the bit of column w); the warps' partial totals
  // (sum of gm + gp, and the planes' popcount) go to tpart / spart
  auto update = [&](int w, int sw, bool apply) {
    const int32_t step = -2 * sw;
    T tp = T(0);
    int32_t sp = 0;
    for (int a0 = 0; a0 < 32 * W; a0 += kThreads) {
      const int k = a0 + tid;
      const bool in = k < P;
      int32_t dl = 0;
      if (in) {
        dl = delta[k];
        if (apply) {
          const uint32_t word = bits_at<SX>(xb + (size_t)(k >> 5) * N + w);
          dl += ((word >> (k & 31)) & 1u) ? step : -step;
          delta[k] = dl;
        }
      }
      if constexpr (FAM == kXentr) {
        if (in) {
          float gm, gp;
          rrrmc::perc_terms<kXentr>(dl, -a.c, gm, gp);
          g[k] = gm - gp;
          tp += gm + gp;
        } else if (k < 32 * W) {
          g[k] = 0.0f;
        }
      } else {
        const bool p1 = in && (FAM == kStep ? dl == 1 : dl < 2);
        const bool p2 = in && (FAM == kStep ? dl == -1 : dl < 0);
        const uint32_t b1 = __ballot_sync(kAll, p1);
        const uint32_t b2 = __ballot_sync(kAll, p2);
        const int j = (a0 >> 5) + warp;
        if (lane == 0 && j < W) {
          if constexpr (FAM == kStep) {
            mk[j] = b1 | b2;
          } else {
            mk[j] = b1;
            mk[W + j] = b2;
          }
        }
        tp += (int32_t)p1 - (int32_t)p2;
        sp += (int32_t)p1 + (int32_t)p2;
      }
    }
    // the warp's partials in block_sum's order
    for (int o = 16; o > 0; o >>= 1) {
      tp += __shfl_xor_sync(kAll, tp, o);
      sp += __shfl_xor_sync(kAll, sp, o);
    }
    if (lane == 0) {
      tpart[warp] = tp;
      spart[warp] = sp;
    }
  };
  // the totals, after a barrier: the warps' partials in turn
  auto totals = [&](T& tot, int32_t& S) {
    tot = tpart[0];
    S = spart[0];
    for (int k = 1; k < kWarps; ++k) {
      tot += tpart[k];
      S += spart[k];
    }
  };

  // load
  for (int i = tid; i < N; i += kThreads) {
    sig[i] = a.sigma[row + i];
    smin[i] = a.smin[row + i];
  }
  for (int k = tid; k < P; k += kThreads) delta[k] = a.delta[(size_t)b * P + k];
  if constexpr (SX)
    for (int k = tid; k < W * N; k += kThreads)
      reinterpret_cast<uint32_t*>(smem + l.xb)[k] = __ldg(a.xb + k);
  // dE's padding never equals a key
  for (int i = N + tid; i < np; i += kThreads) {
    if constexpr (FAM == kXentr) dE[i] = __int_as_float(0x7fc00000);
    else dE[i] = INT32_MIN;
  }
  if constexpr (HIST) {
    for (int k = tid; k < 2 * hstride; k += kThreads) hist0[k] = 0;
    for (int k = tid; k < 2 * sstride; k += kThreads) sup0[k] = 0;
  }
  T E = reinterpret_cast<const T*>(a.E)[b];
  T emin = reinterpret_cast<const T*>(a.emin)[b];
  int32_t itmin = a.itmin[b];
  __syncthreads();
  update(0, 0, false);
  __syncthreads();
  T tot;
  int32_t S;
  totals(tot, S);

  int rl = 0;
  for (int m = 0; m < a.n_moves; ++m) {
    const uint32_t mv = a.move0 + (uint32_t)m;
    int* hist = hist0 + (m & 1) * hstride;
    int* sup = sup0 + (m & 1) * sstride;
    if constexpr (HIST) {
      // the other set, counted next move, is free
      int* h1 = hist0 + ((m + 1) & 1) * hstride;
      int* s1 = sup0 + ((m + 1) & 1) * sstride;
      for (int k = tid; k < nb; k += kThreads) h1[k] = 0;
      for (int k = tid; k < sstride; k += kThreads) s1[k] = 0;
    }
    // dE of every site, four sites a thread at a time (every thread takes
    // the loop alike: the histogram's adds are merged across the warp)
    for (int i0 = tid; i0 - tid < N; i0 += 4 * kThreads) {
      int site[4];
      T acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        site[u] = min(i0 + u * kThreads, N - 1);
        acc[u] = T(0);
      }
      for (int j = 0; j < W; ++j) {
        uint32_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[u] = bits_at<SX>(xb + (size_t)j * N + site[u]);
        if constexpr (FAM == kXentr) {
          const float4* g4 = reinterpret_cast<const float4*>(g + 32 * j);
#pragma unroll
          for (int qq = 0; qq < 8; ++qq) {
            const float4 gv = g4[qq];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const uint32_t nx = ~x[u];
              acc[u] += signed_term(gv.x, nx, 4 * qq);
              acc[u] += signed_term(gv.y, nx, 4 * qq + 1);
              acc[u] += signed_term(gv.z, nx, 4 * qq + 2);
              acc[u] += signed_term(gv.w, nx, 4 * qq + 3);
            }
          }
        } else {
          const uint32_t m1 = mk[j];
          const uint32_t m2 = FAM == kLinear ? mk[W + j] : 0u;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[u] += __popc(x[u] & m1);
            if constexpr (FAM == kLinear) acc[u] += __popc(x[u] & m2);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        const bool in = i < N;
        T d = T(0);
        if (in) {
          const int8_t sg = sig[i];
          if constexpr (FAM == kXentr) {
            d = (tot + (float)sg * acc[u]) * 0.5f;
          } else {
            d = (tot + sg * (2 * acc[u] - S)) >> 1;
          }
          dE[i] = d;
        }
        if constexpr (HIST) {
          const int bin = min(max((int)d + off, 0), nb - 1);
          rrrmc::hist_add_warp(hist, bin, in);
          if (nb > 32) rrrmc::hist_add_warp(sup, bin >> 5, in);
        }
      }
    }
    if ((m & 31) == 0) rl = rrrmc::rank_of(a.cdf, N, a.seed, chain, mv + lane);
    const int r = __shfl_sync(kAll, rl, m & 31);
    __syncthreads();

    // the winner and its spin
    int w, sw;
    if constexpr (HIST) {
      int bin, before;
      rrrmc::hist2_select(hist, sup, nb, r, bin, before);
      const int32_t v = bin - off;
      int32_t best = kI32Max;
      int win = kI32Max;
      rrrmc::warp_tie(
          np >> 2, warp * 32, kThreads,
          [&](int gi) {
            const int4 d = reinterpret_cast<const int4*>(dE)[gi];
            return (uint32_t)(d.x == v) | ((uint32_t)(d.y == v) << 1) |
                   ((uint32_t)(d.z == v) << 2) | ((uint32_t)(d.w == v) << 3);
          },
          q, a.seed, chain, mv, best, win);
      rrrmc::warp_argmin(best, win);
      // the slot carries the spin: sig[w] may be flipped before a slower
      // thread would read it
      if (lane == 0)
        slots[warp] = make_int4(best, win, win < N ? sig[win] : 0, 0);
      __syncthreads();
      int4 sl = lane < kWarps ? slots[lane] : make_int4(kI32Max, kI32Max, 0, 0);
      best = sl.x;
      win = sl.y;
      rrrmc::warp_argmin(best, win);
      w = win;
      sw = __shfl_sync(kAll, sl.z, __ffs(__ballot_sync(kAll, lane < kWarps &&
                                                       sl.y == win)) - 1);
    } else {
      auto key = [&](int i) { return rrrmc::eo_key(dE[i]); };
      const int32_t v = rrrmc::radix_select(N, r, key, hist0, red);
      w = rrrmc::tie_race(N, v, a.seed, chain, mv, key, red);
      sw = sig[w];
      __syncthreads();  // every thread has read sig[w]
    }
    E += dE[w];

    // the flip
    update(w, sw, true);
    if (tid == 0) sig[w] = (int8_t)(-sw);
    __syncthreads();
    totals(tot, S);
    // strict improvement (E is the same in every thread: a uniform branch)
    if (E < emin) {
      emin = E;
      itmin = (int32_t)(mv + 1u);
      for (int i = tid; i < N; i += kThreads) smin[i] = sig[i];
    }
  }

  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    a.sigma[row + i] = sig[i];
    a.smin[row + i] = smin[i];
  }
  for (int k = tid; k < P; k += kThreads) a.delta[(size_t)b * P + k] = delta[k];
  if (tid == 0) {
    reinterpret_cast<T*>(a.E)[b] = E;
    reinterpret_cast<T*>(a.emin)[b] = emin;
    a.itmin[b] = itmin;
  }
}

using Kern = void (*)(EoPercArgs);

template <int FAM>
Kern by_memory(int hist, int sx) {
  if (hist)
    return sx ? eo_perc_kernel<FAM, true, true> : eo_perc_kernel<FAM, true,
                                                                 false>;
  return sx ? eo_perc_kernel<FAM, false, true> : eo_perc_kernel<FAM, false,
                                                               false>;
}

// the instantiation for family code fam (0 step, 1 linear, 2 xentr), the
// histogram select (hist; not for xentr) or the radix one, and the pattern
// bits in shared (sx = 1) or global memory; null if none
Kern kernel_of(int threads, int fam, int hist, int sx) {
  if (threads != kThreads) return nullptr;
  switch (fam) {
    case kStep: return by_memory<kStep>(hist, sx);
    case kLinear: return by_memory<kLinear>(hist, sx);
    case kXentr:
      if (hist) return nullptr;
      return sx ? eo_perc_kernel<kXentr, false, true>
                : eo_perc_kernel<kXentr, false, false>;
  }
  return nullptr;
}

}  // namespace

// dynamic shared memory of one block (`layout`); nb = 0: the radix select
extern "C" size_t rrrmc_eo_perc_smem(int N, int P, int fam, int nb, int sx) {
  return layout(N, P, fam, nb, sx != 0).total;
}

// the launch facts of an instantiation at `smem` dynamic bytes (race.cuh's
// kernel_info) into out[5]; cudaErrorInvalidValue if there is none
extern "C" int rrrmc_eo_perc_info(int threads, int fam, int hist, int sx,
                                  size_t smem, int device, int* out) {
  const Kern k = kernel_of(threads, fam, hist, sx);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads, smem, device, out);
}

// xb: the pattern bits [ceil(P / 32), N]; fam: 0 step, 1 linear (int32
// keys: nb = 2 P + 1 bins, at most kEoHistMax, or 0 for the radix select), 2
// xentr (float keys: nb = 0); c: xentr's 2 lam / sqrt(N); sx: the bits in
// shared memory
extern "C" int rrrmc_eo_perc(
    int8_t* sigma, int32_t* delta, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const uint32_t* xb, const float* cdf, int N, int P, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0, int nb,
    int fam, float c, int sx, void* stream) {
  const Kern k = kernel_of(kThreads, fam, nb > 0, sx);
  if (k == nullptr || (nb != 0 && (nb < 2 * P + 1 || nb > rrrmc::kEoHistMax)))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(N, P, fam, nb, sx != 0);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.total);
  if (err != cudaSuccess) return (int)err;
  const EoPercArgs a{sigma, delta, E, emin, smin, itmin, xb, cdf, N, P,
                     (P + 31) / 32, n_moves, nb, seed, move0, chain0, c, l};
  k<<<B, kThreads, l.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
