// Device code shared by the race kernels: one block of T = 256 or 512
// threads per chain, its state resident in shared memory. The fused pass
// (`fused_pass`) races the sites and sums the shifted log-sum-exp of their
// Boltzmann terms in one walk; `race_moves` runs a chunk's moves on it.
// They serve rejfree_sparse.cu, rejfree_dense.cu, rejfree_replica.cu,
// rejfree_sat.cu and rejfree_perc.cu. The plain versions
// (rrrmc_tpu_torch/ops/rejfree.py) add in the same order.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "philox.cuh"

namespace rrrmc {

constexpr int kBkl = 0, kWtm = 1, kRrr = 2;

__device__ __forceinline__ int32_t geom_skip(float u2, float p) {
  // the TPU kernel's _geom_skip: floor(log(1-u)/log1p(-p)), capped at 1e9
  const float denom = log1pf(-fminf(p, 0.999999f));
  const float sk = floorf(logf(fmaxf(1.0f - u2, 1e-38f)) / denom);
  const int32_t skip = (int32_t)fminf(sk, 1.0e9f);
  return p >= 1.0f ? 0 : skip;
}

// ---- The fused pass --------------------------------------------------------
//
// One pass over a chain's N resident sites: thread t of the T walks sites
// i = t + T r, r ascending (ops/rejfree.py::block_sum's assignment, so z
// keeps its order of additions), evaluates each
// site's Boltzmann exponent bE once, and takes from it the race score, the
// (score, lowest index) argmin, min bE and the speculative sum of
// exp(0 - bE); one combined block reduction follows. bE >= 0, so when min
// bE is 0 that sum is the plain versions' sum of exp(min bE - bE)
// (ops/rejfree.py::_log_z) bit for bit; when it is not (every flip raises
// E) a second pass sums exp(min bE - bE). The four lanes of a quad hold the
// four sites of one Philox group (site i takes word i % 4 of group i / 4):
// lane j draws the group of row r + j and a 4 x 4 transpose through shared
// memory hands each lane its word, one Philox call per four sites.
// The two IEEE logs of a score are taken only for a site that can still
// win: a lower bound of its score (`fused_init`'s table of the least
// logf(-logf(u)) over each bucket of u, plus bE) is compared with the best
// score its warp has seen, refreshed after the first row and after every
// four rows; a site above it cannot be the block's winner, so the race's
// result is the same, bit for bit.

constexpr unsigned kFull = 0xffffffffu;

// the two 32-bit words the winning site reports beside its score (its dE's
// bits and its spin), so that no thread reads the winner from shared memory
// while the flip writes it
struct Pay {
  int32_t a, b;
};

// per-warp partials of a fused pass
template <int T>
struct Partials {
  static constexpr int kWarps = T / 32;
  float score[kWarps], mbe[kWarps], z[kWarps];
  int32_t idx[kWarps], pa[kWarps], pb[kWarps];
};

// buckets of u in the race's lower bound: the top byte of a race word's
// bits ^ 0x80000000 (u grows with it)
constexpr int kLbBuckets = 256;

// a block's scratch: the race pass and rrr's z' pass each have their
// partials (no barrier parts the z' pass's reads from the next move's race
// pass), z2 the second sum when min bE > 0; lb the bound's table; words
// the quads' race words, four rows of T + 1 (the pad keeps the transpose's
// loads off each other's banks); draw the move's accept or skip bits, drawn
// by one thread during the race pass
template <int T>
struct Fused {
  Partials<T> race, zp;
  float z2[T / 32];
  float lb[kLbBuckets];
  uint32_t words[4 * (T + 1)];
  int32_t draw;
};

// fills f.lb before the block's first barrier: for bucket k, the score less
// bE at the bucket's largest u (to_uniform grows with the bits, and the
// computed logf(-logf(u)) falls as u grows, within a few ulp that the
// margin 1e-5 (1 + |l|) covers); -inf for the top bucket, which holds u = 1
template <int T>
__device__ __forceinline__ void fused_init(Fused<T>& f) {
  for (int k = threadIdx.x; k < kLbBuckets; k += T) {
    const uint32_t top = ((uint32_t)(k + 1) << 24) - 1u;
    const float u = to_uniform((int32_t)(top ^ 0x80000000u));
    const float l = logf(-logf(u));
    f.lb[k] = l - 1.0e-5f * (1.0f + fabsf(l));
  }
}

struct PassOut {
  float best;  // the race's least score
  int win;     // its lowest index
  Pay pay;     // what the winner reported
  float mbe;   // min bE
  float logz;  // log z = log(sum exp(mbe - bE)) - mbe
};

// a 32-bit value as Pay's bits, and back
template <typename G>
__device__ __forceinline__ int32_t pay_bits(G v) {
  if constexpr (std::is_same<G, float>::value) return __float_as_int(v);
  else return (int32_t)v;
}
template <typename G>
__device__ __forceinline__ G pay_value(int32_t bits) {
  if constexpr (std::is_same<G, float>::value) return __int_as_float(bits);
  else return (G)bits;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (score, index) minimum with lane ^ o, lowest index among equal scores
__device__ __forceinline__ void argmin_xor(float& v, int& idx, int o) {
  const float v2 = __shfl_xor_sync(kFull, v, o);
  const int i2 = __shfl_xor_sync(kFull, idx, o);
  if (v2 < v || (v2 == v && i2 < idx)) {
    v = v2;
    idx = i2;
  }
}

// the Pay that lane `src` holds, in every lane
__device__ __forceinline__ Pay pay_of(const Pay& p, int src) {
  return Pay{__shfl_sync(kFull, p.a, src), __shfl_sync(kFull, p.b, src)};
}

// One fused pass of a block of T threads over the N sites. site(i, pay, e)
// returns site i's bE and sets its Pay and e = expf(0.0f - bE) (from a
// table where bE takes few values); it is called for this thread's sites in
// ascending order (on a fresh copy of site0 for each walk over the sites,
// so a site walker may keep its place in members; a lambda serves too).
// RACE: race the sites with the Philox words of move mv; otherwise (rrr's
// z' pass) only min bE and log z. Every thread returns the same `o`. One block barrier, two when min bE > 0; `r` and
// f.z2 may be written again only after a further barrier.
template <int T, bool RACE, typename Site>
__device__ __forceinline__ void fused_pass(int N, uint32_t seed,
                                           uint32_t chain, uint32_t mv,
                                           const Site& site0, Fused<T>& f,
                                           Partials<T>& r, PassOut& o) {
  constexpr int W = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, q = lane & 3;
  // this lane's word of row r0 + j: word q of the quad's lane j
  const uint32_t* words = f.words + q * (T + 1) + (tid & ~3);
  const int rows = (N + T - 1) / T;
  // thr: a score some site of this warp reached, so that no site above it
  // can win the race
  float best = INFINITY, mn = INFINITY, zs = 0.0f, thr = INFINITY;
  int win = 0x7fffffff;
  Pay pay{0, 0};
  Site site = site0;
  for (int r0 = 0; r0 < rows; r0 += 4) {
    if (RACE) {
      // this lane draws the words of its quad's group at row r0 + q
      const uint32_t g = (uint32_t)(tid >> 2) + (uint32_t)(T / 4) *
                                                    (uint32_t)(r0 + q);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (4 * (long long)g < N)
        x = philox4x32_10(make_uint4(g, mv, DRAW_RACE, 0u),
                          make_uint2(seed, chain));
      __syncwarp();  // the warp has read the last rows' words
      f.words[tid] = x.x;
      f.words[(T + 1) + tid] = x.y;
      f.words[2 * (T + 1) + tid] = x.z;
      f.words[3 * (T + 1) + tid] = x.w;
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + T * (r0 + j);
      if (i < N) {
        Pay p;
        float e;
        const float be = site(i, p, e);
        mn = fminf(mn, be);
        zs += e;
        if (RACE) {
          const uint32_t word = words[j];
          if (f.lb[(word >> 24) ^ 0x80u] + be <= thr) {
            const float sc = logf(-logf(to_uniform((int32_t)word))) + be;
            if (sc < best) {
              best = sc;
              win = i;
              pay = p;
            }
          }
        }
      }
      if (RACE && j == 0 && r0 == 0 && rows > 1) thr = warp_min(best);
    }
    if (RACE && r0 + 4 < rows) thr = warp_min(best);
  }
  // within the warp: z in block_sum's order, the others in any; the
  // winner's Pay comes from the lane that raced it (site i's lane is
  // i % 32)
  for (int o2 = 16; o2 > 0; o2 >>= 1) {
    if (RACE) argmin_xor(best, win, o2);
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o2));
    zs += __shfl_xor_sync(kFull, zs, o2);
  }
  if (RACE) pay = pay_of(pay, win & 31);
  if (lane == 0) {
    r.score[w] = best;
    r.idx[w] = win;
    r.pa[w] = pay.a;
    r.pb[w] = pay.b;
    r.mbe[w] = mn;
    r.z[w] = zs;
  }
  __syncthreads();
  // across the warps: lane l takes warp l's partials; z adds the warps in
  // turn, as block_sum does; the Pay comes from the lane of the winner's
  // warp ((i % T) / 32)
  best = INFINITY;
  win = 0x7fffffff;
  mn = INFINITY;
  if (lane < W) {
    best = r.score[lane];
    win = r.idx[lane];
    pay = Pay{r.pa[lane], r.pb[lane]};
    mn = r.mbe[lane];
  }
  for (int o2 = 16; o2 > 0; o2 >>= 1) {
    if (RACE) argmin_xor(best, win, o2);
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o2));
  }
  if (RACE) pay = pay_of(pay, (win & (T - 1)) >> 5);
  float z = r.z[0];
#pragma unroll
  for (int k = 1; k < W; ++k) z += r.z[k];
  if (mn != 0.0f) {
    // every flip raises E: sum exp(mn - bE) as the plain _log_z does
    Site again = site0;
    zs = 0.0f;
    for (int rr = 0; rr < rows; ++rr) {
      const int i = tid + T * rr;
      if (i < N) {
        Pay p;
        float e;
        zs += expf(mn - again(i, p, e));
      }
    }
    for (int o2 = 16; o2 > 0; o2 >>= 1)
      zs += __shfl_xor_sync(kFull, zs, o2);
    if (lane == 0) f.z2[w] = zs;
    __syncthreads();
    z = f.z2[0];
#pragma unroll
    for (int k = 1; k < W; ++k) z += f.z2[k];
  }
  o.best = best;
  o.win = win;
  o.pay = pay;
  o.mbe = mn;
  o.logz = logf(z) - mn;
}

// A flip's K field updates as one thread would make them, by warp 0: lane k
// fetches slot k's neighbour and increment (slot(k, nb, inc); nb >= n for a
// padded slot), so that the table loads overlap, and lane 0 applies them in
// slot order (a neighbour met twice gets both; rrr's saved[k] is the field
// before update k, so `warp_restore` puts them back exactly)
template <typename RT, typename G, typename Slot>
__device__ __forceinline__ void warp_apply(int K, int n, const Slot& slot,
                                           RT* lf, RT* saved, bool rrr) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 32) {
    int nb = n;
    G inc = G(0);
    if (k0 + lane < K) slot(k0 + lane, nb, inc);
    const int m = K - k0 < 32 ? K - k0 : 32;
    for (int j = 0; j < m; ++j) {
      const int nj = __shfl_sync(kFull, nb, j);
      const G ij = __shfl_sync(kFull, inc, j);
      if (lane == 0 && nj < n) {
        if (rrr) saved[k0 + j] = lf[nj];
        lf[nj] = RT(G(lf[nj]) + ij);
      }
    }
  }
}

// warp 0 undoes `warp_apply` in reverse slot order; nb_of(k) is slot k's
// neighbour
template <typename RT, typename NbOf>
__device__ __forceinline__ void warp_restore(int K, int n, const NbOf& nb_of,
                                             RT* lf, const RT* saved) {
  const int lane = threadIdx.x & 31;
  for (int k0 = (K - 1) / 32 * 32; k0 >= 0; k0 -= 32) {
    const int nb = k0 + lane < K ? nb_of(k0 + lane) : n;
    const int m = K - k0 < 32 ? K - k0 : 32;
    for (int j = m - 1; j >= 0; --j) {
      const int nj = __shfl_sync(kFull, nb, j);
      if (lane == 0 && nj < n) lf[nj] = saved[k0 + j];
    }
  }
}

// the per-chain scalars of a race chunk, identical in every thread
template <typename CT, typename G>
struct ChainState {
  G E;
  CT coord;
  int32_t acc;
  float zacc;
};

// the thread of a block that keeps the chain's bookkeeping (`race_moves`):
// the last, which has no more sites than any other and no part in a flip
template <int T>
__device__ __forceinline__ bool is_bookkeeper() {
  return threadIdx.x == T - 1;
}

// n_moves race moves of one chain whose state is resident in shared
// memory, in mode kBkl, kWtm or kRrr: a fused pass races the sites;
// flip(win, s_win, rrr) applies the winner's flip (tentatively for rrr,
// saving what undo(win, s_win) puts back), and a barrier follows; rrr
// recomputes log z' over the flipped state and keeps the flip iff
// log ua < log z - log z'; bkl adds the geometric skip + 1 to the
// coordinate, wtm exp(min score). E gains the winner's dE, which the site
// reported as pay.a (G's bits), its spin as pay.b. A chain whose coordinate
// has reached `target` makes no move. The bookkeeper alone draws the
// move's accept or skip bits during the pass, keeps E, acc and zacc, and
// writes the (coordinate, E) stream rows; for bkl and wtm it also moves the
// coordinate and hands it to the other threads through the flip's barrier
// (for rrr every thread adds the one move itself).
template <int T, typename CT, typename G, typename Site, typename Flip,
          typename Undo>
__device__ __forceinline__ void race_moves(
    ChainState<CT, G>& c, int mode, int N, int n_moves, int B,
    uint32_t seed, uint32_t chain, uint32_t move0, CT target,
    CT* __restrict__ cs, G* __restrict__ es, const Site& site, Flip flip,
    Undo undo, Fused<T>& red) {
  const bool book = is_bookkeeper<T>();
  const bool rrr = mode == kRrr, wtm = mode == kWtm;
  const float log_n = logf((float)N);
  __shared__ CT next_coord;
  for (int m = 0; m < n_moves; ++m) {
    const uint32_t mv = move0 + (uint32_t)m;
    if (c.coord < target) {
      if (!wtm && book)
        red.draw = draw_bits(seed, chain, mv, rrr ? DRAW_ACCEPT : DRAW_SKIP);
      PassOut o;
      fused_pass<T, true>(N, seed, chain, mv, site, red, red.race, o);
      const int32_t draw = red.draw;
      const G dE = pay_value<G>(o.pay.a);
      flip(o.win, o.pay.b, rrr);
      if (book) {
        const float zn = expf(o.logz - log_n);
        c.zacc += zn;
        if (!rrr) {
          c.E += dE;
          ++c.acc;
          c.coord += wtm ? CT(expf(o.best))
                         : CT(geom_skip(to_uniform(draw), zn) + 1);
          next_coord = c.coord;
        }
      }
      __syncthreads();
      if (rrr) {
        PassOut o2;
        fused_pass<T, false>(N, seed, chain, mv, site, red, red.zp, o2);
        if (logf(to_uniform(draw)) < o.logz - o2.logz) {
          if (book) {
            c.E += dE;
            ++c.acc;
          }
        } else {
          undo(o.win, o.pay.b);
          __syncthreads();
        }
        c.coord += CT(1);
      } else {
        c.coord = next_coord;
      }
    }
    if (book) {
      cs[(size_t)m * B + blockIdx.x] = c.coord;
      es[(size_t)m * B + blockIdx.x] = c.E;
    }
  }
}

// the global type of a fused kernel's fields: int32 for a narrow integer
// resident type, float for float
template <typename RT>
using GlobalOf =
    typename std::conditional<std::is_same<RT, float>::value, float,
                              int32_t>::type;

// a fused kernel instantiation's launch facts, into out[5]: blocks per SM
// at `smem` dynamic bytes, registers, local bytes a thread (spills), static
// shared bytes, and the most dynamic shared bytes a block may opt in to.
// Returns a cudaError_t.
inline int kernel_info(const void* kern, int threads, size_t smem, int device,
                       int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kern);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const int dyn_max = optin - (int)at.sharedSizeBytes;
  int blocks = 0;
  if ((long long)smem <= dyn_max) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  out[0] = blocks;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = (int)at.sharedSizeBytes;
  out[4] = dyn_max;
  return 0;
}

}  // namespace rrrmc
