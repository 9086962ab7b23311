// Rejection-free race kernel (bkl / wtm / rrr) on the binary perceptrons
// (step, linear and xentr losses), one thread block of T = 256 or 512
// threads per chain (the wrapper picks T by ops/rejfree.py's launch rule).
// Replaces rrrmc_tpu/ops/perc_pallas.py::_rejfree_perc_kernel; the wrapper
// and the plain torch version are rrrmc_tpu_torch/ops/perc.py. The moves are
// race.cuh's `race_moves` (the fused pass); g's terms are perc.cuh's.
//
// The patterns are +-1, so one bit holds each: xb [W, N] uint32, W =
// ceil(P / 32), word-major, bit a % 32 of xb[a / 32, i] set where xi_ai = +1
// (bits past P are 0), packed once per call by the wrapper. The kernel
// keeps them in shared memory (64 KB at N = 1023, P = 511; SX) or, where
// they do not fit beside the state, reads them from global memory (the
// wrapper's plan, "shared" or "global"). Resident beside them for the whole
// chunk: the spins [N] (int8), the stabilities Delta [P] (int16 for
// N <= 32767, else int32; from the caller's [B, P] int32 tensor, written
// back at the end) and g's state, rebuilt from Delta after every flip:
//   step, linear  g as bit planes over the patterns, by warp ballots (warp w
//                 of a pass over the patterns builds word w): step one plane
//                 [Delta == 1] | [Delta == -1], linear two, [Delta < 2] and
//                 [Delta < 0] (g = their sum); tot = sum_a (gm_a + gp_a) and
//                 S = the planes' total popcount;
//   xentr         g [32 W] float32 (zero past P) and tot, summed in
//                 ops/rejfree.py::block_sum's order.
// dE is no resident array: the fused pass's site computes it. For site i,
// with x_ij = xb[j, i]:
//   step, linear  proj_i = sum over planes m and words j of
//                 2 popc(x_ij & m_j) - popc(m_j) = 2 s_i - S, exact integer
//                 arithmetic (sum_a xi_ai m_a over +-1 patterns);
//                 dE_i = (tot + sigma_i proj_i) >> 1, and e = exp(-beta_s
//                 max(dE_i, 0)) from a table over 0 .. P (|dE| <= P);
//   xentr         proj_i = sum_a (+-g_a), a = 0 .. P - 1 in turn, the sign
//                 flipped by the pattern bit (equal to float(xi_ai) g_a);
//                 dE_i = (tot + sigma_i proj_i) * 0.5f, e by expf.
// Per move (race_moves): one fused pass (bE = beta_s * max(dE, 0), the race
// score behind the score bound, the argmin, min bE and z); the flip
// (Delta += -2 sigma_w xi[:, w], a thread per pattern reading the bit of
// column w, then g's state again; a barrier); rrr's z' from a second fused
// pass over the flipped state, and the same update with the spin reversed
// to undo a rejected flip (exact: integer stabilities); bkl's skip, wtm's
// clock.
// Bound on the H100: the per-site product of the passes (W AND + POPC a
// plane for step and linear, P float adds for xentr) and the pass's race
// arithmetic, with a few block barriers a move. The earlier kernel
// streamed the int8 pattern matrix (N P bytes) from L2 for every chain's
// product, which set its pace; the TPU kernel ran the product and the
// rank-1 stability update on its MXU over 128-padded blocks of chains.
#include <cuda_runtime.h>
#include <cstdint>

#include "perc.cuh"
#include "race.cuh"

// the kernel's dynamic shared memory (`layout`)
extern __shared__ __align__(16) unsigned char perc_smem[];

namespace {

using rrrmc::kFull;
using rrrmc::Pay;
constexpr int kWtm = rrrmc::kWtm;
constexpr int kStep = rrrmc::kPercStep, kLinear = rrrmc::kPercLinear,
              kXentr = rrrmc::kPercXentr;

__host__ __device__ __forceinline__ int words_of(int P) {
  return (P + 31) / 32;
}

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// the stabilities are int16 where |Delta| <= N fits
__host__ __device__ __forceinline__ bool delta16(int N) { return N <= 32767; }

// the words of the bit planes in shared memory, whose end the exp table
// follows
__host__ __device__ __forceinline__ int plane_words(int W) {
  return (2 * W + 3) & ~3;
}

// byte offsets of a block's dynamic shared memory: the pattern bits (sx),
// xentr's g [32 W], the bit planes [2 W], the exp table [n_ez], the
// stabilities [P], the spins [N]; each rounded up to 16 bytes
struct Layout {
  uint32_t xb, g, mk, ez, delta, sig, total;
};

inline Layout layout(int N, int P, int fam, int n_ez, bool sx) {
  const size_t W = (size_t)words_of(P);
  size_t o[7];
  size_t at = 0;
  o[0] = at;
  if (sx) at += round16(W * N * 4);
  o[1] = at;
  if (fam == kXentr) at += round16(W * 32 * 4);
  o[2] = at;
  if (fam != kXentr) at += (size_t)plane_words((int)W) * 4;
  o[3] = at;
  at += round16((size_t)n_ez * 4);
  o[4] = at;
  at += round16((size_t)P * (delta16(N) ? 2 : 4));
  o[5] = at;
  at += round16((size_t)N);
  o[6] = at;
  return Layout{(uint32_t)o[0], (uint32_t)o[1], (uint32_t)o[2],
                (uint32_t)o[3], (uint32_t)o[4], (uint32_t)o[5],
                (uint32_t)o[6]};
}

// The kernel's arguments. Everything the moves read is here or derived
// from here in place (kernel arguments live in the constant bank), so that
// no pointer stays in a register across a move.
struct PercArgs {
  int8_t* sigma;
  int32_t* delta;
  void* E;
  void* coord;
  int32_t* acc;
  float* zacc;
  void* cs;
  void* es;
  const uint32_t* xb;  // [W, N] pattern bits in global memory
  int N, P, W, B, n_moves, mode, n_ez;
  uint32_t seed, move0, chain0;
  float beta_s, c;
  int32_t target_i;
  float target_f;
  Layout l;
};

// the dynamic shared memory at byte offset `off`, as U
template <typename U>
__device__ __forceinline__ U* smem_at(uint32_t off) {
  return reinterpret_cast<U*>(perc_smem + off);
}

// the pattern bits: shared (SX) or global memory
template <bool SX>
__device__ __forceinline__ const uint32_t* bits(const PercArgs& a) {
  if constexpr (SX) return smem_at<const uint32_t>(a.l.xb);
  else return a.xb;
}

template <bool SX>
__device__ __forceinline__ uint32_t bits_at(const uint32_t* p) {
  if constexpr (SX) return *p;
  else return __ldg(p);
}

// the per-warp partials of tot (and S), the block's totals, and the count
// of warps whose partials are written
template <int T, typename G>
struct Totals {
  G part[T / 32];
  int32_t spart[T / 32];
  G tot;
  int32_t S;
  int32_t done;
};

// The update of g's state by the whole block: with `apply`, first Delta +=
// -2 sw xi[:, w] (thread per pattern a = a0 + tid, the bit of column w);
// then the bit planes by ballot (step, linear) or g (xentr), and the totals:
// each warp writes its partials, and the last warp to arrive adds them in
// turn (xentr in block_sum's order) into tt.tot and tt.S. Every thread
// must call it; the caller synchronises before reading what it wrote.
template <int FAM, int T, bool SX, typename G>
__device__ __forceinline__ void perc_update(const PercArgs& a,
                                            Totals<T, G>& tt, int w, int sw,
                                            bool apply) {
  constexpr int kWarps = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, P = a.P;
  const bool small = delta16(N);
  int16_t* d16 = smem_at<int16_t>(a.l.delta);
  int32_t* d32 = smem_at<int32_t>(a.l.delta);
  const int32_t step = -2 * sw;
  G tpart = G(0);
  int32_t spart = 0;
  for (int a0 = 0; a0 < P; a0 += T) {
    const int k = a0 + tid;
    const bool in = k < P;
    int32_t dl = 0;
    if (in) {
      dl = small ? (int32_t)d16[k] : d32[k];
      if (apply) {
        const uint32_t word = bits_at<SX>(bits<SX>(a) + (k >> 5) * N + w);
        dl += ((word >> (k & 31)) & 1u) ? step : -step;
        if (small) d16[k] = (int16_t)dl;
        else d32[k] = dl;
      }
    }
    if constexpr (FAM == kXentr) {
      if (in) {
        float gm, gp;
        rrrmc::perc_terms<kXentr>(dl, -a.c, gm, gp);
        smem_at<float>(a.l.g)[k] = gm - gp;
        tpart += gm + gp;
      }
    } else {
      const bool p1 = in && (FAM == kStep ? dl == 1 : dl < 2);
      const bool p2 = in && (FAM == kStep ? dl == -1 : dl < 0);
      const uint32_t b1 = __ballot_sync(kFull, p1);
      const uint32_t b2 = __ballot_sync(kFull, p2);
      if (lane == 0 && a0 + 32 * warp < P) {
        uint32_t* mk = smem_at<uint32_t>(a.l.mk);
        const int j = (a0 >> 5) + warp;
        if constexpr (FAM == kStep) {
          mk[j] = b1 | b2;
        } else {
          mk[j] = b1;
          mk[a.W + j] = b2;
        }
      }
      tpart += (int32_t)p1 - (int32_t)p2;
      spart += (int32_t)p1 + (int32_t)p2;
    }
  }
  // within the warp: xentr in block_sum's order
  for (int o = 16; o > 0; o >>= 1) {
    tpart += __shfl_xor_sync(kFull, tpart, o);
    if constexpr (FAM != kXentr) spart += __shfl_xor_sync(kFull, spart, o);
  }
  if (lane == 0) {
    tt.part[warp] = tpart;
    tt.spart[warp] = spart;
    __threadfence_block();
    if (atomicAdd(&tt.done, 1) == kWarps - 1) {
      __threadfence_block();
      G t = tt.part[0];
      int32_t s = tt.spart[0];
      for (int k = 1; k < kWarps; ++k) {
        t += tt.part[k];
        s += tt.spart[k];
      }
      tt.tot = t;
      tt.S = s;
      tt.done = 0;
    }
  }
}

// +-g: g's sign bit flipped where the pattern bit b of nx (the complement
// of the word) is set, i.e. where xi = -1
__device__ __forceinline__ float signed_term(float g, uint32_t nx, int b) {
  return __int_as_float(__float_as_int(g) ^ ((nx << (31 - b)) & 0x80000000u));
}

// FAM: step, linear or xentr; CT: coordinate (int32, f32 for wtm); SX: the
// pattern bits resident in shared memory
template <int T, int FAM, typename CT, bool SX>
__global__ void __launch_bounds__(T, 1024 / T)
    rejfree_perc_kernel(PercArgs a) {
  using G = typename rrrmc::PercType<FAM>::T;
  const int N = a.N, P = a.P, W = a.W;
  int8_t* sig = smem_at<int8_t>(a.l.sig);
  const bool small = delta16(N);
  __shared__ rrrmc::Fused<T> red;
  __shared__ Totals<T, G> tt;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < N; i += T) sig[i] = a.sigma[(size_t)b * N + i];
  for (int k = tid; k < P; k += T) {
    const int32_t d = a.delta[(size_t)b * P + k];
    if (small) smem_at<int16_t>(a.l.delta)[k] = (int16_t)d;
    else smem_at<int32_t>(a.l.delta)[k] = d;
  }
  if constexpr (SX)
    for (int k = tid; k < W * N; k += T)
      smem_at<uint32_t>(a.l.xb)[k] = __ldg(a.xb + k);
  if constexpr (FAM == kXentr)
    for (int k = P + tid; k < 32 * W; k += T) smem_at<float>(a.l.g)[k] = 0.0f;
  for (int h = tid; h < a.n_ez; h += T)
    smem_at<float>(a.l.ez)[h] = expf(0.0f - a.beta_s * (float)h);
  if (tid == 0) tt.done = 0;
  rrrmc::fused_init(red);
  rrrmc::ChainState<CT, G> c{reinterpret_cast<G*>(a.E)[b],
                             reinterpret_cast<CT*>(a.coord)[b], a.acc[b],
                             a.zacc[b]};
  const CT target = a.mode == kWtm ? CT(a.target_f) : CT(a.target_i);
  __syncthreads();
  perc_update<FAM, T, SX>(a, tt, 0, 0, false);
  __syncthreads();

  // site i's dE from the bit planes and the totals (step, linear) or from
  // g in pattern order (xentr); see the head of the file
  auto site = [&](int i, Pay& p, float& e) -> float {
    const int8_t sg = smem_at<const int8_t>(a.l.sig)[i];
    const uint32_t* xp = bits<SX>(a) + i;
    if constexpr (FAM == kXentr) {
      const float* g = smem_at<const float>(a.l.g);
      float acc = 0.0f;
      for (int j = 0; j < a.W; ++j, xp += a.N) {
        const uint32_t nx = ~bits_at<SX>(xp);
        const float4* g4 = reinterpret_cast<const float4*>(g + 32 * j);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = g4[q];
          acc += signed_term(v.x, nx, 4 * q);
          acc += signed_term(v.y, nx, 4 * q + 1);
          acc += signed_term(v.z, nx, 4 * q + 2);
          acc += signed_term(v.w, nx, 4 * q + 3);
        }
      }
      const float d = (tt.tot + (float)sg * acc) * 0.5f;
      p.a = __float_as_int(d);
      p.b = sg;
      const float be = a.beta_s * (d > 0.0f ? d : 0.0f);
      e = expf(0.0f - be);
      return be;
    } else {
      const uint32_t* mk = smem_at<const uint32_t>(a.l.mk);
      int32_t s = 0;
      for (int j = 0; j < a.W; ++j, xp += a.N) {
        const uint32_t x = bits_at<SX>(xp);
        s += __popc(x & mk[j]);
        if constexpr (FAM == kLinear) s += __popc(x & mk[a.W + j]);
      }
      const int32_t d = (tt.tot + sg * (2 * s - tt.S)) >> 1;
      p.a = d;
      p.b = sg;
      const int32_t h = d > 0 ? d : 0;
      e = smem_at<const float>(a.l.ez)[h];
      return a.beta_s * (float)h;
    }
  };
  auto flip = [&](int w, int sw, bool) {
    perc_update<FAM, T, SX>(a, tt, w, sw, true);
    if (tid == 0) sig[w] = (int8_t)(-sw);
  };
  auto undo = [&](int w, int sw) {
    perc_update<FAM, T, SX>(a, tt, w, -sw, true);
    if (tid == 0) sig[w] = (int8_t)sw;
  };
  rrrmc::race_moves<T>(c, a.mode, N, a.n_moves, a.B, a.seed,
                       a.chain0 + (uint32_t)b, a.move0, target,
                       reinterpret_cast<CT*>(a.cs), reinterpret_cast<G*>(a.es),
                       site, flip, undo, red);

  __syncthreads();
  for (int i = tid; i < N; i += T) a.sigma[(size_t)b * N + i] = sig[i];
  for (int k = tid; k < P; k += T)
    a.delta[(size_t)b * P + k] =
        small ? (int32_t)smem_at<int16_t>(a.l.delta)[k]
              : smem_at<int32_t>(a.l.delta)[k];
  if (rrrmc::is_bookkeeper<T>()) {
    reinterpret_cast<G*>(a.E)[b] = c.E;
    reinterpret_cast<CT*>(a.coord)[b] = c.coord;
    a.acc[b] = c.acc;
    a.zacc[b] = c.zacc;
  }
}

using Kern = void (*)(PercArgs);

template <int T, int FAM>
Kern by_coord(int wtm, int sx) {
  if (sx)
    return wtm ? rejfree_perc_kernel<T, FAM, float, true>
               : rejfree_perc_kernel<T, FAM, int32_t, true>;
  return wtm ? rejfree_perc_kernel<T, FAM, float, false>
             : rejfree_perc_kernel<T, FAM, int32_t, false>;
}

template <int T>
Kern by_fam(int fam, int wtm, int sx) {
  switch (fam) {
    case kStep: return by_coord<T, kStep>(wtm, sx);
    case kLinear: return by_coord<T, kLinear>(wtm, sx);
    case kXentr: return by_coord<T, kXentr>(wtm, sx);
  }
  return nullptr;
}

// the instantiation for T threads, family code fam (0 step, 1 linear, 2
// xentr), wtm's float coordinate or int32, and the pattern bits in shared
// (sx = 1) or global memory; null if none
Kern kernel_of(int threads, int fam, int wtm, int sx) {
  switch (threads) {
    case 256: return by_fam<256>(fam, wtm, sx);
    case 512: return by_fam<512>(fam, wtm, sx);
  }
  return nullptr;
}

}  // namespace

// dynamic shared memory of one block (`layout`)
extern "C" size_t rrrmc_rejfree_perc_smem(int N, int P, int fam, int n_ez,
                                          int sx) {
  return layout(N, P, fam, n_ez, sx != 0).total;
}

// the launch facts of an instantiation at `smem` dynamic bytes (race.cuh's
// kernel_info) into out[5]; cudaErrorInvalidValue if there is none
extern "C" int rrrmc_rejfree_perc_info(int threads, int fam, int wtm, int sx,
                                       size_t smem, int device, int* out) {
  const Kern k = kernel_of(threads, fam, wtm, sx);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads, smem, device, out);
}

// xb: the pattern bits [ceil(P / 32), N]; n_ez: the exp table's entries (P
// + 1 or more for step and linear, unused for xentr); c: xentr's 2 lam /
// sqrt(N)
extern "C" int rrrmc_rejfree_perc(
    int8_t* sigma, int32_t* delta, void* E, void* coord, int32_t* acc,
    float* zacc, void* cs, void* es, const uint32_t* xb, int N, int P, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta_s, int target_i, float target_f, int mode, int fam, float c,
    int n_ez, int threads, int sx, void* stream) {
  const Kern k = kernel_of(threads, fam, mode == kWtm, sx);
  if (k == nullptr || (fam != kXentr && n_ez < P + 1))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(N, P, fam, n_ez, sx != 0);
  const size_t smem = l.total;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const PercArgs a{sigma, delta, E, coord, acc, zacc, cs, es, xb,
                   N, P, words_of(P), B, n_moves, mode, n_ez, seed, move0,
                   chain0, beta_s, c, target_i, target_f, l};
  k<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
