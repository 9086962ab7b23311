// Rejection-free race kernel (bkl / wtm / rrr) on a FullyConnected model,
// one thread block of T = 256 or 512 threads per chain (the wrapper picks T
// from the chains and the blocks that fit on an SM, ops/rejfree.py's
// fused_plan). Replaces rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_dense_kernel
// (J resident in VMEM) and ::_rejfree_stream_kernel (J streamed from HBM):
// the TPU split them by VMEM size, here J is read from device memory or L2
// in both cases, so one kernel serves every N. The wrapper and the plain
// torch version are rrrmc_tpu_torch/ops/rejfree_dense.py.
//
// The TPU kernels recomputed lf = J sigma every move (one matmul, or one
// streamed pass over J) because Mosaic cannot address a row per lane. Here,
// as in the sparse kernel, the chain's state stays resident in dynamic
// shared memory for the whole chunk: the local fields in the narrowest
// type RT that holds every value they can take (int8, int16 or int32 for
// integer J, as the wrapper bounds them from the family's half_bound; f32
// for float J) and the spins as bits (bit i % 32 of word i / 32 set for +1),
// so that every N the earlier 5-bytes-a-site layout took still fits beside
// the fused pass's scratch. sigma / lf are chain-major [B, N] in global
// memory (int8; lf int32 or f32). A flip adds the winner's row of J,
// d * J[w, :] with d = -2 s_w (J int8 for integer J, f32 for float J):
// O(N) per move. Per move (race.cuh's race_moves):
//   pass    one fused pass over the sites: half = s*lf, bE = beta2s *
//           max(half, 0) once per site (e = exp(-bE) from a table of the
//           bound + 1 terms for int8 and int16 fields), the race score
//           log(-log u) + bE (the two logs only where the score bound lets
//           the site win), the block argmin (lowest index on ties), min bE
//           and log z; the winner reports its dE = 2 half and its spin;
//   flip    every thread adds its part of the winner's row, 16 bytes of J
//           a load (16 int8 or 4 f32 sites) wherever the row is 16-byte
//           aligned, and the winner's spin bit is toggled: the one read of
//           the row a move;
//   rrr     the flip is tentative: the fields it overwrites are saved (in
//           shared memory where they fit beside the state, else in a global
//           scratch row), log z' comes from a second fused pass without the
//           race over the flipped state, and the flip is kept iff log ua <
//           log z - log z'; otherwise the saved fields are put back (exact
//           for float lf too);
//   bkl     coordinate += geometric skip (the TPU kernel's _geom_skip) + 1;
//   wtm     coordinate += exp(min score).
// A chain whose coordinate has reached `target` makes no move; it only
// writes its (coordinate, E) stream rows.
//
// Bound on the H100: the arithmetic of one pass over the N resident sites
// per move (two for rrr: a quarter Philox call, the site's bE and z term
// and the score bound a site, the logs only where the bound says the site
// can win) with one or two block barriers a pass, plus one row of J per
// move from L2 or device memory, N bytes for integer J. The fused pass (one
// walk where a separate race and log-sum-exp took three, five for rrr),
// the tables, the narrow fields, the block size and the one read of the
// winner's row a move are what the design does about it; at N = 1024 (4
// sites a thread) the fixed cost of a move (reductions, barriers, the
// flip's load) sets the pace (PERF.md sections 5 and 6).
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace {

using rrrmc::Pay;
constexpr int kWtm = rrrmc::kWtm;

struct DenseArgs {
  int8_t* sigma;
  void* lf;
  void* E;
  void* coord;
  int32_t* acc;
  float* zacc;
  void* cs;
  void* es;
  const void* J;
  void* scratch;  // rrr's saved fields where not in shared memory
  int N, B, n_moves, mode, saved, tab_n;
  uint32_t seed, move0, chain0;
  float beta2s;
  int32_t target_i;
  float target_f;
};

// the couplings' type beside resident fields RT: f32 for f32 fields, else
// int8
template <typename RT>
using JOf = typename std::conditional<std::is_same<RT, float>::value, float,
                                      int8_t>::type;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// where rrr keeps the fields a tentative flip overwrote: bkl and wtm keep
// none, rrr in shared memory where they fit beside the state, else in a
// global scratch row of align16(N fb) bytes a chain
constexpr int kSavedNone = 0, kSavedShared = 1, kSavedGlobal = 2;

// dynamic shared memory of one block, in bytes from its start: the exp
// table [tab_n] f32 at 0, lf [N] of fb bytes at `lf`, rrr's saved fields
// [N] at `saved` (kSavedShared), the spin bits at `bits`; `total` in all
struct Layout {
  size_t lf, saved, bits, total;
};

__host__ __device__ inline Layout layout(int N, int fb, int saved,
                                         int tab_n) {
  Layout l;
  l.lf = align16((size_t)tab_n * 4);
  l.saved = l.lf + align16((size_t)N * fb);
  l.bits = l.saved + (saved == kSavedShared ? align16((size_t)N * fb) : 0);
  l.total = l.bits + 4 * (size_t)((N + 31) / 32);
  return l;
}

// int8 and int16 fields read e = expf(0.0f - beta2s * h) for h = max(s*lf,
// 0) from a table of the bound + 1 terms (the wrapper keeps int16 fields
// only where it has at most 4096), int32 and f32 fields compute it
template <typename RT>
constexpr bool kTabled =
    std::is_same<RT, int8_t>::value || std::is_same<RT, int16_t>::value;

__device__ __forceinline__ int spin_of(const uint32_t* sb, int i) {
  return (int)((sb[i >> 5] >> (i & 31)) & 1u) * 2 - 1;
}

// site i's bE = beta2s * max(s*lf, 0), and e = expf(0.0f - bE) (from `ez`
// for int8 and int16 fields); it reports dE = 2 s lf and s
template <typename RT>
struct DenseSite {
  using G = rrrmc::GlobalOf<RT>;
  const uint32_t* sb;
  const RT* lf;
  const float* ez;
  float beta2s;
  __device__ __forceinline__ float operator()(int i, Pay& p, float& e) const {
    const int s = spin_of(sb, i);
    const G half = G(s) * G(lf[i]);
    p.a = rrrmc::pay_bits(G(2) * half);
    p.b = s;
    const G h = half > G(0) ? half : G(0);
    const float be = beta2s * (float)h;
    if constexpr (kTabled<RT>) e = ez[(int)h];
    else e = expf(0.0f - be);
    return be;
  }
};

// four int8 fields plus d times four int8 couplings, d = +-2, byte by byte
// with wrap-around: 2 J may wrap, but each sum is a field within the bound
// (|lf| <= 127), exact mod 256
__device__ __forceinline__ uint32_t add_bytes(uint32_t l, uint32_t j,
                                              int32_t d) {
  const uint32_t j2 = __vadd4(j, j);
  return d > 0 ? __vadd4(l, j2) : __vsub4(l, j2);
}

// lf[i] = lf[i] + d * row[i] for the N sites by the block's T threads,
// each field first copied to saved[i] where `saved` is given (rrr's
// tentative flip): 16 bytes of the row a load (V sites) where the row is
// 16-byte aligned, the V fields of those sites (16-byte aligned, as saved)
// read and written as R 16-byte words; the rest one site a load. `saved`
// is in shared or in global memory.
template <int T, typename RT>
__device__ __forceinline__ void add_row(RT* lf, const JOf<RT>* row, int N,
                                        rrrmc::GlobalOf<RT> d, RT* saved) {
  using G = rrrmc::GlobalOf<RT>;
  using JT = JOf<RT>;
  constexpr int V = 16 / sizeof(JT);
  constexpr int R = V * sizeof(RT) / 16;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int nv = N / V;
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    uint4* l4 = reinterpret_cast<uint4*>(lf);
    uint4* s4 = reinterpret_cast<uint4*>(saved);
    for (int k = threadIdx.x; k < nv; k += T) {
      union {
        uint4 u;
        JT v[V];
      } j;
      union {
        uint4 u[R];
        RT v[V];
      } l;
      j.u = r4[k];
#pragma unroll
      for (int q = 0; q < R; ++q) l.u[q] = l4[k * R + q];
      if (saved != nullptr) {
#pragma unroll
        for (int q = 0; q < R; ++q) s4[k * R + q] = l.u[q];
      }
      if constexpr (std::is_same<RT, int8_t>::value) {
        l.u[0] = make_uint4(add_bytes(l.u[0].x, j.u.x, d),
                            add_bytes(l.u[0].y, j.u.y, d),
                            add_bytes(l.u[0].z, j.u.z, d),
                            add_bytes(l.u[0].w, j.u.w, d));
      } else {
#pragma unroll
        for (int b = 0; b < V; ++b) l.v[b] = RT(G(l.v[b]) + d * G(j.v[b]));
      }
#pragma unroll
      for (int q = 0; q < R; ++q) l4[k * R + q] = l.u[q];
    }
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < N; i += T) {
    if (saved != nullptr) saved[i] = lf[i];
    lf[i] = RT(G(lf[i]) + d * G(row[i]));
  }
}

// lf[i] = saved[i] for the N sites (rrr's undo), 16 bytes a copy
template <int T, typename RT>
__device__ __forceinline__ void restore(RT* lf, const RT* saved, int N) {
  constexpr int V = 16 / sizeof(RT);
  const int nv = N / V;
  for (int k = threadIdx.x; k < nv; k += T)
    reinterpret_cast<uint4*>(lf)[k] =
        reinterpret_cast<const uint4*>(saved)[k];
  for (int i = nv * V + threadIdx.x; i < N; i += T) lf[i] = saved[i];
}

// RT: resident fields (int8 / int16 / int32 / f32); CT: coordinate (int32,
// f32 for wtm)
template <int T, typename RT, typename CT>
__global__ void __launch_bounds__(T, 1024 / T)
    rejfree_dense_kernel(DenseArgs a) {
  using G = rrrmc::GlobalOf<RT>;
  using JT = JOf<RT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N;
  const Layout lay = layout(N, sizeof(RT), a.saved, a.tab_n);
  float* ez = reinterpret_cast<float*>(smem);
  RT* lf = reinterpret_cast<RT*>(smem + lay.lf);
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem + lay.bits);
  __shared__ rrrmc::Fused<T> red;

  const int b = blockIdx.x;
  RT* saved = a.saved == kSavedShared
                  ? reinterpret_cast<RT*>(smem + lay.saved)
              : a.saved == kSavedGlobal
                  ? reinterpret_cast<RT*>(
                        static_cast<unsigned char*>(a.scratch) +
                        (size_t)b * align16((size_t)N * sizeof(RT)))
                  : nullptr;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t row = (size_t)b * N;
  G* lf_g = reinterpret_cast<G*>(a.lf);
  for (int i = tid; i < N; i += T) lf[i] = RT(lf_g[row + i]);
  // one warp a word of spin bits
  for (int base = tid - lane; base < N; base += T) {
    const int i = base + lane;
    const uint32_t up =
        __ballot_sync(rrrmc::kFull, i < N && a.sigma[row + i] > 0);
    if (lane == 0) sb[base >> 5] = up;
  }
  for (int h = tid; h < a.tab_n; h += T)
    ez[h] = expf(0.0f - a.beta2s * (float)h);
  rrrmc::fused_init(red);
  rrrmc::ChainState<CT, G> c{reinterpret_cast<G*>(a.E)[b],
                             reinterpret_cast<CT*>(a.coord)[b], a.acc[b],
                             a.zacc[b]};
  const CT target = a.mode == kWtm ? CT(a.target_f) : CT(a.target_i);
  const JT* J = reinterpret_cast<const JT*>(a.J);
  __syncthreads();

  const DenseSite<RT> site{sb, lf, ez, a.beta2s};
  auto toggle = [&](int w) {
    if (tid == 0) sb[w >> 5] ^= 1u << (w & 31);
  };
  // the winner's flip, tentative for rrr (the old fields saved)
  auto flip = [&](int w, int sw, bool rrr) {
    add_row<T>(lf, J + (size_t)w * N, N, G(-2 * sw), rrr ? saved : nullptr);
    toggle(w);
  };
  auto undo = [&](int w, int sw) {
    restore<T>(lf, saved, N);
    toggle(w);
  };
  rrrmc::race_moves<T>(c, a.mode, N, a.n_moves, a.B, a.seed,
                       a.chain0 + (uint32_t)b, a.move0, target,
                       reinterpret_cast<CT*>(a.cs), reinterpret_cast<G*>(a.es),
                       site, flip, undo, red);

  __syncthreads();
  for (int i = tid; i < N; i += T) {
    a.sigma[row + i] = (int8_t)spin_of(sb, i);
    lf_g[row + i] = G(lf[i]);
  }
  if (rrrmc::is_bookkeeper<T>()) {
    reinterpret_cast<G*>(a.E)[b] = c.E;
    reinterpret_cast<CT*>(a.coord)[b] = c.coord;
    a.acc[b] = c.acc;
    a.zacc[b] = c.zacc;
  }
}

using Kern = void (*)(DenseArgs);

template <int T, typename RT>
Kern by_coord(int wtm) {
  if (wtm) return rejfree_dense_kernel<T, RT, float>;
  return rejfree_dense_kernel<T, RT, int32_t>;
}

template <int T>
Kern by_field(int field, int wtm) {
  switch (field) {
    case 0: return by_coord<T, int8_t>(wtm);
    case 1: return by_coord<T, int16_t>(wtm);
    case 2: return by_coord<T, int32_t>(wtm);
    case 3: return by_coord<T, float>(wtm);
  }
  return nullptr;
}

// the instantiation for T threads and resident field code `field` (0 int8,
// 1 int16, 2 int32 with int8 J; 3 f32 with f32 J), wtm's float coordinate
// or int32; null if none
Kern kernel_of(int threads, int field, int wtm) {
  switch (threads) {
    case 256: return by_field<256>(field, wtm);
    case 512: return by_field<512>(field, wtm);
  }
  return nullptr;
}

int field_bytes(int field) { return field == 0 ? 1 : field == 1 ? 2 : 4; }

}  // namespace

// dynamic shared memory of one block: the exp table of tab_n f32 terms, lf
// [N] of field_bytes each, rrr's saved fields where `saved` is kSavedShared
// (1), and the spin bits
extern "C" size_t rrrmc_rejfree_dense_smem(int N, int field_bytes, int saved,
                                           int tab_n) {
  return layout(N, field_bytes, saved, tab_n).total;
}

// the launch facts of an instantiation at `smem` dynamic bytes (race.cuh's
// kernel_info) into out[5]; cudaErrorInvalidValue if there is none
extern "C" int rrrmc_rejfree_dense_info(int threads, int field, int wtm,
                                        size_t smem, int device, int* out) {
  const Kern k = kernel_of(threads, field, wtm);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads, smem, device, out);
}

// field 3: f32 J, lf and E; else int8 J with int32 lf and E in global
// memory. saved: where rrr keeps the fields its tentative flip overwrote
// (kSaved*; kSavedGlobal: in `scratch`, B rows of align16(N field bytes)).
// tab_n: the exp table's terms, the bound on |lf| + 1 (int8 and int16
// fields; 0 for the others).
extern "C" int rrrmc_rejfree_dense(
    int8_t* sigma, void* lf, void* E, void* coord, int32_t* acc, float* zacc,
    void* cs, void* es, const void* J, void* scratch, int N, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0, float beta2s,
    int target_i, float target_f, int mode, int threads, int field,
    int saved, int tab_n, void* stream) {
  const Kern k = kernel_of(threads, field, mode == kWtm);
  if (k == nullptr || (field <= 1) != (tab_n > 0) ||
      (mode == rrrmc::kRrr) == (saved == kSavedNone) ||
      (saved == kSavedGlobal) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(N, field_bytes(field), saved, tab_n).total;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const DenseArgs a{sigma, lf, E, coord, acc, zacc, cs, es, J, scratch,
                    N, B, n_moves, mode, saved, tab_n, seed, move0, chain0,
                    beta2s, target_i, target_f};
  k<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
