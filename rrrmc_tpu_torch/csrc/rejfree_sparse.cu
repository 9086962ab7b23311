// Rejection-free race kernel (bkl / wtm / rrr) on a sparse Pairwise model,
// one thread block of T = 256 or 512 threads per chain (the wrapper
// picks T from the chains and the blocks that fit on an SM). Replaces
// rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_sparse_kernel and, for integer
// EA lattices (a LatticeEA is a sparse Pairwise with K = 2D), that file's
// _rejfree_kernel; the wrapper and the plain torch version are
// rrrmc_tpu_torch/ops/rejfree.py.
//
// With pspin set the same kernel is the race on a PSpin3 hypergraph
// (replaces _rejfree_pspin_kernel; wrapper rrrmc_tpu_torch/ops/pspin.py): lf
// holds the cavity sums c (half = s*c as for a pairwise model) and neigh the
// partner table A [N, K', 2] read as rows of width K = 2K', slots 2k and
// 2k+1 being the two partners of triangle k. A flip then adds
// d * s[partner of the partner] to each of the 2K' partners' sums, where the
// pairwise flip adds J * d; nothing else differs.
//
// The chain's spins (int8) and local fields stay resident in dynamic shared
// memory for the whole chunk, the fields in the narrowest type RT that holds
// every value they can take (int8, int16 or int32 for integer couplings, as
// the wrapper bounds them from the tables; f32 for float ones); sigma / lf
// are chain-major [B, N] in global memory (lf int32 or f32), so the load and
// the store are one contiguous row per block. Per move (race.cuh's
// race_moves):
//   pass    one fused pass over the sites: half = s*lf, bE = beta2s *
//           max(half, 0) once per site, the race score log(-log u) + bE
//           with u from the Philox race word of each site, the block argmin
//           (lowest index on ties), min bE and log z; the winner reports its
//           dE = 2 half and its spin through the reduction;
//   flip    the winner's K neighbours are updated through its own row
//           neigh[w*K + k] / J[w*K + k] (padded slots == N are skipped):
//           warp 0 loads the row, one lane applies it in order;
//   rrr     the flip is applied tentatively, log z' comes from a second
//           fused pass (without the race) over the flipped state, and the
//           flip is kept iff log ua < log z - log z'; otherwise the saved
//           fields are put back in reverse order (exact for float lf too);
//   bkl     coordinate += geometric skip (the TPU kernel's _geom_skip) + 1;
//   wtm     coordinate += exp(min score).
// A chain whose coordinate has reached `target` makes no move; it only
// writes its (coordinate, E) stream rows.
//
// Bound on the H100: the arithmetic of one pass over the N resident sites
// per move (two for rrr): a quarter Philox call, the site's bE and z term,
// and a bound on its race score per site, the two IEEE logs only where the
// bound says the site can still win; one or two block barriers per pass.
// The fused pass, the score bound, the narrow fields (more blocks per SM)
// and the block size (512 threads a chain at 128 chains, where 256 left
// most of an SM's warp slots empty) are what the design does about it
// (PERF.md section 6, PR 8, measures each).
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace {

using rrrmc::Pay;
constexpr int kWtm = rrrmc::kWtm;

struct SparseArgs {
  int8_t* sigma;
  void* lf;
  void* E;
  void* coord;
  int32_t* acc;
  float* zacc;
  void* cs;
  void* es;
  const int32_t* neigh;
  const void* J;  // null for pspin
  int N, K, B, n_moves, mode, pspin;
  uint32_t seed, move0, chain0;
  float beta2s;
  int32_t target_i;
  float target_f;
};

// int8 fields: expf(0.0f - beta2s * h) for h = max(s*lf, 0) in [0, 127]
constexpr int kExpTable = 128;

// site i's bE = beta2s * max(s*lf, 0), and e = expf(0.0f - bE) (from `ez`
// for int8 fields); it reports dE = 2 s lf and s
template <typename RT>
struct SparseSite {
  using G = rrrmc::GlobalOf<RT>;
  const int8_t* sig;
  const RT* lf;
  const float* ez;
  float beta2s;
  __device__ __forceinline__ float operator()(int i, Pay& p, float& e) {
    const int8_t s = sig[i];
    const G half = G(s) * G(lf[i]);
    p.a = rrrmc::pay_bits(G(2) * half);
    p.b = s;
    const G h = half > G(0) ? half : G(0);
    const float be = beta2s * (float)h;
    if constexpr (std::is_same<RT, int8_t>::value) e = ez[(int)h];
    else e = expf(0.0f - be);
    return be;
  }
};

// RT: resident fields (int8 / int16 / int32 / f32); CT: coordinate (int32,
// f32 for wtm)
template <int T, typename RT, typename CT>
__global__ void __launch_bounds__(T, 1024 / T)
    rejfree_sparse_kernel(SparseArgs a) {
  using G = rrrmc::GlobalOf<RT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, K = a.K;
  RT* lf = reinterpret_cast<RT*>(smem);
  RT* saved = lf + N;                                  // [K], rrr undo
  int8_t* sig = reinterpret_cast<int8_t*>(saved + K);  // [N]
  __shared__ rrrmc::Fused<T> red;
  constexpr bool kInt8 = std::is_same<RT, int8_t>::value;
  __shared__ float ez[kInt8 ? kExpTable : 1];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N;
  G* lf_g = reinterpret_cast<G*>(a.lf);
  for (int i = tid; i < N; i += T) {
    sig[i] = a.sigma[row + i];
    lf[i] = RT(lf_g[row + i]);
  }
  if (kInt8)
    for (int h = tid; h < kExpTable; h += T)
      ez[h] = expf(0.0f - a.beta2s * (float)h);
  rrrmc::fused_init(red);
  rrrmc::ChainState<CT, G> c{reinterpret_cast<G*>(a.E)[b],
                             reinterpret_cast<CT*>(a.coord)[b], a.acc[b],
                             a.zacc[b]};
  const CT target = a.mode == kWtm ? CT(a.target_f) : CT(a.target_i);
  const int32_t* neigh = a.neigh;
  const G* J = reinterpret_cast<const G*>(a.J);
  const bool pspin = a.pspin != 0;
  __syncthreads();

  // warp 0 flips the winner w (race.cuh's warp_apply): the change of the
  // field at slot k of its row is J * d (pairwise) or d * s_y for the
  // partner y of that slot's partner in its triangle (pspin, slot k ^ 1),
  // d = -2 s_w
  auto flip = [&](int w, int sw, bool rrr) {
    if (tid >= 32) return;
    const G d = G(-2 * sw);
    if (tid == 0) sig[w] = (int8_t)(-sw);
    __syncwarp();
    const int32_t* row_w = neigh + w * K;
    auto slot = [&](int k, int& nb, G& inc) {
      nb = row_w[k];
      inc = pspin ? d * G(sig[row_w[k ^ 1]]) : J[w * K + k] * d;
    };
    rrrmc::warp_apply<RT, G>(K, N, slot, lf, saved, rrr);
  };
  auto undo = [&](int w, int sw) {
    if (tid >= 32) return;
    const int32_t* row_w = neigh + w * K;
    rrrmc::warp_restore(K, N, [&](int k) { return row_w[k]; }, lf, saved);
    if (tid == 0) sig[w] = (int8_t)sw;
  };
  rrrmc::race_moves<T>(c, a.mode, N, a.n_moves, a.B, a.seed,
                       a.chain0 + (uint32_t)b, a.move0, target,
                       reinterpret_cast<CT*>(a.cs), reinterpret_cast<G*>(a.es),
                       SparseSite<RT>{sig, lf, ez, a.beta2s}, flip, undo,
                       red);

  __syncthreads();
  for (int i = tid; i < N; i += T) {
    a.sigma[row + i] = sig[i];
    lf_g[row + i] = G(lf[i]);
  }
  if (rrrmc::is_bookkeeper<T>()) {
    reinterpret_cast<G*>(a.E)[b] = c.E;
    reinterpret_cast<CT*>(a.coord)[b] = c.coord;
    a.acc[b] = c.acc;
    a.zacc[b] = c.zacc;
  }
}

using Kern = void (*)(SparseArgs);

template <int T, typename RT>
Kern by_coord(int wtm) {
  if (wtm) return rejfree_sparse_kernel<T, RT, float>;
  return rejfree_sparse_kernel<T, RT, int32_t>;
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
// 1 int16, 2 int32, 3 f32), wtm's float coordinate or int32; null if none
Kern kernel_of(int threads, int field, int wtm) {
  switch (threads) {
    case 256: return by_field<256>(field, wtm);
    case 512: return by_field<512>(field, wtm);
  }
  return nullptr;
}

}  // namespace

// dynamic shared memory of one block: lf [N] and saved [K] of field_bytes
// each, sigma [N] int8
extern "C" size_t rrrmc_rejfree_sparse_smem(int N, int K, int field_bytes) {
  return (size_t)(N + K) * field_bytes + (size_t)N;
}

// the launch facts of an instantiation at `smem` dynamic bytes (race.cuh's
// kernel_info) into out[5]; cudaErrorInvalidValue if there is none
extern "C" int rrrmc_rejfree_sparse_info(int threads, int field, int wtm,
                                         size_t smem, int device, int* out) {
  const Kern k = kernel_of(threads, field, wtm);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads, smem, device, out);
}

// pspin: neigh = A [N, K/2, 2] read as [N, K] (K = 2 x triangles per spin),
// J null, integer fields
extern "C" int rrrmc_rejfree_sparse(
    int8_t* sigma, void* lf, void* E, void* coord, int32_t* acc, float* zacc,
    void* cs, void* es, const int32_t* neigh, const void* J, int N, int K,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta2s, int target_i, float target_f, int mode, int pspin,
    int threads, int field, void* stream) {
  const Kern k = kernel_of(threads, field, mode == kWtm);
  if (k == nullptr || (pspin && field == 3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rrrmc_rejfree_sparse_smem(
      N, K, field == 0 ? 1 : field == 1 ? 2 : 4);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const SparseArgs a{sigma, lf, E, coord, acc, zacc, cs, es, neigh, J,
                     N, K, B, n_moves, mode, pspin, seed, move0, chain0,
                     beta2s, target_i, target_f};
  k<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
