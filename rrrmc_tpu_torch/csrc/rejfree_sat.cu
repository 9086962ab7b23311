// Rejection-free race kernel (bkl / wtm / rrr) on random K-SAT, one thread
// block of T = 256 or 512 threads per chain (the wrapper picks T by
// ops/rejfree.py's launch rule). Replaces
// rrrmc_tpu/ops/sat_pallas.py::_rejfree_sat_kernel; the wrapper and the
// plain torch version are rrrmc_tpu_torch/ops/sat.py. The moves are
// race.cuh's `race_moves` (the fused pass); the counts and the incremental
// dE are sat.cuh's.
//
// The chain's spins (int8), per-clause satisfied counts (uint8) and dE
// (the exact energy change of flipping each variable, in 16 bits: sat.cuh's
// DeNarrow, |dE| <= Cmax <= 32767) stay resident in dynamic shared memory
// for the whole chunk: 3 bytes a variable and one a clause (the earlier
// kernel's int32 dE took 5 a variable, so the sizes it took still fit
// beside the fused pass's static scratch), beside the table of
// exp(-beta_s k) for k = 0 .. Cmax. The counts come from the caller's
// [B, Mc] int32 tensor and are written back to it at the end; dE is
// derived from them once per launch. Per move (race_moves):
//   pass    one fused pass over the variables: bE = beta_s * max(dE, 0)
//           (dE itself is the key, so beta_s = beta * scale), e from the
//           table, the race score log(-log u) + bE behind the score bound,
//           the block argmin (lowest index on ties), min bE and log z; the
//           winner reports its dE and spin through the reduction;
//   flip    the counts and dE of the winner's clauses by warp 0 (sat.cuh's
//           sat_flip, a lane per clause slot, so the dependent loads
//           T -> A, L of up to 32 slots overlap; 32-bit shared atomics on
//           dE's halves);
//   rrr     log z' from a second fused pass (without the race) over the
//           flipped state; kept iff log ua < log z - log z', otherwise the
//           same flip is applied again (exact);
//   bkl     coordinate += geometric skip + 1; wtm: += exp(min score).
// Bound on the H100: the fused pass over the N resident variables (a
// quarter Philox call, the site's bE and table term and a bound on its
// score per variable, the two IEEE logs only where the bound says it can
// still win) and a block barrier or two per pass; the flip's two dependent
// global loads (clause, then its variables) bound what is left. The TPU
// kernel recomputed dE over all Cmax slots of every variable each move (no
// gather in Mosaic).
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"
#include "sat.cuh"

namespace {

using rrrmc::Pay;
using rrrmc::SatTables;
constexpr int kWtm = rrrmc::kWtm;

struct NoMove {
  __device__ void operator()(int, int) const {}
};

struct SatArgs {
  int8_t* sigma;
  int32_t* cnt;
  int32_t* E;
  void* coord;
  int32_t* acc;
  float* zacc;
  void* cs;
  int32_t* es;
  SatTables t;
  int B, n_moves, mode;
  uint32_t seed, move0, chain0;
  float beta_s;
  int32_t target_i;
  float target_f;
};

// variable i's bE = beta_s * max(dE, 0) and e = expf(0.0f - bE) from `ez`;
// it reports dE and its spin
struct SatSite {
  rrrmc::DeNarrow dE;
  const int8_t* sig;
  const float* ez;
  float beta_s;
  __device__ __forceinline__ float operator()(int i, Pay& p, float& e) const {
    const int32_t d = dE.get(i);
    p.a = d;
    p.b = sig[i];
    const int32_t h = d > 0 ? d : 0;
    e = ez[h];
    return beta_s * (float)h;
  }
};

// CT: coordinate (int32, f32 for wtm)
template <int T, typename CT>
__global__ void __launch_bounds__(T, 1024 / T)
    rejfree_sat_kernel(SatArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SatTables& t = a.t;
  const int N = t.N, Mc = t.Mc;
  const rrrmc::DeNarrow dE{reinterpret_cast<uint16_t*>(smem)};     // [N]
  float* ez = reinterpret_cast<float*>(smem + rrrmc::bytes16(2 * N));
  int8_t* sig = reinterpret_cast<int8_t*>(ez + rrrmc::bytes16(t.Cmax + 1));
  uint8_t* cnt = reinterpret_cast<uint8_t*>(sig + rrrmc::bytes16(N));
  __shared__ rrrmc::Fused<T> red;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < N; i += T) sig[i] = a.sigma[(size_t)b * N + i];
  for (int c = tid; c < Mc; c += T)
    cnt[c] = (uint8_t)a.cnt[(size_t)b * Mc + c];
  for (int h = tid; h <= t.Cmax; h += T)
    ez[h] = expf(0.0f - a.beta_s * (float)h);
  rrrmc::fused_init(red);
  rrrmc::ChainState<CT, int32_t> c{a.E[b], reinterpret_cast<CT*>(a.coord)[b],
                                   a.acc[b], a.zacc[b]};
  const CT target = a.mode == kWtm ? CT(a.target_f) : CT(a.target_i);
  __syncthreads();
  rrrmc::sat_init_delta<T>(t, sig, cnt, dE);
  __syncthreads();

  // warp 0 flips w from spin sw: sat.cuh's sat_flip with a lane per clause
  // slot, so the dependent loads T -> A, L of up to 32 slots overlap; the
  // undo flips it back
  auto flip_w = [&](int w, int sw) {
    if (tid >= 32) return;
    rrrmc::sat_flip<32>(t, w, sw, sig, cnt, dE, NoMove());
    __syncwarp();
    if (tid == 0) sig[w] = (int8_t)(-sw);
  };
  auto flip = [&](int w, int sw, bool) { flip_w(w, sw); };
  auto undo = [&](int w, int sw) { flip_w(w, -sw); };
  rrrmc::race_moves<T>(c, a.mode, N, a.n_moves, a.B, a.seed,
                       a.chain0 + (uint32_t)b, a.move0, target,
                       reinterpret_cast<CT*>(a.cs), a.es,
                       SatSite{dE, sig, ez, a.beta_s}, flip, undo, red);

  __syncthreads();
  for (int i = tid; i < N; i += T) a.sigma[(size_t)b * N + i] = sig[i];
  for (int k = tid; k < Mc; k += T) a.cnt[(size_t)b * Mc + k] = cnt[k];
  if (rrrmc::is_bookkeeper<T>()) {
    a.E[b] = c.E;
    reinterpret_cast<CT*>(a.coord)[b] = c.coord;
    a.acc[b] = c.acc;
    a.zacc[b] = c.zacc;
  }
}

using Kern = void (*)(SatArgs);

// the instantiation for T threads, wtm's float coordinate or int32; null if
// none
Kern kernel_of(int threads, int wtm) {
  switch (threads) {
    case 256:
      return wtm ? rejfree_sat_kernel<256, float>
                 : rejfree_sat_kernel<256, int32_t>;
    case 512:
      return wtm ? rejfree_sat_kernel<512, float>
                 : rejfree_sat_kernel<512, int32_t>;
  }
  return nullptr;
}

}  // namespace

// dynamic shared memory of one block: dE [N] 16-bit, the exp table
// [Cmax + 1] float, sigma [N] int8 and the counts [Mc] uint8, each rounded
// up to 16 bytes
extern "C" size_t rrrmc_rejfree_sat_smem(int N, int Mc, int Cmax) {
  return rrrmc::bytes16(2 * (size_t)N) + 4 * rrrmc::bytes16(Cmax + 1) +
         rrrmc::bytes16(N) + rrrmc::bytes16(Mc);
}

// the launch facts of an instantiation at `smem` dynamic bytes (race.cuh's
// kernel_info) into out[5]; cudaErrorInvalidValue if there is none
extern "C" int rrrmc_rejfree_sat_info(int threads, int wtm, size_t smem,
                                      int device, int* out) {
  const Kern k = kernel_of(threads, wtm);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads, smem, device, out);
}

// Cmax above 32767 (dE's 16 bits) is refused
extern "C" int rrrmc_rejfree_sat(
    int8_t* sigma, int32_t* cnt, int32_t* E, void* coord, int32_t* acc,
    float* zacc, void* cs, int32_t* es, const int32_t* A, const int32_t* L,
    const int32_t* T, const int32_t* TL, int N, int Mc, int K, int Cmax,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    float beta_s, int target_i, float target_f, int mode, int threads,
    void* stream) {
  const Kern k = kernel_of(threads, mode == kWtm);
  if (k == nullptr || Cmax > rrrmc::kDeNarrowMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rrrmc_rejfree_sat_smem(N, Mc, Cmax);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const SatArgs a{sigma, cnt, E, coord, acc, zacc, cs, es,
                  SatTables{A, L, T, TL, N, Mc, K, Cmax},
                  B, n_moves, mode, seed, move0, chain0, beta_s,
                  target_i, target_f};
  k<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
