// Rejection-free race kernel (bkl / wtm / rrr) on the replica composites,
// GraphQuant (the Trotter ring) and GraphRobustEnsemble (the star), over a
// dense (FullyConnected) or a sparse (Pairwise) base; one thread block of
// T = 256 or 512 threads per chain (the wrapper picks T). Replaces
// rrrmc_tpu/ops/quant_pallas.py::_ring_rejfree_kernel (dense base) and
// ::_sparse_comp_kernel (sparse base). The wrapper and the plain torch
// version are rrrmc_tpu_torch/ops/replica.py; the fused pass and the move
// loop are race.cuh's, the kernel template replica_race.cuh's (the ring's
// instantiations are compiled here, the star's in rejfree_replica_star.cu).
//
// The composite has N = Nk * M spins, replica-major (spin (i, k) is
// j = i + k * Nk). The physical cost of flipping j is
//   ring  dE_j = 2 s_j (sb * lf_j + c4 (s_{i,k-1} + s_{i,k+1}))
//   star  dE_j = 2 s_j (sb * lf_j) + s_j fk[(mu_i - s_j + M - 1) >> 1]
// with lf the BASE local fields of each replica (integer for an integer
// base, exact; f32 for a float one), sb = base scale * replica weight, c4 =
// fourK/4 and mu_i = sum_k s_{i,k}. The TPU kernels recomputed lf every
// move (M matmuls, or composite-indexed inverse columns) because Mosaic has
// no gather. Here a chain's spins (int8), base fields and, for the star, mu
// (int32) stay resident in dynamic shared memory for the whole chunk, the
// base fields (and their rrr copy) in the narrowest type that holds every
// value they can take (int8, int16 or int32, as the wrapper bounds them from
// the base's couplings; f32 for a float base). Per move (race.cuh's
// race_moves):
//   pass    one fused pass over the N sites: each thread walks its sites
//           j = t + T r by (k, i), stepping i by T mod Nk and k by T / Nk
//           (no division), and computes the composite dE once per site, in
//           the float32 operations of ops/replica.py::replica_de; from it
//           the score log(-log u) + beta * max(dE, 0), the block argmin
//           (lowest index on ties), min bE and log z; the winner reports its
//           dE and spin through the reduction;
//   flip    of the winner w = (i, k): s_w negated, mu_i moved by d = -2 s_w,
//           and d * J_base[i, :] added to replica block k's fields, over the
//           Nk entries of the dense row (int8 for an integer base, read from
//           global memory, one entry per thread) or the K entries of the
//           sparse row (warp 0 loads them, one lane applies them in order);
//   rrr     the flip is applied tentatively and log z' comes from a second
//           fused pass over the flipped state; it is kept iff
//           log ua < log z - log z', else the saved fields are put back
//           (exact for float fields too);
//   bkl     coordinate += geometric skip + 1; wtm: += exp(min score).
// E (f32 physical) gains the winner's dE. A chain whose coordinate has
// reached `target` makes no move; it only writes its stream rows.
//
// Bound on the H100: the arithmetic of one pass over the N resident sites
// per move (two for rrr): a quarter Philox call, the site's composite dE,
// an exp and a bound on its race score per site, the log pair only where
// the bound says the site can still win, with one or two block barriers
// per pass; a flip touches Nk (dense) or K (sparse) fields. The TPU caps
// (Nk % 128, chains % 128, the composite and star size caps) do not apply:
// shared memory is the only limit (rrrmc_rejfree_replica_smem).
#include <cuda_runtime.h>
#include <cstdint>

#include "replica_race.cuh"

namespace rrrmc {
namespace replica {
template Kern kernel_of<false>(int, int, int);
}  // namespace replica
}  // namespace rrrmc

namespace {

using rrrmc::replica::Args;
using rrrmc::replica::Kern;
constexpr int kWtm = rrrmc::kWtm;

Kern kernel_of(int threads, int field, int star, int wtm) {
  return star ? rrrmc::replica::kernel_of<true>(threads, field, wtm)
              : rrrmc::replica::kernel_of<false>(threads, field, wtm);
}

}  // namespace

// dynamic shared memory of one block: fk [M] and mu [Nk] (star), 4 bytes
// each; the base fields [N] and their rrr copy (K sparse, Nk dense) of
// field_bytes each; the spins [N] int8
extern "C" size_t rrrmc_rejfree_replica_smem(int Nk, int M, int K, int sparse,
                                             int star, int field_bytes) {
  const size_t N = (size_t)Nk * M;
  return 4 * ((size_t)M + (star ? Nk : 0)) +
         (size_t)field_bytes * (N + (sparse ? K : Nk)) + N;
}

// the launch facts of an instantiation at `smem` dynamic bytes (race.cuh's
// kernel_info) into out[5]; cudaErrorInvalidValue if there is none
extern "C" int rrrmc_rejfree_replica_info(int threads, int field, int star,
                                          int wtm, size_t smem, int device,
                                          int* out) {
  const Kern k = kernel_of(threads, field, star, wtm);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, threads, smem, device, out);
}

// field: the resident type's code (f32 with float couplings: f32 fields
// and couplings; else int32 fields in global memory, int8 dense or int32
// sparse couplings). neigh is null for a dense base.
extern "C" int rrrmc_rejfree_replica(
    int8_t* sigma, void* lf, float* E, void* coord, int32_t* acc, float* zacc,
    void* cs, float* es, const void* J, const int32_t* neigh,
    const float* params, int Nk, int M, int K, int B, int n_moves,
    uint32_t seed, uint32_t move0, uint32_t chain0, float beta, int target_i,
    float target_f, int mode, int sparse, int star, int threads, int field,
    void* stream) {
  const Kern k = kernel_of(threads, field, star, mode == kWtm);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = rrrmc_rejfree_replica_smem(
      Nk, M, K, sparse, star, field == 0 ? 1 : field == 1 ? 2 : 4);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{sigma, lf, E, coord, acc, zacc, cs, es, J, neigh, params,
               Nk, M, K, B, n_moves, mode, sparse, seed, move0, chain0, beta,
               target_i, target_f};
  k<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
