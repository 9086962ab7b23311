// tau-extremal optimisation on random K-SAT. Replaces
// rrrmc_tpu/ops/sat_pallas.py::_eo_sat_kernel; the wrapper, the launch plan
// and the plain torch version are rrrmc_tpu_torch/ops/eo_sat.py. The
// variables are ranked by dE itself, the exact energy change of flipping
// each (the TPU kernel's key, sat_pallas.py:551-578); the counts and the
// incremental dE are sat.cuh's.
//
// The move loop, the resident state and the launch plan's routes are
// eo_chain.cuh's, shared with the sparse EO kernel: W = 1, 4, 8 or 32 warps
// a chain (32 at 128 chains of GraphSAT(10^4, 3, 4.2)); the rank drawn
// ahead, the warp-level select over the 2 Cmax + 1 exact bins of the keys
// and the packed tie race; spins and best spins as bits. The keys are dE
// itself, resident and narrow: biased by 128 in a uint8 where Cmax <= 127
// (sat.cuh's DeByte), else by 32768 in a uint16 (DeNarrow), so the tie race
// compares 16 or 8 of them a 16-byte vector with v's biased word. Beside
// them the per-clause satisfied counts (uint8): a variable takes 1 or 2
// bytes and two bits, a clause one byte (56 KB a chain at N = 10^4,
// alpha = 4.2). The counts come from the caller's [B, Mc] int32 tensor and
// are written back at the end; the keys are derived from them at the start
// (sat_init_delta). This file gives the flip (SatFlip): the winner's Cmax
// clause slots over the lanes of the chain's first warp (sat.cuh's
// sat_flip_at, the dependent loads T -> A, L of 32 slots side by side, a
// clause's K variables and signs loaded together), each
// change of a dE a 32-bit shared atomic on its byte or half, moving its key
// between bins.
//
// Bound on the H100: the tie race's Philox calls (about 180 member groups a
// move at alpha = 4.2) and the pass over the packed keys; the flip's
// O(Cmax K) shared words and its two dependent loads from L2.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "eo_chain.cuh"
#include "sat.cuh"

namespace {

using rrrmc::EoArgs;
using rrrmc::kEoHist;
using rrrmc::SatTables;

// the keys as sat.cuh's dE: biased bytes or halves of 32-bit words
__device__ __forceinline__ rrrmc::DeByte de_keys(uint8_t* k) { return {k}; }
__device__ __forceinline__ rrrmc::DeNarrow de_keys(uint16_t* k) {
  return {k};
}

struct SatFlip {
  using Tables = SatTables;
  static constexpr bool kDerived = true;
  static constexpr bool kSpinAfter = false;

  template <class C>
  __device__ __forceinline__ static void load_key(const C&, const EoArgs&,
                                                  int, int) {}

  // the counts, [Mc] uint8 in the chain's extra bytes
  template <class C>
  __device__ __forceinline__ static void load_extra(const C& c,
                                                    const EoArgs& a,
                                                    const Tables& t) {
    const int32_t* g = reinterpret_cast<const int32_t*>(a.lf)
                       + (size_t)c.b * t.Mc;
    for (int k = c.tid; k < t.Mc; k += C::kT) c.extra[k] = (uint8_t)g[k];
  }

  template <class C>
  __device__ __forceinline__ static void derive(const C& c, const Tables& t) {
    rrrmc::sat_init_delta_at<C::kT>(c.tid, t, rrrmc::BitSpins{c.sig},
                                    c.extra, de_keys(c.keys));
  }

  // dE of a variable of key v: v
  template <typename T, typename KT>
  __device__ __forceinline__ static T de(int32_t v) {
    return T(v);
  }

  template <class C>
  __device__ static void flip(const C& c, const EoArgs&, const Tables& t,
                              int w, int32_t) {
    if (c.cw != 0) return;
    const int sw = rrrmc::spin_at(c.sig, w);
    rrrmc::sat_flip_at<32, true>(
        c.lane, t, w, sw, rrrmc::BitSpins{c.sig}, c.extra, de_keys(c.keys),
        [&](int from, int to) {
          c.move_bins(c.bin_key(from), c.bin_key(to));
        });
    __syncwarp();
    if (c.lane == 0) c.flip_spin(w);
  }

  // the counts back
  template <class C>
  __device__ __forceinline__ static void store(const C& c, const EoArgs& a,
                                               const Tables& t) {
    int32_t* g = reinterpret_cast<int32_t*>(a.lf) + (size_t)c.b * t.Mc;
    for (int k = c.tid; k < t.Mc; k += C::kT) g[k] = c.extra[k];
  }
};

using Kern = void (*)(EoArgs, SatTables);

template <typename KT>
Kern by_warps(int W) {
  switch (W) {
    case 1: return rrrmc::eo_chain_kernel<SatFlip, KT, kEoHist, 1>;
    case 4: return rrrmc::eo_chain_kernel<SatFlip, KT, kEoHist, 4>;
    case 8: return rrrmc::eo_chain_kernel<SatFlip, KT, kEoHist, 8>;
    case 32: return rrrmc::eo_chain_kernel<SatFlip, KT, kEoHist, 32>;
  }
  return nullptr;
}

// key codes: 0 dE biased in a uint8 (Cmax <= 127), 1 in a uint16
Kern kernel_of(int key, int W) {
  return key == 0 ? by_warps<uint8_t>(W)
         : key == 1 ? by_warps<uint16_t>(W) : nullptr;
}

rrrmc::EoLayout layout_of(int N, int Mc, int key, int nb, int W) {
  return rrrmc::eo_layout(N, key + 1, nb, W, false, (size_t)Mc);
}

}  // namespace

// dynamic shared memory of one block: eo_chains_of(W) chains' parts, each
// with its counts [Mc] uint8
extern "C" size_t rrrmc_eo_sat_smem(int N, int Mc, int key, int nb, int W) {
  if (key < 0 || key > 1) return 0;
  return (size_t)rrrmc::eo_chains_of(W) * layout_of(N, Mc, key, nb, W).chain;
}

// the launch facts of an instantiation at `smem` dynamic bytes into out[5]
// (blocks per SM, registers, local bytes, static shared bytes, most dynamic
// shared bytes); cudaErrorInvalidValue if there is none
extern "C" int rrrmc_eo_sat_info(int W, int key, size_t smem, int device,
                                 int* out) {
  const Kern k = kernel_of(key, W);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, rrrmc::eo_threads_of(W), smem,
                            device, out);
}

// key: 0 uint8 / 1 uint16 biased dE keys (Cmax at most 127 / 32767) in nb >=
// 2 Cmax + 1 exact bins, at most kEoHistMax; W warps a chain (1: four chains
// a block)
extern "C" int rrrmc_eo_sat(
    int8_t* sigma, int32_t* cnt, int32_t* E, int32_t* emin, int8_t* smin,
    int32_t* itmin, const int32_t* A, const int32_t* L, const int32_t* T,
    const int32_t* TL, const float* cdf, int N, int Mc, int K, int Cmax,
    int B, int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0,
    int key, int nb, int W, void* stream) {
  const Kern k = kernel_of(key, W);
  if (k == nullptr || nb < 2 * Cmax + 1 || nb > rrrmc::kEoHistMax ||
      Cmax > (key == 0 ? rrrmc::kDeByteMax : rrrmc::kDeNarrowMax))
    return (int)cudaErrorInvalidValue;
  const EoArgs a{sigma, cnt, E, emin, smin, itmin, cdf, N, B, n_moves, nb,
                 seed, move0, chain0, 0.0f, 0.0f,
                 layout_of(N, Mc, key, nb, W)};
  return rrrmc::eo_chain_launch(k, a, SatTables{A, L, T, TL, N, Mc, K, Cmax},
                                W, (cudaStream_t)stream);
}
