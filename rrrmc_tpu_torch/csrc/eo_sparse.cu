// tau-extremal optimisation on a sparse Pairwise model. Replaces
// rrrmc_tpu/ops/eo_pallas.py::_eo_sparse_kernel and, for integer EA lattices
// (to EO a LatticeEA is a sparse Pairwise with K = 2D and its padded
// tables), the lattice branch of that file's _eo_kernel; with PSPIN it is
// tau-EO on a PSpin3 hypergraph (_eo_pspin_kernel). The wrappers, the
// launch plan and the plain torch versions are rrrmc_tpu_torch/ops/eo.py and
// ops/eo_pspin.py; the law is eo.cuh's.
//
// The move loop, the resident state and the launch plan's routes (W = 1, 4,
// 8 or 32 warps a chain; keys sigma_i lf_i resident as int8 / int16 with
// exact bins or int32 / float32 with coarse bins; spins as bits) are
// eo_chain.cuh's; this file gives its flip policy (SparseFlip): the flip by
// the chain's first warp: lanes k < K the winner's K
// neighbours and lane K the winner, at once (neigh / J from global memory);
// a row that lists a site twice, or the winner, takes the winner first and
// then each site's adds in row order from one lane, so fields stay
// bit-equal, float ones too; each changed key moves between bins by shared
// atomics.
//
// Bound on the H100: the tie race's Philox calls, one a group of four sites
// that holds a member of the selected class (about 1 700 a move on
// GraphRRG(10^4) near the EO optimum), and the pass over the resident keys;
// global memory is touched for the winner's table row and, every 32 moves,
// the rank table.
#include <cuda_runtime.h>
#include <cstdint>

#include "eo_chain.cuh"

namespace {

using rrrmc::EoArgs;
using rrrmc::kAll;
using rrrmc::kEoCoarse;
using rrrmc::kEoHist;
using rrrmc::spin_at;

struct SparseTables {
  const int32_t* neigh;  // [N, K] (PSpin3: A [N, K/2, 2] read as [N, K])
  const void* J;         // [N, K] (none for PSpin3)
  int K;
};

// PSPIN: the hypergraph flip
template <bool PSPIN>
struct SparseFlip : rrrmc::HalfKeys {
  using Tables = SparseTables;

  template <class C>
  __device__ static void flip(const C& c, const EoArgs&, const Tables& tab,
                              int w, int32_t v) {
    using KT = typename C::Key;
    using T = rrrmc::eo_energy_t<KT>;
    if (c.cw != 0) return;
    const int N = c.N, K = tab.K, lane = c.lane;
    const uint32_t* sig = c.sig;
    KT* keys = c.keys;
    const KT hw = rrrmc::half_of<KT>(v);
    const int sw = spin_at(sig, w);
    const T d = T(-2 * sw);
    // slot k of the winner's row: its site (N: none) and the add to that
    // site's lf (PSpin3: from the partner's spin before the flip, as the
    // plain version reads it)
    auto slot = [&](int k, int& x, T& add) {
      x = __ldg(tab.neigh + (size_t)w * K + k);
      if (x >= N) return;
      if constexpr (PSPIN)
        add = d * T(spin_at(sig, __ldg(tab.neigh + (size_t)w * K + (k ^ 1))));
      else
        add = __ldg(reinterpret_cast<const T*>(tab.J) + (size_t)w * K + k) * d;
    };
    // lane k takes slot k (K <= 32), its loads issued before the winner's
    // own update
    int x = -1 - lane;  // distinct for the idle lanes
    T add = T(0);
    if (K <= 32 && lane < K) {
      slot(lane, x, add);
      if (x >= N) x = -1 - lane;
    }
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
      if (lane == K) c.flip_spin(w);
      if (site >= 0 && lane <= K) c.put(site, oh, nh);
    } else {
      // the winner first, then its row's sites in slot order
      __syncwarp();
      if (lane == 0) {
        c.flip_spin(w);
        c.put(w, hw, KT(-T(hw)));
      }
      __syncwarp();
      // site x's new lf: its key s * lf is stored and moves bins
      auto store = [&](int x, T x_lf) {
        const int s = spin_at(sig, x);
        const KT oh = keys[x];
        c.put(x, oh, KT(T(s) * x_lf));
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
};

using Kern = void (*)(EoArgs, SparseTables);

template <typename KT, int SEL, bool PSPIN>
Kern by_warps(int W) {
  using P = SparseFlip<PSPIN>;
  switch (W) {
    case 1: return rrrmc::eo_chain_kernel<P, KT, SEL, 1>;
    case 4: return rrrmc::eo_chain_kernel<P, KT, SEL, 4>;
    case 8: return rrrmc::eo_chain_kernel<P, KT, SEL, 8>;
    case 32: return rrrmc::eo_chain_kernel<P, KT, SEL, 32>;
  }
  return nullptr;
}

// key codes: 0 int8, 1 int16 (HIST); 2 int32, 3 float32 (COARSE); PSpin3
// keys are int8 or int16
Kern kernel_of(int key, int pspin, int W) {
  if (pspin)
    return key == 0   ? by_warps<int8_t, kEoHist, true>(W)
           : key == 1 ? by_warps<int16_t, kEoHist, true>(W)
                      : nullptr;
  switch (key) {
    case 0: return by_warps<int8_t, kEoHist, false>(W);
    case 1: return by_warps<int16_t, kEoHist, false>(W);
    case 2: return by_warps<int32_t, kEoCoarse, false>(W);
    case 3: return by_warps<float, kEoCoarse, false>(W);
  }
  return nullptr;
}

constexpr int kKeyBytes[4] = {1, 2, 4, 4};

rrrmc::EoLayout layout_of(int N, int key, int nb, int W) {
  return rrrmc::eo_layout(N, kKeyBytes[key], nb, W, key >= 2, 0);
}

}  // namespace

// dynamic shared memory of one block: eo_chains_of(W) chains' parts
extern "C" size_t rrrmc_eo_sparse_smem(int N, int key, int nb, int W) {
  if (key < 0 || key > 3) return 0;
  return (size_t)rrrmc::eo_chains_of(W) * layout_of(N, key, nb, W).chain;
}

// the launch facts of an instantiation at `smem` dynamic bytes into out[5]
// (blocks per SM, registers, local bytes, static shared bytes, most dynamic
// shared bytes); cudaErrorInvalidValue if there is none
extern "C" int rrrmc_eo_sparse_info(int W, int key, int pspin, size_t smem,
                                    int device, int* out) {
  const Kern k = kernel_of(key, pspin, W);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info((const void*)k, rrrmc::eo_threads_of(W), smem,
                            device, out);
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
  const EoArgs a{sigma, lf, E, emin, smin, itmin, cdf, N, B, n_moves, nb,
                 seed, move0, chain0, lo, scale, layout_of(N, key, nb, W)};
  return rrrmc::eo_chain_launch(k, a, SparseTables{neigh, J, K}, W,
                                (cudaStream_t)stream);
}
