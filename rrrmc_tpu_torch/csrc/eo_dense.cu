// tau-extremal optimisation on a FullyConnected model. Replaces the dense
// branch of rrrmc_tpu/ops/eo_pallas.py::_eo_kernel (J resident in VMEM:
// integer N <= 4096, float N <= 2048) and that file's _eo_stream_kernel (J
// streamed from HBM beyond): the TPU split them by VMEM size and recomputed
// lf = J sigma every move, one matmul or one streamed pass over J, because
// Mosaic cannot address a row per lane. Here J is read from device memory or
// L2 at every N, so one kernel serves both. The wrapper, the launch plan and
// the plain torch version are rrrmc_tpu_torch/ops/eo_dense.py.
//
// The move loop, the resident state and the launch plan's routes are
// eo_chain.cuh's, shared with the sparse EO kernel: W = 1, 4, 8 or 32 warps
// a chain (ops/eo.py::eo_plan, at most 40 sites a lane); keys half = sigma
// lf resident in the type the bound on |half| allows (int8 on the densified
// +-J RRG, int16 on SK(1024) +-J, with exact bins; int32 or float32 with
// coarse bins), spins and best spins as bits, lf rebuilt as sigma * half at
// the end; the rank drawn ahead, the warp-level select and the packed tie
// race. This file gives the flip (DenseFlip): every warp of the chain takes
// 16-byte vectors of the winner's row of J, a lane a vector (16 int8
// couplings or 4 float32 ones), issued as soon as the winner is known (four
// a lane in flight, one for int16 keys); an int8 vector that is all zero and
// does not hold the winner is skipped with no shared-memory work (all but
// one to three of the densified RRG's 625 a row). Each site of a vector that
// is not skipped takes lf_i += d J[w, i], d = -2 sigma_w, on lf = sigma_i
// half_i, every site of a float row included (an add of -0.0 or +0.0 can
// turn a -0.0 field into +0.0, as the plain version's lf += d J does), and
// its new key moves between bins by shared atomics; the winner's key is
// -sigma_w (lf_w + d J[w, w]). Every warp reads the winner's spin, so its
// bit flips after the move's barrier (kSpinAfter: eo_chain.cuh flips it).
// int16 keys, all of which move at every move of SK, are updated two to a
// 32-bit word (packed_sites: the keys' vectors read and written whole, +-2 J
// added with SIMD instructions); int8, int32 and float keys site by site.
// Integer J is exact; float J adds one rounding per site and move, the plain
// version's.
//
// Bound on the H100: the winner's row of J at every chain-move, N bytes
// (int8) or 4N (float32) from L2 or, for a J larger than L2 (the densified
// RRG's 100 MB, SKNormal(4096)'s 67 MB), mostly from device memory; the
// tie race's Philox calls and the pass over the packed keys; on SK, whose
// keys all move at every move, the N bin moves.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "eo_chain.cuh"

namespace {

using rrrmc::EoArgs;
using rrrmc::kAll;
using rrrmc::kEoCoarse;
using rrrmc::kEoHist;

// int16 keys are updated in SIMD words (packed_sites): every key of an SK
// row moves; int8 keys (the densified RRG's one to three couplings a row)
// site by site, which holds fewer registers
__host__ __device__ constexpr bool packed_keys(int key_bytes) {
  return key_bytes == 2;
}
// the vectors of J's row a lane has in flight: one for the packed update
// (its registers), four site by site
constexpr int kRowLoadsPacked = 1, kRowLoadsSites = 4;

// word k of a 16-byte vector (k known at compile time)
__device__ __forceinline__ uint32_t word_of(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// coupling j of a 16-byte vector of int8 or float32 couplings
template <typename JT>
__device__ __forceinline__ JT coupling(const uint4& q, int j) {
  if constexpr (std::is_same<JT, float>::value)
    return __uint_as_float(word_of(q, j));
  else
    return (int8_t)(word_of(q, j >> 2) >> (8 * (j & 3)));
}

template <typename JT>
struct DenseTables {
  const JT* J;  // [N, N]
  int aligned;  // every row starts on 16 bytes: 16-byte loads
};

template <typename JT>
struct DenseFlip : rrrmc::HalfKeys {
  using Tables = DenseTables<JT>;
  // every warp of the chain reads the winner's spin in the flip
  static constexpr bool kSpinAfter = true;
  // couplings a 16-byte vector
  static constexpr int kE = 16 / (int)sizeof(JT);

  // vector vi of the row (zeros past the row's end)
  __device__ __forceinline__ static uint4 row_vector(const JT* row, int vi,
                                                     int nv, int N,
                                                     bool aligned) {
    if (vi >= nv) return make_uint4(0u, 0u, 0u, 0u);
    if (aligned) return __ldg(reinterpret_cast<const uint4*>(row) + vi);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int i = vi * kE + j;
      if (i >= N) continue;
      if constexpr (std::is_same<JT, float>::value)
        w[j] = __float_as_uint(__ldg(row + i));
      else
        w[j >> 2] |= (uint32_t)(uint8_t)__ldg(row + i) << (8 * (j & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  // a changed key's move from bin b0 to b1 (ok: the key changed), an
  // atomic pair a moved key. The whole warp calls it: the ablation of
  // scripts/torch_eo_timing.py merges a warp's moves here (MERGED_MOVE).
  template <class C>
  __device__ __forceinline__ static void move(const C& c, bool ok, int b0,
                                              int b1) {
    if (ok) c.move_bins(b0, b1);
  }

  // The 16 sites of vector vi of an int8 row with int8 or int16 keys, in
  // SIMD words: the keys' 16-byte vectors read, each key += sigma_i d J_i
  // (d J_i = +-2 J_i, negated per byte or half where sigma_i d < 0; the
  // sums wrap exactly, the result lying in the key's range), written back;
  // the winner's key is 2 J_ww - half_w; each changed key moves bins.
  template <class C, typename T>
  __device__ __forceinline__ static void packed_sites(const C& c,
                                                      const uint4& q, int vi,
                                                      bool live, int w, T d,
                                                      uint32_t sb) {
    using KT = typename C::Key;
    constexpr bool kByte = sizeof(KT) == 1;
    constexpr int kWords = kByte ? 4 : 8;  // key words of the 16 sites
    const int i0 = vi * 16;
    uint4* kv = reinterpret_cast<uint4*>(c.keys);
    const int k0 = kByte ? vi : 2 * vi;
    const bool hi = !kByte && k0 + 1 < c.nkv;  // past it: sentinels only
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const uint4 a = live ? kv[k0] : z, b = live && hi ? kv[k0 + 1] : z;
    const uint32_t ko[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t kn[8];
    const uint32_t neg = d < T(0) ? 0xffffffffu : 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (kByte) {
        const uint32_t jw = word_of(q, k);
        const uint32_t m =
            ((((sb >> (4 * k)) & 15u) * 0x00204081u) & 0x01010101u) * 0xffu
            ^ neg;
        const uint32_t j2 = __vadd4(jw, jw);
        kn[k] = __vadd4(ko[k], __vsub4(j2 ^ m, m));
      } else {
        uint32_t pw;  // couplings 2k, 2k + 1 sign-extended to 16 bits
        asm("prmt.b32 %0, %1, %2, %3;"
            : "=r"(pw)
            : "r"(word_of(q, k >> 1)), "r"(0u),
              "r"((k & 1) ? 0xB3A2u : 0x9180u));
        const uint32_t m =
            ((((sb >> (2 * k)) & 3u) * 0x00008001u) & 0x00010001u) * 0xffffu
            ^ neg;
        const uint32_t j2 = __vadd2(pw, pw);
        kn[k] = __vadd2(ko[k], __vsub2(j2 ^ m, m));
      }
    }
    auto key_in = [](const uint32_t(&x)[8], int j) -> int {
      return kByte ? (int)(int8_t)(x[j >> 2] >> (8 * (j & 3)))
                   : (int)(int16_t)(x[j >> 1] >> (16 * (j & 1)));
    };
    int wn = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int jj = coupling<int8_t>(q, j);
      const bool is_w = i0 + j == w;
      const int oh = key_in(ko, j);
      const int nh = is_w ? 2 * jj - oh : key_in(kn, j);
      if (is_w) wn = nh;
      move(c, live && (jj != 0 || is_w), c.bin_key(oh), c.bin_key(nh));
    }
    if (live) {
      kv[k0] = make_uint4(kn[0], kn[1], kn[2], kn[3]);
      if (hi) kv[k0 + 1] = make_uint4(kn[4], kn[5], kn[6], kn[7]);
      if (w >= i0 && w < i0 + 16) c.keys[w] = KT(wn);
    }
  }

  // the sites of vector vi: lf += d J[w, :], each changed key moved between
  // bins. The whole warp calls it.
  template <class C, typename T>
  __device__ __forceinline__ static void sites(const C& c, const uint4& q,
                                               int vi, int nv, int w, T d) {
    using KT = typename C::Key;
    const int i0 = vi * kE;
    const bool has_w = w >= i0 && w < i0 + kE;
    const bool live = vi < nv && (std::is_same<JT, float>::value || has_w ||
                                  (q.x | q.y | q.z | q.w) != 0u);
    if (!__any_sync(kAll, live)) return;
    // the vector's kE spins (kE divides 32)
    const uint32_t sb = live ? c.sig[i0 >> 5] >> (i0 & 31) : 0u;
    if constexpr (C::kSel == kEoHist && packed_keys(sizeof(KT))) {
      packed_sites(c, q, vi, live, w, d, sb);
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int i = i0 + j;
        const T jij = T(coupling<JT>(q, j));
        // an integer coupling of 0 changes nothing; a float one can (-0.0)
        const bool ok = live && i < c.N &&
                        (std::is_same<JT, float>::value || jij != T(0) ||
                         i == w);
        const int s = 1 - 2 * (int)((sb >> j) & 1u);
        const KT oh = ok ? c.keys[i] : KT(0);
        const T lf = T(s) * T(oh) + d * jij;
        const KT nh = KT(T(i == w ? -s : s) * lf);
        if (ok) c.keys[i] = nh;
        move(c, ok, c.bin_of(oh), c.bin_of(nh));
      }
    }
  }

  template <class C>
  __device__ static void flip(const C& c, const EoArgs&, const Tables& tab,
                              int w, int32_t) {
    using KT = typename C::Key;
    using T = rrrmc::eo_energy_t<KT>;
    constexpr int kRowLoads =
        C::kSel == kEoHist && packed_keys(sizeof(KT)) ? kRowLoadsPacked
                                                      : kRowLoadsSites;
    const int N = c.N;
    const T d = T(-2 * rrrmc::spin_at(c.sig, w));
    const JT* row = tab.J + (size_t)w * N;
    const int nv = (N + kE - 1) / kE;
    for (int base = c.cw * 32; base < nv; base += kRowLoads * C::kT) {
      uint4 q[kRowLoads];
#pragma unroll
      for (int r = 0; r < kRowLoads; ++r)
        q[r] = row_vector(row, base + r * C::kT + c.lane, nv, N,
                          tab.aligned);
#pragma unroll
      for (int r = 0; r < kRowLoads; ++r)
        sites(c, q[r], base + r * C::kT + c.lane, nv, w, d);
    }
  }
};

template <typename JT>
using Kern = void (*)(EoArgs, DenseTables<JT>);

template <typename KT, int SEL, typename JT>
Kern<JT> by_warps(int W) {
  using P = DenseFlip<JT>;
  switch (W) {
    case 1: return rrrmc::eo_chain_kernel<P, KT, SEL, 1>;
    case 4: return rrrmc::eo_chain_kernel<P, KT, SEL, 4>;
    case 8: return rrrmc::eo_chain_kernel<P, KT, SEL, 8>;
    case 32: return rrrmc::eo_chain_kernel<P, KT, SEL, 32>;
  }
  return nullptr;
}

// key codes (those of eo_sparse.cu): 0 int8, 1 int16 (HIST), 2 int32
// (COARSE), all with int8 J; 3 float32 (COARSE) with float32 J
Kern<int8_t> int_kernel(int key, int W) {
  switch (key) {
    case 0: return by_warps<int8_t, kEoHist, int8_t>(W);
    case 1: return by_warps<int16_t, kEoHist, int8_t>(W);
    case 2: return by_warps<int32_t, kEoCoarse, int8_t>(W);
  }
  return nullptr;
}

Kern<float> float_kernel(int key, int W) {
  return key == 3 ? by_warps<float, kEoCoarse, float>(W) : nullptr;
}

const void* kernel_of(int key, int W) {
  return key == 3 ? (const void*)float_kernel(key, W)
                  : (const void*)int_kernel(key, W);
}

constexpr int kKeyBytes[4] = {1, 2, 4, 4};

rrrmc::EoLayout layout_of(int N, int key, int nb, int W) {
  return rrrmc::eo_layout(N, kKeyBytes[key], nb, W, key >= 2, 0);
}

}  // namespace

// dynamic shared memory of one block: eo_chains_of(W) chains' parts
extern "C" size_t rrrmc_eo_dense_smem(int N, int key, int nb, int W) {
  if (key < 0 || key > 3) return 0;
  return (size_t)rrrmc::eo_chains_of(W) * layout_of(N, key, nb, W).chain;
}

// the launch facts of an instantiation at `smem` dynamic bytes into out[5]
// (blocks per SM, registers, local bytes, static shared bytes, most dynamic
// shared bytes); cudaErrorInvalidValue if there is none
extern "C" int rrrmc_eo_dense_info(int W, int key, size_t smem, int device,
                                   int* out) {
  const void* k = key >= 0 && key <= 3 ? kernel_of(key, W) : nullptr;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info(k, rrrmc::eo_threads_of(W), smem, device, out);
}

// key: 0 int8 / 1 int16 keys with nb = 2 half_max + 1 exact bins; 2 int32
// keys with nb coarse bins (int8 J); 3 float32 keys and J with nb coarse
// bins, bin = floor((x - lo) * scale) clamped; W warps a chain (1: four
// chains a block)
extern "C" int rrrmc_eo_dense(
    int8_t* sigma, void* lf, void* E, void* emin, int8_t* smin,
    int32_t* itmin, const void* J, const float* cdf, int N, int B,
    int n_moves, uint32_t seed, uint32_t move0, uint32_t chain0, int key,
    int nb, float lo, float scale, int W, void* stream) {
  if (key < 0 || key > 3 || kernel_of(key, W) == nullptr || nb <= 0 ||
      (key < 2 && nb > rrrmc::kEoHistMax))
    return (int)cudaErrorInvalidValue;
  const EoArgs a{sigma, lf, E, emin, smin, itmin, cdf, N, B, n_moves, nb,
                 seed, move0, chain0, lo, scale, layout_of(N, key, nb, W)};
  const size_t jb = key == 3 ? 4 : 1;
  const int aligned = (size_t)J % 16 == 0 && ((size_t)N * jb) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (key == 3)
    return rrrmc::eo_chain_launch(
        float_kernel(key, W),
        a, DenseTables<float>{(const float*)J, aligned}, W, st);
  return rrrmc::eo_chain_launch(
      int_kernel(key, W), a, DenseTables<int8_t>{(const int8_t*)J, aligned},
      W, st);
}
