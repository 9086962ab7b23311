// BKL on an integer sparse Pairwise model by energy classes, one warp per
// chain (wrapper and plain torch version: rrrmc_tpu_torch/ops/
// rejfree_classes.py). Replaces no TPU kernel: the TPU ran BKL as the race
// of rejfree_sparse.cu, a pass over all N sites a move. This kernel makes a
// move in O(classes + K) work and picks the same law.
//
// A site's Boltzmann exponent is beta2s * h, h = max(s * lf, 0), and with
// int8 resident fields h is an integer in [0, C), C = field bound + 1 <= 128
// (the ±J RRG has h in {0, 1, 3}, an EA lattice in {0, 2, 4, 6}). The
// chain's state stays in shared memory for the launch:
//   half[i] = s_i * lf_i (int8) and s_i (int8), N rounded up to groups of
//           512 sites;
//   cnt[h]  the sites of class h;
//   gcnt[h * ng + g] the sites of class h in group g (ng <= 64 groups).
// That is about 2 bytes a site (21 KB a chain at N = 10^4), so that all
// 1024 chains of the benchmark are resident at once (10 blocks an SM).
// Per move (the 32 lanes run the same steps):
//   classes z = sum_h cnt[h] * ez[h - hmin] over h >= hmin, the least
//           occupied class, in ascending h (ez[k] = expf(0 - beta2s k));
//           z / N = (z / N) * ez[hmin]; the class is drawn with probability
//           cnt[h] ez[h - hmin] / z by the inverse CDF, never an empty one;
//   site    k = floor(u * cnt[c]) (a 32-bit word times cnt, high half): the
//           k-th site of class c in ascending index: the warp scans the
//           class's group counts (two groups a lane), then the 512 halves
//           of that group (16 a lane, byte-wise SIMD compares);
//   flip    the site's spin and half change sign; warp lanes < K load its
//           table row and, where its neighbours are distinct, apply a
//           field change each and move the changed sites between the class
//           and group counts with shared atomics (else lane 0 applies the
//           slots in order: the counts are the same);
//   bkl     E += 2 half, coordinate += geom_skip(u, z / N) + 1, zacc +=
//           z / N, acc += 1; (coordinate, E) stream rows as race_moves
//           writes them. A chain whose coordinate reached the target stops;
//           the warp writes its remaining rows.
// Random words: Philox under key (seed, chain), counter (0, move, DRAW_CLASS,
// 0) (word 0 the class, word 1 the site) and (0, move, DRAW_SKIP, 0), drawn
// 32 moves ahead, a move a lane.
//
// Bound on the H100: the latency of a move's dependent chain (shared-memory
// loads, warp scans, the table row from L2) at a few chains an SM; the
// narrow state puts every chain of a launch on the card at once.
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace {

using rrrmc::kFull;

constexpr int kGroup = 512;       // sites of a group
constexpr int kMaxGroups = 64;    // two a lane
constexpr int kMaxClasses = 128;  // h of int8 fields

struct ClassArgs {
  int8_t* sigma;
  int32_t* lf;
  int32_t* E;
  int32_t* coord;
  int32_t* acc;
  float* zacc;
  int32_t* cs;
  int32_t* es;
  const int32_t* neigh;
  const int32_t* J;
  int N, K, B, n_moves, C;
  uint32_t seed, move0, chain0;
  float beta2s;
  int32_t target;
};

// inclusive warp scan of v
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// bit t set where byte t of the 16 halves has class c (max(half, 0) == c)
__device__ __forceinline__ unsigned class_bits(uint4 v, int c) {
  const unsigned want = (unsigned)c * 0x01010101u;
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned b = __vcmpeq4(__vmaxs4(w[q], 0u), want) & 0x80808080u;
    bits |= (((b >> 7) | (b >> 14) | (b >> 21) | (b >> 28)) & 0xFu) << (4 * q);
  }
  return bits;
}

// moves site i of group g from class a to class b in the counts (lane 0)
__device__ __forceinline__ void recount(int* cnt, int* gcnt, int ng, int g,
                                        int a, int b) {
  if (a == b) return;
  --cnt[a];
  ++cnt[b];
  --gcnt[a * ng + g];
  ++gcnt[b * ng + g];
}

__global__ void __launch_bounds__(32)
    rejfree_sparse_kernel_classes(ClassArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ez[kMaxClasses];
  const int N = a.N, K = a.K, C = a.C, B = a.B;
  const int ng = (N + kGroup - 1) / kGroup, npad = ng * kGroup;
  int8_t* half = reinterpret_cast<int8_t*>(smem);
  int8_t* sig = half + npad;
  int* cnt = reinterpret_cast<int*>(sig + npad);  // [C], then gcnt [C, ng]
  int* gcnt = cnt + C;
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row = (size_t)b * N;

  for (int i = lane; i < npad; i += 32) {
    int8_t s = 1, h = 127;  // a pad follows every site: never selected
    if (i < N) {
      s = a.sigma[row + i];
      h = (int8_t)(s * a.lf[row + i]);
    }
    sig[i] = s;
    half[i] = h;
  }
  for (int h = lane; h < kMaxClasses; h += 32)
    ez[h] = expf(0.0f - a.beta2s * (float)h);
  for (int j = lane; j < C * (ng + 1); j += 32) cnt[j] = 0;
  __syncwarp();
  // a lane counts its groups' classes; then a lane a class sums them
  for (int g = lane; g < ng; g += 32) {
    const int end = min(N, (g + 1) * kGroup);
    for (int i = g * kGroup; i < end; ++i) {
      const int h = half[i] > 0 ? half[i] : 0;
      ++gcnt[h * ng + g];
    }
  }
  __syncwarp();
  for (int h = lane; h < C; h += 32) {
    int n = 0;
    for (int g = 0; g < ng; ++g) n += gcnt[h * ng + g];
    cnt[h] = n;
  }
  __syncwarp();

  int32_t E = a.E[b], coord = a.coord[b], acc = a.acc[b];
  float zacc = a.zacc[b];
  const int32_t target = a.target;
  const uint2 key = make_uint2(a.seed, a.chain0 + (uint32_t)b);
  uint32_t wc = 0u, ws = 0u, wk = 0u;
  int m = 0;
  for (; m < a.n_moves && coord < target; ++m) {
    const int j = m & 31;
    if (j == 0) {  // the words of the next 32 moves, one a lane
      const uint32_t mv = a.move0 + (uint32_t)(m + lane);
      const uint4 x = rrrmc::philox4x32_10(
          make_uint4(0u, mv, rrrmc::DRAW_CLASS, 0u), key);
      wc = x.x;
      ws = x.y;
      wk = rrrmc::philox4x32_10(make_uint4(0u, mv, rrrmc::DRAW_SKIP, 0u),
                                key).x;
    }
    const uint32_t wcls = __shfl_sync(kFull, wc, j);
    const uint32_t wsite = __shfl_sync(kFull, ws, j);
    const uint32_t wskip = __shfl_sync(kFull, wk, j);

    // the class: z over the occupied classes from the least, in ascending h
    int hmin = 0;
    while (cnt[hmin] == 0) ++hmin;
    float zs = 0.0f;
#pragma unroll 4
    for (int h = hmin; h < C; ++h) zs += (float)cnt[h] * ez[h - hmin];
    const float zn = zs / (float)N * ez[hmin];
    const int32_t skip = rrrmc::geom_skip(rrrmc::to_uniform((int32_t)wskip),
                                          zn);
    const float t = rrrmc::to_uniform((int32_t)wcls) * zs;
    float cum = 0.0f;
    int c = hmin;
#pragma unroll 4
    for (int h = hmin; h < C; ++h) {
      const int n = cnt[h];
      if (n > 0 && t >= cum) c = h;
      cum += (float)n * ez[h - hmin];
    }
    int k = (int)__umulhi(wsite, (uint32_t)cnt[c]);

    // the k-th site of class c: its group (lane l holds groups 2l, 2l + 1)
    const int* gc = gcnt + c * ng;
    const int v0 = 2 * lane < ng ? gc[2 * lane] : 0;
    const int v1 = 2 * lane + 1 < ng ? gc[2 * lane + 1] : 0;
    const int inc = warp_scan(v0 + v1, lane);
    const int L = __ffs(__ballot_sync(kFull, inc > k)) - 1;
    k -= __shfl_sync(kFull, inc - v0 - v1, L);
    const int lv0 = __shfl_sync(kFull, v0, L);
    const int g = k < lv0 ? 2 * L : 2 * L + 1;
    if (k >= lv0) k -= lv0;
    // then its place among the group's 512 halves (16 a lane)
    const int base = g * kGroup;
    const unsigned bits = class_bits(
        *reinterpret_cast<const uint4*>(half + base + 16 * lane), c);
    const int nb16 = __popc(bits);
    const int inc2 = warp_scan(nb16, lane);
    const int L2 = __ffs(__ballot_sync(kFull, inc2 > k)) - 1;
    unsigned mb = __shfl_sync(kFull, bits, L2);
    for (int r = k - __shfl_sync(kFull, inc2 - nb16, L2); r > 0; --r)
      mb &= mb - 1u;
    const int i = base + 16 * L2 + __ffs(mb) - 1;

    // the flip: lanes < K load the site's row (issued before lane 0 flips
    // the site); d = -2 s changes each neighbour's field by J d
    int nbl = N, jl = 0;
    if (lane < K) {
      nbl = a.neigh[(size_t)i * K + lane];
      jl = a.J[(size_t)i * K + lane];
    }
    int d = 0;
    if (lane == 0) {
      const int s = sig[i], hf = half[i];
      sig[i] = (int8_t)(-s);
      half[i] = (int8_t)(-hf);
      recount(cnt, gcnt, ng, i / kGroup, hf > 0 ? hf : 0, hf < 0 ? -hf : 0);
      E += 2 * hf;
      d = -2 * s;
    }
    d = __shfl_sync(kFull, d, 0);
    __syncwarp();
    // distinct neighbours (a simple graph's row): a lane each, the counts
    // moved by shared atomics, whose sums do not depend on their order;
    // else lane 0 applies the slots in order
    const unsigned same = __match_any_sync(
        kFull, lane < K && nbl < N ? nbl : -1 - lane);
    if (K <= 32 && __all_sync(kFull, __popc(same) == 1)) {
      if (lane < K && nbl < N) {
        const int ho = half[nbl];
        const int hn = ho + sig[nbl] * jl * d;
        half[nbl] = (int8_t)hn;
        const int ca = ho > 0 ? ho : 0, cb = hn > 0 ? hn : 0;
        if (ca != cb) {
          const int g2 = nbl / kGroup;
          atomicAdd(&cnt[ca], -1);
          atomicAdd(&cnt[cb], 1);
          atomicAdd(&gcnt[ca * ng + g2], -1);
          atomicAdd(&gcnt[cb * ng + g2], 1);
        }
      }
    } else {
      for (int k0 = 0; k0 < K; k0 += 32) {
        if (k0 > 0) {
          nbl = N;
          jl = 0;
          if (k0 + lane < K) {
            nbl = a.neigh[(size_t)i * K + k0 + lane];
            jl = a.J[(size_t)i * K + k0 + lane];
          }
        }
        const int slots = min(32, K - k0);
        for (int q = 0; q < slots; ++q) {
          const int nb = __shfl_sync(kFull, nbl, q);
          const int jv = __shfl_sync(kFull, jl, q);
          if (lane == 0 && nb < N) {
            const int ho = half[nb];
            const int hn = ho + sig[nb] * jv * d;
            half[nb] = (int8_t)hn;
            recount(cnt, gcnt, ng, nb / kGroup, ho > 0 ? ho : 0,
                    hn > 0 ? hn : 0);
          }
        }
      }
    }
    __syncwarp();
    ++acc;
    zacc += zn;
    coord += skip + 1;
    if (lane == 0) {
      a.cs[(size_t)m * B + b] = coord;
      a.es[(size_t)m * B + b] = E;
    }
  }
  E = __shfl_sync(kFull, E, 0);
  for (int r = m + lane; r < a.n_moves; r += 32) {
    a.cs[(size_t)r * B + b] = coord;
    a.es[(size_t)r * B + b] = E;
  }
  for (int i = lane; i < N; i += 32) {
    a.sigma[row + i] = sig[i];
    a.lf[row + i] = (int32_t)sig[i] * (int32_t)half[i];
  }
  if (lane == 0) {
    a.E[b] = E;
    a.coord[b] = coord;
    a.acc[b] = acc;
    a.zacc[b] = zacc;
  }
}

}  // namespace

// dynamic shared memory of one block: halves and spins of the N sites
// rounded up to groups of 512, and the class and group counts
extern "C" size_t rrrmc_rejfree_classes_smem(int N, int C) {
  const size_t ng = (size_t)(N + kGroup - 1) / kGroup;
  return 2 * ng * kGroup + sizeof(int) * (size_t)C * (ng + 1);
}

// the kernel's launch facts at `smem` dynamic bytes (race.cuh's kernel_info)
// into out[5]
extern "C" int rrrmc_rejfree_classes_info(size_t smem, int device, int* out) {
  const void* k = (const void*)rejfree_sparse_kernel_classes;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return rrrmc::kernel_info(k, 32, smem, device, out);
}

// lf, E: int32; coord: int32 (bkl); C classes (field bound + 1 <= 128), N at
// most 64 groups of 512 sites
extern "C" int rrrmc_rejfree_classes(
    int8_t* sigma, int32_t* lf, int32_t* E, int32_t* coord, int32_t* acc,
    float* zacc, int32_t* cs, int32_t* es, const int32_t* neigh,
    const int32_t* J, int N, int K, int B, int n_moves, int C, uint32_t seed,
    uint32_t move0, uint32_t chain0, float beta2s, int target, void* stream) {
  if (C < 1 || C > kMaxClasses || N < 1 ||
      (N + kGroup - 1) / kGroup > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const void* k = (const void*)rejfree_sparse_kernel_classes;
  const size_t smem = rrrmc_rejfree_classes_smem(N, C);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const ClassArgs args{sigma, lf, E, coord, acc, zacc, cs, es, neigh, J,
                       N, K, B, n_moves, C, seed, move0, chain0, beta2s,
                       target};
  rejfree_sparse_kernel_classes<<<B, 32, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
