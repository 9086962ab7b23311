// Checkerboard Metropolis sweeps on an even-L integer LatticeEA of any D.
// Replaces rrrmc_tpu/ops/sweep_pallas.py::_sweep_kernel; the wrapper,
// its launch plan and the plain torch version are
// rrrmc_tpu_torch/ops/sweep.py.
//
// What bounds it: operations. Per attempted flip a quarter of a Philox
// call, the 2D neighbour products, the threshold and the compare; memory
// traffic is one read and one write of sigma a launch. The design spends
// little else on a flip:
//
// * The chains of a block in step. A block runs C chains (the plan's C, a
//   power of two up to 32); their spins stay in shared memory for all
//   n_sweeps as [N][C (+ 4)] bytes, a site's C chains side by side (from
//   C = 4, 4 spare bytes a site spread the slots of a warp over the banks),
//   so one load fetches a neighbour's spins for several chains at once.
// * No divisions in the sweep loop. The wrapper hands the kernel, once a
//   launch, a row per (colour, pair) (ops/sweep.py::site_rows): the site of
//   that colour in pair k (sites 2k and 2k + 1 differ in colour), its 2D
//   periodic neighbours, their couplings Jp / Jm and two constants. A lane
//   reads its row through L1, once for all its chains: for D = 2 and 3 (the
//   kernel's D as a constant) with 16-byte loads into registers, for any
//   other D (kD = 0, D at run time) entry by entry.
// * Four chains a lane where the couplings allow it (kSwar: every site's
//   sum of |J| at most 127). The spins are bytes b = (s < 0); one 4-byte
//   load fetches a neighbour's bits for the lane's four chains, and one
//   integer product-add per neighbour, acc += J * word, sums
//   sum_j J_j b_jc + K for all four at once in the four bytes of acc (the
//   row's K * 0x01010101 keeps every byte in [0, 2K], so no carry crosses
//   a byte). Then lf_c = A - 2 byte_c(acc) with the row's A = h + sum J + 2K.
//   Otherwise one chain a lane, spins as int8 +-1, lf = h + sum J s.
// * Philox as the TPU kernel's counter layout asks: the four sites of one
//   colour in pairs 4g..4g+3 take the four words of one call (counter
//   (g, 2*sweep + colour, DRAW_SWEEP, 0), key (seed, chain0 + b)), so a lane
//   draws once a chain per octet of sites and decides its four sites from
//   it.
//
// Acceptance, with half = s*lf (dE = 2*half): accept iff half <= 0 or
// bits < th, th = table[half - 1] from the int32 table computed in float64
// on the host when max |half| <= 64, else
// clip(expf(-beta2s*half)*2^32 - 2^31) (no FMA contraction: -fmad=false).
// The accepted half values are summed mod 2^32 per lane and chain and
// reduced per chain into E += 2*sum, exact int32 arithmetic in any order.
//
// Given aux (a call's last launch), the block ends with a fields epilogue:
// every site's local field for each of its chains, from the final spins in
// shared memory and the site's row, by the sweep loop's arithmetic, written
// to aux [B][N] int32. The fields then cost one write, and no pass over the
// state after the launch.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"
#include "race.cuh"

namespace {

// the most threads a block (the plan's)
constexpr int kMaxThreads = 1024;

// ints of a row: the site, 2D neighbours, 2D couplings, A and K (kSwar) or
// h and 0, padded to 16 bytes (ops/sweep.py::row_len)
__host__ __device__ constexpr int row_len(int D) {
  return (4 * D + 3 + 3) & ~3;
}

// shared bytes a site of a block of C chains (ops/sweep.py::site_bytes):
// from 4 chains, 4 spare bytes spread a warp's sites over the banks
__host__ __device__ __forceinline__ int site_bytes(int C) {
  return C >= 4 ? C + 4 : C;
}

__device__ __forceinline__ int32_t threshold(int32_t half, const int32_t* th,
                                             int n_th, float beta2s,
                                             bool table) {
  if (table) return th[min(half, n_th) - 1];  // the TPU kernel's select
  const float p = expf(-beta2s * (float)half);
  float thf = p * 4294967296.0f - 2147483648.0f;
  thf = fminf(fmaxf(thf, -2147483648.0f), 2147483520.0f);
  return (int32_t)thf;
}

// kD: the lattice's D (2 or 3), or 0 for any D, given at run time as D.
// D comes after the scalars: placed after N, ptxas spilled 8 bytes in the
// D = 3 four-chains-a-lane instantiations at the 64 registers of 1024
// threads. aux: the fields' output, or null (no epilogue).
template <bool kTable, bool kSwar, int kD>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ E_g,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ th_g,
    int N, int n_th, int B, int log_c, int n_sweeps, uint32_t seed,
    uint32_t sweep0, uint32_t chain0, float beta2s, int D,
    int32_t* __restrict__ aux) {
  const int nb = 2 * (kD ? kD : D), len = row_len(kD ? kD : D);
  constexpr int kPer = kSwar ? 4 : 1;  // chains a lane
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* th = reinterpret_cast<int32_t*>(smem);        // [n_th]
  uint8_t* sig = reinterpret_cast<uint8_t*>(th + n_th);  // [N][S]
  __shared__ uint32_t red[kMaxThreads];

  const int C = 1 << log_c, S = site_bytes(C);  // chains, bytes a site
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int log_l = kSwar ? log_c - 2 : log_c;       // lanes a site: C/kPer
  const int c0 = (tid & ((1 << log_l) - 1)) * kPer;  // the lane's 1st chain
  const int slot = tid >> log_l;  // the lane's site slot in the block
  const int n_slots = T >> log_l;
  const int b0 = blockIdx.x * C;
  const int nc = min(C, B - b0);  // chains of this block (ragged: fewer)
  for (int x = tid; x < N * C; x += T) {
    const int cc = x / N, i = x - cc * N;
    const int8_t s = cc < nc ? sigma[(size_t)(b0 + cc) * N + i] : (int8_t)1;
    sig[i * S + cc] = kSwar ? (uint8_t)(s < 0) : (uint8_t)s;
  }
  for (int v = tid; v < n_th; v += T) th[v] = th_g[v];
  const int P = N / 2;            // pairs: one site of each colour
  const int n_oct = (P + 3) / 4;  // Philox calls a chain and colour step
  uint32_t dE[kPer];              // accepted half values, mod 2^32
#pragma unroll
  for (int c = 0; c < kPer; ++c) dE[c] = 0;
  __syncthreads();

  for (int s = 0; s < n_sweeps; ++s) {
    for (int col = 0; col < 2; ++col) {
      const uint32_t t = 2u * (sweep0 + (uint32_t)s) + (uint32_t)col;
      const int32_t* rc = rows + (size_t)col * P * len;
      for (int g = slot; g < n_oct; g += n_slots) {
        uint32_t words[kPer][4];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const uint4 r = rrrmc::philox4x32_10(
              make_uint4((uint32_t)g, t, rrrmc::DRAW_SWEEP, 0u),
              make_uint2(seed, chain0 + (uint32_t)(b0 + c0 + c)));
          words[c][0] = r.x;
          words[c][1] = r.y;
          words[c][2] = r.z;
          words[c][3] = r.w;
        }
        int off[4];
        uint32_t own[4], flip[4];  // flip: a 1 in the byte of each flip
        // the octet's four sites share no edge: every load and decision,
        // then the stores
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * g + q;
          off[q] = -1;
          own[q] = flip[q] = 0;
          if (k >= P) continue;
          const int32_t* row = rc + (size_t)k * len;
          int v[kD ? row_len(kD) : 1];
          if constexpr (kD > 0) {
#pragma unroll
            for (int u = 0; u < row_len(kD) / 4; ++u) {
              const int4 w = __ldg(reinterpret_cast<const int4*>(row) + u);
              v[4 * u] = w.x;
              v[4 * u + 1] = w.y;
              v[4 * u + 2] = w.z;
              v[4 * u + 3] = w.w;
            }
          }
          // entry j of the row: from the registers, or through L1
          auto at = [&](int j) -> int32_t {
            if constexpr (kD > 0) return v[j];
            else return __ldg(row + j);
          };
          off[q] = at(0) * S + c0;
          int32_t half[kPer];
          if constexpr (kSwar) {
            uint32_t acc = (uint32_t)at(2 + 2 * nb);  // K * 0x01010101
#pragma unroll
            for (int d = 0; d < nb; ++d)
              acc += (uint32_t)at(1 + nb + d) *
                     *reinterpret_cast<const uint32_t*>(
                         sig + at(1 + d) * S + c0);
            own[q] = *reinterpret_cast<const uint32_t*>(sig + off[q]);
#pragma unroll
            for (int c = 0; c < kPer; ++c) {
              const int32_t lf =
                  at(1 + 2 * nb) - 2 * (int32_t)((acc >> (8 * c)) & 0xFFu);
              half[c] = ((own[q] >> (8 * c)) & 1u) ? -lf : lf;
            }
          } else {
            int32_t lf = at(1 + 2 * nb);  // h
#pragma unroll
            for (int d = 0; d < nb; ++d)
              lf += at(1 + nb + d) * (int32_t)(int8_t)sig[at(1 + d) * S + c0];
            own[q] = sig[off[q]];
            half[0] = (int32_t)(int8_t)own[q] * lf;
          }
#pragma unroll
          for (int c = 0; c < kPer; ++c) {
            if (half[c] <= 0 || (int32_t)words[c][q] <
                                    threshold(half[c], th, n_th, beta2s,
                                              kTable)) {
              flip[q] |= 1u << (8 * c);
              dE[c] += (uint32_t)half[c];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!flip[q]) continue;
          if constexpr (kSwar)
            *reinterpret_cast<uint32_t*>(sig + off[q]) = own[q] ^ flip[q];
          else
            sig[off[q]] = (uint8_t)(-(int8_t)own[q]);
        }
      }
      __syncthreads();
    }
  }

  for (int x = tid; x < N * C; x += T) {
    const int cc = x / N, i = x - cc * N;
    const uint8_t b = sig[i * S + cc];
    if (cc < nc)
      sigma[(size_t)(b0 + cc) * N + i] =
          kSwar ? (int8_t)(1 - 2 * (int)b) : (int8_t)b;
  }
  // per chain of the lane's kPer: the block's sum over the chain's lanes
  const int lanes = C / kPer;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    red[tid] = dE[c];
    __syncthreads();
    const int cc = tid * kPer + c;
    if (tid < lanes && cc < nc) {
      uint32_t tot = 0;
      for (int x = tid; x < T; x += lanes) tot += red[x];
      E_g[b0 + cc] = (int32_t)((uint32_t)E_g[b0 + cc] + 2u * tot);
    }
    __syncthreads();
  }

  // the fields epilogue: a thread takes a site, reads its row once and
  // takes the block's chains kPer at a time; the threads walk the sites, so
  // each chain's row of aux is written coalesced. Site i lies in pair i / 2,
  // in the colour-0 row when that row's site is i.
  if (aux == nullptr) return;
  for (int i = tid; i < N; i += T) {
    const int32_t* row = rows + (size_t)(i >> 1) * len;
    if (__ldg(row) != i) row += (size_t)P * len;
    int v[kD ? row_len(kD) : 1];
    if constexpr (kD > 0) {
#pragma unroll
      for (int u = 0; u < row_len(kD) / 4; ++u) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(row) + u);
        v[4 * u] = w.x;
        v[4 * u + 1] = w.y;
        v[4 * u + 2] = w.z;
        v[4 * u + 3] = w.w;
      }
    }
    auto at = [&](int j) -> int32_t {
      if constexpr (kD > 0) return v[j];
      else return __ldg(row + j);
    };
    for (int c = 0; c < nc; c += kPer) {
      int32_t lf[kPer];
      if constexpr (kSwar) {
        uint32_t acc = (uint32_t)at(2 + 2 * nb);  // K * 0x01010101
#pragma unroll
        for (int d = 0; d < nb; ++d)
          acc += (uint32_t)at(1 + nb + d) *
                 *reinterpret_cast<const uint32_t*>(sig + at(1 + d) * S + c);
#pragma unroll
        for (int cc = 0; cc < kPer; ++cc)
          lf[cc] = at(1 + 2 * nb) - 2 * (int32_t)((acc >> (8 * cc)) & 0xFFu);
      } else {
        lf[0] = at(1 + 2 * nb);  // h
#pragma unroll
        for (int d = 0; d < nb; ++d)
          lf[0] += at(1 + nb + d) * (int32_t)(int8_t)sig[at(1 + d) * S + c];
      }
#pragma unroll
      for (int cc = 0; cc < kPer; ++cc)
        if (c + cc < nc) aux[(size_t)(b0 + c + cc) * N + i] = lf[cc];
    }
  }
}

template <bool kTable, bool kSwar>
const void* kernel_of(int D) {
  if (D == 2) return (const void*)sweep_kernel<kTable, kSwar, 2>;
  if (D == 3) return (const void*)sweep_kernel<kTable, kSwar, 3>;
  return (const void*)sweep_kernel<kTable, kSwar, 0>;
}

const void* kernel_of(int table, int swar, int D) {
  if (table) return swar ? kernel_of<true, true>(D) : kernel_of<true, false>(D);
  return swar ? kernel_of<false, true>(D) : kernel_of<false, false>(D);
}

template <bool kTable, bool kSwar, int kD>
int launch(int8_t* sigma, int32_t* E, const int32_t* rows, const int32_t* th,
           int32_t* aux, int N, int D, int n_th, int B, int log_c,
           int threads, int n_sweeps, uint32_t seed, uint32_t sweep0,
           uint32_t chain0, float beta2s, size_t smem, cudaStream_t st) {
  auto kern = sweep_kernel<kTable, kSwar, kD>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int C = 1 << log_c;
  kern<<<(B + C - 1) / C, threads, smem, st>>>(
      sigma, E, rows, th, N, n_th, B, log_c, n_sweeps, seed, sweep0,
      chain0, beta2s, D, aux);
  return (int)cudaGetLastError();
}

}  // namespace

// out[5] of the instantiation of (D, table, swar) at `threads` threads and
// `smem` dynamic bytes (race.cuh's kernel_info: blocks per SM, registers,
// local bytes, static shared bytes, most dynamic shared bytes)
extern "C" int rrrmc_sweep_info(int threads, int D, int table, int swar,
                                size_t smem, int device, int* out) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  return rrrmc::kernel_info(kernel_of(table, swar, D), threads, smem, device,
                            out);
}

// n_th > 0: threshold-table path with that many entries; n_th == 0: exp
// path. rows: [2][N/2][row_len(D)] int32 (ops/sweep.py::site_rows, built for
// `swar` or not); 2^log_c chains and `threads` threads a block (the
// plan's; swar needs at least 4 chains); aux: [B][N] int32 that receives
// the final spins' local fields, or null
extern "C" int rrrmc_sweep(int8_t* sigma, int32_t* E, const int32_t* rows,
                           const int32_t* th, int32_t* aux, int L, int D,
                           int B, int n_th, int swar, int log_c, int threads,
                           int n_sweeps, uint32_t seed, uint32_t sweep0,
                           uint32_t chain0, float beta2s, void* stream) {
  const int log_l = swar ? log_c - 2 : log_c;
  if (D < 1 || log_c > 5 || log_l < 0 || threads % 32 ||
      threads > kMaxThreads || (threads >> log_l) < 1)
    return (int)cudaErrorInvalidValue;
  int N = 1;
  for (int d = 0; d < D; ++d) N *= L;
  // the threshold table [n_th] int32 and the spins [N][site_bytes(C)]
  const size_t smem = (size_t)n_th * 4 + (size_t)N * site_bytes(1 << log_c);
  cudaStream_t st = (cudaStream_t)stream;
#define RRRMC_ARGS sigma, E, rows, th, aux, N, D, n_th, B, log_c, threads, \
                   n_sweeps, seed, sweep0, chain0, beta2s, smem, st
#define RRRMC_D(T, S)                                                  \
  (D == 2   ? launch<T, S, 2>(RRRMC_ARGS)                              \
   : D == 3 ? launch<T, S, 3>(RRRMC_ARGS)                              \
            : launch<T, S, 0>(RRRMC_ARGS))
  if (n_th > 0) return swar ? RRRMC_D(true, true) : RRRMC_D(true, false);
  return swar ? RRRMC_D(false, true) : RRRMC_D(false, false);
#undef RRRMC_D
#undef RRRMC_ARGS
}
