// Device code shared by the K-SAT kernels (rejfree_sat.cu, eo_sat.cu): a
// chain's per-clause satisfied counts (uint8) and the exact int32 energy
// change of flipping each variable, dE, resident in shared memory beside its
// spins. The plain versions are rrrmc_tpu_torch/ops/sat.py and
// ops/eo_sat.py (with models/sat.py's delta_from_counts and flip_counts).
//
// The contribution of clause a to dE of its variable v is +1 where v is the
// sole satisfier (count 1 and v's literal true) and -1 where a is violated
// (count 0); dE_v sums it over v's clauses (T[v], TL[v]; a literal sign 0
// contributes nothing, as in the model). The TPU kernels
// recomputed dE from bit-packed per-slot counts every move; here the flip of
// w moves the counts of w's clauses by s' * TL[w] (s' = -s_w, the new spin)
// and, for each, dE of the clause's K variables by the difference of the
// clause's two terms, O(Cmax K) shared-memory gathers. One thread takes one
// clause slot of w (a clause holds w once: the wrapper refuses clauses with
// a repeated variable); two clauses of w can share a variable, so dE moves
// by shared atomics, exact and order-free: on int32 words (eo_sat.cu) or,
// in the race (rejfree_sat.cu), on 16-bit halves of 32-bit words
// (`DeNarrow`).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace rrrmc {

struct SatTables {
  const int32_t* __restrict__ A;   // [Mc, K] variable ids (>= N: padding)
  const int32_t* __restrict__ L;   // [Mc, K] literal signs
  const int32_t* __restrict__ T;   // [N, Cmax] clause ids (Mc: padding)
  const int32_t* __restrict__ TL;  // [N, Cmax] literal signs (0: padding)
  int N, Mc, K, Cmax;
};

// a clause's term in dE of one of its variables, from the clause's count
// and whether that variable's literal is true
__device__ __forceinline__ int clause_term(int count, bool lit_true) {
  return (lit_true && count == 1 ? 1 : 0) - (count == 0 ? 1 : 0);
}

// dE in 16 bits a variable, two to a 32-bit word (the array 4-byte
// aligned), each biased by 2^15: |dE| <= Cmax <= kDeNarrowMax, so neither
// half leaves [1, 65535], and a 32-bit atomicAdd of a change shifted into
// v's half moves that half alone
struct DeNarrow {
  uint16_t* h;
  __device__ __forceinline__ int get(int v) const { return (int)h[v] - 32768; }
};
constexpr int kDeNarrowMax = 32767;

// dE[v] = x, and dE[v] += x returning the old value: int32 words, or
// DeNarrow
__device__ __forceinline__ void de_set(int32_t* d, int v, int x) { d[v] = x; }
__device__ __forceinline__ int de_add(int32_t* d, int v, int x) {
  return atomicAdd(d + v, x);
}
__device__ __forceinline__ void de_set(DeNarrow d, int v, int x) {
  d.h[v] = (uint16_t)(x + 32768);
}
__device__ __forceinline__ int de_add(DeNarrow d, int v, int x) {
  const int sh = 16 * (v & 1);
  const unsigned old = atomicAdd(reinterpret_cast<unsigned*>(d.h + (v & ~1)),
                                 (unsigned)x << sh);
  return (int)((old >> sh) & 0xffffu) - 32768;
}

// dE of every variable from the spins and the counts (after both are
// loaded); the caller synchronises before reading dE
template <int THREADS, typename DE>
__device__ void sat_init_delta(const SatTables& t, const int8_t* sig,
                               const uint8_t* cnt, DE dE) {
  for (int i = threadIdx.x; i < t.N; i += THREADS) {
    int s = 0;
    for (int c = 0; c < t.Cmax; ++c) {
      const int a = t.T[(size_t)i * t.Cmax + c];
      const int lit = t.TL[(size_t)i * t.Cmax + c];
      if (a < t.Mc && lit != 0) s += clause_term(cnt[a], sig[i] == lit);
    }
    de_set(dE, i, s);
  }
}

// The flip of variable w from spin sw to -sw by the first THREADS threads,
// thread c taking clause slots c, c + THREADS, ...: counts and dE (each
// change of dE[v] from `from` to `to` is reported to moved(from, to), for
// the EO histogram). sig[w] itself is left to the caller; the other
// variables' spins are only read. Each of those threads must call it; the
// caller synchronises before and after.
template <int THREADS, typename DE, typename Moved>
__device__ void sat_flip(const SatTables& t, int w, int sw, const int8_t* sig,
                         uint8_t* cnt, DE dE, Moved moved) {
  const int ns = -sw;
  for (int c = threadIdx.x; c < t.Cmax; c += THREADS) {
    const size_t slot = (size_t)w * t.Cmax + c;
    const int a = t.T[slot];
    if (a >= t.Mc) continue;
    const int old = cnt[a];
    const int now = old + ns * t.TL[slot];
    cnt[a] = (uint8_t)now;
    for (int k = 0; k < t.K; ++k) {
      const int v = t.A[(size_t)a * t.K + k];
      const int lit = t.L[(size_t)a * t.K + k];
      if (v >= t.N || lit == 0) continue;  // padding
      const int delta =
          v == w ? clause_term(now, ns == lit) - clause_term(old, sw == lit)
                 : clause_term(now, sig[v] == lit)
                       - clause_term(old, sig[v] == lit);
      if (delta != 0) {
        const int from = de_add(dE, v, delta);
        moved(from, from + delta);
      }
    }
  }
}

// bytes of N spins or Mc counts in shared memory, rounded up to 16
__host__ __device__ __forceinline__ size_t bytes16(size_t n) {
  return (n + 15) / 16 * 16;
}

}  // namespace rrrmc
