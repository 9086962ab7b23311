// Device code shared by the K-SAT kernels (rejfree_sat.cu, eo_sat.cu): a
// chain's per-clause satisfied counts (uint8) and the exact energy
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
// by shared atomics, exact and order-free: on 16-bit halves of 32-bit words
// (`DeNarrow`: the race, rejfree_sat.cu, and the EO kernel, eo_sat.cu,
// where Cmax > 127) or on bytes of them (`DeByte`: the EO kernel where
// Cmax <= 127). The spins are read by index as +-1: int8 spins (the race)
// or bits (eo_chain.cuh::BitSpins).
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

// dE in 8 bits a variable, four to a 32-bit word, each biased by 128:
// |dE| <= Cmax <= kDeByteMax, so no byte leaves [1, 255] (a partial update
// of dE[v] is a sum of at most Cmax clause terms too), and a 32-bit
// atomicAdd of a change shifted into v's byte moves that byte alone
struct DeByte {
  uint8_t* h;
};
constexpr int kDeByteMax = 127;

// dE[v] = x, and dE[v] += x returning the old value: DeNarrow or DeByte
__device__ __forceinline__ void de_set(DeNarrow d, int v, int x) {
  d.h[v] = (uint16_t)(x + 32768);
}
__device__ __forceinline__ int de_add(DeNarrow d, int v, int x) {
  const int sh = 16 * (v & 1);
  const unsigned old = atomicAdd(reinterpret_cast<unsigned*>(d.h + (v & ~1)),
                                 (unsigned)x << sh);
  return (int)((old >> sh) & 0xffffu) - 32768;
}
__device__ __forceinline__ void de_set(DeByte d, int v, int x) {
  d.h[v] = (uint8_t)(x + 128);
}
__device__ __forceinline__ int de_add(DeByte d, int v, int x) {
  const int sh = 8 * (v & 3);
  const unsigned old = atomicAdd(reinterpret_cast<unsigned*>(d.h + (v & ~3)),
                                 (unsigned)x << sh);
  return (int)((old >> sh) & 0xffu) - 128;
}

// dE of every variable from the spins and the counts (after both are
// loaded), thread tid of THREADS taking variables tid, tid + THREADS, ...;
// the caller synchronises before reading dE
template <int THREADS, typename Sig, typename DE>
__device__ void sat_init_delta_at(int tid, const SatTables& t, Sig sig,
                                  const uint8_t* cnt, DE dE) {
  for (int i = tid; i < t.N; i += THREADS) {
    int s = 0;
    for (int c = 0; c < t.Cmax; ++c) {
      const int a = t.T[(size_t)i * t.Cmax + c];
      const int lit = t.TL[(size_t)i * t.Cmax + c];
      if (a < t.Mc && lit != 0) s += clause_term(cnt[a], sig[i] == lit);
    }
    de_set(dE, i, s);
  }
}

template <int THREADS, typename Sig, typename DE>
__device__ void sat_init_delta(const SatTables& t, Sig sig,
                               const uint8_t* cnt, DE dE) {
  sat_init_delta_at<THREADS>((int)threadIdx.x, t, sig, cnt, dE);
}

// the most variables a clause whose loads sat_flip_at issues ahead
constexpr int kSatAhead = 4;

// The flip of variable w from spin sw to -sw by THREADS threads, thread
// tid taking clause slots tid, tid + THREADS, ...: counts and dE (each
// change of dE[v] from `from` to `to` is reported to moved(from, to), for
// the EO histogram). sig[w] itself is left to the caller (sig[w] is not
// read); the other variables' spins are only read. Each of those threads
// must call it; the caller synchronises before and after. AHEAD: the
// slot's loads through the read-only cache, and for K <= kSatAhead the
// clause's K variables and signs loaded together before their updates.
template <int THREADS, bool AHEAD = false, typename Sig, typename DE,
          typename Moved>
__device__ void sat_flip_at(int tid, const SatTables& t, int w, int sw,
                            Sig sig, uint8_t* cnt, DE dE, Moved moved) {
  const int ns = -sw;
  for (int c = tid; c < t.Cmax; c += THREADS) {
    const size_t slot = (size_t)w * t.Cmax + c;
    const int a = AHEAD ? __ldg(t.T + slot) : t.T[slot];
    const int tl = AHEAD ? __ldg(t.TL + slot) : t.TL[slot];
    if (a >= t.Mc) continue;
    const int old = cnt[a];
    const int now = old + ns * tl;
    cnt[a] = (uint8_t)now;
    // variable v of the clause, literal sign lit
    auto update = [&](int v, int lit) {
      if (v >= t.N || lit == 0) return;  // padding
      const int delta =
          v == w ? clause_term(now, ns == lit) - clause_term(old, sw == lit)
                 : clause_term(now, sig[v] == lit)
                       - clause_term(old, sig[v] == lit);
      if (delta != 0) {
        const int from = de_add(dE, v, delta);
        moved(from, from + delta);
      }
    };
    const size_t row = (size_t)a * t.K;
    if (AHEAD && t.K <= kSatAhead) {
      int vs[kSatAhead], ls[kSatAhead];
#pragma unroll
      for (int k = 0; k < kSatAhead; ++k) {
        vs[k] = k < t.K ? __ldg(t.A + row + k) : t.N;
        ls[k] = k < t.K ? __ldg(t.L + row + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kSatAhead; ++k) update(vs[k], ls[k]);
    } else {
      for (int k = 0; k < t.K; ++k) update(t.A[row + k], t.L[row + k]);
    }
  }
}

// sat_flip_at by the block's first THREADS threads
template <int THREADS, typename Sig, typename DE, typename Moved>
__device__ void sat_flip(const SatTables& t, int w, int sw, Sig sig,
                         uint8_t* cnt, DE dE, Moved moved) {
  sat_flip_at<THREADS>((int)threadIdx.x, t, w, sw, sig, cnt, dE, moved);
}

// bytes of N spins or Mc counts in shared memory, rounded up to 16
__host__ __device__ __forceinline__ size_t bytes16(size_t n) {
  return (n + 15) / 16 * 16;
}

}  // namespace rrrmc
