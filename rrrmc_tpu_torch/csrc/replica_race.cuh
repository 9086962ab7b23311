// The replica composites' race kernel (rejfree_replica.cu, whose note
// describes it): its arguments, the composite site walker, the kernel
// template and the table of one term's instantiations. The ring's are
// compiled in rejfree_replica.cu and the star's in rejfree_replica_star.cu,
// so that nvcc builds the two halves of the 32 instantiations in parallel.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "race.cuh"

namespace rrrmc {
namespace replica {

struct Args {
  int8_t* sigma;
  void* lf;
  float* E;
  void* coord;
  int32_t* acc;
  float* zacc;
  void* cs;
  float* es;
  const void* J;
  const int32_t* neigh;
  const float* params;  // sb, c4, fk[M]
  int Nk, M, K, B, n_moves, mode, sparse;
  uint32_t seed, move0, chain0;
  float beta;
  int32_t target_i;
  float target_f;
};

// the composite site walker: site j = i + k Nk's bE = beta * max(dE_j, 0),
// reporting dE_j and s_j; (k, i) is the calling thread's next site, stepped
// by T = tq Nk + tr after each call
template <typename RT, bool STAR>
struct ReplicaSite {
  const int8_t* sig;
  const RT* lf;
  const int32_t* mu;
  const float* fk;
  int Nk, M, tq, tr;
  float sb, c4, beta;
  int k, i;
  __device__ __forceinline__ float operator()(int j, Pay& p, float& e) {
    const int8_t sj = sig[j];
    const float s = (float)sj;
    const float t = sb * (float)lf[j];
    float x;
    if (STAR) {
      x = 2.0f * s * t + s * fk[(mu[i] - (int)sj + M - 1) >> 1];
    } else {
      const int up = k + 1 == M ? i : j + Nk;
      const int dn = k == 0 ? j + (M - 1) * Nk : j - Nk;
      x = 2.0f * s * (t + c4 * (float)(sig[up] + sig[dn]));
    }
    i += tr;
    k += tq;
    if (i >= Nk) {
      i -= Nk;
      ++k;
    }
    p.a = __float_as_int(x);
    p.b = sj;
    const float be = beta * (x > 0.0f ? x : 0.0f);
    e = expf(0.0f - be);
    return be;
  }
};

// RT: resident base fields (int8 / int16 / int32 / f32); STAR: the star's
// term, else the ring's; CT: coordinate (int32, f32 for wtm). The base
// couplings: dense int8 (integer base) or f32, sparse int32 or f32.
template <int T, typename RT, bool STAR, typename CT>
__global__ void __launch_bounds__(T, 1024 / T)
    rejfree_replica_kernel(Args a) {
  using G = rrrmc::GlobalOf<RT>;
  using JD = typename std::conditional<std::is_same<RT, float>::value, float,
                                       int8_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Nk = a.Nk, M = a.M, K = a.K, N = a.Nk * a.M;
  const int n_save = a.sparse ? K : Nk;
  float* fk = reinterpret_cast<float*>(smem);                    // [M]
  int32_t* mu = reinterpret_cast<int32_t*>(fk + M);              // [Nk] star
  RT* lf = reinterpret_cast<RT*>(mu + (STAR ? Nk : 0));          // [N]
  RT* saved = lf + N;                                            // [n_save]
  int8_t* sig = reinterpret_cast<int8_t*>(saved + n_save);       // [N]
  __shared__ rrrmc::Fused<T> red;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N;
  G* lf_g = reinterpret_cast<G*>(a.lf);
  for (int j = tid; j < N; j += T) {
    sig[j] = a.sigma[row + j];
    lf[j] = RT(lf_g[row + j]);
  }
  for (int m = tid; m < M; m += T) fk[m] = a.params[2 + m];
  rrrmc::fused_init(red);
  __syncthreads();
  if (STAR) {
    for (int i = tid; i < Nk; i += T) {
      int32_t s = 0;
      for (int k = 0; k < M; ++k) s += sig[k * Nk + i];
      mu[i] = s;
    }
  }
  rrrmc::ChainState<CT, float> c{a.E[b], reinterpret_cast<CT*>(a.coord)[b],
                                 a.acc[b], a.zacc[b]};
  const CT target = a.mode == kWtm ? CT(a.target_f) : CT(a.target_i);
  const bool sparse = a.sparse != 0;
  const G* Js = reinterpret_cast<const G*>(a.J);
  const JD* Jd = reinterpret_cast<const JD*>(a.J);
  const int32_t* neigh = a.neigh;
  const int k0 = tid / Nk;
  const ReplicaSite<RT, STAR> site{sig, lf, mu, fk, Nk, M, T / Nk, T % Nk,
                                   a.params[0], a.params[1], a.beta,
                                   k0, tid - k0 * Nk};
  __syncthreads();

  // the flip of w = (iw, kw), tentative for rrr (the old fields saved)
  auto flip = [&](int w, int sw, bool rrr) {
    const int kw = w / Nk, iw = w - kw * Nk;
    const G d = G(-2 * sw);
    RT* lfk = lf + kw * Nk;
    if (sparse) {
      if (tid < 32) {
        auto slot = [&](int q, int& nb, G& inc) {
          nb = neigh[iw * K + q];
          inc = Js[iw * K + q] * d;
        };
        rrrmc::warp_apply<RT, G>(K, Nk, slot, lfk, saved, rrr);
      }
    } else {
      const JD* jrow = Jd + (size_t)iw * Nk;
      for (int i = tid; i < Nk; i += T) {
        if (rrr) saved[i] = lfk[i];
        lfk[i] = RT(G(lfk[i]) + d * G(jrow[i]));
      }
    }
    if (tid == 0) {
      sig[w] = (int8_t)(-sw);
      if (STAR) mu[iw] -= 2 * sw;
    }
  };
  auto undo = [&](int w, int sw) {
    const int kw = w / Nk, iw = w - kw * Nk;
    RT* lfk = lf + kw * Nk;
    if (sparse) {
      if (tid < 32)
        rrrmc::warp_restore(K, Nk, [&](int q) { return neigh[iw * K + q]; },
                            lfk, saved);
    } else {
      for (int i = tid; i < Nk; i += T) lfk[i] = saved[i];
    }
    if (tid == 0) {
      sig[w] = (int8_t)sw;
      if (STAR) mu[iw] += 2 * sw;
    }
  };
  rrrmc::race_moves<T>(c, a.mode, N, a.n_moves, a.B, a.seed,
                       a.chain0 + (uint32_t)b, a.move0, target,
                       reinterpret_cast<CT*>(a.cs), a.es, site, flip, undo,
                       red);

  __syncthreads();
  for (int j = tid; j < N; j += T) {
    a.sigma[row + j] = sig[j];
    lf_g[row + j] = G(lf[j]);
  }
  if (rrrmc::is_bookkeeper<T>()) {
    a.E[b] = c.E;
    reinterpret_cast<CT*>(a.coord)[b] = c.coord;
    a.acc[b] = c.acc;
    a.zacc[b] = c.zacc;
  }
}

using Kern = void (*)(Args);

template <int T, typename RT, bool STAR>
Kern by_coord(int wtm) {
  if (wtm) return rejfree_replica_kernel<T, RT, STAR, float>;
  return rejfree_replica_kernel<T, RT, STAR, int32_t>;
}

template <int T, bool STAR>
Kern by_field(int field, int wtm) {
  switch (field) {
    case 0: return by_coord<T, int8_t, STAR>(wtm);
    case 1: return by_coord<T, int16_t, STAR>(wtm);
    case 2: return by_coord<T, int32_t, STAR>(wtm);
    case 3: return by_coord<T, float, STAR>(wtm);
  }
  return nullptr;
}

// the term's instantiation for T threads, resident field code `field` (0
// int8, 1 int16, 2 int32, 3 f32) and the coordinate; null if none
template <bool STAR>
Kern kernel_of(int threads, int field, int wtm) {
  switch (threads) {
    case 256: return by_field<256, STAR>(field, wtm);
    case 512: return by_field<512, STAR>(field, wtm);
  }
  return nullptr;
}

// each term's instantiations are compiled once, in its own source
extern template Kern kernel_of<false>(int, int, int);
extern template Kern kernel_of<true>(int, int, int);

}  // namespace replica
}  // namespace rrrmc
