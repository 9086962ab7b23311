// Sequential Metropolis sweeps on the replica composites, GraphQuant (the
// Trotter ring) and GraphRobustEnsemble (the star), over a dense base.
// Replaces rrrmc_tpu/ops/quant_pallas.py::_ring_sweep_kernel (launched by
// `_pallas_ring_sweep`); the wrapper, the launch plan and the plain torch
// version are rrrmc_tpu_torch/ops/replica_sweep.py.
//
// What it computes: every sweep visits the N = Nk * M composite spins in
// order (replica-major, spin (i, k) = i + k * Nk); spin j = (i, k) is decided
// against its base field plus the corrections of the flips accepted since
// the last commit of the fields, with the physical cost
//   ring  dE = 2 s (sb * lf + c4 (s_{i,k-1} + s_{i,k+1}))
//   star  dE = 2 s (sb * lf) + s fk[(mu_i - s + M - 1) >> 1]
// (ops/replica.py's identity), and accepted iff dE <= 0 or bits < th with
// th = clip(exp(-beta dE) 2^32 - 2^31) computed per decision in float32, the
// TPU kernel's threshold (c4 and fk are irrational: no integer table as in
// sk_sweep.cu). The bits of spin j in sweep t are word j % 4 of Philox
// counter (j / 4, t, DRAW_REPLICA_SWEEP, 0) under key (seed, chain), so
// split launches equal one. E (f32 physical) gains each accepted dE in site
// order; `acc` counts the accepted flips.
//
// Design: spans never cross a replica block, so the ring partners and mu's
// other terms lie in other blocks and do not change during a span; each
// spin's extra term (ring: c4 times the partners' spins; star: s fk[...]
// from mu, summed from the spins) and its Philox word (a quarter of a call
// a spin, all lanes working) are derived once, when the span is loaded.
// A warp decides 32 consecutive spins at once, one a lane (an expf each);
// the lowest accepting lane is the next flip in site order, its row of J
// corrects the span's later fields, and evaluation resumes after it.
// - An integer base (int8 J, int32 fields, exact; the TPU kept f32 fields
//   and multiplied by sb when dE is formed, as here) runs sk_sweep.cu's
//   block-synchronous scheme (sweep_block.cuh): a block of kChains = 16
//   chains decides the same span of kSpanMax spins (Nk below it), loaded
//   4 spins a lane where Nk % 4 == 0 while the block copies the span's
//   diagonal block of J with cp.async; its corrections read that block
//   from shared memory, and at the span's end the block commits every
//   chain's flips to the mover's block of its fields with one int8
//   tensor-core product, lf[chains, k Nk + n] += dlt[chains, span]
//   J_base[i0 + span, n]. Warps past B stay for the barriers and commit a
//   zero row.
// - A float base keeps the plain version's float32 sums: spans of SPAN
//   spins (ops/replica_sweep.py), each warp on its own chain, the
//   corrections from J's row in global memory and the commit of a span's
//   flips summed in site order on the CUDA cores, rows in 16-byte loads
//   with the loads of four flips in flight.
//
// Bound on the H100: the least time is that of its bytes (sigma and lf read
// and written, J read once). What remains (PERF.md): the decisions, one
// round a 32 spins plus one an accepted flip with an expf a lane and round,
// sequential per chain; for the float base its commits on the CUDA cores.
#include <cuda_runtime.h>
#include <cstdint>

#include "philox.cuh"
#include "sweep_block.cuh"

namespace {

using rrrmc::kChains;
using rrrmc::kSpanMax;
using rrrmc::span_stride;

constexpr int kFloatChains = 8;  // chains (warps) of a float block
constexpr int kFloatSpan = 512;  // the float base's span (SPAN)

// dynamic shared memory of an integer block: the span's diagonal block of J
// [span][sp] int8, then per chain dlt [sp] int8, spins [sp] int8, lf [sp]
// int32, words [sp] int32 and the extra term [sp] f32
__host__ __device__ inline size_t int_smem(int span) {
  const size_t sp = span_stride(span);
  return (size_t)span * sp + (size_t)kChains * sp * 14;
}

// dynamic shared memory of a float block: per chain lf [sp] f32, the extra
// term [sp] f32, words [sp] int32, accepted offsets [sp] int16, spins [sp]
__host__ __device__ inline size_t float_smem(int span) {
  return (size_t)kFloatChains * span_stride(span) * 15;
}

// the chain's span (spins i0..i0 + len - 1 of replica block `blk`): spins,
// fields, extra terms and Philox words into shared memory, by its warp; 4
// spins a lane and load where VEC >= 4 (Nk % 4 == 0: every row's span is
// 4-byte aligned, 16-byte for the fields), else one
template <int VEC, typename T, bool STAR>
__device__ void load_span(const int8_t* __restrict__ sigma,
                          const T* __restrict__ lf, size_t row, int blk,
                          int up, int dn, int i0, int len, int Nk, int M,
                          float c4, const float* __restrict__ fk,
                          int8_t* __restrict__ sigw, T* __restrict__ lfw,
                          float* __restrict__ extra, int32_t* __restrict__ words,
                          uint2 key, uint32_t t, int lane) {
  const size_t s0 = row + blk + i0;
  if constexpr (VEC >= 4) {
    rrrmc::copy_row<VEC>(lfw, lf + s0, len, lane);
    for (int q = 4 * lane; q < len; q += 128) {
      const char4 sq = *reinterpret_cast<const char4*>(sigma + s0 + q);
      *reinterpret_cast<char4*>(sigw + q) = sq;
      float4 ex;
      if (STAR) {
        int4 mu = make_int4(0, 0, 0, 0);
        for (int kk = 0; kk < M; ++kk) {
          const char4 m =
              *reinterpret_cast<const char4*>(sigma + row + kk * Nk + i0 + q);
          mu.x += m.x;
          mu.y += m.y;
          mu.z += m.z;
          mu.w += m.w;
        }
        ex = make_float4((float)sq.x * fk[(mu.x - sq.x + M - 1) >> 1],
                         (float)sq.y * fk[(mu.y - sq.y + M - 1) >> 1],
                         (float)sq.z * fk[(mu.z - sq.z + M - 1) >> 1],
                         (float)sq.w * fk[(mu.w - sq.w + M - 1) >> 1]);
      } else {
        const char4 u = *reinterpret_cast<const char4*>(sigma + row + up +
                                                        i0 + q);
        const char4 d = *reinterpret_cast<const char4*>(sigma + row + dn +
                                                        i0 + q);
        ex = make_float4(c4 * (float)(u.x + d.x), c4 * (float)(u.y + d.y),
                         c4 * (float)(u.z + d.z), c4 * (float)(u.w + d.w));
      }
      *reinterpret_cast<float4*>(extra + q) = ex;
    }
  } else {
    for (int q = lane; q < len; q += 32) {
      const int sq = sigma[s0 + q];
      lfw[q] = lf[s0 + q];
      sigw[q] = (int8_t)sq;
      if (STAR) {
        int mu = 0;
        for (int kk = 0; kk < M; ++kk) mu += sigma[row + kk * Nk + i0 + q];
        extra[q] = (float)sq * fk[(mu - sq + M - 1) >> 1];
      } else {
        extra[q] = c4 * (float)(sigma[row + up + i0 + q] +
                                sigma[row + dn + i0 + q]);
      }
    }
  }
  const int j0 = blk + i0;
  for (int g = (j0 >> 2) + lane; g <= (j0 + len - 1) >> 2; g += 32) {
    const uint4 w4 = rrrmc::philox4x32_10(
        make_uint4((uint32_t)g, t, rrrmc::DRAW_REPLICA_SWEEP, 0u), key);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int q = 4 * g + jj - j0;
      if (q >= 0 && q < len) words[q] = (int32_t)w[jj];
    }
  }
}

// the decision of one spin: its dE (physical, float32) and whether the
// Metropolis test with word u accepts it
template <typename T, bool STAR>
__device__ __forceinline__ bool accept(int sv, T lv, float ex, int32_t u,
                                       float sb, float beta, float& dE) {
  const float sf = (float)sv;
  const float tq = sb * (float)lv;
  dE = STAR ? 2.0f * sf * tq + ex : 2.0f * sf * (tq + ex);
  const float p = expf(-beta * dE);
  const float x = fminf(fmaxf(p * 4294967296.0f - 2147483648.0f,
                              -2147483648.0f),
                        2147483520.0f);
  return dE <= 0.0f || u < (int32_t)x;
}

// the integer base: block-synchronous spans, tensor-core commits
template <bool STAR, int VEC>
__global__ void __launch_bounds__(32 * kChains, 1) replica_sweep_kernel(
    int8_t* __restrict__ sigma, int32_t* __restrict__ lf,
    float* __restrict__ E_g, int32_t* __restrict__ acc_g,
    const int8_t* __restrict__ J, const float* __restrict__ params, int Nk,
    int M, int B, int span, int n_sweeps, float beta, uint32_t seed,
    uint32_t sweep0, uint32_t chain0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flipped[kChains];
  constexpr int C = kChains;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cb = blockIdx.x * C;
  const int b = cb + warp;
  const bool live = b < B;
  const int sp = span_stride(span);
  int8_t* Jd = reinterpret_cast<int8_t*>(smem);             // [span][sp]
  int8_t* dlt_all = Jd + (size_t)span * sp;                   // [C][sp]
  int8_t* dlt = dlt_all + warp * sp;
  int8_t* sigw = dlt_all + C * sp + warp * sp;
  int32_t* lfw = reinterpret_cast<int32_t*>(dlt_all + 2 * C * sp) + warp * sp;
  int32_t* words = reinterpret_cast<int32_t*>(dlt_all + 6 * C * sp) +
                   warp * sp;
  float* extra = reinterpret_cast<float*>(dlt_all + 10 * C * sp) + warp * sp;

  const float sb = params[0], c4 = params[1];
  const float* fk = params + 2;
  const int N = Nk * M;
  const uint2 key = make_uint2(seed, chain0 + (uint32_t)b);
  const size_t row = (size_t)(live ? b : 0) * N;
  float E = live ? E_g[b] : 0.0f;  // lane 0's copy is the one kept
  int32_t acc = 0;

  for (int s = 0; s < n_sweeps; ++s) {
    const uint32_t t = sweep0 + (uint32_t)s;
    for (int k = 0; k < M; ++k) {
      const int blk = k * Nk;
      const int up = (k + 1 == M ? 0 : k + 1) * Nk;
      const int dn = (k == 0 ? M - 1 : k - 1) * Nk;
      for (int i0 = 0; i0 < Nk; i0 += span) {
        const int len = min(span, Nk - i0);
        rrrmc::load_diag<VEC>(Jd, sp, J, Nk, i0, len);
        for (int q = lane; q < sp; q += 32) dlt[q] = 0;
        if (live)
          load_span<VEC, int32_t, STAR>(sigma, lf, row, blk, up, dn, i0, len,
                                        Nk, M, c4, fk, sigw, lfw, extra,
                                        words, key, t, lane);
        rrrmc::wait_diag<VEC>();
        __syncthreads();
        int n_acc = 0;
        if (live) {
          int q0 = 0;
          while (q0 < len) {
            const int q = q0 + lane;
            bool ok = false;
            float dE = 0.0f;
            int sv = 0;
            if (q < len) {
              sv = sigw[q];
              ok = accept<int32_t, STAR>(sv, lfw[q], extra[q], words[q], sb,
                                         beta, dE);
            }
            const unsigned mask = __ballot_sync(0xffffffffu, ok);
            if (mask == 0u) {
              q0 += 32;
              continue;
            }
            const int f = __ffs(mask) - 1;
            const int qf = q0 + f;
            const float dE_f = __shfl_sync(0xffffffffu, dE, f);
            const int32_t d = -2 * __shfl_sync(0xffffffffu, sv, f);
            __syncwarp();
            if (lane == f) {
              sigw[qf] = (int8_t)(-sv);
              dlt[qf] = (int8_t)d;
            }
            if (lane == 0) {
              E += dE_f;
              ++acc;
            }
            ++n_acc;
            rrrmc::correct_span(lfw, Jd + qf * sp, d, qf + 1, len, lane);
            __syncwarp();
            q0 = qf + 1;
          }
          rrrmc::copy_row<VEC>(sigma + row + blk + i0, sigw, len, lane);
        }
        if (lane == 0) flipped[warp] = n_acc;
        __syncthreads();
        bool live0 = false, live1 = false;
        int n_flips = 0;
        for (int c = 0; c < C; ++c) {
          if (c < 8) live0 |= flipped[c] != 0;
          else live1 |= flipped[c] != 0;
          n_flips += flipped[c];
        }
        if (n_flips > rrrmc::kRowFlips)
          rrrmc::commit_mma<VEC>(lf, (size_t)N, blk, J, Nk, Nk, i0, len,
                                 dlt_all, sp, cb, B, live0, live1, warp, C,
                                 lane);
        else if (n_flips)
          rrrmc::commit_rows<VEC>(lf, (size_t)N, blk, J, Nk, Nk, i0, len,
                                  dlt_all, sp, cb, C, flipped, warp, lane);
        __syncthreads();
      }
    }
  }
  if (live && lane == 0) {
    E_g[b] = E;
    acc_g[b] += acc;
  }
}

// the float base: one warp a chain, no block barrier
template <bool STAR>
__global__ void __launch_bounds__(32 * kFloatChains) replica_sweep_float_kernel(
    int8_t* __restrict__ sigma, float* __restrict__ lf,
    float* __restrict__ E_g, int32_t* __restrict__ acc_g,
    const float* __restrict__ J, const float* __restrict__ params, int Nk,
    int M, int B, int span, int n_sweeps, float beta, uint32_t seed,
    uint32_t sweep0, uint32_t chain0, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kFloatChains + warp;
  if (b >= B) return;  // whole warp; the kernel has no block barrier
  const int sp = span_stride(span);
  unsigned char* base = smem + (size_t)sp * 15 * warp;
  float* lfw = reinterpret_cast<float*>(base);                 // [sp]
  float* extra = lfw + sp;                                      // [sp]
  int32_t* words = reinterpret_cast<int32_t*>(extra + sp);     // [sp]
  int16_t* flips = reinterpret_cast<int16_t*>(words + sp);     // [sp]
  int8_t* sigw = reinterpret_cast<int8_t*>(flips + sp);        // [sp]

  const float sb = params[0], c4 = params[1];
  const float* fk = params + 2;
  const int N = Nk * M;
  const uint2 key = make_uint2(seed, chain0 + (uint32_t)b);
  const size_t row = (size_t)b * N;
  float E = E_g[b];  // lane 0's copy is the one kept
  int32_t acc = 0;

  for (int s = 0; s < n_sweeps; ++s) {
    const uint32_t t = sweep0 + (uint32_t)s;
    for (int k = 0; k < M; ++k) {
      const int blk = k * Nk;
      const int up = (k + 1 == M ? 0 : k + 1) * Nk;
      const int dn = (k == 0 ? M - 1 : k - 1) * Nk;
      for (int i0 = 0; i0 < Nk; i0 += span) {
        const int len = min(span, Nk - i0);
        load_span<1, float, STAR>(sigma, lf, row, blk, up, dn, i0, len, Nk,
                                  M, c4, fk, sigw, lfw, extra, words, key, t,
                                  lane);
        __syncwarp();
        int n_acc = 0;
        int q0 = 0;
        while (q0 < len) {
          const int q = q0 + lane;
          bool ok = false;
          float dE = 0.0f;
          int sv = 0;
          if (q < len) {
            sv = sigw[q];
            ok = accept<float, STAR>(sv, lfw[q], extra[q], words[q], sb, beta,
                                     dE);
          }
          const unsigned mask = __ballot_sync(0xffffffffu, ok);
          if (mask == 0u) {
            q0 += 32;
            continue;
          }
          const int f = __ffs(mask) - 1;
          const int qf = q0 + f;
          const float dE_f = __shfl_sync(0xffffffffu, dE, f);
          const float d = (float)(-2 * __shfl_sync(0xffffffffu, sv, f));
          __syncwarp();
          if (lane == f) sigw[qf] = (int8_t)(-sv);
          if (lane == 0) {
            flips[n_acc] = (int16_t)qf;
            E += dE_f;
            ++acc;
          }
          ++n_acc;
          const float* jrow = J + (size_t)(i0 + qf) * Nk + i0;
          if (vec4) {
            // groups of 4 from qf's (its earlier spins are decided)
            const float4* j4 = reinterpret_cast<const float4*>(jrow);
            float4* l4 = reinterpret_cast<float4*>(lfw);
            for (int g = ((qf + 1) >> 2) + lane; g < len >> 2; g += 32) {
              const float4 jv = __ldg(j4 + g);
              float4 v = l4[g];
              v.x += d * jv.x;
              v.y += d * jv.y;
              v.z += d * jv.z;
              v.w += d * jv.w;
              l4[g] = v;
            }
          } else {
            for (int q2 = qf + 1 + lane; q2 < len; q2 += 32)
              lfw[q2] += d * jrow[q2];
          }
          __syncwarp();
          q0 = qf + 1;
        }
        for (int q = lane; q < len; q += 32)
          sigma[row + blk + i0 + q] = sigw[q];
        // commit: lf[block k, i] += sum_j d_j J_base[i0 + q_j, i], the
        // accepted flips in site order, four rows' loads in flight
        if (n_acc && vec4) {
          float4* lr = reinterpret_cast<float4*>(lf + row + blk);
          const float4* J4 = reinterpret_cast<const float4*>(J);
          const int nk4 = Nk >> 2;
          for (int i = lane; i < nk4; i += 32) {
            float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            int jj = 0;
            for (; jj + 4 <= n_acc; jj += 4) {
              float w[4];
              float4 r[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int qj = flips[jj + u];
                w[u] = (float)(2 * (int)sigw[qj]);
                r[u] = __ldg(J4 + (size_t)(i0 + qj) * nk4 + i);
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                a.x += w[u] * r[u].x;
                a.y += w[u] * r[u].y;
                a.z += w[u] * r[u].z;
                a.w += w[u] * r[u].w;
              }
            }
            for (; jj < n_acc; ++jj) {
              const int qj = flips[jj];
              const float w = (float)(2 * (int)sigw[qj]);
              const float4 r = __ldg(J4 + (size_t)(i0 + qj) * nk4 + i);
              a.x += w * r.x;
              a.y += w * r.y;
              a.z += w * r.z;
              a.w += w * r.w;
            }
            float4 v = lr[i];
            v.x += a.x;
            v.y += a.y;
            v.z += a.z;
            v.w += a.w;
            lr[i] = v;
          }
        } else if (n_acc) {
          for (int i = lane; i < Nk; i += 32) {
            float a = 0.0f;
            for (int jj = 0; jj < n_acc; ++jj) {
              const int qj = flips[jj];
              a += (float)(2 * (int)sigw[qj]) * J[(size_t)(i0 + qj) * Nk + i];
            }
            lf[row + blk + i] += a;
          }
        }
        __syncwarp();
      }
    }
  }
  if (lane == 0) {
    E_g[b] = E;
    acc_g[b] += acc;
  }
}

using IntKern = void (*)(int8_t*, int32_t*, float*, int32_t*, const int8_t*,
                         const float*, int, int, int, int, int, float,
                         uint32_t, uint32_t, uint32_t);
using FloatKern = void (*)(int8_t*, float*, float*, int32_t*, const float*,
                           const float*, int, int, int, int, int, float,
                           uint32_t, uint32_t, uint32_t, int);

IntKern int_kernel(int star, int vec) {
  if (star) {
    if (vec == 16) return replica_sweep_kernel<true, 16>;
    if (vec == 4) return replica_sweep_kernel<true, 4>;
    if (vec == 1) return replica_sweep_kernel<true, 1>;
  } else {
    if (vec == 16) return replica_sweep_kernel<false, 16>;
    if (vec == 4) return replica_sweep_kernel<false, 4>;
    if (vec == 1) return replica_sweep_kernel<false, 1>;
  }
  return nullptr;
}

FloatKern float_kernel(int star) {
  if (star) return replica_sweep_float_kernel<true>;
  return replica_sweep_float_kernel<false>;
}

}  // namespace

// dynamic shared memory of a block of the launch on replica blocks of Nk
// spins: an integer base's or a float base's (is_float)
extern "C" size_t rrrmc_replica_sweep_smem(int Nk, int is_float) {
  return is_float ? float_smem(min(Nk, kFloatSpan))
                  : int_smem(min(Nk, kSpanMax));
}

// the most dynamic shared memory a block of this kernel may opt in to
extern "C" int rrrmc_replica_sweep_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// out[5]: registers, local bytes a thread, max threads a block, static
// shared bytes and the card's multiprocessors, of the instantiation
// (is_float, star, vec; vec is ignored for a float base)
extern "C" int rrrmc_replica_sweep_info(int is_float, int star, int vec,
                                        int device, int* out) {
  const void* k = is_float ? (const void*)float_kernel(star)
                           : (const void*)int_kernel(star, vec);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = sms;
  return 0;
}

// the plan (ops/replica_sweep.py::sweep_plan). is_float: f32 fields and
// couplings, kFloatChains chains a block, spans of kFloatSpan spins (SPAN;
// Nk below it), `vec` 4 where Nk % 4 == 0 and the rows are 16-byte
// aligned, else 1; else int32 fields and int8 couplings, kChains chains a
// block, spans of kSpanMax spins (Nk below it), J loads of `vec` bytes
extern "C" int rrrmc_replica_sweep(int8_t* sigma, void* lf, float* E,
                                   int32_t* acc, const void* J,
                                   const float* params, int Nk, int M, int B,
                                   int n_sweeps, float beta, uint32_t seed,
                                   uint32_t sweep0, uint32_t chain0,
                                   int is_float, int star, int vec,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Nk < 1) return (int)cudaErrorInvalidValue;
  if (is_float) {
    if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
    const FloatKern k = float_kernel(star);
    const int span = min(Nk, kFloatSpan);
    const size_t smem = float_smem(span);
    // above 48 KB a launch is refused unless the kernel opts in
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + kFloatChains - 1) / kFloatChains;
    k<<<blocks, 32 * kFloatChains, smem, st>>>(
        sigma, (float*)lf, E, acc, (const float*)J, params, Nk, M, B, span,
        n_sweeps, beta, seed, sweep0, chain0, vec == 4);
    return (int)cudaGetLastError();
  }
  const IntKern k = int_kernel(star, vec);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const int span = min(Nk, kSpanMax);
  const size_t smem = int_smem(span);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kChains - 1) / kChains;
  k<<<blocks, 32 * kChains, smem, st>>>(
      sigma, (int32_t*)lf, E, acc, (const int8_t*)J, params, Nk, M, B, span,
      n_sweeps, beta, seed, sweep0, chain0);
  return (int)cudaGetLastError();
}
