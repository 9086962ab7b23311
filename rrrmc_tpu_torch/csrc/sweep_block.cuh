// The block-synchronous parts of the dense sweep kernels (sk_sweep.cu,
// replica_sweep.cu): a block's chains, one warp each, decide the same span
// of sites; at the span's end they meet at a block barrier and the block
// commits every chain's accepted flips at once, with int8 tensor cores:
//
//   lf[c, off + n] += sum_k dlt[c, k] J[col0 + k, n]   (n < nrows)
//
// dlt [C, sp] int8 in shared memory holds -2 s_old of each accepted flip of
// the span (0 elsewhere, and past the span), J is a symmetric int8 matrix,
// so J[col0 + k, n] = J[n, col0 + k] and both operands are read K-major from
// their rows: the chains' rows of dlt, and J's rows n. The sums are exact
// int32, so the commit equals the sequential one bit for bit.
//
// One warp computes a 16-row tile of n for every chain of the block, with
// mma.sync.m16n8k32 (A = 16 rows of J by 32 sites, B = 32 sites by 8
// chains). The order in which a dot product visits its K terms is free, so
// each lane reads 16 consecutive sites of a J row with one 16-byte load:
// lane (g, t) (g = lane / 4, t = lane % 4) loads sites 16t..16t+15 of a
// 64-site chunk from rows n0 + g and n0 + g + 8, and sites 16t..16t+3 and
// 16t+4..16t+7 become its k = 4t..4t+3 and 16+4t..16+4t+3 of the first
// product, 16t+8..16t+15 those of the second. Its B fragment is the same
// 16 bytes of its chain's row of dlt (chain g of the tile), so A and B agree
// on which site each k is. tests/torch_port_helpers.py::
// blocked_commit_reference models the tiles in torch.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace rrrmc {

// the most accepted flips of a block and span that `commit_rows` commits
// (the tensor-core product reads all of J's span columns whatever the
// flips; a near-frozen sweep has about one flip a block and span)
constexpr int kRowFlips = 4;
// sites of one K chunk of the commit (two m16n8k32 products)
constexpr int kChunk = 64;
// the longest span of the integer kernels (the span's diagonal block of J,
// span x span int8, lives in shared memory); a span is kSpanMax sites, or
// the whole row below it
constexpr int kSpanMax = 256;
// chains (warps) of a block of the integer kernels: the commit reads each
// tile of J once for all of them (two 8-chain tiles of the product)
constexpr int kChains = 16;

// the stride of a span's per-chain arrays: the span rounded up to a chunk
__host__ __device__ inline int span_stride(int span) {
  return (span + kChunk - 1) / kChunk * kChunk;
}

// row[c .. c + 15] as four little-endian words, zero past `ncols`. VEC: the
// loads the row's alignment allows (16 bytes: row + c 16-byte aligned; 4:
// 4-byte aligned; 1: bytes)
template <int VEC>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row, int c,
                                        int ncols) {
  if (c + 16 <= ncols) {
    if (VEC == 16) return __ldg(reinterpret_cast<const uint4*>(row + c));
    if (VEC == 4) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row + c);
      return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < ncols)
      w[i >> 2] |= (uint32_t)(uint8_t)__ldg(row + c + i) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// d += A B on the int8 tensor cores: A 16 x 32 (row), B 32 x 8 (col)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the span's diagonal block of J into shared memory, by the whole block:
// Jd[r * sp + c] = J[(s0 + r) * ld + s0 + c] for r < len, zero for
// len <= c < sp (row s0 + r's sites past the span). With 16-byte rows
// (VEC == 16, so len % 16 == 0) the copies are cp.async, in flight while
// the warps load their chains' spans: `wait_diag` before the block's
// barrier completes them
template <int VEC>
__device__ void load_diag(int8_t* __restrict__ Jd, int sp,
                          const int8_t* __restrict__ J, int ld, int s0,
                          int len) {
  const int per_row = sp / 16;
  for (int i = threadIdx.x; i < len * per_row; i += blockDim.x) {
    const int r = i / per_row, c = 16 * (i - r * per_row);
    if constexpr (VEC == 16) {
      // 0 bytes read past the span: the 16 are zero-filled
      const int bytes = c < len ? 16 : 0;
      const int8_t* src = bytes ? J + (size_t)(s0 + r) * ld + s0 + c : J;
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(Jd + r * sp + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :
                   : "r"(dst), "l"(src), "r"(bytes)
                   : "memory");
    } else {
      *reinterpret_cast<uint4*>(Jd + r * sp + c) =
          load16<VEC>(J + (size_t)(s0 + r) * ld + s0, c, len);
    }
  }
}

// the thread's copies of `load_diag` done (before the block's barrier)
template <int VEC>
__device__ __forceinline__ void wait_diag() {
  if constexpr (VEC == 16) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[0 .. len) = src[0 .. len), spins (int8) or fields (4-byte T) of a
// chain's span between its row and shared memory, by its warp: 4 a lane
// and access where VEC >= 4 (the rows hold a multiple of 4, 16-byte aligned
// for the fields and 4-byte for the spins; len % 4 == 0), else one
template <int VEC, typename T>
__device__ __forceinline__ void copy_row(T* __restrict__ dst,
                                         const T* __restrict__ src, int len,
                                         int lane) {
  if constexpr (VEC >= 4) {
    using V = typename std::conditional<sizeof(T) == 1, uint32_t, uint4>::type;
    for (int k = 4 * lane; k < len; k += 128)
      *reinterpret_cast<V*>(dst + k) = *reinterpret_cast<const V*>(src + k);
  } else {
    for (int k = lane; k < len; k += 32) dst[k] = src[k];
  }
}

// lfw[k] += d * Jd_row[k] for k from the 4-site group of `from` to the
// span's end, by the warp (an accepted flip's correction of the span's
// later fields; earlier sites of the group are decided and never read
// again). lfw: int32 [sp], 16-byte aligned; Jd_row: int8 [sp]
__device__ __forceinline__ void correct_span(int32_t* __restrict__ lfw,
                                             const int8_t* __restrict__ Jd_row,
                                             int32_t d, int from, int len,
                                             int lane) {
  const char4* jr = reinterpret_cast<const char4*>(Jd_row);
  int4* l4 = reinterpret_cast<int4*>(lfw);
  for (int q = (from >> 2) + lane; q < (len + 3) >> 2; q += 32) {
    const char4 j = jr[q];
    int4 v = l4[q];
    v.x += d * (int32_t)j.x;
    v.y += d * (int32_t)j.y;
    v.z += d * (int32_t)j.z;
    v.w += d * (int32_t)j.w;
    l4[q] = v;
  }
}

// lf[ch, off + n] and lf[ch, off + n + 8] (0 past B or nrows): a tile's
// fields, loaded before its product so that the loads overlap J's. The
// fields are read and written once a commit: streaming loads and stores
// (evict first), so that J's rows stay in L2 for the other blocks
__device__ __forceinline__ int2 get_rows(const int32_t* __restrict__ lf,
                                         size_t lf_ld, int off, int n,
                                         int nrows, int ch, int B) {
  int2 v = make_int2(0, 0);
  if (ch >= B) return v;
  const int32_t* r = lf + (size_t)ch * lf_ld + off + n;
  if (n < nrows) v.x = __ldcs(r);
  if (n + 8 < nrows) v.y = __ldcs(r + 8);
  return v;
}

// lf[ch, off + n] = v.x + lo and lf[ch, off + n + 8] = v.y + hi, within B
// and nrows
__device__ __forceinline__ void put_rows(int32_t* __restrict__ lf,
                                         size_t lf_ld, int off, int n,
                                         int nrows, int ch, int B, int2 v,
                                         int lo, int hi) {
  if (ch >= B) return;
  int32_t* r = lf + (size_t)ch * lf_ld + off + n;
  if (n < nrows) __stcs(r, v.x + lo);
  if (n + 8 < nrows) __stcs(r + 8, v.y + hi);
}

// the commit of the module comment, by the block's warps over 16-row tiles
// of n. lf: int32 rows of lf_ld entries, chain cb + c's row at
// (cb + c) * lf_ld; J: int8 [nrows][ld] (ld = its columns); dlt: [C][sp]
// (C = kChains); live0 / live1: chain tile 0 / 1 (chains 0..7 / 8..15 of
// the block) has an accepted flip. Chains at or past B and rows at or past
// nrows are neither read nor written.
template <int VEC>
__device__ void commit_mma(int32_t* __restrict__ lf, size_t lf_ld, int off,
                           const int8_t* __restrict__ J, int ld, int nrows,
                           int col0, int len, const int8_t* __restrict__ dlt,
                           int sp, int cb, int B, bool live0, bool live1,
                           int warp, int nwarps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int nchunks = (len + kChunk - 1) / kChunk;
  for (int n0 = 16 * warp; n0 < nrows; n0 += 16 * nwarps) {
    const int8_t* ra = J + (size_t)min(n0 + g, nrows - 1) * ld;
    const int8_t* rb = J + (size_t)min(n0 + g + 8, nrows - 1) * ld;
    // D: (row n0 + g, chains 2t, 2t + 1) and (row n0 + g + 8, the same)
    const int ch = cb + 2 * t, n = n0 + g;
    int2 f00 = make_int2(0, 0), f01 = f00, f10 = f00, f11 = f00;
    if (live0) {
      f00 = get_rows(lf, lf_ld, off, n, nrows, ch, B);
      f01 = get_rows(lf, lf_ld, off, n, nrows, ch + 1, B);
    }
    if (live1) {
      f10 = get_rows(lf, lf_ld, off, n, nrows, ch + 8, B);
      f11 = get_rows(lf, lf_ld, off, n, nrows, ch + 9, B);
    }
    int acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kc = 0; kc < kSpanMax / kChunk; ++kc) {
      if (kc < nchunks) {
        const int c = 16 * t + kChunk * kc;
        const uint4 a = load16<VEC>(ra, col0 + c, ld);
        const uint4 h = load16<VEC>(rb, col0 + c, ld);
        if (live0) {
          const uint4 d = *reinterpret_cast<const uint4*>(dlt + g * sp + c);
          mma_s8(acc0, a.x, h.x, a.y, h.y, d.x, d.y);
          mma_s8(acc0, a.z, h.z, a.w, h.w, d.z, d.w);
        }
        if (live1) {
          const uint4 d =
              *reinterpret_cast<const uint4*>(dlt + (8 + g) * sp + c);
          mma_s8(acc1, a.x, h.x, a.y, h.y, d.x, d.y);
          mma_s8(acc1, a.z, h.z, a.w, h.w, d.z, d.w);
        }
      }
    }
    if (live0) {
      put_rows(lf, lf_ld, off, n, nrows, ch, B, f00, acc0[0], acc0[2]);
      put_rows(lf, lf_ld, off, n, nrows, ch + 1, B, f01, acc0[1], acc0[3]);
    }
    if (live1) {
      put_rows(lf, lf_ld, off, n, nrows, ch + 8, B, f10, acc1[0], acc1[2]);
      put_rows(lf, lf_ld, off, n, nrows, ch + 9, B, f11, acc1[1], acc1[3]);
    }
  }
}

// the same commit for a span with at most kRowFlips flips in the block:
// the flips' rows of J, lf[cb + c, off + n] += dlt[c, k] J[col0 + k, n],
// chain by chain, the block's threads over n (4 fields a thread where VEC
// allows it: lf's rows then are 16-byte aligned too). flipped[c]: chain
// c's flips in the span
template <int VEC>
__device__ void commit_rows(int32_t* __restrict__ lf, size_t lf_ld, int off,
                            const int8_t* __restrict__ J, int ld, int nrows,
                            int col0, int len, const int8_t* __restrict__ dlt,
                            int sp, int cb, int C, const int* flipped,
                            int warp, int lane) {
  constexpr int W = VEC >= 4 ? 4 : 1;  // fields a thread
  for (int c = 0; c < C; ++c) {
    if (flipped[c] == 0) continue;
    const int8_t* dc = dlt + c * sp;
    int32_t* lr = lf + (size_t)(cb + c) * lf_ld + off;
    // a warp-uniform loop: every lane reaches the ballots
    for (int n0 = W * 32 * warp; n0 < nrows; n0 += W * blockDim.x) {
      const int n = n0 + W * lane;
      int4 a = make_int4(0, 0, 0, 0);
      for (int g = 0; g < len; g += 32) {
        unsigned m = __ballot_sync(0xffffffffu,
                                   g + lane < len && dc[g + lane] != 0);
        while (m && n < nrows) {
          const int k = g + __ffs(m) - 1;
          m &= m - 1;
          const int32_t d = dc[k];
          const int8_t* jr = J + (size_t)(col0 + k) * ld + n;
          if constexpr (W == 4) {
            const char4 j = __ldg(reinterpret_cast<const char4*>(jr));
            a.x += d * j.x;
            a.y += d * j.y;
            a.z += d * j.z;
            a.w += d * j.w;
          } else {
            a.x += d * __ldg(jr);
          }
        }
      }
      if (n >= nrows) continue;
      if constexpr (W == 4) {
        int4* p = reinterpret_cast<int4*>(lr + n);
        int4 v = *p;
        v.x += a.x;
        v.y += a.y;
        v.z += a.z;
        v.w += a.w;
        *p = v;
      } else {
        lr[n] += a.x;
      }
    }
  }
}

}  // namespace rrrmc
