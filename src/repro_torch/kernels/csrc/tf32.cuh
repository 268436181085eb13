// Split-TF32 tensor-core helpers for the f32 variant of the flash
// backward, the f32 score both f32 flash kernels compute on the CUDA
// cores, and the rule that routes a flash call to a variant.
//
// An f32 operand x is split into TF32 terms: hi = rna(x), then the same of
// each exact remainder (x - hi is exact in f32).  Two terms hold x within
// 2^-22 |x|, three hold every bit.  A product a b is a sum of
// mma.sync.m16n8k8 TF32 products of terms with f32 sums, small terms
// first.  The tensor cores' own sums truncate, so the kernels sum each
// short run of products (one 8-deep step of a dP product, one key or row
// tile of a gradient product) from zero on the tensor cores and add it to
// f32 running sums: over a whole 256-deep product the truncation would
// leave several times more elements off an f64 result than plain f32 does
// (tests/test_torch_kernels.py emulates both).
//
// The scores S = Q K^T are not split: the backward recomputes p = exp(s -
// lse) against the forward's lse, so its s must be the forward's own bits
// (score_f32: the same FMA chain over the head dim).  Scores in the
// hundreds, as the reference's init gives, turn any other rounding of s
// into p off by its difference times one, and gradients far from an f64
// run where p is near one-hot (PERF.md).
//
// Fragment layouts (m16n8k8, lane l = 4 g + t): A a[0] (row g, k t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); B b0 (k t, column g),
// b1 (k t + 4, g); C as mma16816's (mma.cuh): c[0], c[1] at row g,
// columns 2t, 2t + 1, c[2], c[3] at row g + 8.  The sum over k does not
// care which of its 8 indices an element takes, so operands read by 64-bit
// loads use the paired k order: k t <-> element 2t, k t + 4 <-> 2t + 1.
//
// Shared-memory pitches (in floats) that keep every load free of bank
// conflicts: 4 mod 8 for row-major A and n-major B in the natural order
// (32-bit loads), for k-major B in the paired order (64-bit loads of two
// 8-column tiles) and for the scores' 128-bit loads; 8 mod 16 for A in the
// paired order (64-bit loads).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {

// The flash kernels' variants; flash_route picks one for a call and both
// C entries dispatch on it.
constexpr int kRouteCudaCores = 0;  // f32 or bf16 products on the CUDA cores
constexpr int kRouteBf16Tc = 1;     // bf16 mma.sync (mma.cuh)
constexpr int kRouteF32Tc = 2;      // the f32 backward: split TF32 mma.sync (this file)

// Whether every pointer (null counts) is on a 16-byte boundary, as
// cp.async's 16-byte copies need.
inline bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  const auto bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return bits % 16 == 0;
}

// bf16 rows of whole 16-element steps, and in the backward f32 rows of
// whole 8-element steps, head dims up to 256, every row on a 16-byte
// boundary; anything else takes the CUDA-core variant.  The f32 forward
// stays on the CUDA cores: its scores must round as plain f32's
// (flash_attention.cu says why).
inline int flash_route(int dtype, int D, const void* a, const void* b, const void* c,
                       const void* d, bool backward) {
  if (D <= 0 || D > 256 || !aligned16(a, b, c, d)) return kRouteCudaCores;
  if (dtype == kBFloat16 && D % 16 == 0) return kRouteBf16Tc;
  if (dtype == kFloat32 && D % 8 == 0 && backward) return kRouteF32Tc;
  return kRouteCudaCores;
}

// s + a . b over four elements as one FMA chain, x first: the step of the
// f32 score both f32 flash kernels take (their bits agree only so).
__device__ __forceinline__ float fma4(float s, float4 a, float4 b) {
  s = __fmaf_rn(a.x, b.x, s);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, in two integer operations.  The low 13
// bits of the result are zero.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// How many TF32 terms each operand of a product is split into, and which
// products of terms it takes: every pair (i, j) with i + j <= ORDER, the
// smallest first.
// - The gradient products (dS K, P^T dO, dS^T Q): hi + lo each and lo hi
//   + hi lo + hi hi, about 2^-21 of |a b|.
// - dP = dO V^T and its transpose: hi + lo and all four products, lo lo
//   too, within about 2^-21 of |a b| from the splits alone.  dS = p (dp -
//   delta) cancels where p is one-hot; with three products the 2-layer
//   gemma-2b f32 gradient check came within 2.4% of its bound (PERF.md).
constexpr int kTerms = 2, kOrder = 1;
constexpr int kScoreTerms = 2, kScoreOrder = 2;

// t[i][n]: term i of x[n] (hi first); each remainder is exact in f32
template <int T, int N>
__device__ __forceinline__ void split_tf32(const float* x, unsigned (*t)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float r = x[n];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      t[i][n] = tf32_rna(r);
      r -= __uint_as_float(t[i][n]);
    }
  }
}

// c (16x8 f32) += a (16x8 tf32, row-major) b (8x8 tf32, column-major)
__device__ __forceinline__ void mma1688(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b from splits into TA and TB terms: the products of terms (i, j),
// i + j <= ORDER, smallest first.  SWAP takes them in the order the same
// product with a and b exchanged would (a transposed score then sums as
// the score itself does).
template <int TA, int TB, int ORDER, bool SWAP = false>
__device__ __forceinline__ void mma_split(float* c, const unsigned (*a)[4],
                                          const unsigned (*b)[2]) {
#pragma unroll
  for (int o = ORDER; o >= 0; --o)
#pragma unroll
    for (int n = 0; n < TA; ++n) {
      const int i = SWAP ? n : TA - 1 - n, j = o - i;
      if (j >= 0 && j < TB) mma1688(c, a[i], b[j][0], b[j][1]);
    }
}

// A (16 x 8) at rows m0 .., columns k0 .. of a row-major f32 tile, natural
// k order (pitch 4 mod 8)
__device__ __forceinline__ void lda_f32(float* a, const float* tile, int ld, int m0, int k0,
                                        int lane) {
  const float* p = tile + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// The same in the paired k order (pitch 8 mod 16): two 64-bit loads
__device__ __forceinline__ void lda_f32_paired(float* a, const float* tile, int ld, int m0, int k0,
                                               int lane) {
  const float* p = tile + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * ld);
  a[0] = x.x;
  a[2] = x.y;
  a[1] = y.x;
  a[3] = y.y;
}

// B (8 x 8) of columns n0 .. from a tile stored n-major (row n holds B's
// column n: K rows in Q K^T), natural k order (pitch 4 mod 8)
__device__ __forceinline__ void ldb_f32_nmajor(float* b, const float* tile, int ld, int n0, int k0,
                                               int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  b[0] = p[0];
  b[1] = p[4];
}

// B of two 8-column tiles from a tile stored k-major (row k holds B's row
// k: K rows in dS K, dO and Q rows in P^T dO and dS^T Q), in the paired k
// order (rows k0 + 2t and + 1; pitch 4 mod 8).  Tile 0 takes columns
// n0 + 2i, tile 1 columns n0 + 2i + 1 (i < 8): b[0] = tile 0's (b0, b1),
// b[1] tile 1's.  Their C tiles then hold columns n0 + 4t .. + 3 of rows g
// and g + 8 in one lane (c_pair_row).
__device__ __forceinline__ void ldb_f32_kmajor_pair(float (*b)[2], const float* tile, int ld,
                                                    int n0, int k0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + 2 * (lane >> 2);
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(p + ld);
  b[0][0] = x.x;
  b[1][0] = x.y;
  b[0][1] = y.x;
  b[1][1] = y.y;
}

// Columns n0 + 4t .. + 3 of row g (h = 0) or g + 8 (h = 1) of a pair of C
// tiles from ldb_f32_kmajor_pair's B
__device__ __forceinline__ float4 c_pair_row(const float* c0, const float* c1, int h) {
  return make_float4(c0[2 * h], c1[2 * h], c0[2 * h + 1], c1[2 * h + 1]);
}

// s[j] += A B^T for rows m0 .. m0 + 15 of A (row-major in `a`) and the N
// 8-row tiles j of `bt` (n-major: rows 8 j ..), over depth D (a multiple
// of 8), both f32 of pitch ld (4 mod 8), in kScoreTerms terms (the dP
// products; SWAP: a transposed one, A the keys).  Each 8-deep step is one
// run: its products sum from zero on the tensor cores and are added to s
// in f32.
template <int N, bool SWAP = false>
__device__ __forceinline__ void scores_tf32(float (&s)[N][4], const float* a, const float* bt,
                                            int ld, int m0, int D, int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    float x[4];
    unsigned at[kScoreTerms][4];
    lda_f32(x, a, ld, m0, k0, lane);
    split_tf32<kScoreTerms, 4>(x, at);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float y[2];
      unsigned bt2[kScoreTerms][2];
      ldb_f32_nmajor(y, bt, ld, 8 * j, k0, lane);
      split_tf32<kScoreTerms, 2>(y, bt2);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_split<kScoreTerms, kScoreTerms, kScoreOrder, SWAP>(c, at, bt2);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += c[e];
    }
  }
}

// s[j][2 h + e] = the f32 score of row m0 + g + 8 h of `a` and row 8 j +
// 2 t + e of `b` (lane 4 g + t), both rows of pitch ld (4 mod 8) in shared
// memory: the FMA chain over the head dim D (a multiple of 4) from zero,
// fma4's, in an m16n8 accumulator's layout.  The CUDA-core forward's
// chain for the same row and key, so the same bits.
template <int N>
__device__ __forceinline__ void scores_f32(float (&s)[N][4], const float* a, const float* b,
                                           int ld, int m0, int D, int lane) {
  const float* pa = a + (m0 + (lane >> 2)) * ld;
  const float* pb = b + 2 * (lane & 3) * ld;
#pragma unroll
  for (int j = 0; j < N; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(pa + d);
    const float4 a1 = *reinterpret_cast<const float4*>(pa + 8 * ld + d);
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 bv = *reinterpret_cast<const float4*>(pb + (8 * j + e) * ld + d);
        s[j][e] = fma4(s[j][e], a0, bv);
        s[j][2 + e] = fma4(s[j][2 + e], a1, bv);
      }
  }
}

}  // namespace repro
