// bf16 tensor-core helpers shared by the port's kernels (flash forward,
// flash backward, dense decode, the mLSTM forward and backward): ldmatrix
// loads of 8x8 bf16 matrices from shared memory and the mma.sync.m16n8k16
// product with f32 sums, in the sm_80+ fragment layouts that Hopper keeps.
#pragma once

#include "common.cuh"

namespace repro {

using bf16 = __nv_bfloat16;

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// one row of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row-major) b (16x8 bf16, column-major).
// Lane l = 4 g + t holds c[0], c[1] at row g, columns 2t, 2t + 1 and c[2],
// c[3] at row g + 8.
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A (16 x 16) at rows m0 .., columns k0 .. of a row-major bf16 tile.
__device__ __forceinline__ void load_a(unsigned* a, const bf16* tile, int ld, int m0, int k0,
                                       int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B of two adjacent 8-column blocks n0 .. n0 + 15 from a tile stored
// n-major (row n holds B's column n: K and Q rows in the score products).
// b[0], b[1]: columns n0 ..; b[2], b[3]: n0 + 8 ..
__device__ __forceinline__ void load_b_nmajor(unsigned* b, const bf16* tile, int ld, int n0,
                                              int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// The same from a tile stored k-major (row k holds B's row k: dO, Q and K
// rows in the gradient products).
__device__ __forceinline__ void load_b_kmajor(unsigned* b, const bf16* tile, int ld, int n0,
                                              int k0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// The A fragments (16 rows x 16 keys) of probabilities held in two m16n8
// accumulator tiles, keys 0-7 (s0) and 8-15 (s1) of a k-step, re-packed in
// registers and split into bf16 hi + lo parts: hi + lo keeps about 16 bits
// of p.  a[0]: row g, keys 2t ..; a[1]: row g + 8; a[2], a[3]: keys 8 + 2t.
__device__ __forceinline__ void p_frags_hi_lo(const float* s0, const float* s1, unsigned* ah,
                                              unsigned* al) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* src = (i < 2 ? s0 : s1) + 2 * (i & 1);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
    const float2 hf = __bfloat1622float2(hi);
    ah[i] = *reinterpret_cast<const unsigned*>(&hi);
    al[i] = pack_bf16(src[0] - hf.x, src[1] - hf.y);
  }
}

// One online-softmax step over N m16n8 accumulator tiles of scaled scores
// (masked entries hold `mask`): a lane holds rows g (elements 0, 1) and
// g + 8 (2, 3), and the four lanes of a quad hold a row, so its max and sum
// take two shuffles.  Turns s into p = exp(s - m_new) (0 where masked),
// updates the rows' running max m and sum l, and returns in corr the
// factor exp(m_old - m_new) that rescales their accumulators.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N][4], float* m, float* l, float* corr,
                                             float mask) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = mask;
#pragma unroll
    for (int j = 0; j < N; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    corr[h] = expf(m[h] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = s[j][e] > mask ? expf(s[j][e] - m_new) : 0.f;
        s[j][e] = p;
        psum += p;
      }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l[h] = l[h] * corr[h] + psum;
    m[h] = m_new;
  }
}

// ----------------------------------------------- mLSTM's split products
//
// Shared by the mLSTM forward (csrc/mlstm_chunk.cu) and backward
// (csrc/mlstm_chunk_bwd.cu): f32 operands in three bf16 terms and short
// runs of tensor-core sums added in f32.

// acc[i] += part[i] for the first n of N m16n8 accumulator tiles, in f32
// (rounded to nearest).  The kernels add each short run of mma.sync sums
// (a 64-wide dk step, or one k step) to running f32 sums this way: the
// tensor cores' own accumulation truncates, which over long runs leaves
// more of xlstm's cancelling normalizers off their f64 value than f32
// sums do.
template <int N>
__device__ __forceinline__ void add_tiles(float (&acc)[N][4], const float (&part)[N][4], int n) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= n) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
  }
}

// x0, x1 split into three bf16 terms hi + mid + lo, which hold all 24
// bits of an f32 (each remainder is exact in f32), as bf16 pairs x[0..2].
__device__ __forceinline__ void split3(float x0, float x1, unsigned* x) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hi);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mid);
  x[0] = *reinterpret_cast<const unsigned*>(&hi);
  x[1] = *reinterpret_cast<const unsigned*>(&mid);
  x[2] = pack_bf16(r0 - mf.x, r1 - mf.y);
}

// The A fragments (16 rows x 16 columns) of f32 values held in two m16n8
// accumulator tiles, columns 0-7 (s0) and 8-15 (s1) of a k-step, re-packed
// in registers in three bf16 terms: a[r][0..3] is term r (hi, mid, lo).
__device__ __forceinline__ void frags3(const float* s0, const float* s1, unsigned (*a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* src = (i < 2 ? s0 : s1) + 2 * (i & 1);
    unsigned x[3];
    split3(src[0], src[1], x);
    a[0][i] = x[0];
    a[1][i] = x[1];
    a[2][i] = x[2];
  }
}

// A (16 x 16) at rows m0 .., columns k0 .. of A, from a tile stored
// k-major (row k holds A's column k: the v rows in the state update).
__device__ __forceinline__ void load_a_kmajor(unsigned* a, const bf16* tile, int ld, int m0, int k0,
                                              int lane) {
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8);
}

// Rows [0, rows) x COLS bf16 columns from src (row r at src + r * stride)
// into a shared tile (rows of `pitch`); zero where r >= rvalid or the
// column >= cvalid.  With `vec`, by cp.async in 16-byte pieces (cvalid a
// multiple of 8, src 16-byte aligned); otherwise by plain loads and stores.
template <int COLS = 64>
__device__ __forceinline__ void stage_rows(bf16* dst, int pitch, const bf16* src, long long stride,
                                           int rows, int rvalid, int cvalid, bool vec, int tid,
                                           int nthreads) {
  constexpr int kPieces = COLS / 8;
  if (vec) {
    for (int i = tid; i < rows * kPieces; i += nthreads) {
      const int r = i / kPieces, c8 = (i % kPieces) * 8;
      const bool ok = r < rvalid && c8 < cvalid;
      cp_async16(dst + r * pitch + c8, ok ? src + r * stride + c8 : src, ok);
    }
  } else {
    for (int i = tid; i < rows * COLS; i += nthreads) {
      const int r = i / COLS, col = i % COLS;
      dst[r * pitch + col] =
          r < rvalid && col < cvalid ? src[r * stride + col] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace repro
