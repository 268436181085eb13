// Chunkwise-parallel stabilized mLSTM, backward, for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/mlstm_chunk.py::mlstm_chunk with
// respect to q, k, v, log_i and log_f (the Pallas TPU kernel has no
// backward; the reference differentiates its chunk recurrence,
// src/repro/models/recurrent.py:314-376, by XLA).  The forward
// (csrc/mlstm_chunk.cu) is, per (batch, head) and chunk with the carry
// (C, n, m) entering it, q scaled by 1/sqrt(dk):
//   D_ij = cs_i - cs_j + li_j (j <= i),  m_i = max(max_j D_ij, cs_i + m),
//   E_ij = exp(D_ij - m_i),  W_ij = (q_i . k_j) E_ij,  inter_i = exp(cs_i + m - m_i),
//   num_i = sum_j W_ij v_j + inter_i q_i C,  den_i = sum_j W_ij + inter_i q_i . n,
//   h_i = num_i / max(|den_i|, exp(-m_i)),
//   C' = decay C + sum_j w_j k_j v_j^T,  n' = decay n + sum_j w_j k_j,
// with w_j = exp(total - cs_j + li_j - m'), decay = exp(m + total - m').
// Every stabilizer cancels out of h on both branches of the max (num and
// den carry exp(-m_i), the carry exp(-m)), so the backward holds them
// constant: the exact gradient of the function.  It takes the forward's
// branch from the den the forward wrote (max(|den|, exp(-m_i)) is
// recomputed from it and the recomputed m_i, which has the forward's bits:
// the same cumsum, csrc/mlstm.cuh, and an exact max); den is never
// recomputed.
//
// Walking the chunks in reverse, the gradient G of the carry C and dn of n
// move as
//   G_t = decay_t G_{t+1} + sum_i inter_i q_i^T dnum_i,  dnum_i = dh_i / lim_i,
//   dn_t = decay_t dn_{t+1} + sum_i dden_i inter_i q_i,  dden_i = -(dh_i . h_i) / den_i
// (dden_i = 0 where the max took exp(-m_i)), and each chunk, given the carry
// C_t entering it (the forward's workspace) and G_{t+1}, dn_{t+1}, gives
//   dW_ij = dnum_i . v_j + dden_i,  dS_ij = dW_ij E_ij,  dD_ij = dW_ij W_ij,
//   dq_i = sum_j dS_ij k_j + inter_i C dnum_i + dden_i inter_i n,
//   dk_j = sum_i dS_ij q_i + w_j (G_{t+1} v_j + dn_{t+1}),
//   dv_j = sum_i W_ij dnum_i + w_j G_{t+1}^T k_j,
//   dinter_i = q_i . (C dnum_i) + dden_i q_i . n,  dw_j = k_j . (G_{t+1} v_j + dn_{t+1}),
//   ddecay = <G_{t+1}, C> + dn_{t+1} . n,
// and the gates' gradients from these through cs (a cumsum of log_f),
// total = cs_{c-1}, D, inter, w and decay.
//
// What bounds it on the H100: operations.  At xlstm-125m's (2, 1024, 4,
// 384), chunk 128, five products of c^2 dk / 2 (S = q k^T, dnum v^T, dS k,
// dS^T q, W^T dnum) and four of c dk^2 (C dnum, G v, G^T k, and the move of
// G) a chunk and head: 11.4 GFLOP, 0.0115 ms at the bf16 tensor-core rate,
// against 101 MB of inputs, carries and outputs (0.030 ms at 3.35 TB/s).
//
// Design, bf16 inputs (f32 inputs take the CUDA cores: at the end): every
// matrix product on mma.sync m16n8k16 with f32 sums (mma.cuh), every operand
// as bf16 terms.  q, k and v in bf16 are exact and enter as one term; every
// f32 operand (dnum, the moved carry gradient's inter-weighted dnum, dS, W,
// C, G) as three terms hi + mid + lo, which hold all 24 bits (two terms leave the
// products 10 to 40 times farther from f64 than f32 sums:
// tests/test_torch_kernels.py emulates both).  An f32 x f32 product takes
// the six term products of order <= 2 (hi hi, hi mid, mid hi, hi lo, lo hi,
// mid mid), an f32 x bf16 one three (mma_terms' order); each 16-deep k-step's
// term products are summed by the tensor cores and then added to f32
// running sums, since the tensor cores' own accumulation truncates.  Row
// scalars stay on the f32 side (G += q^T (scale inter o dnum); the
// 1/sqrt(dk) scale multiplies f32 sums), so the bf16 side stays one exact
// term.  Elementwise and cancelling work (dW, dS, dD, the sums of dD,
// dden, dinter, dw, ddecay) stays in f32 registers.  W = S o E is never
// exponentiated, so a recomputed S that rounds apart from the forward's
// meets no saved quantity (unlike the flash backward's scores, which meet
// the forward's lse); m_i, lim_i and the branch come from the forward's den
// as above.  Six passes on the caller's stream, no atomics, every sum in one
// fixed order, so two launches give equal bits:
// - rows, per (batch x head, chunk, 16 rows): each row's m_i, inter_i,
//   lim_i, dden_i (dh . h summed by a warp), w_i and the chunk's decay; dnum
//   and u = scale inter dnum split into bf16 planes, so every later pass
//   copies its operands with 16-byte cp.async;
// - moves, per (batch x head, chunk 1 .., 64 x 64 tile of G^T): each
//   chunk's move of the carry gradient, U_t = u^T q over its positions, on
//   the tensor cores (and of dn, on the CUDA cores); the chunks' moves are
//   independent, so these blocks fill the card;
// - state, per (batch x head, 64 x 64 tile of G^T): the reverse walk above,
//   G_t = decay_t G_{t+1} + U_t elementwise, writing G_{t+1} and dn_{t+1}
//   for every chunk, and this tile's share of ddecay; it holds G^T in the
//   accumulator layout in which the forward's state pass held C^T, so G is
//   written, and meets C_t, in the workspace's 16-byte fragment pieces;
// - scores, per (batch x head, chunk, two 16-row tiles paired as i and 7 - i
//   so every block has the same causal work): S = q k^T and P = dnum v^T
//   over dk, then W, dS (written as bf16 planes), rowD and this block's
//   share of colD;
// - grads, per (batch x head, chunk, dq | dk | dv, 64 columns): first the
//   carry's product over dk (C dnum, G v or G^T k; C or G split into bf16
//   planes as it is copied from its fragment order) and its share of dinter or
//   dw, then the chunk's product over positions (dS k, dS^T q or W^T dnum)
//   added to it; dq, dk, dv written in q's dtype, rounded to nearest;
//   the scores' and the grads' staged steps flow through two buffers (the
//   next copied by cp.async while this one is multiplied);
// - gates, per (batch x head, chunk): the partials summed in order, then
//   dlog_i and dlog_f (a reverse cumsum).
// Any dk up to 512 and any chunk up to 128; tiles past dk or c are
// zero-filled.
#include <cstdint>

#include "mlstm.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;         // state and grads passes
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;                // column tile of dk, depth of a staged step
constexpr int kP = kT + 8;            // bf16 pitch of 64-wide shared rows (144 bytes)
constexpr int kPC = kMaxChunk + 8;    // bf16 pitch of chunk-wide shared rows (272 bytes)
constexpr int kScoreWarps = 2;        // scores pass: 16-row tiles a block
constexpr int kScoreBlocks = 4;       // scores pass: blocks a chunk
constexpr int kRowGroup = 16;         // rows pass: rows a block
constexpr int kRowWarps = 4;
constexpr int kUnit = 256;            // floats in a 16 x 16 unit of the bf16 workspace

// bf16 terms of an input: bf16 is exact, f32 takes three
template <typename T>
__host__ __device__ constexpr int terms_of() {
  return sizeof(T) == 2 ? 1 : 3;
}

// The row of (batch b, the first position of chunk `chunk`, head hh) in the
// (B, S, H) arrays; position j of the chunk is H rows on.
__device__ __forceinline__ long long chunk_row(int b, int S, int chunk, int c, int H, int hh) {
  return (static_cast<long long>(b) * S + static_cast<long long>(chunk) * c) * H + hh;
}

struct Shape {
  int S, H, dk, c, nc, dkp, cp, ntile;  // dkp, cp: dk and c rounded up to 16
  long long rows, P;                    // B * S * H rows, B * H * nc chunks
  float scale;
};

// Scratch: f32 per row (mi, inter, dden, w, rowD), per chunk (decay),
// the partials (colD per scores block, dinter and dw per column tile,
// ddecay per state tile), dn_{t+1} per chunk (dkp floats), each chunk's
// moves U (per state tile, in its accumulators' order) and un, and G_{t+1}
// per chunk (dkp^2 floats in the mma fragment order of the forward's bf16
// workspace); bf16 planes (three terms, each rows x dkp) of dnum and u; per
// chunk the planes of W and dS (cp x cp).
struct Scratch {
  float *mi, *inter, *dden, *w, *rowD, *decay, *colD, *pinter, *pw, *pdecay, *dn, *U, *un, *G;
  bf16 *dnum, *u, *W, *dS;
};

// An operand in bf16 planes: term t of row r at p + t * plane + r * pitch,
// `cols` valid columns a row (zero past dk in the planes), rows 16-byte
// aligned when `vec`.
struct Op {
  const bf16* p;
  long long plane;
  int pitch, cols;
  bool vec;
};

// Rows [0, rows) x COLS of `terms` planes of an operand into shared tiles
// (rows of `ld`, planes `dplane` apart): shared row r takes source row
// row_of(r) (valid when < rvalid) at src + row_of(r) * rstride, zero past
// rvalid or cvalid columns; 16-byte cp.async pieces with `vec`, else
// element by element.  The caller commits and waits.
template <int COLS, typename RowOf>
__device__ __forceinline__ void stage(bf16* dst, int ld, int dplane, const bf16* src,
                                      long long splane, long long rstride, int terms, int rows,
                                      RowOf row_of, int rvalid, int cvalid, bool vec, int tid,
                                      int nthreads) {
  constexpr int kPieces = COLS / 8;
  for (int tt = 0; tt < terms; ++tt) {
    bf16* d = dst + tt * dplane;
    const bf16* s = src + tt * splane;
    if (vec) {
#pragma unroll 1
      for (int i = tid; i < rows * kPieces; i += nthreads) {
        const int r = i / kPieces, c8 = (i % kPieces) * 8, sr = row_of(r);
        const bool ok = sr < rvalid && c8 < cvalid;
        cp_async16(d + r * ld + c8, ok ? s + sr * rstride + c8 : s, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < rows * COLS; i += nthreads) {
        const int r = i / COLS, col = i % COLS, sr = row_of(r);
        d[r * ld + col] =
            sr < rvalid && col < cvalid ? s[sr * rstride + col] : __float2bfloat16(0.f);
      }
    }
  }
}
struct Same {
  __device__ int operator()(int r) const { return r; }
};

// Three bf16 terms of the pair (x0, x1) into planes at p (+ plane, + 2 plane).
__device__ __forceinline__ void put3(bf16* p, long long plane, float x0, float x1) {
  unsigned x[3];
  split3(x0, x1, x);
#pragma unroll
  for (int r = 0; r < 3; ++r) *reinterpret_cast<unsigned*>(p + r * plane) = x[r];
}

// TA x TB term fragments of one 16-deep k-step: A (16 x 16), and B's
// 8-column block `half` of a load_b_* pair.
template <int TA>
__device__ __forceinline__ void load_a_terms(unsigned (&a)[TA][4], const bf16* s, int ld, int plane,
                                             int m0, int k0, int lane, bool kmajor) {
#pragma unroll
  for (int r = 0; r < TA; ++r) {
    if (kmajor)
      load_a_kmajor(a[r], s + r * plane, ld, m0, k0, lane);
    else
      load_a(a[r], s + r * plane, ld, m0, k0, lane);
  }
}
template <int TB>
__device__ __forceinline__ void load_b_terms(unsigned (&b)[TB][4], const bf16* s, int ld, int plane,
                                             int n0, int k0, int lane, bool kmajor) {
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    if (kmajor)
      load_b_kmajor(b[r], s + r * plane, ld, n0, k0, lane);
    else
      load_b_nmajor(b[r], s + r * plane, ld, n0, k0, lane);
  }
}

// acc (an m16n8 tile) += mul * (the term products x, y of order x + y <=
// max(TA, TB) - 1, summed by the tensor cores): one k-step's run, added in
// f32.  The products go by B's term y from the smallest, then by A's term x
// from the smallest: (0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0) for
// three terms each.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float* acc, const unsigned (&a)[TA][4],
                                          const unsigned (&b)[TB][4], int half, float mul = 1.f) {
  constexpr int kOrder = (TA > TB ? TA : TB) - 1;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int y = TB - 1; y >= 0; --y)
#pragma unroll
    for (int x = TA - 1; x >= 0; --x)
      if (x + y <= kOrder) mma16816(part, a[x], b[y][2 * half], b[y][2 * half + 1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = fmaf(part[e], mul, acc[e]);
}

// The same for both 8-column halves of a 16-column block of B (acc0, acc1),
// loading B's terms from shared memory one at a time (planes `plane`
// apart; k-major or n-major): one term of B in registers instead of TB.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms_b(float* acc0, float* acc1, const unsigned (&a)[TA][4],
                                            const bf16* sb, int ld, int plane, int n0, int k0,
                                            int lane, bool kmajor, float mul = 1.f) {
  constexpr int kOrder = (TA > TB ? TA : TB) - 1;
  float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int y = TB - 1; y >= 0; --y) {
    unsigned b[4];
    if (kmajor)
      load_b_kmajor(b, sb + y * plane, ld, n0, k0, lane);
    else
      load_b_nmajor(b, sb + y * plane, ld, n0, k0, lane);
#pragma unroll
    for (int x = TA - 1; x >= 0; --x)
      if (x + y <= kOrder) {
        mma16816(p0, a[x], b[0], b[1]);
        mma16816(p1, a[x], b[2], b[3]);
      }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc0[e] = fmaf(p0[e], mul, acc0[e]);
    acc1[e] = fmaf(p1[e], mul, acc1[e]);
  }
}

// An input pair (e, e + 1) of a row as f32: paired when dk is even (the
// pair is then aligned), else element by element (the second only if it
// exists).
__device__ __forceinline__ float2 load2(const float* p, bool pair, bool second) {
  if (pair) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], second ? p[1] : 0.f);
}
__device__ __forceinline__ float2 load2(const bf16* p, bool pair, bool second) {
  if (pair) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]), second ? __bfloat162float(p[1]) : 0.f);
}

// An output pair (e, e + 1) of a row, rounded to T: paired when dk is even
// (the pair is then aligned), else element by element.
__device__ __forceinline__ void put2(float* p, float x0, float x1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (second) p[1] = x1;
  }
}
__device__ __forceinline__ void put2(bf16* p, float x0, float x1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16_rn(x0);
    if (second) p[1] = __float2bfloat16_rn(x1);
  }
}

// ------------------------------------------------------------------- rows

// One block (4 warps) per (batch x head, chunk, 16 rows).
__global__ void __launch_bounds__(kRowWarps * 32)
mlstm_bwd_rows(const float* __restrict__ log_i, const float* __restrict__ log_f,
               const float* __restrict__ ws, const float* __restrict__ den,
               const float* __restrict__ h, const float* __restrict__ dh, Scratch sc, Shape sh) {
  __shared__ float cs[kMaxChunk], li[kMaxChunk], w[kMaxChunk];
  __shared__ float decay_s, mn_s;
  const int bh = blockIdx.x, chunk = blockIdx.y, nc = sh.nc, H = sh.H, c = sh.c, dk = sh.dk;
  const int dkp = sh.dkp, b = bh / H, hh = bh - b * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = chunk_row(b, sh.S, chunk, c, H, hh);
  const Carry wsc = carry_of(const_cast<float*>(ws), sh.P, dkp);
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const float m = chunk > 0 ? wsc.m[p] : 0.f;
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, cs, c, lane);
    for (int j = lane; j < c; j += 32) li[j] = log_i[row0 + static_cast<long long>(j) * H];
    __syncwarp();
    warp_carry(cs, li, w, c, c, m, lane, &decay_s, &mn_s);
    __syncwarp();
    if (chunk + 1 < nc) {  // the move to the m' the forward stored
      const float mn = wsc.m[p + 1], total = cs[c - 1];
      for (int j = lane; j < c; j += 32) w[j] = expf(total - cs[j] + li[j] - mn);
      if (lane == 0) decay_s = expf(m + total - mn);
    }
  }
  __syncthreads();
  if (blockIdx.z == 0 && threadIdx.x == 0) sc.decay[p] = decay_s;
  const long long plane = sh.rows * dkp;
  const int i_end = min(c, static_cast<int>(blockIdx.z + 1) * kRowGroup);
  for (int i = blockIdx.z * kRowGroup + warp; i < i_end; i += kRowWarps) {
    const float csi = cs[i];
    float dmax = -INFINITY;
    for (int j = lane; j <= i; j += 32) dmax = fmaxf(dmax, csi - cs[j] + li[j]);
    const float mi = fmaxf(warp_max(dmax), csi + m);
    const long long row = row0 + static_cast<long long>(i) * H;
    float dot = 0.f;
    for (int e = lane; e < dk; e += 32) dot += dh[row * dk + e] * h[row * dk + e];
    dot = warp_sum(dot);
    const float dn = den[row], floor_ = expf(-mi), inter = expf(csi + m - mi);
    const float lim = fmaxf(fabsf(dn), floor_);
    if (lane == 0) {
      sc.mi[row] = mi;
      sc.inter[row] = inter;
      sc.dden[row] = fabsf(dn) >= floor_ && dn != 0.f ? -dot / dn : 0.f;
      sc.w[row] = w[i];
    }
    const float su = sh.scale * inter;
    for (int e = 2 * lane; e < dkp; e += 64) {
      const long long at = row * dkp + e;
      const float d0 = e < dk ? dh[row * dk + e] / lim : 0.f;
      const float d1 = e + 1 < dk ? dh[row * dk + e + 1] / lim : 0.f;
      put3(sc.dnum + at, plane, d0, d1);
      put3(sc.u + at, plane, d0 * su, d1 * su);
    }
  }
}

// ------------------------------------------------------------------ moves

// The carry gradient's tiles: warp w of a block holds, for value rows
// e0 + 16 (w % 4) .. and dk columns d0 + 32 (w / 4) .., four m16n8
// accumulator tiles of G^T (the layout of the forward's C^T, so a lane's
// tiles meet C_t's 16-byte pieces of the workspace); thread d < 64 of the
// first column of tiles holds dn[d0 + d].

// One block per (batch x head, chunk 1 .., 64 dk columns d x 64 value rows
// e): the chunk's move of G^T, U = u^T q over its positions (K = c) from
// shared planes of u (value rows) and q (dk columns), each k-step's run
// added in f32, stored in the accumulators' own order for the state pass;
// in the first column of tiles also the move of dn, sum_i dden_i inter_i
// q_i (scaled).  The chunks' moves are independent, so these blocks fill
// the card; only the state pass walks the chunks in order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_bwd_moves(Op qo, Scratch sc, Shape sh) {
  constexpr int TQ = terms_of<T>();
  constexpr int kPl = kMaxChunk * kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sU = reinterpret_cast<bf16*>(smem_raw);  // [3][kMaxChunk][kP]
  bf16* sQ = sU + 3 * kPl;                        // [TQ][kMaxChunk][kP]
  float* sDd = reinterpret_cast<float*>(sQ + TQ * kPl);
  float* sIn = sDd + kMaxChunk;
  const int H = sh.H, c = sh.c, dkp = sh.dkp, nc = sh.nc;
  const int bh = blockIdx.x, ch = blockIdx.y + 1, b = bh / H, hh = bh - b * H;
  const int tile = blockIdx.z, d0 = (tile / sh.ntile) * kT, e0 = (tile % sh.ntile) * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int em = 16 * (warp & 3), dn0 = 32 * (warp >> 2);
  const int rows = (c + 15) & ~15;
  const long long p = static_cast<long long>(bh) * nc + ch;
  const long long row0 = chunk_row(b, sh.S, ch, c, H, hh);
  stage<kT>(sU, kP, kPl, sc.u + row0 * dkp + e0, sh.rows * dkp, static_cast<long long>(H) * dkp, 3,
            rows, Same{}, c, dkp - e0, true, tid, kThreads);
  stage<kT>(sQ, kP, kPl, qo.p + row0 * qo.pitch + d0, qo.plane,
            static_cast<long long>(H) * qo.pitch, TQ, rows, Same{}, c, qo.cols - d0, qo.vec, tid,
            kThreads);
  for (int r = tid; r < c; r += kThreads) {
    const long long row = row0 + static_cast<long long>(r) * H;
    sDd[r] = sc.dden[row];
    sIn[r] = sc.inter[row];
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float U[4][4] = {};
#pragma unroll 1
  for (int ks = 0; ks < rows / 16; ++ks) {
    unsigned a[3][4];
    load_a_terms<3>(a, sU, kP, kPl, em, 16 * ks, lane, true);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned bq[TQ][4];
      load_b_terms<TQ>(bq, sQ, kP, kPl, dn0 + 16 * np, 16 * ks, lane, true);
      mma_terms<3, TQ>(U[2 * np], a, bq, 0);
      mma_terms<3, TQ>(U[2 * np + 1], a, bq, 1);
    }
  }
  float4* out = reinterpret_cast<float4*>(sc.U) +
                (p * sh.ntile * sh.ntile + tile) * 4 * kThreads + tid;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    out[nt * kThreads] = make_float4(U[nt][0], U[nt][1], U[nt][2], U[nt][3]);
  if (tile % sh.ntile == 0 && tid < kT) {  // q whole again from its terms (hi + mid + lo is exact)
    float un = 0.f;
    for (int i = 0; i < c; ++i) {
      float qv = 0.f;
#pragma unroll
      for (int r = 0; r < TQ; ++r) qv += __bfloat162float(sQ[r * kPl + i * kP + tid]);
      un = fmaf(sDd[i], sIn[i] * (qv * sh.scale), un);
    }
    if (d0 + tid < dkp) sc.un[p * dkp + d0 + tid] = un;
  }
}

// ------------------------------------------------------------------ state

// One block per (batch x head, 64 dk columns d x 64 value rows e) of G^T,
// walking the chunks from the last: it writes G_{t+1} (f32, in 16-byte
// pieces of the forward's fragment order) and dn_{t+1} for chunk t and its
// share of ddecay_t, then moves to
// G_t = decay_t G_{t+1} + U_t and dn_t = decay_t dn_{t+1} + un_t with the
// moves pass's U_t and un_t.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_state(const float* __restrict__ ws, bool frag, Scratch sc, Shape sh) {
  __shared__ float sRed[kWarps];
  const int dk = sh.dk, dkp = sh.dkp, nc = sh.nc, nkb = dkp / 16;
  const int bh = blockIdx.x, d0 = blockIdx.y * kT, e0 = blockIdx.z * kT;
  const int tile = blockIdx.y * sh.ntile + blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int er = e0 + 16 * (warp & 3), dc = d0 + 32 * (warp >> 2);
  const bool n_tile = blockIdx.z == 0;
  const Carry wsc = carry_of(const_cast<float*>(ws), sh.P, dkp);
  const long long gplane = static_cast<long long>(dkp) * dkp;
  float G[4][4] = {}, dn = 0.f;
  for (int ch = nc - 1; ch >= 0; --ch) {
    const long long p = static_cast<long long>(bh) * nc + ch;
    float4 u[4];  // this chunk's move, fetched ahead of the work on G_{ch+1}
    float decay = 0.f, un = 0.f;
    if (ch > 0) {
      const float4* U = reinterpret_cast<const float4*>(sc.U) +
                        (p * sh.ntile * sh.ntile + tile) * 4 * kThreads + tid;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) u[nt] = U[nt * kThreads];
      decay = sc.decay[p];
      if (n_tile && tid < kT && d0 + tid < dkp) un = sc.un[p * dkp + d0 + tid];
    }
    if (ch + 1 < nc) {  // G_{ch+1} (as the forward stores C) and dn_{ch+1}, which chunk ch reads
      float* Gg = sc.G + p * gplane;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int eb = er >> 4, kb = (dc >> 4) + np;
        if (eb >= nkb || kb >= nkb) continue;
        float* unit = Gg + (static_cast<long long>(eb) * nkb + kb) * kUnit;
        const float* a0 = G[2 * np];
        const float* a1 = G[2 * np + 1];
        *reinterpret_cast<float4*>(unit + lane * 4) = make_float4(a0[0], a0[1], a1[0], a1[1]);
        *reinterpret_cast<float4*>(unit + kUnit / 2 + lane * 4) =
            make_float4(a0[2], a0[3], a1[2], a1[3]);
      }
      if (n_tile && tid < kT && d0 + tid < dkp) sc.dn[p * dkp + d0 + tid] = dn;
    }
    // this tile's share of ddecay_ch = <G_{ch+1}, C_ch> + dn_{ch+1} . n_ch
    float part = 0.f;
    if (ch > 0 && ch + 1 < nc) {
      const float* Cg = wsc.C + p * dkp * dkp;
      if (frag) {  // unit (er / 16, kb): C[16 kb + 2t, +1, +8, +9][er + g (+8)]
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int eb = er >> 4, kb = (dc >> 4) + np;
          if (eb >= nkb || kb >= nkb) continue;
          const float* unit = Cg + (static_cast<long long>(eb) * nkb + kb) * kUnit;
          const float4 x = *reinterpret_cast<const float4*>(unit + lane * 4);
          const float4 y = *reinterpret_cast<const float4*>(unit + kUnit / 2 + lane * 4);
          const float* a0 = G[2 * np];
          const float* a1 = G[2 * np + 1];
          part = fmaf(a0[0], x.x, part);
          part = fmaf(a0[1], x.y, part);
          part = fmaf(a1[0], x.z, part);
          part = fmaf(a1[1], x.w, part);
          part = fmaf(a0[2], y.x, part);
          part = fmaf(a0[3], y.y, part);
          part = fmaf(a1[2], y.z, part);
          part = fmaf(a1[3], y.w, part);
        }
      } else {  // row-major C[d][e]
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = er + g + 8 * (x >> 1), d = dc + 8 * nt + 2 * t + (x & 1);
            if (d < dk && e < dk)
              part = fmaf(G[nt][x], Cg[static_cast<long long>(d) * dk + e], part);
          }
      }
      if (n_tile && tid < kT && d0 + tid < dk) part = fmaf(dn, wsc.n[p * dkp + d0 + tid], part);
    }
    part = warp_sum(part);
    if (lane == 0) sRed[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float x = 0.f;
      for (int w = 0; w < kWarps; ++w) x += sRed[w];
      sc.pdecay[static_cast<long long>(tile) * sh.P + p] = x;
    }
    if (ch == 0) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      G[nt][0] = decay * G[nt][0] + u[nt].x;
      G[nt][1] = decay * G[nt][1] + u[nt].y;
      G[nt][2] = decay * G[nt][2] + u[nt].z;
      G[nt][3] = decay * G[nt][3] + u[nt].w;
    }
    dn = decay * dn + un;
    __syncthreads();  // sRed is read before the next chunk writes it
  }
}

// ----------------------------------------------------------------- scores

// The scores pass's staged step over dk (deeper for one-term bf16 inputs)
// and the bf16 elements of one of its two buffers.
template <int TQ>
__host__ __device__ constexpr int score_depth() {
  return TQ == 1 ? 32 : 16;
}
template <int TQ>
__host__ __device__ constexpr int score_buffer() {
  return ((TQ + 3) * 16 * kScoreWarps + 2 * TQ * kMaxChunk) * (score_depth<TQ>() + 8);
}

// The 16-row tile that warp w of scores block z takes: tiles z and 7 - z,
// so each block has the same causal work (9 tile pairs at c = 128).
__device__ __forceinline__ int score_tile(int z, int w) { return w == 0 ? z : 7 - z; }

// One block (2 warps) per (batch x head, chunk, tile pair).  A warp holds
// S and P = dnum v^T for its 16 rows and every column up to its diagonal
// in m16n8 accumulators, over dk in staged steps of 32 through two buffers.
template <typename T>
__global__ void __launch_bounds__(kScoreWarps * 32)
mlstm_bwd_scores(Op qo, Op ko, Op vo, const float* __restrict__ log_i,
                 const float* __restrict__ log_f, Scratch sc, Shape sh) {
  constexpr int TQ = terms_of<T>();
  constexpr int kSD = score_depth<TQ>(), kPS = kSD + 8;
  constexpr int kRowsA = 16 * kScoreWarps;
  constexpr int kPlA = kRowsA * kPS, kPlB = kMaxChunk * kPS;
  constexpr int kNth = kScoreWarps * 32;
  // two buffers of one step: q [TQ][32][kPS] (this block's rows), dnum
  // [3][32][kPS], k and v [TQ][128][kPS] (kPS = kSD + 8)
  constexpr int kBuf = score_buffer<TQ>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);
  float* scs = reinterpret_cast<float*>(buf + 2 * kBuf);
  float* sli = scs + kMaxChunk;
  float* colpart = sli + kMaxChunk;  // [kScoreWarps][kMaxChunk]
  const int H = sh.H, c = sh.c, dk = sh.dk, dkp = sh.dkp, cp = sh.cp;
  const int bh = blockIdx.x, chunk = blockIdx.y, z = blockIdx.z, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rows = cp;
  const int mt = score_tile(z, warp);
  const bool active = 16 * mt < rows;
  const long long row0 = chunk_row(b, sh.S, chunk, c, H, hh);
  const long long p = static_cast<long long>(bh) * sh.nc + chunk;
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, scs, c, lane);
    for (int j = lane; j < c; j += 32) sli[j] = log_i[row0 + static_cast<long long>(j) * H];
    for (int j = c + lane; j < kMaxChunk; j += 32) scs[j] = sli[j] = 0.f;
  }
  for (int j = tid; j < kScoreWarps * kMaxChunk; j += kNth) colpart[j] = 0.f;
  // shared row r of the A tiles is chunk row 16 score_tile(z, r / 16) + r % 16;
  // k and v rows up to the block's last diagonal
  const auto a_row = [z](int r) { return 16 * score_tile(z, r >> 4) + (r & 15); };
  const int brows = min(rows, 16 * (7 - z + 1));
  float s[16][4], pp[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = pp[i][e] = 0.f;
  const long long hq = static_cast<long long>(H) * qo.pitch, hp = static_cast<long long>(H) * dkp;
  // the step at dk columns d0 .. into buffer d0 / kSD % 2
  const auto issue = [&](int d0) {
    bf16* sQ = buf + (d0 / kSD & 1) * kBuf;
    bf16* sN = sQ + TQ * kPlA;
    bf16* sK = sN + 3 * kPlA;
    bf16* sV = sK + TQ * kPlB;
    stage<kSD>(sQ, kPS, kPlA, qo.p + row0 * qo.pitch + d0, qo.plane, hq, TQ, kRowsA, a_row, c,
              qo.cols - d0, qo.vec, tid, kNth);
    stage<kSD>(sN, kPS, kPlA, sc.dnum + row0 * dkp + d0, sh.rows * dkp, hp, 3, kRowsA, a_row, c,
              dkp - d0, true, tid, kNth);
    stage<kSD>(sK, kPS, kPlB, ko.p + row0 * ko.pitch + d0, ko.plane, hq, TQ, brows, Same{}, c,
              ko.cols - d0, ko.vec, tid, kNth);
    stage<kSD>(sV, kPS, kPlB, vo.p + row0 * vo.pitch + d0, vo.plane, hq, TQ, brows, Same{}, c,
              vo.cols - d0, vo.vec, tid, kNth);
    cp_async_commit();
  };
  issue(0);
  for (int d0 = 0; d0 < dk; d0 += kSD) {
    cp_async_wait_all();
    __syncthreads();  // this step has landed everywhere; the other buffer is consumed
    if (d0 + kSD < dk) issue(d0 + kSD);
    if (!active) continue;
    const bf16* sQ = buf + (d0 / kSD & 1) * kBuf;
    const bf16* sN = sQ + TQ * kPlA;
    const bf16* sK = sN + 3 * kPlA;
    const bf16* sV = sK + TQ * kPlB;
#pragma unroll
    for (int kk = 0; kk < kSD / 16; ++kk) {
      {  // S = q k^T
        unsigned aq[TQ][4];
        load_a_terms<TQ>(aq, sQ, kPS, kPlA, 16 * warp, 16 * kk, lane, false);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (np > mt) break;
          unsigned bk[TQ][4];
          load_b_terms<TQ>(bk, sK, kPS, kPlB, 16 * np, 16 * kk, lane, false);
          mma_terms<TQ, TQ>(s[2 * np], aq, bk, 0);
          mma_terms<TQ, TQ>(s[2 * np + 1], aq, bk, 1);
        }
      }
      {  // P = dnum v^T
        unsigned an[3][4];
        load_a_terms<3>(an, sN, kPS, kPlA, 16 * warp, 16 * kk, lane, false);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (np > mt) break;
          unsigned bv[TQ][4];
          load_b_terms<TQ>(bv, sV, kPS, kPlB, 16 * np, 16 * kk, lane, false);
          mma_terms<3, TQ>(pp[2 * np], an, bv, 0);
          mma_terms<3, TQ>(pp[2 * np + 1], an, bv, 1);
        }
      }
    }
  }
  if (active) {
    // W = S scale E, dW = P + dden, dS = dW E, dD = dW W (j <= i < c), as
    // the forward forms W; rows i0 = 16 mt + g, i1 = i0 + 8
    const int i0 = 16 * mt + g, i1 = i0 + 8;
    const bool ok0 = i0 < c, ok1 = i1 < c;
    const long long r0 = row0 + static_cast<long long>(i0) * H;
    const long long r1 = row0 + static_cast<long long>(i1) * H;
    const float mi0 = ok0 ? sc.mi[r0] : 0.f, mi1 = ok1 ? sc.mi[r1] : 0.f;
    const float dd0 = ok0 ? sc.dden[r0] : 0.f, dd1 = ok1 ? sc.dden[r1] : 0.f;
    const float cs0 = scs[i0], cs1 = scs[i1];
    const long long cc = static_cast<long long>(cp) * cp;
    bf16* Wp = sc.W + p * 3 * cc;
    bf16* dSp = sc.dS + p * 3 * cc;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt >= 2 * (mt + 1)) break;
      float col[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * t + e;
        const float csj = scs[j], lij = sli[j];
        const bool v0 = ok0 && j <= i0, v1 = ok1 && j <= i1;
        const float E0 = v0 ? expf(cs0 - csj + lij - mi0) : 0.f;
        const float E1 = v1 ? expf(cs1 - csj + lij - mi1) : 0.f;
        const float W0 = s[nt][e] * sh.scale * E0, W1 = s[nt][2 + e] * sh.scale * E1;
        const float dW0 = v0 ? pp[nt][e] + dd0 : 0.f, dW1 = v1 ? pp[nt][2 + e] + dd1 : 0.f;
        const float dD0 = dW0 * W0, dD1 = dW1 * W1;
        rs0 += dD0;
        rs1 += dD1;
        col[e] = dD0 + dD1;
        s[nt][e] = W0;
        s[nt][2 + e] = W1;
        pp[nt][e] = dW0 * E0;
        pp[nt][2 + e] = dW1 * E1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // the warp's 16 rows of each column
        col[0] += __shfl_xor_sync(kFull, col[0], o);
        col[1] += __shfl_xor_sync(kFull, col[1], o);
      }
      if (g == 0) {
        colpart[warp * kMaxChunk + nt * 8 + 2 * t] = col[0];
        colpart[warp * kMaxChunk + nt * 8 + 2 * t + 1] = col[1];
      }
      const int j = nt * 8 + 2 * t;
      put3(Wp + i0 * cp + j, cc, s[nt][0], s[nt][1]);
      put3(Wp + i1 * cp + j, cc, s[nt][2], s[nt][3]);
      put3(dSp + i0 * cp + j, cc, pp[nt][0], pp[nt][1]);
      put3(dSp + i1 * cp + j, cc, pp[nt][2], pp[nt][3]);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      rs0 += __shfl_xor_sync(kFull, rs0, o);
      rs1 += __shfl_xor_sync(kFull, rs1, o);
    }
    if (t == 0) {
      if (ok0) sc.rowD[r0] = rs0;
      if (ok1) sc.rowD[r1] = rs1;
    }
  }
  __syncthreads();
  for (int j = tid; j < c; j += kNth) {
    float x = 0.f;
    for (int w = 0; w < kScoreWarps; ++w) x += colpart[w * kMaxChunk + j];
    sc.colD[z * sh.rows + row0 + static_cast<long long>(j) * H] = x;
  }
}

// ------------------------------------------------------------------ grads

// The grads pass's shared memory: two buffers of one staged step of depth
// kGK, each an A operand (three planes of 128 x kGK, or of kGK x 128
// transposed) and a B operand (three planes of kGK x 64, or of 64 x kGK);
// the rows' scalars, the 64 columns of n or dn and the two column halves'
// partial sums of the two column halves.
constexpr int kGK = 32;        // grads pass: depth of a staged step
constexpr int kPG = kGK + 8;   // its pitch (80 bytes)
constexpr int kGradA = 3 * kMaxChunk * kPG;
constexpr int kGradB = 3 * kT * kPG;
constexpr int kGradBuf = kGradA + kGradB;
constexpr size_t kGradSmem =
    2 * kGradBuf * sizeof(bf16) + (3 * kMaxChunk + kT + 2 * kMaxChunk) * sizeof(float);
static_assert(kMaxChunk * kPG >= kGK * kPC && kT * kPG >= kGK * kP, "a plane holds each layout");

// A tile of a carry (C, or G), `erows` value rows e (from e0) x `dcols` dk
// columns d (from d0; all multiples of 16), into three shared planes [e][d]
// (rows of `ld`), split into bf16 terms as it is copied.  The carry in mma
// fragment order (frag: a lane's 16-byte piece of unit (eb, kb) holds
// C[16 kb + 2t, +1, +8, +9][16 eb + g], the second half e + 8) or
// row-major with rows of dk.
__device__ __forceinline__ void stage_carry(bf16* dst, const float* Cg, bool frag, int dk, int dkp,
                                            int e0, int erows, int d0, int dcols, int ld, int tid,
                                            int nthreads) {
  const int nkb = dkp / 16, plane = erows * ld, ucols = dcols / 16;
  if (frag) {
#pragma unroll 1
    for (int i = tid; i < (erows / 16) * ucols * (kUnit / 4); i += nthreads) {
      const int u = i / (kUnit / 4), piece = i % (kUnit / 4);
      const int half = piece >> 5, l = piece & 31, g = l >> 2, t = l & 3;
      const int ue = u / ucols, ud = u % ucols;
      const int eb = (e0 >> 4) + ue, kb = (d0 >> 4) + ud;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (eb < nkb && kb < nkb)
        x = *reinterpret_cast<const float4*>(Cg + (static_cast<long long>(eb) * nkb + kb) * kUnit +
                                             half * (kUnit / 2) + l * 4);
      const int el = 16 * ue + 8 * half + g, dl = 16 * ud + 2 * t;
      put3(dst + el * ld + dl, plane, x.x, x.y);
      put3(dst + el * ld + dl + 8, plane, x.z, x.w);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < erows * dcols / 2; i += nthreads) {
      const int el = i % erows, dl = 2 * (i / erows), e = e0 + el, d = d0 + dl;
      const bool ok = e < dk;
      const float x0 = ok && d < dk ? Cg[static_cast<long long>(d) * dk + e] : 0.f;
      const float x1 = ok && d + 1 < dk ? Cg[static_cast<long long>(d + 1) * dk + e] : 0.f;
      put3(dst + el * ld + dl, plane, x0, x1);
    }
  }
}

// The grads pass's step `step` into its buffer: for step < n1 the carry's
// product over dk columns f0 = kGK step .. (A: dnum, v or k; B: C or G),
// then the chunk's over positions s0 = kGK (step - n1) .. (A: dS or W's
// planes; B: k, q or dnum).  C and G are split into bf16 terms as they are
// copied.  Every source is worked out here from the kernel's arguments, so
// no pointer stays live across the steps.
template <typename T, int MODE>
__device__ __forceinline__ void grads_issue(bf16* buf, int step, int n1, Op qo, Op ko, Op vo,
                                            const float* ws, bool frag, Scratch sc, Shape sh,
                                            long long row0, long long p, int c0, int tid) {
  constexpr int TQ = terms_of<T>();
  constexpr int TA2 = MODE == 0 ? 3 : TQ;  // dnum; v; k
  constexpr int TB1 = MODE == 2 ? 3 : TQ;  // k; q; dnum
  const int H = sh.H, c = sh.c, dk = sh.dk, dkp = sh.dkp, cp = sh.cp, rows = cp;
  const long long cc = static_cast<long long>(cp) * cp;
  const Op dn{sc.dnum, sh.rows * dkp, dkp, dkp, true};
  bf16* sA = buf + (step & 1) * kGradBuf;
  bf16* sB = sA + kGradA;
  if (step < n1) {
    const int f0 = step * kGK;
    const Op a = MODE == 0 ? dn : MODE == 1 ? vo : ko;
    stage<kGK>(sA, kPG, kMaxChunk * kPG, a.p + row0 * a.pitch + f0, a.plane,
               static_cast<long long>(H) * a.pitch, TA2, rows, Same{}, c, a.cols - f0, a.vec, tid,
               kThreads);
    const float* carry =
        (MODE == 0 ? carry_of(const_cast<float*>(ws), sh.P, dkp).C : sc.G) + p * dkp * dkp;
    if (MODE != 2)  // rows e = f0 .., columns d = c0 ..: k-major
      stage_carry(sB, carry, MODE == 0 ? frag : true, dk, dkp, f0, kGK, c0, kT, kP, tid,
                  kThreads);
    else  // rows e = c0 .., columns d = f0 ..: n-major
      stage_carry(sB, carry, true, dk, dkp, c0, kT, f0, kGK, kPG, tid, kThreads);
  } else {
    const int s0 = (step - n1) * kGK;
    const bf16* m = (MODE == 2 ? sc.W : sc.dS) + p * 3 * cc;
    if (MODE == 0)
      stage<kGK>(sA, kPG, kMaxChunk * kPG, m + s0, cc, cp, 3, rows, Same{}, rows, cp - s0, true,
                 tid, kThreads);
    else
      stage<kMaxChunk>(sA, kPC, kGK * kPC, m + static_cast<long long>(s0) * cp, cc, cp, 3,
                       min(kGK, rows - s0), Same{}, rows - s0, cp, true, tid, kThreads);
    const Op bo = MODE == 0 ? ko : MODE == 1 ? qo : dn;
    stage<kT>(sB, kP, kGK * kP, bo.p + (row0 + static_cast<long long>(s0) * H) * bo.pitch + c0,
              bo.plane, static_cast<long long>(H) * bo.pitch, TB1, kGK, Same{}, c - s0,
              bo.cols - c0, bo.vec, tid, kThreads);
  }
  cp_async_commit();
}

// One block per (batch x head, chunk, output, 64 columns c0 ..) with output
// MODE 0 (dq), 1 (dk) or 2 (dv).  Warp (rw, cw) = (w % 4, w / 4) holds rows
// of the 16-row tiles rw and 7 - rw (the same causal work for every warp)
// and columns c0 + 32 cw .. + 31 in m16n8 accumulators.  First the carry's
// product over dk (MODE 0: C dnum; 1: G v; 2: G^T k) and its partials, then
// the chunk's product over positions (dS k; dS^T q; W^T dnum) added to it;
// the steps of both flow through two buffers, the next one copied while
// this one is multiplied, one barrier a step.
template <typename T, int MODE>
__device__ __forceinline__ void grads_body(Op qo, Op ko, Op vo, const T* __restrict__ q,
                                           const T* __restrict__ k, const float* __restrict__ ws,
                                           bool frag, Scratch sc, T* __restrict__ out, Shape sh,
                                           int ct, unsigned char* smem_raw) {
  constexpr int TQ = terms_of<T>();
  constexpr int TA2 = MODE == 0 ? 3 : TQ;  // dnum; v; k
  constexpr int TB1 = MODE == 2 ? 3 : TQ;  // k; q; dnum
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][kGradBuf]
  float* sInter = reinterpret_cast<float*>(buf + 2 * kGradBuf);
  float* sDden = sInter + kMaxChunk;
  float* sW = sDden + kMaxChunk;
  float* sN = sW + kMaxChunk;  // [kT]: n (dq) or dn (dk) of the block's columns
  float* sRed = sN + kT;       // [2][kMaxChunk]
  const int H = sh.H, c = sh.c, dk = sh.dk, dkp = sh.dkp, cp = sh.cp, nc = sh.nc;
  const int bh = blockIdx.x, chunk = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, cw = warp >> 2, c0 = ct * kT, rows = cp;
  // this warp's 16-row tiles: mt(0) = rw, mt(1) = 7 - rw, held if they lie within the rows
  const auto mt = [rw](int mi) { return mi == 0 ? rw : 7 - rw; };
  const auto on_rows = [rw, rows](int mi) { return 16 * (mi == 0 ? rw : 7 - rw) < rows; };
  const long long row0 = chunk_row(b, sh.S, chunk, c, H, hh);
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const Carry wsc = carry_of(const_cast<float*>(ws), sh.P, dkp);
  const bool carry = MODE == 0 ? chunk > 0 : chunk + 1 < nc;
  const int n1 = carry ? ceil_div(dk, kGK) : 0, nsteps = n1 + ceil_div(rows, kGK);
  grads_issue<T, MODE>(buf, 0, n1, qo, ko, vo, ws, frag, sc, sh, row0, p, c0, tid);

  for (int r = tid; r < kMaxChunk; r += kThreads) {
    const long long row = row0 + static_cast<long long>(r) * H;
    const bool ok = r < c;
    sInter[r] = ok ? sc.inter[row] : 0.f;
    sDden[r] = ok ? sc.dden[row] : 0.f;
    sW[r] = ok ? sc.w[row] : 0.f;
  }
  for (int d = tid; d < kT; d += kThreads) {
    const bool ok = carry && c0 + d < dk;
    sN[d] = !ok          ? 0.f
            : MODE == 0  ? wsc.n[p * dkp + c0 + d]
            : MODE == 1  ? sc.dn[p * dkp + c0 + d]
                         : 0.f;
  }
  __syncthreads();
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][nt][x] = 0.f;

  for (int step = 0;; ++step) {
    if (step == n1) {
      // the carry's product is whole: its terms and partials.  MODE 0:
      // dinter's share, acc = inter (C dnum + dden n); 1: dw's share,
      // acc = w (G v + dn); 2: acc = w G^T k
      float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // rows g, g + 8 of each tile
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 16 * mt(mi) + g + 8 * hr;
          const bool ok = on_rows(mi) && i < c;
          const long long at = (row0 + static_cast<long long>(i) * H) * dk;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = 32 * cw + 8 * nt + 2 * t;
            float2 xv = make_float2(0.f, 0.f);  // q (MODE 0) or k (1) at columns col, col + 1
            if (MODE != 2 && ok && c0 + col < dk)
              xv = load2(MODE == 0 ? q + at + c0 + col : k + at + c0 + col, (dk & 1) == 0,
                         c0 + col + 1 < dk);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = acc[mi][nt][2 * hr + e];
              const float xe = e == 0 ? xv.x : xv.y;
              if (MODE == 0) {
                part[mi][hr] = fmaf(xe * sh.scale, x + sDden[i] * sN[col + e], part[mi][hr]);
                x = sInter[i] * x + sDden[i] * sInter[i] * sN[col + e];
              } else if (MODE == 1) {
                const float y = x + sN[col + e];
                part[mi][hr] = fmaf(xe, y, part[mi][hr]);
                x = sW[i] * y;
              } else {
                x = sW[i] * x;
              }
            }
          }
          __syncwarp();  // one row's q or k loads in flight at a time: fewer live registers
        }
      if (MODE != 2) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float y = part[mi][hr];
            y += __shfl_xor_sync(kFull, y, 1);
            y += __shfl_xor_sync(kFull, y, 2);
            if (t == 0 && on_rows(mi)) sRed[cw * kMaxChunk + 16 * mt(mi) + g + 8 * hr] = y;
          }
        __syncthreads();
        float* dst = (MODE == 0 ? sc.pinter : sc.pw) + static_cast<long long>(ct) * sh.rows;
        for (int i = tid; i < c; i += kThreads)
          dst[row0 + static_cast<long long>(i) * H] = sRed[i] + sRed[kMaxChunk + i];
      }
    }
    if (step == nsteps) break;
    cp_async_wait_all();
    __syncthreads();  // this step has landed everywhere; the other buffer is consumed
    if (step + 1 < nsteps)
      grads_issue<T, MODE>(buf, step + 1, n1, qo, ko, vo, ws, frag, sc, sh, row0, p, c0, tid);
    const bf16* sA = buf + (step & 1) * kGradBuf;
    const bf16* sB = sA + kGradA;
    if (step < n1) {
      const int f0 = step * kGK;
#pragma unroll 1
      for (int kk = 0; kk < kGK / 16; ++kk) {
        if (f0 + 16 * kk >= dk) break;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {  // one 16-row tile of A at a time
          if (!on_rows(mi)) continue;
          unsigned a[TA2][4];
          load_a_terms<TA2>(a, sA, kPG, kMaxChunk * kPG, 16 * mt(mi), 16 * kk, lane, false);
#pragma unroll
          for (int np = 0; np < 2; ++np) {  // one 16-column block of B at a time
            if (MODE == 2)
              mma_terms_b<TA2, 3>(acc[mi][2 * np], acc[mi][2 * np + 1], a, sB, kPG, kT * kPG,
                                  32 * cw + 16 * np, 16 * kk, lane, false);
            else
              mma_terms_b<TA2, 3>(acc[mi][2 * np], acc[mi][2 * np + 1], a, sB, kP, kGK * kP,
                                  32 * cw + 16 * np, 16 * kk, lane, true);
          }
        }
      }
      continue;
    }
    // the chunk's product (MODE 0: K = j <= i; 1, 2: K = i >= j, A
    // transposed from the [i][j] planes)
    const int s0 = (step - n1) * kGK;
#pragma unroll 1
    for (int kk = 0; kk < kGK / 16; ++kk) {
      const int kb = (s0 >> 4) + kk;
      if (16 * kb >= rows) break;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {  // one 16-row tile of A at a time
        if (!on_rows(mi) || (MODE == 0 ? kb > mt(mi) : kb < mt(mi))) continue;
        unsigned a[3][4];
        if (MODE == 0)
          load_a_terms<3>(a, sA, kPG, kMaxChunk * kPG, 16 * mt(mi), 16 * kk, lane, false);
        else
          load_a_terms<3>(a, sA, kPC, kGK * kPC, 16 * mt(mi), 16 * kk, lane, true);
#pragma unroll
        for (int np = 0; np < 2; ++np)  // one 16-column block of B at a time
          mma_terms_b<3, TB1>(acc[mi][2 * np], acc[mi][2 * np + 1], a, sB, kP, kGK * kP,
                              32 * cw + 16 * np, 16 * kk, lane, true,
                              MODE == 1 ? sh.scale : 1.f);
      }
    }
  }

  // dq = scale acc, dk = acc, dv = acc, in T
  const bool pair = (dk & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (!on_rows(mi)) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = 16 * mt(mi) + g + 8 * hr;
      if (i >= c) continue;
      T* o = out + (row0 + static_cast<long long>(i) * H) * dk;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c0 + 32 * cw + 8 * nt + 2 * t;
        if (col >= dk) continue;
        float x0 = acc[mi][nt][2 * hr], x1 = acc[mi][nt][2 * hr + 1];
        if (MODE == 0) {
          x0 *= sh.scale;
          x1 *= sh.scale;
        }
        put2(o + col, x0, x1, pair, col + 1 < dk);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: 128 registers
mlstm_bwd_grads(Op qo, Op ko, Op vo, const T* __restrict__ q, const T* __restrict__ k,
                const float* __restrict__ ws, bool frag, Scratch sc, T* __restrict__ dq,
                T* __restrict__ dk_out, T* __restrict__ dv, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mode = blockIdx.z / sh.ntile, ct = blockIdx.z - mode * sh.ntile;
  if (mode == 0)
    grads_body<T, 0>(qo, ko, vo, q, k, ws, frag, sc, dq, sh, ct, smem_raw);
  else if (mode == 1)
    grads_body<T, 1>(qo, ko, vo, q, k, ws, frag, sc, dk_out, sh, ct, smem_raw);
  else
    grads_body<T, 2>(qo, ko, vo, q, k, ws, frag, sc, dv, sh, ct, smem_raw);
}

// ------------------------------------------------------------------ gates

// One warp per (batch x head, chunk): the partials summed in order, then
//   dcs_i = dinter_i inter_i + rowD_i - colD_i - dw_i w_i (+ dtotal at c - 1),
//   dlog_i_j = colD_j + dw_j w_j,  dlog_f_j = sum_{i >= j} dcs_i,
// with dtotal = ddecay decay + sum_j dw_j w_j, all in f64 from the f32
// partials: dcs cancels, and dlog_f sums c of them in a chain, so in f32
// these few adds would sit as far from f64 as the products behind them.
__global__ void __launch_bounds__(32)
mlstm_bwd_gates(Scratch sc, float* __restrict__ dlog_i, float* __restrict__ dlog_f, Shape sh) {
  __shared__ double dcs[kMaxChunk];
  const int bh = blockIdx.x, chunk = blockIdx.y, H = sh.H, c = sh.c;
  const int b = bh / H, hh = bh - b * H;
  const int lane = threadIdx.x;
  const long long p = static_cast<long long>(bh) * sh.nc + chunk;
  const long long row0 = chunk_row(b, sh.S, chunk, c, H, hh);
  double wsum = 0.0;
  for (int i = lane; i < c; i += 32) {
    const long long row = row0 + static_cast<long long>(i) * H;
    double di = 0.0, dw = 0.0, colD = 0.0;
    for (int x = 0; x < sh.ntile; ++x) {
      di += sc.pinter[x * sh.rows + row];
      dw += sc.pw[x * sh.rows + row];
    }
    for (int z = 0; z < kScoreBlocks; ++z) colD += sc.colD[z * sh.rows + row];
    const double ww = dw * sc.w[row];
    wsum += ww;
    dcs[i] = di * sc.inter[row] + sc.rowD[row] - colD - ww;
    dlog_i[row] = static_cast<float>(colD + ww);
  }
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(kFull, wsum, o);
  __syncwarp();
  if (lane == 0) {
    double dd = 0.0;
    for (int x = 0; x < sh.ntile * sh.ntile; ++x) dd += sc.pdecay[x * sh.P + p];
    dcs[c - 1] += dd * sc.decay[p] + wsum;
    double run = 0.0;
    for (int j = c - 1; j >= 0; --j) {
      run += dcs[j];
      dlog_f[row0 + static_cast<long long>(j) * H] = static_cast<float>(run);
    }
  }
}

// ----------------------------------------------------------------- launch

inline size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

struct Layout {
  size_t mi, inter, dden, w, rowD, decay, colD, pinter, pw, pdecay, dn, U, un, G;
  size_t dnum, u, W, dS, total;  // byte offsets
};
inline Layout layout(int B, int S, int H, int dk, int c) {
  Layout L;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o = align256(o + bytes);
    return at;
  };
  const size_t rows = static_cast<size_t>(B) * S * H, P = rows / c;
  const size_t dkp = (dk + 15) & ~15, cp = (c + 15) & ~15, nt = ceil_div(dk, kT);
  const size_t f = sizeof(float), h2 = sizeof(bf16);
  L.mi = take(rows * f);
  L.inter = take(rows * f);
  L.dden = take(rows * f);
  L.w = take(rows * f);
  L.rowD = take(rows * f);
  L.decay = take(P * f);
  L.colD = take(kScoreBlocks * rows * f);
  L.pinter = take(nt * rows * f);
  L.pw = take(nt * rows * f);
  L.pdecay = take(nt * nt * P * f);
  L.dn = take(P * dkp * f);
  L.U = take(P * nt * nt * kThreads * 16 * f);
  L.un = take(P * dkp * f);
  L.G = take(P * dkp * dkp * f);
  L.dnum = take(3 * rows * dkp * h2);
  L.u = take(3 * rows * dkp * h2);
  L.W = take(P * 3 * cp * cp * h2);
  L.dS = take(P * 3 * cp * cp * h2);
  L.total = o;
  return L;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// An input q, k or v as an operand: bf16 read in place, in 16-byte pieces
// when dk is a multiple of 8 and the rows aligned.
inline Op input_op(const bf16* x, int dk) {
  const bool vec = dk % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  return Op{x, 0, dk, dk, vec};
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const float* li, const float* lf,
                   const float* ws, bool frag, const float* den, const float* h, const float* dh,
                   T* dq, T* dk_out, T* dv, float* dli, float* dlf, unsigned char* scratch, int B,
                   int S, int H, int dk, int c, float scale, cudaStream_t stream) {
  constexpr int TQ = terms_of<T>();
  const Layout L = layout(B, S, H, dk, c);
  Shape sh;
  sh.S = S;
  sh.H = H;
  sh.dk = dk;
  sh.c = c;
  sh.nc = S / c;
  sh.dkp = (dk + 15) & ~15;
  sh.cp = (c + 15) & ~15;
  sh.ntile = ceil_div(dk, kT);
  sh.rows = static_cast<long long>(B) * S * H;
  sh.P = sh.rows / c;
  sh.scale = scale;
  auto f = [scratch](size_t off) { return reinterpret_cast<float*>(scratch + off); };
  auto hb = [scratch](size_t off) { return reinterpret_cast<bf16*>(scratch + off); };
  Scratch sc{f(L.mi),     f(L.inter), f(L.dden),   f(L.w),    f(L.rowD),
             f(L.decay),  f(L.colD),  f(L.pinter), f(L.pw),   f(L.pdecay), f(L.dn),
             f(L.U),      f(L.un),    f(L.G),      hb(L.dnum), hb(L.u),    hb(L.W),
             hb(L.dS)};
  const Op qo = input_op(q, dk), ko = input_op(k, dk), vo = input_op(v, dk);
  const int BH = B * H, nc = sh.nc, nt = sh.ntile;
  const size_t moves_smem =
      (3 + TQ) * kMaxChunk * kP * sizeof(bf16) + 2 * kMaxChunk * sizeof(float);
  const size_t score_smem =
      2 * score_buffer<TQ>() * sizeof(bf16) + (2 + kScoreWarps) * kMaxChunk * sizeof(float);
  cudaError_t err = allow_smem(mlstm_bwd_moves<T>, moves_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(mlstm_bwd_scores<T>, score_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(mlstm_bwd_grads<T>, kGradSmem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_rows<<<dim3(BH, nc, ceil_div(c, kRowGroup)), kRowWarps * 32, 0, stream>>>(
      li, lf, ws, den, h, dh, sc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nc > 1) {
    mlstm_bwd_moves<T><<<dim3(BH, nc - 1, nt * nt), kThreads, moves_smem, stream>>>(qo, sc, sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mlstm_bwd_state<<<dim3(BH, nt, nt), kThreads, 0, stream>>>(ws, frag, sc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_scores<T><<<dim3(BH, nc, kScoreBlocks), kScoreWarps * 32, score_smem, stream>>>(
      qo, ko, vo, li, lf, sc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_grads<T><<<dim3(BH, nc, 3 * nt), kThreads, kGradSmem, stream>>>(
      qo, ko, vo, q, k, ws, frag, sc, dq, dk_out, dv, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_gates<<<dim3(BH, nc), 32, 0, stream>>>(sc, dli, dlf, sh);
  return cudaGetLastError();
}

// --------------------------------------------- f32 inputs: the CUDA cores
//
// f32 inputs take the first port's kernels, in f32 on the CUDA
// cores: rows, state (G over 64 x 64 tiles walked back), scores, grads (64
// columns), gates; every sum in a fixed order.  The tensor-core passes
// above, with q, k, v in three bf16 terms too and six-term f32 x f32
// products, put one leaf of the reduced xlstm's f32 gradients 2.03 times
// as far from f64 as the plain path
// (tests/test_torch_gpu.py::test_recurrent_train_gradients_on_card allows
// twice; these kernels pass): the tensor cores align their products to
// the largest one before summing, which costs more than f32 FMA chains
// where the sums cancel.
namespace cc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // G tile side; output columns of a grads block
constexpr int kTD = 32;     // depth of one staged product step
constexpr int kUnit = 256;  // floats in a 16 x 16 unit of the bf16 workspace

template <typename T>
__device__ __forceinline__ float ld(const T* p, long long i) {
  return to_f32(p[i]);
}

// Entry (d, e) of a carry C in the forward's workspace: row-major with rows
// of dk (f32 inputs) or in mma fragment order (bf16: unit (e / 16, d / 16),
// lane 4 g + t of column 16 eb + g (+ 8 in the second half) holds dk rows
// 16 kb + 2t, + 1, + 8, + 9 as four floats).
__device__ __forceinline__ float carry_at(const float* C, bool frag, int dk, int nkb, int d,
                                          int e) {
  if (!frag) return C[static_cast<long long>(d) * dk + e];
  const int eb = e >> 4, kb = d >> 4, el = e & 15, r = d & 15;
  const int g = el & 7, half = el >> 3, t = (r & 7) >> 1;
  return C[(static_cast<long long>(eb) * nkb + kb) * kUnit + half * (kUnit / 2) +
           (4 * g + t) * 4 + ((r >> 3) << 1) + (r & 1)];
}

// Scratch laid out by the wrapper (every array f32): per row (B, S, H) mi,
// inter, lim, dden, w, rowD, colD; per (batch x head, chunk) decay; per
// (batch x head, chunk) W and dS (c x c); per (column block, batch x head,
// chunk) the partials pinter, pw (c each) and pdecay.
// The row of (batch b, the first position of chunk `chunk`, head hh) in the
// (B, S, H) arrays; position j of the chunk is H rows on.
__device__ __forceinline__ long long chunk_row(int b, int S, int chunk, int c, int H, int hh) {
  return (static_cast<long long>(b) * S + static_cast<long long>(chunk) * c) * H + hh;
}

struct Scratch {
  float *mi, *inter, *lim, *dden, *w, *rowD, *colD, *decay, *W, *dS, *pinter, *pw, *pdecay;
};

// ------------------------------------------------------------------- rows

// One block (4 warps) per (batch x head, chunk).
__global__ void __launch_bounds__(128)
mlstm_bwd_rows(const float* __restrict__ log_i, const float* __restrict__ log_f,
               const float* __restrict__ ws, const float* __restrict__ den,
               const float* __restrict__ h, const float* __restrict__ dh, Scratch sc, int S,
               int H, int dk, int c) {
  __shared__ float cs[kMaxChunk], li[kMaxChunk], w[kMaxChunk];
  __shared__ float decay_s, mn_s;
  const int bh = blockIdx.x, chunk = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, hh = bh - b * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = chunk_row(b, S, chunk, c, H, hh);
  const int dkp = (dk + 15) & ~15;
  const Carry wsc = carry_of(const_cast<float*>(ws), static_cast<long long>(gridDim.x) * nc, dkp);
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const float m = chunk > 0 ? wsc.m[p] : 0.f;
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, cs, c, lane);
    for (int j = lane; j < c; j += 32) li[j] = log_i[row0 + static_cast<long long>(j) * H];
    __syncwarp();
    warp_carry(cs, li, w, c, c, m, lane, &decay_s, &mn_s);
    __syncwarp();
    if (chunk + 1 < nc) {  // the move to the m' the forward stored
      const float mn = wsc.m[p + 1], total = cs[c - 1];
      for (int j = lane; j < c; j += 32) w[j] = expf(total - cs[j] + li[j] - mn);
      if (lane == 0) decay_s = expf(m + total - mn);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) sc.decay[p] = decay_s;
  for (int i = warp; i < c; i += 4) {
    const float csi = cs[i];
    float dmax = -INFINITY;
    for (int j = lane; j <= i; j += 32) dmax = fmaxf(dmax, csi - cs[j] + li[j]);
    const float mi = fmaxf(warp_max(dmax), csi + m);
    const long long row = row0 + static_cast<long long>(i) * H;
    float dot = 0.f;
    for (int e = lane; e < dk; e += 32) dot += dh[row * dk + e] * h[row * dk + e];
    dot = warp_sum(dot);
    if (lane == 0) {
      const float dn = den[row], floor_ = expf(-mi);
      sc.mi[row] = mi;
      sc.inter[row] = expf(csi + m - mi);
      sc.lim[row] = fmaxf(fabsf(dn), floor_);
      sc.dden[row] = fabsf(dn) >= floor_ && dn != 0.f ? -dot / dn : 0.f;
      sc.w[row] = w[i];
    }
  }
}

// ------------------------------------------------------------------ state

// One block per (batch x head, 64 dk rows, 64 value columns) of G, walking
// the chunks from the last; thread (ty, tx) holds G[d0 + ty + 16 a][e0 + tx
// + 16 bb], thread d < 64 of the first column of tiles dn[d0 + d].
struct StateSmem {
  float a[kMaxChunk][kTile + 1];  // inter_i q_i[d] (q scaled)
  float b[kMaxChunk][kTile];      // dh_i[e] / lim_i
  float dd[kMaxChunk];            // dden_i
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_state(const T* __restrict__ q, const float* __restrict__ dh, Scratch sc,
                float* __restrict__ gws, int S, int H, int dk, int c, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  const int d0 = blockIdx.y * kTile, e0 = blockIdx.z * kTile;
  const bool n_tile = blockIdx.z == 0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = S / c;
  const long long gsize = static_cast<long long>(dk) * dk + dk;  // G and dn of one entry
  float G[4][4] = {}, dn = 0.f;
  for (int ch = nc - 1; ch >= 0; --ch) {
    float* slot = gws + (static_cast<long long>(bh) * nc + ch) * gsize;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int d = d0 + ty + 16 * a, e = e0 + tx + 16 * bb;
        if (d < dk && e < dk) slot[static_cast<long long>(d) * dk + e] = G[a][bb];
      }
    if (n_tile && tid < kTile && d0 + tid < dk)
      slot[static_cast<long long>(dk) * dk + d0 + tid] = dn;
    if (ch == 0) break;  // G entering chunk 0 has no use: C_0 = 0
    const long long row0 = chunk_row(b, S, ch, c, H, hh);
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int i = tid; i < c * kTile; i += kThreads) {
      const int r = i / kTile, col = i - r * kTile;
      const long long row = row0 + static_cast<long long>(r) * H;
      sm.a[r][col] = d0 + col < dk ? sc.inter[row] * (ld(q, row * dk + d0 + col) * scale) : 0.f;
      sm.b[r][col] = e0 + col < dk ? dh[row * dk + e0 + col] / sc.lim[row] : 0.f;
    }
    for (int r = tid; r < c; r += kThreads)
      sm.dd[r] = sc.dden[row0 + static_cast<long long>(r) * H];
    __syncthreads();
    const float decay = sc.decay[static_cast<long long>(bh) * nc + ch];
    float u[4][4] = {};
    for (int i = 0; i < c; ++i) {
      float ad[4], be[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ad[a] = sm.a[i][ty + 16 * a];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) be[bb] = sm.b[i][tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) u[a][bb] = fmaf(ad[a], be[bb], u[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) G[a][bb] = decay * G[a][bb] + u[a][bb];
    if (n_tile && tid < kTile) {
      float un = 0.f;
      for (int i = 0; i < c; ++i) un = fmaf(sm.dd[i], sm.a[i][tid], un);
      dn = decay * dn + un;
    }
  }
}

// ----------------------------------------------------------------- scores

// One block per (batch x head, chunk): S = q k^T (q scaled) and P = dh v^T
// over dk in 32-wide steps (a 16 x 16 thread grid, 8 x 8 each, the lower
// triangle only), then per row (a warp a row) W, dS and dD's sums.
struct ScoreLayout {
  int lds;
  size_t s, p, q, k, colpart, total;  // float offsets
};
__host__ __device__ inline ScoreLayout score_layout() {
  ScoreLayout L;
  L.lds = kMaxChunk + 1;
  L.s = 0;
  L.p = L.s + static_cast<size_t>(kMaxChunk) * L.lds;
  L.q = L.p + static_cast<size_t>(kMaxChunk) * L.lds;
  L.k = L.q + static_cast<size_t>(kMaxChunk) * (kTD + 1);
  L.colpart = L.k + static_cast<size_t>(kMaxChunk) * (kTD + 1);
  L.total = L.colpart + static_cast<size_t>(kWarps) * kMaxChunk;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_scores(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ log_i, const float* __restrict__ log_f,
                 const float* __restrict__ dh, Scratch sc, int S, int H, int dk, int c,
                 float scale) {
  extern __shared__ float smem[];
  __shared__ float cs[kMaxChunk], li[kMaxChunk];
  const ScoreLayout L = score_layout();
  float* sS = smem + L.s;
  float* sP = smem + L.p;
  float* sA = smem + L.q;
  float* sB = smem + L.k;
  float* colpart = smem + L.colpart;
  const int bh = blockIdx.x, chunk = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ty = tid >> 4, tx = tid & 15;
  const long long tstride = static_cast<long long>(H) * dk;
  const long long row0 = chunk_row(b, S, chunk, c, H, hh);
  const long long head0 = row0 * dk;
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, cs, c, lane);
    for (int j = lane; j < c; j += 32) li[j] = log_i[row0 + static_cast<long long>(j) * H];
  }

  // dst[i][j] = sum over dk of x_i . y_j (x scaled by xs), j <= i
  auto products = [&](const auto* x, const auto* y, float xs, float* dst) {
    for (int d0 = 0; d0 < dk; d0 += kTD) {
      __syncthreads();  // the previous step is consumed
      for (int i = tid; i < kMaxChunk * kTD; i += kThreads) {
        const int r = i / kTD, dd = i - r * kTD;
        const bool ok = r < c && d0 + dd < dk;
        sA[r * (kTD + 1) + dd] = ok ? ld(x, head0 + r * tstride + d0 + dd) * xs : 0.f;
        sB[r * (kTD + 1) + dd] = ok ? ld(y, head0 + r * tstride + d0 + dd) : 0.f;
      }
      __syncthreads();
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) acc[a][bb] = 0.f;
      for (int dd = 0; dd < kTD; ++dd) {
        float xa[8], yb[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) xa[a] = sA[(ty + 16 * a) * (kTD + 1) + dd];
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) yb[bb] = sB[(tx + 16 * bb) * (kTD + 1) + dd];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int bb = 0; bb <= a; ++bb) acc[a][bb] = fmaf(xa[a], yb[bb], acc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb <= a; ++bb) {
          const int i = ty + 16 * a, j = tx + 16 * bb;
          float* o = dst + i * L.lds + j;
          *o = d0 == 0 ? acc[a][bb] : *o + acc[a][bb];
        }
    }
  };
  products(q, k, scale, sS);
  products(dh, v, 1.f, sP);
  __syncthreads();

  for (int j = lane; j < kMaxChunk; j += 32) colpart[warp * kMaxChunk + j] = 0.f;
  for (int i = warp; i < c; i += kWarps) {
    const long long row = row0 + static_cast<long long>(i) * H;
    const float csi = cs[i], mi = sc.mi[row], lim = sc.lim[row], dden = sc.dden[row];
    float rsum = 0.f;
    for (int j = lane; j < c; j += 32) {
      float wv = 0.f, dsv = 0.f;
      if (j <= i) {
        const float e = expf(csi - cs[j] + li[j] - mi);
        wv = sS[i * L.lds + j] * e;
        const float dw = sP[i * L.lds + j] / lim + dden;
        dsv = dw * e;
        const float dd = dw * wv;
        rsum += dd;
        colpart[warp * kMaxChunk + j] += dd;
      }
      sS[i * L.lds + j] = wv;
      sP[i * L.lds + j] = dsv;
    }
    rsum = warp_sum(rsum);
    if (lane == 0) sc.rowD[row] = rsum;
  }
  __syncthreads();
  const long long cc = static_cast<long long>(c) * c;
  float* Wg = sc.W + (static_cast<long long>(bh) * nc + chunk) * cc;
  float* dSg = sc.dS + (static_cast<long long>(bh) * nc + chunk) * cc;
  for (int x = tid; x < c * c; x += kThreads) {
    const int i = x / c, j = x - i * c;
    Wg[x] = sS[i * L.lds + j];
    dSg[x] = sP[i * L.lds + j];
  }
  for (int j = tid; j < c; j += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += colpart[w * kMaxChunk + j];
    sc.colD[row0 + static_cast<long long>(j) * H] = s;
  }
}

// ------------------------------------------------------------------ grads

// One block per (batch x head, chunk, 64 columns of dk).  Thread (ty, tx)
// holds rows ty + 16 a (a < 8) and columns tx + 16 bb (bb < 4) of a c x 64
// output; products over a second axis go in 32-wide staged steps.
struct GradLayout {
  size_t m, xc, yc, sa, sb, red, total;  // float offsets
};
constexpr int kLdM = kMaxChunk + 1;
constexpr int kLdC = kTile + 1;
__host__ __device__ inline GradLayout grad_layout() {
  GradLayout L;
  L.m = 0;                                             // c x c (dS or W)
  L.xc = L.m + static_cast<size_t>(kMaxChunk) * kLdM;  // c x 64: a column tile of an input
  L.yc = L.xc + static_cast<size_t>(kMaxChunk) * kLdC;
  L.sa = L.yc + static_cast<size_t>(kMaxChunk) * kLdC;  // c x 32 staged step
  L.sb = L.sa + static_cast<size_t>(kMaxChunk) * (kTD + 1);  // 64 x 32 staged step
  L.red = L.sb + static_cast<size_t>(kTile) * (kTD + 1);
  L.total = L.red + kWarps;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_grads(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ ws, bool frag, const float* __restrict__ gws,
                const float* __restrict__ dh, Scratch sc, float* __restrict__ dq,
                float* __restrict__ dkk, float* __restrict__ dv, int S, int H, int dk, int c,
                float scale) {
  extern __shared__ float smem[];
  __shared__ float s_inter[kMaxChunk], s_lim[kMaxChunk], s_dden[kMaxChunk], s_w[kMaxChunk];
  __shared__ float s_n[kTile], s_dn[kTile];
  const GradLayout L = grad_layout();
  float* sM = smem + L.m;
  float* sXc = smem + L.xc;
  float* sYc = smem + L.yc;
  float* sA = smem + L.sa;
  float* sB = smem + L.sb;
  float* sRed = smem + L.red;
  const int bh = blockIdx.x, chunk = blockIdx.y, nc = gridDim.y, ct = blockIdx.z;
  const int c0 = ct * kTile;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ty = tid >> 4, tx = tid & 15;
  const long long tstride = static_cast<long long>(H) * dk;
  const long long row0 = chunk_row(b, S, chunk, c, H, hh);
  const long long head0 = row0 * dk;
  const int dkp = (dk + 15) & ~15, nkb = dkp / 16;
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const bool carry_in = chunk > 0;
  const Carry wsc = carry_of(const_cast<float*>(ws), static_cast<long long>(gridDim.x) * nc, dkp);
  const float* Cg = wsc.C + p * dkp * dkp;
  const float* G = gws + p * (static_cast<long long>(dk) * dk + dk);
  const float* dnG = G + static_cast<long long>(dk) * dk;
  const long long cc = static_cast<long long>(c) * c;
  const float* Wg = sc.W + p * cc;
  const float* dSg = sc.dS + p * cc;

  for (int r = tid; r < kMaxChunk; r += kThreads) {
    const long long row = row0 + static_cast<long long>(r) * H;
    const bool ok = r < c;
    s_inter[r] = ok ? sc.inter[row] : 0.f;
    s_lim[r] = ok ? sc.lim[row] : 1.f;
    s_dden[r] = ok ? sc.dden[row] : 0.f;
    s_w[r] = ok ? sc.w[row] : 0.f;
  }
  for (int d = tid; d < kTile; d += kThreads) {
    const bool ok = c0 + d < dk;
    s_n[d] = ok && carry_in ? wsc.n[p * dkp + c0 + d] : 0.f;
    s_dn[d] = ok ? dnG[c0 + d] : 0.f;
  }
  // a c x 64 column tile of x (times xs), rows past c and columns past dk zero
  auto col_tile = [&](const auto* x, float* dst, bool by_lim, float xs) {
    for (int i = tid; i < kMaxChunk * kTile; i += kThreads) {
      const int r = i / kTile, col = i - r * kTile;
      const bool ok = r < c && c0 + col < dk;
      float val = ok ? ld(x, head0 + r * tstride + c0 + col) * xs : 0.f;
      if (by_lim && ok) val /= s_lim[r];
      dst[r * kLdC + col] = val;
    }
  };
  auto mat = [&](const float* src) {  // a c x c matrix of the scratch
    for (int x = tid; x < kMaxChunk * kMaxChunk; x += kThreads) {
      const int i = x / kMaxChunk, j = x - i * kMaxChunk;
      sM[i * kLdM + j] = i < c && j < c ? src[i * c + j] : 0.f;
    }
  };
  float acc[8][4], acc2[8][4];
  auto zero = [&](float (&t)[8][4]) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) t[a][bb] = 0.f;
  };
  // acc2[i][col] += sum over the second axis f of A(i, f) B(col, f), A from
  // `a_of(r, f)` (c x F) and B from `b_of(col, f)` (64 x F), staged 32 at a time
  auto cross = [&](int F, auto a_of, auto b_of) {
    for (int f0 = 0; f0 < F; f0 += kTD) {
      __syncthreads();
      for (int i = tid; i < kMaxChunk * kTD; i += kThreads) {
        const int r = i / kTD, ff = i - r * kTD;
        sA[r * (kTD + 1) + ff] = r < c && f0 + ff < F ? a_of(r, f0 + ff) : 0.f;
      }
      for (int i = tid; i < kTile * kTD; i += kThreads) {
        const int col = i / kTD, ff = i - col * kTD;
        sB[col * (kTD + 1) + ff] = c0 + col < dk && f0 + ff < F ? b_of(c0 + col, f0 + ff) : 0.f;
      }
      __syncthreads();
      for (int ff = 0; ff < kTD; ++ff) {
        float xa[8], yb[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) xa[a] = sA[(ty + 16 * a) * (kTD + 1) + ff];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) yb[bb] = sB[(tx + 16 * bb) * (kTD + 1) + ff];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc2[a][bb] = fmaf(xa[a], yb[bb], acc2[a][bb]);
      }
    }
  };
  // sum over the 16 threads of a row group (a half warp) of a per-row value, in a fixed order
  auto row_sum = [&](float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
  };
  float* pinter = sc.pinter + (static_cast<long long>(ct) * gridDim.x * nc + p) * c;
  float* pw = sc.pw + (static_cast<long long>(ct) * gridDim.x * nc + p) * c;

  // 1. dq = scale (dS k + inter C dnum + dden inter n); pinter = q . (C dnum) + dden q . n
  __syncthreads();
  mat(dSg);
  col_tile(k, sXc, false, 1.f);
  col_tile(q, sYc, false, scale);
  __syncthreads();
  zero(acc);
  for (int j = 0; j < c; ++j) {
    float kb[4];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) kb[bb] = sXc[j * kLdC + tx + 16 * bb];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float ds = sM[(ty + 16 * a) * kLdM + j];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(ds, kb[bb], acc[a][bb]);
    }
  }
  zero(acc2);
  if (carry_in)
    cross(dk, [&](int r, int e) { return dh[head0 + r * tstride + e] / s_lim[r]; },
          [&](int d, int e) { return carry_at(Cg, frag, dk, nkb, d, e); });
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ty + 16 * a;
    const float inter = s_inter[i], dd = s_dden[i];
    float part = 0.f;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int col = tx + 16 * bb;
      const float qv = sYc[i * kLdC + col];
      part = fmaf(qv, acc2[a][bb] + dd * s_n[col], part);
      if (i < c && c0 + col < dk)
        dq[head0 + i * tstride + c0 + col] =
            scale * (acc[a][bb] + inter * acc2[a][bb] + dd * inter * s_n[col]);
    }
    part = row_sum(part);
    if (tx == 0 && i < c) pinter[i] = part;
  }

  // 2. dk = dS^T q + w (G v + dn); pw = k . (G v + dn)
  zero(acc);
  for (int i = 0; i < c; ++i) {
    float qb[4];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) qb[bb] = sYc[i * kLdC + tx + 16 * bb];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float ds = sM[i * kLdM + ty + 16 * a];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(ds, qb[bb], acc[a][bb]);
    }
  }
  zero(acc2);
  cross(dk, [&](int r, int e) { return ld(v, head0 + r * tstride + e); },
        [&](int d, int e) { return G[static_cast<long long>(d) * dk + e]; });
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = ty + 16 * a;
    const float w = s_w[j];
    float part = 0.f;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int col = tx + 16 * bb;
      const float y = acc2[a][bb] + s_dn[col];
      part = fmaf(sXc[j * kLdC + col], y, part);
      if (j < c && c0 + col < dk) dkk[head0 + j * tstride + c0 + col] = acc[a][bb] + w * y;
    }
    part = row_sum(part);
    if (tx == 0 && j < c) pw[j] = part;
  }

  // 3. dv = W^T dnum + w G^T k (this block's columns are value columns)
  __syncthreads();
  mat(Wg);
  col_tile(dh, sYc, true, 1.f);
  __syncthreads();
  zero(acc);
  for (int i = 0; i < c; ++i) {
    float nb[4];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) nb[bb] = sYc[i * kLdC + tx + 16 * bb];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float wv = sM[i * kLdM + ty + 16 * a];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(wv, nb[bb], acc[a][bb]);
    }
  }
  zero(acc2);
  cross(dk, [&](int r, int d) { return ld(k, head0 + r * tstride + d); },
        [&](int e, int d) { return G[static_cast<long long>(d) * dk + e]; });
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = ty + 16 * a;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int col = tx + 16 * bb;
      if (j < c && c0 + col < dk)
        dv[head0 + j * tstride + c0 + col] = acc[a][bb] + s_w[j] * acc2[a][bb];
    }
  }

  // 4. this block's rows of <G, C> + dn . n
  float part = 0.f;
  if (carry_in) {
    for (int x = tid; x < kTile * dk; x += kThreads) {
      const int dl = x / dk, e = x - dl * dk, d = c0 + dl;
      if (d < dk)
        part = fmaf(G[static_cast<long long>(d) * dk + e], carry_at(Cg, frag, dk, nkb, d, e), part);
    }
    if (tid < kTile) part = fmaf(s_dn[tid], s_n[tid], part);
  }
  part = warp_sum(part);
  if (lane == 0) sRed[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sRed[w];
    sc.pdecay[static_cast<long long>(ct) * gridDim.x * nc + p] = s;
  }
}

// ------------------------------------------------------------------ gates

// One warp per (batch x head, chunk): the partials of the column blocks
// summed in order, then
//   dcs_i = dinter_i inter_i + rowD_i - colD_i - dw_i w_i (+ dtotal at c - 1),
//   dlog_i_j = colD_j + dw_j w_j,  dlog_f_j = sum_{i >= j} dcs_i,
// with dtotal = ddecay decay + sum_j dw_j w_j.
__global__ void __launch_bounds__(32)
mlstm_bwd_gates(Scratch sc, float* __restrict__ dlog_i, float* __restrict__ dlog_f, int S, int H,
                int c, int ntiles) {
  __shared__ double dcs[kMaxChunk];
  const int bh = blockIdx.x, chunk = blockIdx.y, nc = gridDim.y, nbh = gridDim.x;
  const int b = bh / H, hh = bh - b * H;
  const int lane = threadIdx.x;
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const long long row0 = chunk_row(b, S, chunk, c, H, hh);
  double wsum = 0.0;  // the gates' few adds in f64, as the tensor-core variant's
  for (int i = lane; i < c; i += 32) {
    const long long row = row0 + static_cast<long long>(i) * H;
    double di = 0.0, dw = 0.0;
    for (int t = 0; t < ntiles; ++t) {
      const long long base = (static_cast<long long>(t) * nbh * nc + p) * c + i;
      di += sc.pinter[base];
      dw += sc.pw[base];
    }
    const double ww = dw * sc.w[row];
    wsum += ww;
    dcs[i] = di * sc.inter[row] + sc.rowD[row] - sc.colD[row] - ww;
    dlog_i[row] = static_cast<float>(sc.colD[row] + ww);
  }
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(kFull, wsum, o);
  __syncwarp();
  if (lane == 0) {
    double dd = 0.0;
    for (int t = 0; t < ntiles; ++t) dd += sc.pdecay[static_cast<long long>(t) * nbh * nc + p];
    dcs[c - 1] += dd * sc.decay[p] + wsum;
    double run = 0.0;
    for (int j = c - 1; j >= 0; --j) {
      run += dcs[j];
      dlog_f[row0 + static_cast<long long>(j) * H] = static_cast<float>(run);
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const float* li, const float* lf,
                   const float* ws, bool frag, const float* den, const float* h, const float* dh,
                   float* dq, float* dk_out, float* dv, float* dli, float* dlf, float* gws,
                   Scratch sc, int B, int S, int H, int dk, int c, float scale,
                   cudaStream_t stream) {
  const int nc = S / c, tiles = ceil_div(dk, kTile);
  cudaError_t err = allow_smem(mlstm_bwd_state<T>, sizeof(StateSmem));
  if (err != cudaSuccess) return err;
  const size_t score_smem = score_layout().total * sizeof(float);
  err = allow_smem(mlstm_bwd_scores<T>, score_smem);
  if (err != cudaSuccess) return err;
  const size_t grad_smem = grad_layout().total * sizeof(float);
  err = allow_smem(mlstm_bwd_grads<T>, grad_smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_rows<<<dim3(B * H, nc), 128, 0, stream>>>(li, lf, ws, den, h, dh, sc, S, H, dk, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_state<T><<<dim3(B * H, tiles, tiles), kThreads, sizeof(StateSmem), stream>>>(
      q, dh, sc, gws, S, H, dk, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_scores<T><<<dim3(B * H, nc), kThreads, score_smem, stream>>>(q, k, v, li, lf, dh, sc,
                                                                         S, H, dk, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_grads<T><<<dim3(B * H, nc, tiles), kThreads, grad_smem, stream>>>(
      q, k, v, ws, frag, gws, dh, sc, dq, dk_out, dv, S, H, dk, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_gates<<<dim3(B * H, nc), 32, 0, stream>>>(sc, dli, dlf, S, H, c, tiles);
  return cudaGetLastError();
}


}  // namespace cc

}  // namespace
}  // namespace repro

// Bytes of scratch the backward needs (repro_mlstm_chunk_bwd's `scratch`,
// 256-byte aligned).  bf16: the rows' and chunks' scalars and partials, the
// bf16 planes of its operands and each chunk's W, dS and G.  f32 (the CUDA
// cores): G and dn for every chunk (B * H * (S / c) * (dk^2 + dk) floats),
// then the rows' and chunks' scalars, W and dS, and the column blocks'
// partials.
extern "C" long long repro_mlstm_chunk_bwd_scratch(int B, int S, int H, int dk, int c, int dtype) {
  if (dtype != repro::kFloat32)
    return static_cast<long long>(repro::layout(B, S, H, dk, c).total);
  const long long rows = static_cast<long long>(B) * S * H, chunks = rows / c;
  const long long tiles = repro::ceil_div(dk, repro::cc::kTile);
  const long long gws = chunks * (static_cast<long long>(dk) * dk + dk);
  return 4 * (gws + 7 * rows + chunks + 2 * chunks * c * c + tiles * (2 * rows + chunks));
}

namespace repro {
namespace {

// The f32 entry: the CUDA-core kernels on their scratch (repro_mlstm_chunk_bwd_scratch).
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* li,
                       const float* lf, const float* ws, const float* den, const float* h,
                       const float* dh, float* dq, float* dk_out, float* dv, float* dli,
                       float* dlf, float* scratch, int B, int S, int H, int dk, int c, float scale,
                       cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H, chunks = rows / c;
  const long long tiles = ceil_div(dk, cc::kTile);
  float* gws = scratch;
  float* f = gws + chunks * (static_cast<long long>(dk) * dk + dk);
  cc::Scratch sc;
  sc.mi = f;
  sc.inter = sc.mi + rows;
  sc.lim = sc.inter + rows;
  sc.dden = sc.lim + rows;
  sc.w = sc.dden + rows;
  sc.rowD = sc.w + rows;
  sc.colD = sc.rowD + rows;
  sc.decay = sc.colD + rows;
  sc.W = sc.decay + chunks;
  sc.dS = sc.W + chunks * c * c;
  sc.pinter = sc.dS + chunks * c * c;
  sc.pw = sc.pinter + tiles * rows;
  sc.pdecay = sc.pw + tiles * rows;
  return cc::launch(q, k, v, li, lf, ws, false, den, h, dh, dq, dk_out, dv, dli, dlf, gws, sc, B,
                    S, H, dk, c, scale, stream);
}

}  // namespace
}  // namespace repro

// q, k, v (B, S, H, dk) in `dtype` as the forward took them; log_i, log_f
// (B, S, H) f32 as the forward took them (log_f already a log sigmoid);
// ws the forward's workspace (its carries), den (B, S, H) the forward's
// denominators, h (B, S, H, dk) f32 its output; dh (B, S, H, dk) f32 the
// output's gradient.  Writes dq, dk, dv (B, S, H, dk) in `dtype` (dq for
// the unscaled q; bf16 rounded to nearest from the f32 sums), dlog_i,
// dlog_f (B, S, H) f32.  scratch: repro_mlstm_chunk_bwd_scratch bytes,
// 256-byte aligned.  `col_tiles`, `row_groups` and `score_blocks` are the
// wrapper's plan (mlstm_chunk._bwd_plan: ceil(dk / 64), ceil(c / 16), 4);
// another plan is refused.  bf16: six kernels (the tensor cores); f32: five
// (the CUDA cores), on `stream`.  Returns the CUDA error of the launches (0
// on success).
extern "C" int repro_mlstm_chunk_bwd(int device, int dtype, const void* q, const void* k,
                                     const void* v, const void* log_i, const void* log_f,
                                     const void* ws, const void* den, const void* h,
                                     const void* dh, void* dq, void* dk, void* dv, void* dlog_i,
                                     void* dlog_f, void* scratch, int B, int S, int H, int dk_,
                                     int c, int col_tiles, int row_groups, int score_blocks,
                                     float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (dk_ <= 0 || dk_ > repro::kMaxDk || c <= 0 || c > repro::kMaxChunk || S % c)
    return cudaErrorInvalidValue;
  if (col_tiles != repro::ceil_div(dk_, repro::kT) ||
      row_groups != repro::ceil_div(c, repro::kRowGroup) || score_blocks != repro::kScoreBlocks ||
      (reinterpret_cast<uintptr_t>(scratch) & 255u) != 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto li = static_cast<const float*>(log_i);
  auto lf = static_cast<const float*>(log_f);
  auto wsf = static_cast<const float*>(ws);
  auto dn = static_cast<const float*>(den);
  auto hp = static_cast<const float*>(h);
  auto dhp = static_cast<const float*>(dh);
  auto dlip = static_cast<float*>(dlog_i);
  auto dlfp = static_cast<float*>(dlog_f);
  auto sp = static_cast<unsigned char*>(scratch);
  if (dtype == repro::kFloat32)
    return repro::launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), li, lf, wsf, dn, hp, dhp,
                             static_cast<float*>(dq), static_cast<float*>(dk),
                             static_cast<float*>(dv), dlip, dlfp, static_cast<float*>(scratch), B,
                             S, H, dk_, c, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch(static_cast<const repro::bf16*>(q), static_cast<const repro::bf16*>(k),
                         static_cast<const repro::bf16*>(v), li, lf, wsf, true, dn, hp, dhp,
                         static_cast<repro::bf16*>(dq), static_cast<repro::bf16*>(dk),
                         static_cast<repro::bf16*>(dv), dlip, dlfp, sp, B, S, H, dk_, c, scale, s);
  return cudaErrorInvalidValue;
}
