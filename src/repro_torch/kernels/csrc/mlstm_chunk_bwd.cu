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

// An input q, k or v as an operand: bf16 read in place, in 16-byte pieces
// when dk is a multiple of 8 and the rows aligned.
inline Op input_op(const bf16* x, int dk) {
  const bool vec = dk % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  return Op{x, 0, dk, dk, vec};
}

inline Shape shape_of(int B, int S, int H, int dk, int c, float scale) {
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
  return sh;
}

inline Scratch scratch_of(unsigned char* scratch, const Layout& L) {
  auto f = [scratch](size_t off) { return reinterpret_cast<float*>(scratch + off); };
  auto hb = [scratch](size_t off) { return reinterpret_cast<bf16*>(scratch + off); };
  return Scratch{f(L.mi),     f(L.inter), f(L.dden),   f(L.w),    f(L.rowD),
                 f(L.decay),  f(L.colD),  f(L.pinter), f(L.pw),   f(L.pdecay), f(L.dn),
                 f(L.U),      f(L.un),    f(L.G),      hb(L.dnum), hb(L.u),    hb(L.W),
                 hb(L.dS)};
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const float* li, const float* lf,
                   const float* ws, bool frag, const float* den, const float* h, const float* dh,
                   T* dq, T* dk_out, T* dv, float* dli, float* dlf, unsigned char* scratch, int B,
                   int S, int H, int dk, int c, float scale, cudaStream_t stream) {
  constexpr int TQ = terms_of<T>();
  const Shape sh = shape_of(B, S, H, dk, c, scale);
  const Scratch sc = scratch_of(scratch, layout(B, S, H, dk, c));
  const Op qo = input_op(q, dk), ko = input_op(k, dk), vo = input_op(v, dk);
  const int BH = B * H, nc = sh.nc, nt = sh.ntile;
  const size_t moves_smem =
      (3 + TQ) * kMaxChunk * kP * sizeof(bf16) + 2 * kMaxChunk * sizeof(float);
  const size_t score_smem =
      2 * score_buffer<TQ>() * sizeof(bf16) + (2 + kScoreWarps) * kMaxChunk * sizeof(float);
  cudaError_t err = set_max_dynamic_smem(mlstm_bwd_moves<T>, moves_smem);
  if (err != cudaSuccess) return err;
  err = set_max_dynamic_smem(mlstm_bwd_scores<T>, score_smem);
  if (err != cudaSuccess) return err;
  err = set_max_dynamic_smem(mlstm_bwd_grads<T>, kGradSmem);
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
// f32 inputs take the same six passes on the same grids (_bwd_plan), with
// f32 FMA chains on the CUDA cores in place of mma.sync: on the tensor
// cores (q, k, v in three bf16 terms, six-term f32 x f32 products) one leaf
// of the reduced xlstm's f32 gradients lay 2.03 times as far from f64 as
// the plain path's (tests/test_torch_gpu.py::
// test_recurrent_train_gradients_on_card allows twice): the tensor cores
// align their products to the largest one before summing, which costs
// more than f32 FMA chains where the sums cancel.  Every thread owns an 8
// x 8 tile of a product and reads 16 operands for its 64 FMAs a step of the
// sum; tiles arrive by cp.async into two buffers, the next step copied
// while this one is multiplied.  The operands live in the bf16 planes'
// room of the scratch, in f32: dnum and u (rows x dkp), W and dS (cp x cp
// a chunk).  The state walk (mlstm_bwd_state, G in the forward's fragment
// order, C row-major) and the gates (mlstm_bwd_gates) are the bf16 path's
// own kernels: they add in f32 and f64 alone.
namespace cc {

constexpr int kMovesThreads = 64;   // moves: an 8 x 8 tile of U a thread
constexpr int kMP = kT + 4;         // moves: pitch of a 64-wide row
constexpr int kMD = 32;             // moves: positions a staged step
constexpr int kScoreThreads = 96;   // scores: 34 tiles of S, 34 of P = dnum v^T
constexpr int kSTiles = 34;
constexpr int kSD = 16;             // scores: dk a staged step
constexpr int kSPq = kSD + 4;       // pitch of its rows (+ 4 every 8 rows)
constexpr int kScA = 2 * 16 * kSPq + 4 * 4;         // q or dnum: the block's 32 rows
constexpr int kScB = kMaxChunk * kSPq + 16 * 4;     // k or v: the chunk's rows
constexpr int kScBuf = 2 * kScA + 2 * kScB;         // floats of a ring buffer
constexpr int kScPw = kMaxChunk + 1;                // pitch of S and P rows
constexpr size_t kScSmem = (2 * static_cast<size_t>(kScBuf) + 2 * 32 * kScPw + 2 * kMaxChunk +
                            2 * 32) * sizeof(float);
constexpr int kGradThreads = 128;   // grads: rows tr + 16 a, columns tc + 8 b of a 128 x 64 output
constexpr int kGD = 32;             // grads: depth of a staged step
constexpr int kGR = kGD + 4;        // pitch of [row][f] tiles (144 bytes)
constexpr int kGA = kMaxChunk * kGR;  // A: [128][kGR] or [kGD][kMaxChunk + 4]
constexpr int kGB = kT * kGR;         // B: [64][kGR] or [kGD][kT + 4]
constexpr int kGBuf = kGA + kGB;
constexpr size_t kGSmem = (2 * static_cast<size_t>(kGBuf) + 3 * kMaxChunk + kT) * sizeof(float);
static_assert(kGD * (kMaxChunk + 4) <= kGA && kGD * (kT + 4) <= kGB, "a buffer holds each layout");

// The f32 operands in the room of the bf16 planes (4 of their 6 bytes an element).
struct F32 {
  float *dnum, *u, *W, *dS;
};
inline F32 f32_of(const Scratch& sc) {
  return F32{reinterpret_cast<float*>(sc.dnum), reinterpret_cast<float*>(sc.u),
             reinterpret_cast<float*>(sc.W), reinterpret_cast<float*>(sc.dS)};
}

// Row r of a staged scores step: 16 floats, 4 more every 8 rows, so the 8
// rows of a tile lie on distinct banks.
__device__ __forceinline__ int sc_row(int r) { return r * kSPq + (r >> 3) * 4; }

// ------------------------------------------------------------------- rows

// The bf16 rows pass's scalars, and dnum and u = scale inter dnum in f32.
__global__ void __launch_bounds__(kRowWarps * 32)
mlstm_bwd_rows_f32(const float* __restrict__ log_i, const float* __restrict__ log_f,
                   const float* __restrict__ ws, const float* __restrict__ den,
                   const float* __restrict__ h, const float* __restrict__ dh, Scratch sc, F32 op,
                   Shape sh) {
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
    for (int e = lane; e < dkp; e += 32) {
      const float d = e < dk ? dh[row * dk + e] / lim : 0.f;
      op.dnum[row * dkp + e] = d;
      op.u[row * dkp + e] = d * su;
    }
  }
}

// ------------------------------------------------------------------ moves

// One block (64 threads) per (batch x head, chunk 1 .., 64 dk columns d x
// 64 value rows e): U = u^T q over the chunk's positions in steps of 32,
// thread (tr, tc) holding value rows 4 tr + {0..3, 32..35} and dk columns
// 4 tc + {0..3, 32..35}, one FMA chain an element; then written in the
// bf16 moves pass's accumulator order (the state pass reads it).  In the
// first column of tiles also un, as the bf16 pass forms it.
__global__ void __launch_bounds__(kMovesThreads)
mlstm_bwd_moves_f32(const float* __restrict__ q, F32 op, Scratch sc, Shape sh, bool vec) {
  __shared__ __align__(16) float buf[2][2][kMD][kMP];  // [buffer][u | q][position][column]
  __shared__ float sDd[kMaxChunk], sIn[kMaxChunk];
  const int H = sh.H, c = sh.c, dk = sh.dk, dkp = sh.dkp, nc = sh.nc;
  const int bh = blockIdx.x, ch = blockIdx.y + 1, b = bh / H, hh = bh - b * H;
  const int tile = blockIdx.z, d0 = (tile / sh.ntile) * kT, e0 = (tile % sh.ntile) * kT;
  const int tid = threadIdx.x, lane = tid & 31, tc = lane & 7, tr = (tid >> 5) * 4 + (lane >> 3);
  const long long p = static_cast<long long>(bh) * nc + ch;
  const long long row0 = chunk_row(b, sh.S, ch, c, H, hh);
  const int nsteps = ceil_div(c, kMD);
  const bool n_tile = e0 == 0;
  auto issue = [&](int st) {
    const int i0 = st * kMD;
    for (int x = tid; x < 2 * kMD * (kT / 4); x += kMovesThreads) {
      const int which = x / (kMD * (kT / 4)), y = x - which * (kMD * (kT / 4));
      const int r = y / (kT / 4), col = (y % (kT / 4)) * 4;
      const long long row = row0 + static_cast<long long>(i0 + r) * H;
      const bool ok = i0 + r < c;
      if (which == 0)
        copy4(&buf[st & 1][0][r][col], op.u + row * dkp + e0 + col, op.u, ok ? e0 + col : dkp, dkp,
              true);
      else
        copy4(&buf[st & 1][1][r][col], q + row * dk + d0 + col, q, ok ? d0 + col : dk, dk, vec);
    }
    cp_async_commit();
  };
  issue(0);
  for (int r = tid; r < c; r += kMovesThreads) {
    const long long row = row0 + static_cast<long long>(r) * H;
    sDd[r] = sc.dden[row];
    sIn[r] = sc.inter[row];
  }
  float U[8][8], un = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int x = 0; x < 8; ++x) U[a][x] = 0.f;
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait_all();
    __syncthreads();  // step st has landed everywhere; step st - 1's buffer is consumed
    if (st + 1 < nsteps) issue(st + 1);
    const float(*su)[kMP] = buf[st & 1][0];
    const float(*sq)[kMP] = buf[st & 1][1];
#pragma unroll 4
    for (int f = 0; f < kMD; ++f) {
      const float4 ua = *reinterpret_cast<const float4*>(&su[f][4 * tr]);
      const float4 ub = *reinterpret_cast<const float4*>(&su[f][32 + 4 * tr]);
      const float4 qa = *reinterpret_cast<const float4*>(&sq[f][4 * tc]);
      const float4 qb = *reinterpret_cast<const float4*>(&sq[f][32 + 4 * tc]);
      const float ue[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
      const float qd[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int x = 0; x < 8; ++x) U[a][x] = fmaf(ue[a], qd[x], U[a][x]);
    }
    if (n_tile)  // q whole: sum_i dden_i inter_i q_i scaled, for dk column d0 + tid
      for (int f = 0, i = st * kMD; f < kMD && i < c; ++f, ++i)
        un = fmaf(sDd[i], sIn[i] * (sq[f][tid] * sh.scale), un);
  }
  __syncthreads();  // every step is consumed: the buffers hold U^T[e][d] now
  float(*T)[kMP] = reinterpret_cast<float(*)[kMP]>(&buf[0][0][0][0]);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float* row = T[a < 4 ? 4 * tr + a : 32 + 4 * tr + a - 4];
    *reinterpret_cast<float4*>(row + 4 * tc) = make_float4(U[a][0], U[a][1], U[a][2], U[a][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tc) = make_float4(U[a][4], U[a][5], U[a][6], U[a][7]);
  }
  __syncthreads();
  // thread vt of the bf16 pass (warp w, lane 4 g + t) held, in tile nt, value
  // rows 16 (w % 4) + g (+ 8) and dk columns 32 (w / 4) + 8 nt + 2 t (+ 1)
  float4* out = reinterpret_cast<float4*>(sc.U) + (p * sh.ntile * sh.ntile + tile) * 4 * kThreads;
  for (int vt = tid; vt < kThreads; vt += kMovesThreads) {
    const int w = vt >> 5, g = (vt & 31) >> 2, t = vt & 3;
    const int e = 16 * (w & 3) + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = 32 * (w >> 2) + 8 * nt + 2 * t;
      out[nt * kThreads + vt] = make_float4(T[e][d], T[e][d + 1], T[e + 8][d], T[e + 8][d + 1]);
    }
  }
  if (n_tile && d0 + tid < dkp) sc.un[p * dkp + d0 + tid] = un;
}

// ----------------------------------------------------------------- scores

// One block (3 warps) per (batch x head, chunk, 16-row tiles z and 7 - z).
// Threads 0 .. 33 hold the causal 8 x 8 tiles of S = q k^T of the block's
// 32 rows (8-row bands up to the diagonal: 4 z + 3 + 4 (7 - z) + 3),
// threads 34 .. 67 the same tiles of P = dnum v^T, each an FMA chain over
// dk in steps of 16; then, a warp a row, W = S scale E, dW = P + dden, dS =
// dW E, dD = dW W (j <= i < c; written whole rows of cp, zero elsewhere),
// rowD (a warp sum) and this block's share of colD (its rows in order).
__global__ void __launch_bounds__(kScoreThreads)
mlstm_bwd_scores_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ log_i,
                     const float* __restrict__ log_f, F32 op, Scratch sc, Shape sh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* sS = ring + 2 * kScBuf;  // [32][kScPw]: S scale, then dD
  float* sP = sS + 32 * kScPw;
  float* scs = sP + 32 * kScPw;
  float* sli = scs + kMaxChunk;
  float* smi = sli + kMaxChunk;
  float* sdd = smi + 32;
  const int H = sh.H, c = sh.c, dk = sh.dk, dkp = sh.dkp, cp = sh.cp;
  const int bh = blockIdx.x, chunk = blockIdx.y, z = blockIdx.z, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = chunk_row(b, sh.S, chunk, c, H, hh);
  const long long p = static_cast<long long>(bh) * sh.nc + chunk;
  const int lo = z, hi = 7 - z;
  auto row_of = [lo, hi](int r) { return r < 16 ? 16 * lo + r : 16 * hi + r - 16; };
  const int krows = 16 * ((16 * hi < cp ? hi : lo) + 1);  // k and v rows the block's rows reach
  const int nd = ceil_div(dk, kSD);
  // this thread's tile: S (tid < 34) or P; 8-row band rb of the block, column band cb
  const bool s_thread = tid < kSTiles, p_thread = tid >= kSTiles && tid < 2 * kSTiles;
  int rb = 0, cb = 0;
  for (int half = 0, n = 0, s = s_thread ? tid : tid - kSTiles; half < 2; ++half)
    for (int band = 0; band < 2; ++band) {
      const int cnt = 2 * (half ? hi : lo) + band + 1;
      if (s >= n && s < n + cnt) {
        rb = 2 * half + band;
        cb = s - n;
      }
      n += cnt;
    }

  auto issue = [&](int st) {
    float* buf = ring + (st & 1) * kScBuf;
    const int d0 = st * kSD;
    constexpr int kPc = kSD / 4;
    for (int x = tid; x < (2 * 32 + 2 * kMaxChunk) * kPc; x += kScoreThreads) {
      const int r = x / kPc, col = (x % kPc) * 4;
      if (r < 64) {  // q (r < 32) and dnum of the block's rows
        const int rr = r & 31, pos = row_of(rr);
        const long long row = row0 + static_cast<long long>(pos) * H;
        if (r < 32)
          copy4(buf + sc_row(rr) + col, q + row * dk + d0 + col, q, pos < c ? d0 + col : dk, dk, vec);
        else
          copy4(buf + kScA + sc_row(rr) + col, op.dnum + row * dkp + d0 + col, op.dnum,
                pos < c ? d0 + col : dkp, dkp, true);
      } else {  // k and v of the chunk's rows
        const int rr = (r - 64) % kMaxChunk, is_v = (r - 64) / kMaxChunk;
        if (rr >= krows) continue;
        const float* src = (is_v ? v : k) + (row0 + static_cast<long long>(rr) * H) * dk + d0 + col;
        copy4(buf + 2 * kScA + is_v * kScB + sc_row(rr) + col, src, k, rr < c ? d0 + col : dk, dk,
              vec);
      }
    }
    cp_async_commit();
  };
  issue(0);
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, scs, c, lane);
    for (int j = lane; j < c; j += 32) sli[j] = log_i[row0 + static_cast<long long>(j) * H];
    for (int j = c + lane; j < kMaxChunk; j += 32) scs[j] = sli[j] = 0.f;
  } else if (warp == 1) {
    const int i = row_of(lane);
    const long long row = row0 + static_cast<long long>(i) * H;
    smi[lane] = i < c ? sc.mi[row] : 0.f;
    sdd[lane] = i < c ? sc.dden[row] : 0.f;
  }
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[a][x] = 0.f;
  for (int st = 0; st < nd; ++st) {
    cp_async_wait_all();
    __syncthreads();  // step st has landed everywhere; step st - 1's buffer is consumed
    if (st + 1 < nd) issue(st + 1);
    if (!s_thread && !p_thread) continue;
    const float* buf = ring + (st & 1) * kScBuf;
    const float* sa = buf + (s_thread ? 0 : kScA);
    const float* sb = buf + 2 * kScA + (s_thread ? 0 : kScB);
#pragma unroll 4
    for (int f = 0; f < kSD; ++f) {
      float x8[8], y8[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        x8[x] = sa[sc_row(8 * rb + x) + f];
        y8[x] = sb[sc_row(8 * cb + x) + f];
      }
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(x8[x], y8[y], acc[x][y]);
    }
  }
  if (s_thread || p_thread) {
    float* dst = s_thread ? sS : sP;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y)
        dst[(8 * rb + x) * kScPw + 8 * cb + y] = s_thread ? acc[x][y] * sh.scale : acc[x][y];
  }
  __syncthreads();
  const long long cc = static_cast<long long>(cp) * cp;
  for (int r = warp; r < 32; r += kScoreThreads / 32) {
    const int i = row_of(r);
    if (i >= cp) continue;
    const bool ok = i < c;
    const float csi = scs[i], mi = smi[r], dd = sdd[r];
    float rs = 0.f;
    for (int j = lane; j < cp; j += 32) {
      const bool on = ok && j <= i;
      const float E = on ? expf(csi - scs[j] + sli[j] - mi) : 0.f;
      const float Wv = on ? sS[r * kScPw + j] * E : 0.f;
      const float dW = on ? sP[r * kScPw + j] + dd : 0.f;
      const float dD = dW * Wv;
      rs += dD;
      op.W[p * cc + static_cast<long long>(i) * cp + j] = Wv;
      op.dS[p * cc + static_cast<long long>(i) * cp + j] = dW * E;
      sS[r * kScPw + j] = dD;
    }
    rs = warp_sum(rs);
    if (lane == 0 && ok) sc.rowD[row0 + static_cast<long long>(i) * H] = rs;
  }
  __syncthreads();
  for (int j = tid; j < c; j += kScoreThreads) {
    float x = 0.f;
    for (int r = 0; r < 32; ++r)
      if (row_of(r) < c) x += sS[r * kScPw + j];
    sc.colD[z * sh.rows + row0 + static_cast<long long>(j) * H] = x;
  }
}

// ------------------------------------------------------------------ grads

// acc += A B over one staged step of kGD: A [row][f] (ARF) or [f][row], B
// [col][f] (BCF) or [f][col]; this thread's rows tr + 16 a for a in [alo,
// ahi] (the others are zero over this step) and columns tc + 8 b.
template <bool ARF, bool BCF>
__device__ __forceinline__ void grads_fma(float (&acc)[8][8], const float* sA, const float* sB,
                                          int tr, int tc, int alo, int ahi) {
#pragma unroll 4
  for (int f = 0; f < kGD; ++f) {
    float bv[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) bv[y] = BCF ? sB[(tc + 8 * y) * kGR + f] : sB[f * (kT + 4) + tc + 8 * y];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (a < alo || a > ahi) continue;
      const float x = ARF ? sA[(tr + 16 * a) * kGR + f] : sA[f * (kMaxChunk + 4) + tr + 16 * a];
#pragma unroll
      for (int y = 0; y < 8; ++y) acc[a][y] = fmaf(x, bv[y], acc[a][y]);
    }
  }
}

// One block (128 threads) per (batch x head, chunk, output MODE 0 dq | 1
// dk | 2 dv, 64 columns c0 ..), as the bf16 pass: first the carry's product
// over dk in steps of 32 (MODE 0: C dnum; 1: G v; 2: G^T k) and its
// partials, then the chunk's over positions (dS k; dS^T scale q; W^T dnum)
// added to it.  G comes from the fragment order in 8-byte pieces.
template <int MODE>
__device__ __forceinline__ void grads_f32_body(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               const float* __restrict__ ws, F32 op, Scratch sc,
                                               float* __restrict__ out, Shape sh, int ct, bool vec,
                                               float* smem) {
  float* sInter = smem + 2 * kGBuf;
  float* sDden = sInter + kMaxChunk;
  float* sW = sDden + kMaxChunk;
  float* sN = sW + kMaxChunk;  // [kT]: n (dq) or dn (dk) of the block's columns
  const int H = sh.H, c = sh.c, dk = sh.dk, dkp = sh.dkp, cp = sh.cp, nc = sh.nc, nkb = dkp / 16;
  const int bh = blockIdx.x, chunk = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, tc = lane & 7, tr = (tid >> 5) * 4 + (lane >> 3);
  const int c0 = ct * kT;
  const long long row0 = chunk_row(b, sh.S, chunk, c, H, hh);
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const Carry wsc = carry_of(const_cast<float*>(ws), sh.P, dkp);
  const bool carry = MODE == 0 ? chunk > 0 : chunk + 1 < nc;
  const int n1 = carry ? ceil_div(dk, kGD) : 0, nsteps = n1 + ceil_div(cp, kGD);
  const long long cc = static_cast<long long>(cp) * cp;
  const float* G = sc.G + p * dkp * dkp;

  auto issue = [&](int st) {
    float* sA = smem + (st & 1) * kGBuf;
    float* sB = sA + kGA;
    if (st < n1) {
      const int f0 = st * kGD;
      for (int x = tid; x < kMaxChunk * (kGD / 4); x += kGradThreads) {  // A: dnum, v or k [i][f]
        const int r = x / (kGD / 4), col = (x % (kGD / 4)) * 4;
        const long long row = row0 + static_cast<long long>(r) * H;
        if (MODE == 0)
          copy4(sA + r * kGR + col, op.dnum + row * dkp + f0 + col, op.dnum,
                r < c ? f0 + col : dkp, dkp, true);
        else
          copy4(sA + r * kGR + col, (MODE == 1 ? v : k) + row * dk + f0 + col, k,
                r < c ? f0 + col : dk, dk, vec);
      }
      if (MODE == 0) {  // B: C[d][e] as [d = c0 ..][e = f0 ..]
        const float* Cg = wsc.C + p * dkp * dkp;
        for (int x = tid; x < kT * (kGD / 4); x += kGradThreads) {
          const int r = x / (kGD / 4), col = (x % (kGD / 4)) * 4;
          copy4(sB + r * kGR + col, Cg + static_cast<long long>(c0 + r) * dk + f0 + col, ws,
                c0 + r < dk ? f0 + col : dk, dk, vec);
        }
      } else {  // B: G[d][e] from its fragment pieces (e, d .. d + 1 and d + 8 .. d + 9)
        for (int x = tid; x < 8 * 64; x += kGradThreads) {
          const int u = x >> 6, half = (x >> 5) & 1, l = x & 31, g = l >> 2, t = l & 3;
          // MODE 1: [e = f0 ..][d = c0 ..], units 2 (e) x 4 (d); 2: [e = c0 ..][d = f0 ..], 4 x 2
          const int ue = MODE == 1 ? u >> 2 : u >> 1, ud = MODE == 1 ? u & 3 : u & 1;
          const int eb = (MODE == 1 ? f0 : c0) / 16 + ue, kb = (MODE == 1 ? c0 : f0) / 16 + ud;
          const bool ok = eb < nkb && kb < nkb;
          const float* src = G + (static_cast<long long>(ok ? eb : 0) * nkb + (ok ? kb : 0)) * kUnit +
                             half * (kUnit / 2) + l * 4;
          const int el = 16 * ue + 8 * half + g, dl = 16 * ud + 2 * t;
          float* dst = MODE == 1 ? sB + el * (kT + 4) + dl : sB + el * kGR + dl;
          cp_async8(dst, src, ok);  // d, d + 1
          cp_async8(dst + 8, src + 2, ok);  // d + 8, d + 9: 8 floats on in either layout
        }
      }
    } else {
      const int s0 = (st - n1) * kGD;
      if (MODE == 0) {  // A: dS [i][j = s0 ..]
        const float* M = op.dS + p * cc;
        for (int x = tid; x < kMaxChunk * (kGD / 4); x += kGradThreads) {
          const int r = x / (kGD / 4), col = (x % (kGD / 4)) * 4;
          copy4(sA + r * kGR + col, M + static_cast<long long>(r) * cp + s0 + col, M,
                r < cp ? s0 + col : cp, cp, true);
        }
      } else {  // A: dS^T or W^T, [f = i = s0 ..][j]
        const float* M = (MODE == 1 ? op.dS : op.W) + p * cc;
        for (int x = tid; x < kGD * (kMaxChunk / 4); x += kGradThreads) {
          const int r = x / (kMaxChunk / 4), col = (x % (kMaxChunk / 4)) * 4;
          copy4(sA + r * (kMaxChunk + 4) + col, M + static_cast<long long>(s0 + r) * cp + col, M,
                s0 + r < cp ? col : cp, cp, true);
        }
      }
      // B: k (dq), q (dk, scaled as it lands) or dnum (dv) of positions s0 .., [f][col]
      for (int x = tid; x < kGD * (kT / 4); x += kGradThreads) {
        const int r = x / (kT / 4), col = (x % (kT / 4)) * 4;
        const long long row = row0 + static_cast<long long>(s0 + r) * H;
        if (MODE == 2)
          copy4(sB + r * (kT + 4) + col, op.dnum + row * dkp + c0 + col, op.dnum,
                s0 + r < c ? c0 + col : dkp, dkp, true);
        else
          copy4(sB + r * (kT + 4) + col, (MODE == 0 ? k : q) + row * dk + c0 + col, q,
                s0 + r < c ? c0 + col : dk, dk, vec);
      }
    }
    cp_async_commit();
  };
  issue(0);
  for (int r = tid; r < kMaxChunk; r += kGradThreads) {
    const long long row = row0 + static_cast<long long>(r) * H;
    const bool ok = r < c;
    sInter[r] = ok ? sc.inter[row] : 0.f;
    sDden[r] = ok ? sc.dden[row] : 0.f;
    sW[r] = ok ? sc.w[row] : 0.f;
  }
  for (int d = tid; d < kT; d += kGradThreads) {
    const bool ok = carry && c0 + d < dk;
    sN[d] = !ok ? 0.f : MODE == 0 ? wsc.n[p * dkp + c0 + d] : MODE == 1 ? sc.dn[p * dkp + c0 + d] : 0.f;
  }
  __syncthreads();
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[a][y] = 0.f;

  for (int st = 0;; ++st) {
    if (st == n1) {
      // the carry's product is whole.  MODE 0: dinter's share, acc = inter (C
      // dnum + dden n); 1: dw's share, acc = w (G v + dn); 2: acc = w G^T k
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = tr + 16 * a;
        const bool ok = i < c;
        const float* xr = (MODE == 0 ? q : k) + (row0 + static_cast<long long>(i) * H) * dk + c0;
        float part = 0.f;
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int col = tc + 8 * y;
          if (MODE == 0) {
            const float xe = ok && c0 + col < dk ? xr[col] : 0.f;
            const float t = fmaf(sDden[i], sN[col], acc[a][y]);
            part = fmaf(xe * sh.scale, t, part);
            acc[a][y] = sInter[i] * t;
          } else if (MODE == 1) {
            const float xe = ok && c0 + col < dk ? xr[col] : 0.f;
            const float t = acc[a][y] + sN[col];
            part = fmaf(xe, t, part);
            acc[a][y] = sW[i] * t;
          } else {
            acc[a][y] = sW[i] * acc[a][y];
          }
        }
        if (MODE != 2) {  // the row's 64 columns: 8 lanes, 8 columns each
          part += __shfl_xor_sync(kFull, part, 1);
          part += __shfl_xor_sync(kFull, part, 2);
          part += __shfl_xor_sync(kFull, part, 4);
          if (tc == 0 && ok)
            (MODE == 0 ? sc.pinter : sc.pw)[static_cast<long long>(ct) * sh.rows + row0 +
                                            static_cast<long long>(i) * H] = part;
        }
      }
    }
    if (st == nsteps) break;
    cp_async_wait_all();
    const float* sA = smem + (st & 1) * kGBuf;
    const float* sB = sA + kGA;
    if (MODE == 1 && st >= n1)  // scale this thread's own pieces of q as they land
      for (int x = tid; x < kGD * (kT / 4); x += kGradThreads) {
        float4* y = reinterpret_cast<float4*>(const_cast<float*>(sB) + (x / (kT / 4)) * (kT + 4) +
                                              (x % (kT / 4)) * 4);
        float4 z = *y;
        z.x *= sh.scale;
        z.y *= sh.scale;
        z.z *= sh.scale;
        z.w *= sh.scale;
        *y = z;
      }
    __syncthreads();  // step st has landed everywhere; step st - 1's buffer is consumed
    if (st + 1 < nsteps) issue(st + 1);
    if (st < n1) {
      if (MODE == 1)
        grads_fma<true, false>(acc, sA, sB, tr, tc, 0, 7);
      else
        grads_fma<true, true>(acc, sA, sB, tr, tc, 0, 7);
      continue;
    }
    // the chunk's product: MODE 0 rows i take j <= i (bands a >= s0 / 16);
    // 1, 2 rows j take i >= j (bands a <= (s0 + 31) / 16)
    const int s0 = (st - n1) * kGD;
    if (MODE == 0)
      grads_fma<true, false>(acc, sA, sB, tr, tc, s0 / 16, 7);
    else
      grads_fma<false, false>(acc, sA, sB, tr, tc, 0, (s0 + kGD - 1) / 16);
  }

  // dq = scale acc, dk = acc, dv = acc
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = tr + 16 * a;
    if (i >= c) continue;
    float* o = out + (row0 + static_cast<long long>(i) * H) * dk + c0;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int col = tc + 8 * y;
      if (c0 + col < dk) o[col] = MODE == 0 ? acc[a][y] * sh.scale : acc[a][y];
    }
  }
}

__global__ void __launch_bounds__(kGradThreads, 3)
mlstm_bwd_grads_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ ws, F32 op, Scratch sc,
                    float* __restrict__ dq, float* __restrict__ dk_out, float* __restrict__ dv,
                    Shape sh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int mode = blockIdx.z / sh.ntile, ct = blockIdx.z - mode * sh.ntile;
  if (mode == 0)
    grads_f32_body<0>(q, k, v, ws, op, sc, dq, sh, ct, vec, smem);
  else if (mode == 1)
    grads_f32_body<1>(q, k, v, ws, op, sc, dk_out, sh, ct, vec, smem);
  else
    grads_f32_body<2>(q, k, v, ws, op, sc, dv, sh, ct, vec, smem);
}

}  // namespace cc

// The f32 entry: rows, moves, state, scores, grads, gates on the bf16
// path's scratch and grids.
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* li,
                       const float* lf, const float* ws, const float* den, const float* h,
                       const float* dh, float* dq, float* dk_out, float* dv, float* dli,
                       float* dlf, unsigned char* scratch, int B, int S, int H, int dk, int c,
                       float scale, cudaStream_t stream) {
  const Shape sh = shape_of(B, S, H, dk, c, scale);
  const Scratch sc = scratch_of(scratch, layout(B, S, H, dk, c));
  const cc::F32 op = cc::f32_of(sc);
  const bool vec = dk % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(ws)) & 15u) == 0;
  const int BH = B * H, nc = sh.nc, nt = sh.ntile;
  cudaError_t err = set_max_dynamic_smem(cc::mlstm_bwd_scores_f32, cc::kScSmem);
  if (err != cudaSuccess) return err;
  err = set_max_dynamic_smem(cc::mlstm_bwd_grads_f32, cc::kGSmem);
  if (err != cudaSuccess) return err;
  cc::mlstm_bwd_rows_f32<<<dim3(BH, nc, ceil_div(c, kRowGroup)), kRowWarps * 32, 0, stream>>>(
      li, lf, ws, den, h, dh, sc, op, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nc > 1) {
    cc::mlstm_bwd_moves_f32<<<dim3(BH, nc - 1, nt * nt), cc::kMovesThreads, 0, stream>>>(q, op, sc,
                                                                                        sh, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mlstm_bwd_state<<<dim3(BH, nt, nt), kThreads, 0, stream>>>(ws, false, sc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc::mlstm_bwd_scores_f32<<<dim3(BH, nc, kScoreBlocks), cc::kScoreThreads, cc::kScSmem, stream>>>(
      q, k, v, li, lf, op, sc, sh, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc::mlstm_bwd_grads_f32<<<dim3(BH, nc, 3 * nt), cc::kGradThreads, cc::kGSmem, stream>>>(
      q, k, v, ws, op, sc, dq, dk_out, dv, sh, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_gates<<<dim3(BH, nc), 32, 0, stream>>>(sc, dli, dlf, sh);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Bytes of scratch the backward needs (repro_mlstm_chunk_bwd's `scratch`,
// 256-byte aligned), for either dtype: the rows' and chunks' scalars and
// partials, each chunk's moves U and G, and the operands (bf16: dnum, u, W
// and dS in three bf16 planes; f32: the same in f32, in the planes' room).
extern "C" long long repro_mlstm_chunk_bwd_scratch(int B, int S, int H, int dk, int c) {
  return static_cast<long long>(repro::layout(B, S, H, dk, c).total);
}

// q, k, v (B, S, H, dk) in `dtype` as the forward took them; log_i, log_f
// (B, S, H) f32 as the forward took them (log_f already a log sigmoid);
// ws the forward's workspace (its carries), den (B, S, H) the forward's
// denominators, h (B, S, H, dk) f32 its output; dh (B, S, H, dk) f32 the
// output's gradient.  Writes dq, dk, dv (B, S, H, dk) in `dtype` (dq for
// the unscaled q; bf16 rounded to nearest from the f32 sums), dlog_i,
// dlog_f (B, S, H) f32.  scratch: repro_mlstm_chunk_bwd_scratch bytes,
// 256-byte aligned.  `col_tiles`, `row_groups` and `score_blocks` are the
// wrapper's plan (mlstm_chunk._bwd_plan: ceil(dk / 64), ceil(c / 16), 4);
// another plan is refused.  Six kernels (five for one chunk) on `stream`:
// bf16 on the tensor cores, f32 on the CUDA cores.  Returns the CUDA error
// of the launches (0 on success).
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
                             static_cast<float*>(dv), dlip, dlfp, sp, B, S, H, dk_, c, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch(static_cast<const repro::bf16*>(q), static_cast<const repro::bf16*>(k),
                         static_cast<const repro::bf16*>(v), li, lf, wsf, true, dn, hp, dhp,
                         static_cast<repro::bf16*>(dq), static_cast<repro::bf16*>(dk),
                         static_cast<repro::bf16*>(dv), dlip, dlfp, sp, B, S, H, dk_, c, scale, s);
  return cudaErrorInvalidValue;
}
