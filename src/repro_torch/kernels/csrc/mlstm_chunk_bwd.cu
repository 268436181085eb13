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
// the same cumsum, csrc/mlstm.cuh, and an exact max).
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
// What bounds it on the H100: operations, in f32 on the CUDA cores.  At
// xlstm-125m's (2, 1024, 4, 384), chunk 128: five c^2 dk / 2 products and
// three c dk^2 products a chunk and head, 9.3 GFLOP (0.139 ms at 67 TFLOP/s)
// against 63 MB of inputs and outputs.
//
// Design: a simple kernel that is right, in f32 on the CUDA cores, five
// passes on the caller's stream, no atomics, every sum in a fixed order:
// - rows: per (batch x head, chunk), each row's m_i, inter_i, lim_i, dden_i
//   (dh . h summed by a warp), each position's carry weight w_j and the
//   chunk's decay;
// - state: per (batch x head, 64 x 64 tile of G), the reverse walk above
//   (G's columns and rows evolve independently, so no tile needs another:
//   dk = 384 gives 36 tiles where G whole, 576 KiB, fits no SM), writing
//   G_{t+1}, dn_{t+1} for every chunk to a workspace;
// - scores: per (batch x head, chunk), S = q k^T and dh v^T over dk into
//   shared memory, then W, dS and the row and column sums of dD (the
//   columns summed per warp, then over the warps in order), written out;
// - grads: per (batch x head, chunk, 64 columns of dk), dq, dk, dv for
//   those columns, and this block's share of the sums over dk that couple
//   columns (dinter, dw, ddecay), written to partials;
// - gates: per (batch x head, chunk), the partials summed over the column
//   blocks in order, then dlog_i and dlog_f (a reverse cumsum).
// q, k, v f32 or bf16 (read as f32); the carry C is read from the forward's
// workspace in either of its layouts (row-major for f32 inputs, mma
// fragment order for bf16).  Any dk up to 512 and any chunk up to 128.
#include <cstdint>

#include "mlstm.cuh"

namespace repro {
namespace {

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
  __shared__ float dcs[kMaxChunk];
  const int bh = blockIdx.x, chunk = blockIdx.y, nc = gridDim.y, nbh = gridDim.x;
  const int b = bh / H, hh = bh - b * H;
  const int lane = threadIdx.x;
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const long long row0 = chunk_row(b, S, chunk, c, H, hh);
  float wsum = 0.f;
  for (int i = lane; i < c; i += 32) {
    const long long row = row0 + static_cast<long long>(i) * H;
    float di = 0.f, dw = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const long long base = (static_cast<long long>(t) * nbh * nc + p) * c + i;
      di += sc.pinter[base];
      dw += sc.pw[base];
    }
    const float ww = dw * sc.w[row];
    wsum += ww;
    dcs[i] = di * sc.inter[row] + sc.rowD[row] - sc.colD[row] - ww;
    dlog_i[row] = sc.colD[row] + ww;
  }
  wsum = warp_sum(wsum);
  __syncwarp();
  if (lane == 0) {
    float dd = 0.f;
    for (int t = 0; t < ntiles; ++t) dd += sc.pdecay[static_cast<long long>(t) * nbh * nc + p];
    dcs[c - 1] += dd * sc.decay[p] + wsum;
    float run = 0.f;
    for (int j = c - 1; j >= 0; --j) {
      run += dcs[j];
      dlog_f[row0 + static_cast<long long>(j) * H] = run;
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

}  // namespace
}  // namespace repro

// Floats of scratch the backward needs beside its workspace of gradients
// (B * H * (S / c) * (dk^2 + dk) floats): the rows' and chunks' scalars, W
// and dS, and the column blocks' partials.
extern "C" long long repro_mlstm_chunk_bwd_scratch(int B, int S, int H, int dk, int c) {
  const long long rows = static_cast<long long>(B) * S * H, chunks = rows / c;
  const long long tiles = repro::ceil_div(dk, repro::kTile);
  return 7 * rows + chunks + 2 * chunks * c * c + tiles * (2 * rows + chunks);
}

// q, k, v (B, S, H, dk) in `dtype` as the forward took them; log_i, log_f
// (B, S, H) f32 as the forward took them (log_f already a log sigmoid);
// ws the forward's workspace (its carries), den (B, S, H) the forward's
// denominators, h (B, S, H, dk) f32 its output; dh (B, S, H, dk) f32 the
// output's gradient.  Writes dq, dk, dv (B, S, H, dk) f32 (dq for the
// unscaled q), dlog_i, dlog_f (B, S, H) f32.  gws: B * H * (S / c) * (dk^2 +
// dk) floats; scratch: repro_mlstm_chunk_bwd_scratch floats.  Five launches
// on `stream`.  Returns the CUDA error of the launches (0 on success).
extern "C" int repro_mlstm_chunk_bwd(int device, int dtype, const void* q, const void* k,
                                     const void* v, const void* log_i, const void* log_f,
                                     const void* ws, const void* den, const void* h,
                                     const void* dh, void* dq, void* dk, void* dv, void* dlog_i,
                                     void* dlog_f, void* gws, void* scratch, int B, int S, int H,
                                     int dk_, int c, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (dk_ <= 0 || dk_ > repro::kMaxDk || c <= 0 || c > repro::kMaxChunk || S % c)
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(B) * S * H, chunks = rows / c;
  const long long tiles = repro::ceil_div(dk_, repro::kTile);
  float* f = static_cast<float*>(scratch);
  repro::Scratch sc;
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
  auto s = static_cast<cudaStream_t>(stream);
  auto li = static_cast<const float*>(log_i);
  auto lf = static_cast<const float*>(log_f);
  auto wsf = static_cast<const float*>(ws);
  auto dn = static_cast<const float*>(den);
  auto hp = static_cast<const float*>(h);
  auto dhp = static_cast<const float*>(dh);
  auto dqp = static_cast<float*>(dq);
  auto dkp = static_cast<float*>(dk);
  auto dvp = static_cast<float*>(dv);
  auto dlip = static_cast<float*>(dlog_i);
  auto dlfp = static_cast<float*>(dlog_f);
  auto g = static_cast<float*>(gws);
  if (dtype == repro::kFloat32)
    return repro::launch(static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), li, lf, wsf, false, dn, hp, dhp, dqp, dkp,
                         dvp, dlip, dlfp, g, sc, B, S, H, dk_, c, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch(static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v), li, lf, wsf, true, dn, hp, dhp,
                         dqp, dkp, dvp, dlip, dlfp, g, sc, B, S, H, dk_, c, scale, s);
  return cudaErrorInvalidValue;
}
