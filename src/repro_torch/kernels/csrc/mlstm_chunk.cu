// Chunkwise-parallel stabilized mLSTM, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py::mlstm_chunk
// (_mlstm_kernel), which mirrors models/recurrent.py::mlstm_chunk_recurrence:
// per (batch, head) the matrix memory C (dk x dk), the normalizer n (dk) and
// the stabilizer m are carried over chunks of c positions; within a chunk
//   csum = cumsum(log_f), D[i,j] = csum_i - csum_j + log_i_j (j <= i),
//   m_i = max(max_j D[i,j], csum_i + m),  W = (q k^T) * exp(D - m_i),
//   num = W v + exp(csum_i + m - m_i) q C,  den = rowsum(W) + (same) q.n,
//   h = num / max(|den|, exp(-m_i)),
// then (C, n, m) move to the chunk's end:
//   dec_j = total - csum_j + log_i_j, m' = max(m + total, max_j dec_j),
//   C' = exp(m + total - m') C + sum_j exp(dec_j - m') k_j v_j^T (n alike).
// q (scaled by 1/sqrt(dk)), k, v (B, S, H, dk) f32 or bf16, log_i, log_f
// (B, S, H) f32; h (B, S, H, dk) f32; optionally the final C (B, H, dk, dk),
// n (B, H, dk), m (B, H).  Everything is computed in f32.
//
// What bounds it on the H100: bytes, in bf16.  At xlstm-125m's (1, 2048, 4,
// 384), chunk 128, it does 5.6 GFLOP (q k^T and W v over the lower
// triangle, q C and the C update), 5.7 us at the bf16 tensor-core rate,
// against 34 MB of inputs and outputs, 10 us at 3.35 TB/s.  In f32 the
// CUDA cores' 67 TFLOP/s make it operation bound (84 us).
//
// Design (the chunkwise-parallel form of the xLSTM / TFLA kernels), in two
// passes on the caller's stream.  Its premise: the stabilizer chain (m per
// chunk) depends only on the gates, so every block that needs it
// recomputes it from log_f and log_i in the same order, with the same
// bits, and the blocks need not talk.
// - State pass, grid (batch * head, 64 dk rows, 96 value columns): 96
//   blocks at xlstm's width, one an SM.  A block walks the chunks in order,
//   keeps its tile of C (and, in the first column of tiles, of n) in
//   registers, and writes the carry entering each chunk (C, n, m) to a
//   workspace (B * H * S / c entries; the first, zero, is never written or
//   read).  The last state becomes the optional final (C, n, m).
// - Output pass, grid (batch * head, chunk, 192 value columns): 128 blocks.
//   A block forms S = q k^T over dk, the masked log weights and
//   stabilizers, W and its row sums once, then for each of its three
//   64-wide value tiles num = W v + inter q C and den = rowsum(W) + inter
//   q.n from the carry in the workspace, and writes h.
// - bf16: every product but n's runs on mma.sync m16n8k16 with f32 sums
//   (mma.cuh).  q, k and v are exact in bf16; each f32 operand (w v in the
//   update, C and n in q C and q.n, W in W v) is split into three bf16
//   terms hi + mid + lo, which hold all 24 bits of an f32: with hi + lo
//   alone (16 bits) xlstm's layers, whose normalizer cancels to |h| ~ 1e4,
//   leave 60 to 170 times as many elements off their f64 result as the
//   plain version does.  The 1/sqrt(dk) scale multiplies the f32 products.
//   The tensor cores' own sums truncate, so each short run of them (a 64
//   dk step, or one k step) is added to f32 running sums.  The workspace
//   holds C in f32, in mma fragment order, written and read as 16-byte
//   pieces.  Tiles move by cp.async (16-byte pieces where dk is a multiple
//   of 8), double-buffered over chunks (state) and in a ring of three steps
//   (output).
// - f32: the same two passes on the CUDA cores, register-tiled FMA chains
//   (below, "f32 passes"): the state pass a chained scan, one block per
//   (chunk, 64 x 64 tile of C) forming the chunk's move at once and then
//   taking C from the block of the chunk before (2304 blocks at xlstm's
//   prefill); the output pass on 192 value columns and half of a chunk's
//   rows a block (256 blocks of 9 warps, one an SM); the workspace keeps C
//   row-major.
// - The gates' cumsum is a warp scan (each lane sums a run in order, the
//   runs are scanned with shuffles) and the carry weights are taken by a
//   warp; every sum has one fixed order, so two calls give equal bits.
// Any dk up to 512 and any c up to 128; tiles past dk or c are zero-filled.
#include <cstdint>

#include "mlstm.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kTile = 64;          // dk rows of a state tile; bf16 output: value tile, dk step
constexpr int kPitch = kTile + 8;  // bf16 shared rows of 144 bytes: ldmatrix rows on distinct banks
constexpr int kStateE = 96;        // bf16 state pass: value columns of a block's tile of C
constexpr int kStateWarps = 12;    // bf16 state pass: 6 x 2 warps on a 96 x 64 tile of C^T
constexpr int kGateGroup = 16;     // bf16 state pass: chunks whose carry moves are taken at once
constexpr int kOutWarps = 8;       // bf16 output pass: 16 positions a warp
constexpr int kOutStages = 3;      // bf16 output pass: steps in the ring of buffers
constexpr int kValueGroup = 3;     // bf16 output pass: 64-wide value tiles a block

// An element pair (e, e + 1) of a row of h: paired when dk is even (the
// pair is then aligned), else element by element.
__device__ __forceinline__ void store2(float* p, float x0, float x1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (second) p[1] = x1;
  }
}
// ------------------------------------------------------------ bf16 passes
//
// The workspace holds each carry C in f32, in mma fragment order, as the
// output pass's B operand of q C wants it: C's (dkp / 16)^2 units of 16 dk
// rows x 16 value columns, unit (eb, kb) at ((eb * dkp / 16) + kb) * kUnit;
// in a unit, lane l = 4 g + t holds at l * 4 the pairs of B fragments b0,
// b1 of value column 16 eb + g and at kUnit / 2 + l * 4 those of column
// 16 eb + 8 + g (b0: dk rows 16 kb + 2t, + 1; b1: 16 kb + 2t + 8, + 9).  The
// state pass computes C^T, whose m16n8 accumulators hold exactly these
// pairs, so a lane stores its unit as two 16-byte pieces; the output pass
// splits them into bf16 hi + mid + lo as it multiplies.

constexpr int kUnit = 256;  // floats in a 16 x 16 unit

struct StateTC {
  bf16 k[2][kMaxChunk][kPitch];  // k rows of a chunk, this block's dk columns
  bf16 v[2][kMaxChunk][kStateE + 8];  // v rows, this block's value columns
  float w[kGateGroup][kMaxChunk];  // the weights w_j of the group's chunks (0 past c)
  float total[kGateGroup], dmax[kGateGroup], decay[kGateGroup], m_next[kGateGroup];
};

// The carry moves of chunks g0 .. g0 + n - 1 (n <= kGateGroup), by the
// whole block of kWarps warps: warp w takes chunks w, w + kWarps, ..
// (loading their gates before it needs them): their cumsum (warp_cumsum's
// order, in registers), total and dec_j = total - csum_j + log_i_j (into w)
// and max_j dec_j; then one thread runs the m chain through them from `m`;
// then every thread turns dec_j into w_j = exp(dec_j - m') for j < rows (0
// past c).  `m` enters the group.  Both state passes take their gates here.
template <int kWarps, typename Sm>
__device__ void group_gates(Sm& sm, const float* log_i, const float* log_f, long long head0,
                            int H, int c, int rows, int g0, int n, float m) {
  constexpr int kRun = kMaxChunk / 32, kPer = (kGateGroup + kWarps - 1) / kWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (c + 31) >> 5, j0 = lane * per;
  float lf[kPer][kRun], li[kPer][kRun];
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int i = warp + x * kWarps;
    const long long pos = static_cast<long long>(g0 + i) * c;
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      const bool ok = i < n && u < per && j0 + u < c;
      lf[x][u] = ok ? log_f[head0 + (pos + j0 + u) * H] : 0.f;
      li[x][u] = ok ? log_i[head0 + (pos + j0 + u) * H] : 0.f;
    }
  }
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int i = warp + x * kWarps;
    if (i >= n) break;
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < kRun; ++u) run += lf[x][u];
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    float acc = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) acc = 0.f;
    float cs[kRun], last = 0.f;
    const int u_last = (c - 1) - ((c - 1) / per) * per;  // c - 1 is lane (c - 1) / per's
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      acc += lf[x][u];
      cs[u] = acc;
      if (u == u_last) last = acc;
    }
    const float total = __shfl_sync(kFull, last, (c - 1) / per);
    float dmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < kRun; ++u)
      if (u < per && j0 + u < c) {
        const float dec = total - cs[u] + li[x][u];
        sm.w[i][j0 + u] = dec;
        dmax = fmaxf(dmax, dec);
      }
    dmax = warp_max(dmax);
    if (lane == 0) {
      sm.total[i] = total;
      sm.dmax[i] = dmax;
    }
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < n; ++i) {
      const float mn = fmaxf(m + sm.total[i], sm.dmax[i]);
      sm.decay[i] = expf(m + sm.total[i] - mn);
      sm.m_next[i] = mn;
      m = mn;
    }
  __syncthreads();
  for (int x = tid; x < n * rows; x += blockDim.x) {
    const int i = x / rows, j = x - i * rows;
    sm.w[i][j] = j < c ? expf(sm.w[i][j] - sm.m_next[i]) : 0.f;
  }
  __syncthreads();
}

// The A fragment of (w o v)^T in three bf16 terms (aw[r] is term r): a
// holds v^T (rows e, columns j = j0 + 2t, + 1 in a[0], a[1]; + 8, + 9 in
// a[2], a[3]).
__device__ __forceinline__ void weigh_a(const unsigned* a, const float* w, int j0, int t,
                                        unsigned (*aw)[4]) {
  const float2 w01 = *reinterpret_cast<const float2*>(w + j0 + 2 * t);
  const float2 w89 = *reinterpret_cast<const float2*>(w + j0 + 2 * t + 8);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[r]));
    const float2 wr = r < 2 ? w01 : w89;
    unsigned p[3];
    split3(x.x * wr.x, x.y * wr.y, p);
    aw[0][r] = p[0];
    aw[1][r] = p[1];
    aw[2][r] = p[2];
  }
}

// One block per (batch x head, 64 dk rows, 96 value columns) of C, walking
// the chunks in order (96 blocks at xlstm's width: one an SM).  12 warps:
// warp w holds C^T for value rows 16 (w % 6) .. and dk columns 32 (w / 6)
// .. in registers.  The k and v tiles of the next chunk land by cp.async
// while this one is multiplied; the gates of 16 chunks are taken at once;
// one barrier a chunk.  n = sum_j w_j k_j runs on the CUDA cores in the
// first column of tiles.
__global__ void __launch_bounds__(kStateWarps * 32, 1)
mlstm_state_tc(const bf16* __restrict__ k, const bf16* __restrict__ v,
               const float* __restrict__ log_i, const float* __restrict__ log_f,
               float* __restrict__ ws, float* __restrict__ C_out, float* __restrict__ n_out,
               float* __restrict__ m_out, int S, int H, int dk, int c, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateTC& sm = *reinterpret_cast<StateTC*>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  const int d0 = blockIdx.y * kTile, e0 = blockIdx.z * kStateE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int er = (warp % 6) * 16, dc = (warp / 6) * 32;  // this warp's value rows, dk columns
  const bool n_block = blockIdx.z == 0, n_warp = n_block && warp < kTile / 8;
  const bool m_thread = blockIdx.y == 0 && blockIdx.z == 0 && tid == 0;
  const int nc = S / c, rows = (c + 15) & ~15, nthreads = blockDim.x;
  const int dkp = (dk + 15) & ~15, nkb = dkp / 16;
  const long long tstride = static_cast<long long>(H) * dk;
  const long long head0 = static_cast<long long>(b) * S * H + hh;  // (b, 0, hh) in positions x H
  const bf16* kbase = k + head0 * dk + d0;
  const bf16* vbase = v + head0 * dk + e0;
  const Carry wsc = carry_of(ws, static_cast<long long>(gridDim.x) * nc, dkp);
  const bool want_final = C_out != nullptr;
  // n: lane quad (d, j mod 4) of warp w < 8 sums d = d0 + 8 w + g over j = t, t + 4, ...
  const int nd_ = d0 + warp * 8 + g;

  auto stage = [&](int ch, int buf) {
    const long long pos = static_cast<long long>(ch) * c;
    stage_rows(&sm.k[buf][0][0], kPitch, kbase + pos * tstride, tstride, rows, c, dk - d0, vec,
               tid, nthreads);
    stage_rows<kStateE>(&sm.v[buf][0][0], kStateE + 8, vbase + pos * tstride, tstride, rows, c,
                        dk - e0, vec, tid, nthreads);
    cp_async_commit();
  };

  float C[4][4], nrow = 0.f, m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) C[i][0] = C[i][1] = C[i][2] = C[i][3] = 0.f;

  stage(0, 0);
  for (int ch = 0; ch < nc; ++ch) {
    const int buf = ch & 1, gi = ch % kGateGroup;
    if (gi == 0)
      group_gates<kStateWarps>(sm, log_i, log_f, head0, H, c, rows, ch, min(kGateGroup, nc - ch),
                               m);
    cp_async_wait_all();
    __syncthreads();  // chunk ch has landed, and chunk ch - 1's buffer is consumed
    if (ch + 1 < nc) stage(ch + 1, buf ^ 1);
    if (ch + 1 == nc && !want_final) break;
    // this chunk's sum_j (w_j v_j) k_j^T for 16 value rows x 32 dk columns
    float u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i][0] = u[i][1] = u[i][2] = u[i][3] = 0.f;
    const float* w = sm.w[gi];
#pragma unroll 2
    for (int ks = 0; ks < rows / 16; ++ks) {
      unsigned a[4], aw[3][4];
      load_a_kmajor(a, &sm.v[buf][0][0], kStateE + 8, er, ks * 16, lane);
      weigh_a(a, w, ks * 16, t, aw);
      float up[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) up[i][0] = up[i][1] = up[i][2] = up[i][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bk[4];
        load_b_kmajor(bk, &sm.k[buf][0][0], kPitch, dc + np * 16, ks * 16, lane);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          mma16816(up[2 * np], aw[r], bk[0], bk[1]);
          mma16816(up[2 * np + 1], aw[r], bk[2], bk[3]);
        }
      }
      add_tiles<4>(u, up, 4);
    }
    float un = 0.f;
    if (n_warp) {  // sum_j w_j k_j[d]: lane t sums j = t + 4 u + 16 i in chains u, then the quad
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j0 = t; j0 < rows; j0 += 16)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part[u] = fmaf(w[j0 + 4 * u], __bfloat162float(sm.k[buf][j0 + 4 * u][warp * 8 + g]),
                         part[u]);
      un = (part[0] + part[1]) + (part[2] + part[3]);
      un += __shfl_xor_sync(kFull, un, 1);
      un += __shfl_xor_sync(kFull, un, 2);
    }
    const float decay = sm.decay[gi];
    m = sm.m_next[gi];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) C[i][e] = decay * C[i][e] + u[i][e];
    nrow = decay * nrow + un;

    if (ch + 1 < nc) {  // the carry entering chunk ch + 1
      const long long p = static_cast<long long>(bh) * nc + ch + 1;
      float* units = wsc.C + p * dkp * dkp;
      const int eb = (e0 + er) / 16;
#pragma unroll
      for (int q2 = 0; q2 < 2; ++q2) {
        const int kb = (d0 + dc) / 16 + q2;
        if (eb >= nkb || kb >= nkb) continue;
        float* unit = units + (static_cast<long long>(eb) * nkb + kb) * kUnit;
        *reinterpret_cast<float4*>(unit + lane * 4) =
            make_float4(C[2 * q2][0], C[2 * q2][1], C[2 * q2 + 1][0], C[2 * q2 + 1][1]);
        *reinterpret_cast<float4*>(unit + kUnit / 2 + lane * 4) =
            make_float4(C[2 * q2][2], C[2 * q2][3], C[2 * q2 + 1][2], C[2 * q2 + 1][3]);
      }
      if (n_warp && t == 0 && nd_ < dkp) wsc.n[p * dkp + nd_] = nrow;
      if (m_thread) wsc.m[p] = m;
    } else {  // the final state: C[d][e] from C^T's accumulators
      float* Cf = C_out + static_cast<long long>(bh) * dk * dk;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int d = d0 + dc + i * 8 + 2 * t + (x & 1), e = e0 + er + g + (x >> 1) * 8;
          if (d < dk && e < dk) Cf[static_cast<long long>(d) * dk + e] = C[i][x];
        }
      if (n_warp && t == 0 && nd_ < dk) n_out[static_cast<long long>(bh) * dk + nd_] = nrow;
      if (m_thread) m_out[bh] = m;
    }
    if (gi == kGateGroup - 1) __syncthreads();  // the group's weights are consumed
  }
}

// The output pass's shared memory, by byte offsets: q of the whole chunk
// (rows of ndt * 64 + 8 bf16), a ring of kOutStages steps (a k step:
// [128][kPitch] bf16; a C step: 16 units), v of two value tiles, n, gates.
struct OutLayout {
  int qpitch;
  size_t q, ring, v, n, lf, li, cs, total;
};
__host__ __device__ inline OutLayout out_layout(int dk) {
  OutLayout L;
  L.qpitch = ceil_div(dk, kTile) * kTile + 8;
  L.q = 0;
  L.ring = L.q + static_cast<size_t>(kMaxChunk) * L.qpitch * sizeof(bf16);
  L.v = L.ring + static_cast<size_t>(kOutStages) * kMaxChunk * kPitch * sizeof(bf16);
  L.n = L.v + static_cast<size_t>(2) * kMaxChunk * kPitch * sizeof(bf16);
  L.lf = L.n + kMaxDk * sizeof(float);
  L.li = L.lf + kMaxChunk * sizeof(float);
  L.cs = L.li + kMaxChunk * sizeof(float);
  L.total = L.cs + kMaxChunk * sizeof(float);
  return L;
}

// One block per (batch x head, chunk, up to kValueGroup 64-wide value
// tiles).  Steps 0 .. ndt - 1 bring q (kept whole) and k by 64-wide dk
// steps and form S = q k^T; then S becomes W (kept in f32 registers); then
// for each value tile, ndt steps bring the carry's units
// and form q C (and, in the first, q.n), and W v closes the tile.  Warps w
// and w + 4 (one SM sub-partition) take row blocks w and 7 - w, so the two
// share the causal work evenly.  The steps flow through a ring of
// kOutStages cp.async buffers, one barrier a step.
__global__ void __launch_bounds__(kOutWarps * 32, 1)
mlstm_out_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const float* __restrict__ log_i, const float* __restrict__ log_f,
             const float* __restrict__ ws, float* __restrict__ h, float* __restrict__ den,
             int S, int H, int dk, int c, float scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const OutLayout L = out_layout(dk);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw + L.q);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L.ring);
  bf16* sv = reinterpret_cast<bf16*>(smem_raw + L.v);
  float* sn = reinterpret_cast<float*>(smem_raw + L.n);
  float* slf = reinterpret_cast<float*>(smem_raw + L.lf);
  float* sli = reinterpret_cast<float*>(smem_raw + L.li);
  float* scs = reinterpret_cast<float*>(smem_raw + L.cs);
  constexpr int kStep = kMaxChunk * kPitch;  // bf16 of one ring buffer

  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int nc = S / c, rows = (c + 15) & ~15, nthreads = blockDim.x;
  const int dkp = (dk + 15) & ~15, nkb = dkp / 16, ndt = ceil_div(dk, kTile);
  const int vt0 = blockIdx.z * kValueGroup, nvt = min(kValueGroup, ndt - vt0);
  const int nsteps = ndt * (1 + nvt);
  const int rb = warp < 4 ? warp : 11 - warp;
  const bool active = rb * 16 < rows;
  const long long tstride = static_cast<long long>(H) * dk;
  const long long row0 =
      (static_cast<long long>(b) * S + static_cast<long long>(chunk) * c) * H + hh;
  const bool carry_in = chunk > 0;
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const Carry wsc = carry_of(const_cast<float*>(ws), static_cast<long long>(gridDim.x) * nc, dkp);
  const float* units = wsc.C + p * dkp * dkp;

  // one step's copies into its ring buffer, one cp.async group a step
  auto stage = [&](int step) {
    if (step >= nsteps) {
      cp_async_commit();  // empty: keeps the group count regular
      return;
    }
    if (step < ndt) {  // q and k, dk columns 64 step ..
      const int d0 = step * kTile;
      stage_rows(ring + (step % kOutStages) * kStep, kPitch, k + row0 * dk + d0, tstride, rows, c,
                 dk - d0, vec, tid, nthreads);
      // q stays whole: its rows are qpitch wide
      stage_rows(sq + d0, L.qpitch, q + row0 * dk + d0, tstride, rows, c, dk - d0, vec, tid,
                 nthreads);
    } else {  // the carry's units for (value tile vt, dk step dt)
      const int vt = (step - ndt) / ndt, dt = (step - ndt) % ndt;
      if (carry_in) {  // unit u = 4 x + y: value block 4 (vt0 + vt) + x, dk block 4 dt + y
        float* dst = reinterpret_cast<float*>(ring + (step % kOutStages) * kStep);
        for (int i = tid; i < 16 * (kUnit / 4); i += nthreads) {
          const int u = i / (kUnit / 4), piece = i % (kUnit / 4);
          const int eb = 4 * (vt0 + vt) + u / 4, kb = 4 * dt + u % 4;
          const bool ok = eb < nkb && kb < nkb;
          cp_async16(dst + u * kUnit + piece * 4,
                     ok ? units + (static_cast<long long>(eb) * nkb + kb) * kUnit + piece * 4
                        : units,
                     ok);
        }
      }
      if (dt == 0) {
        const int e0 = (vt0 + vt) * kTile;
        stage_rows(sv + (vt & 1) * kStep, kPitch, v + row0 * dk + e0, tstride, rows, c, dk - e0,
                   vec, tid, nthreads);
      }
    }
    cp_async_commit();
  };

  // the first group also brings the chunk's gates and the carry's n
  for (int j = tid; j < c; j += nthreads) {
    cp_async4(&slf[j], log_f + row0 + static_cast<long long>(j) * H, true);
    cp_async4(&sli[j], log_i + row0 + static_cast<long long>(j) * H, true);
  }
  for (int i = tid; i < dkp / 4; i += nthreads)
    cp_async16(&sn[4 * i], carry_in ? wsc.n + p * dkp + 4 * i : wsc.n, carry_in);
  for (int s = 0; s < kOutStages - 1; ++s) stage(s);
  const float m_prev = carry_in ? wsc.m[p] : 0.f;

  // this lane's rows i0 = 16 rb + g and i1 = i0 + 8
  const int i0 = rb * 16 + g, i1 = i0 + 8;
  float s[16][4], qc[8][4], qn[4] = {0.f, 0.f, 0.f, 0.f};
  float mi0 = 0.f, mi1 = 0.f, rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) qc[i][0] = qc[i][1] = qc[i][2] = qc[i][3] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait_group<kOutStages - 2>();  // this step has landed
    __syncthreads();  // for every thread; and the step before's buffer is consumed
    stage(step + kOutStages - 1);
    if (step == 0 && warp == 0) {  // the chunk's cumsum; rows past c read as 0
      warp_cumsum(slf, 1, scs, c, lane);
      for (int j = c + lane; j < kMaxChunk; j += 32) scs[j] = sli[j] = 0.f;
    }
    if (!active) continue;
    const bf16* buf = ring + (step % kOutStages) * kStep;
    if (step < ndt) {  // S over this dk step, added to the running sums once whole
      const int d0 = step * kTile, ksteps = min(4, ceil_div(dk - d0, 16));
      float sp[16][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) sp[i][0] = sp[i][1] = sp[i][2] = sp[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= ksteps) break;
        unsigned a[4];
        load_a(a, sq, L.qpitch, rb * 16, d0 + kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (np > rb) break;
          unsigned bk[4];
          load_b_nmajor(bk, buf, kPitch, np * 16, kk * 16, lane);
          mma16816(sp[2 * np], a, bk[0], bk[1]);
          mma16816(sp[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      add_tiles<16>(s, sp, 2 * (rb + 1));
      continue;
    }
    if (step == ndt) {
      // S is whole, and the cumsum (written in step 0) is visible: the
      // masked log weights D, the stabilizers m_i, W = S * exp(D - m_i) and
      // its row sums (a lane quad holds a row)
      const float cs0 = scs[i0], cs1 = scs[i1];
      float dm0 = -INFINITY, dm1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt >= 2 * (rb + 1)) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * t + e;
          const float csj = scs[j], lij = sli[j];
          if (j <= i0) dm0 = fmaxf(dm0, cs0 - csj + lij);
          if (j <= i1) dm1 = fmaxf(dm1, cs1 - csj + lij);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        dm0 = fmaxf(dm0, __shfl_xor_sync(kFull, dm0, o));
        dm1 = fmaxf(dm1, __shfl_xor_sync(kFull, dm1, o));
      }
      mi0 = fmaxf(dm0, cs0 + m_prev);
      mi1 = fmaxf(dm1, cs1 + m_prev);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt >= 2 * (rb + 1)) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * t + e;
          const float csj = scs[j], lij = sli[j];
          const float w0 = j <= i0 ? s[nt][e] * scale * expf(cs0 - csj + lij - mi0) : 0.f;
          const float w1 = j <= i1 ? s[nt][2 + e] * scale * expf(cs1 - csj + lij - mi1) : 0.f;
          s[nt][e] = w0;
          s[nt][2 + e] = w1;
          rs0 += w0;
          rs1 += w1;
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        rs0 += __shfl_xor_sync(kFull, rs0, o);
        rs1 += __shfl_xor_sync(kFull, rs1, o);
      }
    }
    // q C for value tile vt over this dk step (and q.n in the first tile)
    const int vt = (step - ndt) / ndt, dt = (step - ndt) % ndt;
    const int d0 = dt * kTile, ksteps = min(4, ceil_div(dk - d0, 16));
    if (carry_in) {  // this dk step's sums, added to the running ones once whole
      float qp[8][4], qnp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 8; ++i) qp[i][0] = qp[i][1] = qp[i][2] = qp[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= ksteps) break;
        unsigned a[4];
        load_a(a, sq, L.qpitch, rb * 16, d0 + kk * 16, lane);
#pragma unroll
        for (int eb = 0; eb < 4; ++eb) {
          const float* unit = reinterpret_cast<const float*>(buf) + (eb * 4 + kk) * kUnit;
#pragma unroll
          for (int half = 0; half < 2; ++half) {  // value columns 16 eb + g, then + 8
            const float4 x = *reinterpret_cast<const float4*>(unit + half * (kUnit / 2) + lane * 4);
            unsigned b0[3], b1[3];
            split3(x.x, x.y, b0);
            split3(x.z, x.w, b1);
#pragma unroll
            for (int r = 0; r < 3; ++r) mma16816(qp[2 * eb + half], a, b0[r], b1[r]);
          }
        }
        if (vt == 0) {  // q.n: B's columns 0, 1, 2 hold n's hi, mid and lo parts
          const int j = d0 + kk * 16 + 2 * t;
          unsigned b0[3] = {0u, 0u, 0u}, b1[3] = {0u, 0u, 0u};
          if (g < 3) {
            split3(sn[j], sn[j + 1], b0);
            split3(sn[j + 8], sn[j + 9], b1);
          }
          mma16816(qnp, a, g == 0 ? b0[0] : g == 1 ? b0[1] : b0[2],
                   g == 0 ? b1[0] : g == 1 ? b1[1] : b1[2]);
        }
      }
      add_tiles<8>(qc, qp, 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) qn[e] += qnp[e];
    }
    if (dt + 1 < ndt) continue;
    // the tile is whole: W v, then
    //   h = (W v + inter q C) / max(|rowsum W + inter q.n|, exp(-m_i))
    const bf16* svt = sv + (vt & 1) * kStep;
    float o[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk > rb) break;
      unsigned aw[3][4];
      frags3(s[2 * kk], s[2 * kk + 1], aw);
      float op[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) op[i][0] = op[i][1] = op[i][2] = op[i][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bv[4];
        load_b_kmajor(bv, svt, kPitch, np * 16, kk * 16, lane);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          mma16816(op[2 * np], aw[r], bv[0], bv[1]);
          mma16816(op[2 * np + 1], aw[r], bv[2], bv[3]);
        }
      }
      add_tiles<8>(o, op, 8);
    }
    const float cs0 = scs[i0], cs1 = scs[i1];
    // q.n of rows i0, i1: columns 0 and 1 (lane t = 0) and 2 (t = 1)
    const float qn0 = __shfl_sync(kFull, qn[0] + qn[1], lane & ~3) +
                      __shfl_sync(kFull, qn[0], (lane & ~3) + 1);
    const float qn1 = __shfl_sync(kFull, qn[2] + qn[3], lane & ~3) +
                      __shfl_sync(kFull, qn[2], (lane & ~3) + 1);
    const float inter0 = expf(cs0 + m_prev - mi0), inter1 = expf(cs1 + m_prev - mi1);
    const float den0 = rs0 + inter0 * (qn0 * scale), den1 = rs1 + inter1 * (qn1 * scale);
    const float lim0 = fmaxf(fabsf(den0), expf(-mi0));
    const float lim1 = fmaxf(fabsf(den1), expf(-mi1));
    if (den != nullptr && vt0 + vt == 0 && t == 0) {  // for the backward: one lane a row
      if (i0 < c) den[row0 + static_cast<long long>(i0) * H] = den0;
      if (i1 < c) den[row0 + static_cast<long long>(i1) * H] = den1;
    }
    const bool pair = (dk & 1) == 0;
    const int e0 = (vt0 + vt) * kTile;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * 8 + 2 * t;
      if (e < dk) {
        if (i0 < c)
          store2(h + (row0 + static_cast<long long>(i0) * H) * dk + e,
                 (o[i][0] + inter0 * (qc[i][0] * scale)) / lim0,
                 (o[i][1] + inter0 * (qc[i][1] * scale)) / lim0, pair, e + 1 < dk);
        if (i1 < c)
          store2(h + (row0 + static_cast<long long>(i1) * H) * dk + e,
                 (o[i][2] + inter1 * (qc[i][2] * scale)) / lim1,
                 (o[i][3] + inter1 * (qc[i][3] * scale)) / lim1, pair, e + 1 < dk);
      }
      qc[i][0] = qc[i][1] = qc[i][2] = qc[i][3] = 0.f;
    }
  }
  cp_async_wait_all();
}

// ------------------------------------------------------------- f32 passes
//
// f32 inputs stay on the CUDA cores, every product an f32 FMA chain in one
// fixed order (f32 on the tensor cores, in split terms, misses the f32
// gates that hold the kernel path to plain f32's own rounding: a split-TF32
// flash forward and a split-bf16 mLSTM backward both did).  Each thread
// owns an 8 x 8 tile of a product and reads 16 operands for its 64 FMAs
// a step of the sum (four FMAs a shared-memory load); every tile arrives
// by cp.async (16-byte pieces where dk is a multiple of 4 and the rows are
// aligned, else 4-byte ones) into a ring of buffers, the next steps copied
// while this one is multiplied.  The workspace keeps C row-major with rows
// of dk.

constexpr int kSF = 64;       // f32 state pass: a block's tile of C, 64 dk rows x 64 value columns
constexpr int kSFThreads = 64;  // an 8 x 8 tile of it a thread
constexpr int kSFStep = 32;   // positions a staged step

struct StateF32 {
  float k[2][kSFStep][kSF];  // a step's k rows, this block's dk columns
  float v[2][kSFStep][kSF];  // its v rows, turned into w_j v_j as they land
  float w[kGateGroup][kMaxChunk];  // group_gates: the weights w_j of a group's chunks
  float total[kGateGroup], dmax[kGateGroup], decay[kGateGroup], m_next[kGateGroup];
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The f32 state pass, a chained scan: one block (64 threads) per (chunk t,
// batch x head, 64 dk rows x 64 value columns of C), blocks of chunk t
// taking the tickets after every block of chunk t - 1 (an atomic counter
// hands them out in the order blocks start, so a block only waits on one
// that is running or done).  Every block first forms its chunk's move U_t =
// sum_j k_j (w_j v_j)^T over the chunk's positions in steps of 32, thread
// (tr, tc) holding dk rows 4 tr + {0..3, 32..35} and value columns 4 tc +
// {0..3, 32..35}: each step an FMA chain from 0, added to the running sum
// (the first column of tiles also n's move, thread d for dk row d); these
// run at once for all chunks.  Then it waits for the flag of chunk t's tile
// of C (written by the block of chunk t - 1), reads that tile, and writes
// C_{t+1} = fma(decay_t, C_t, U_t) (and n, m) as the carry entering chunk t
// + 1 (the final carry at the last chunk), then raises chunk t + 1's flag.
// The gates (m chain, w_j, decay) come from group_gates over the chunk's
// group of 16, from m entering it, with the bits of every other pass.  A
// wait that outlasts 2^22 polls traps rather than hanging the card.
__global__ void __launch_bounds__(kSFThreads)
mlstm_state_f32(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ log_i, const float* __restrict__ log_f,
                float* __restrict__ ws, int* __restrict__ sync, float* __restrict__ C_out,
                float* __restrict__ n_out, float* __restrict__ m_out, int BH, int S, int H,
                int dk, int c, bool vec) {
  __shared__ __align__(16) StateF32 sm;
  __shared__ int ticket_s;
  const int tid = threadIdx.x, lane = tid & 31, tc = lane & 7, tr = (tid >> 5) * 4 + (lane >> 3);
  const int tiles = ceil_div(dk, kSF), per_chunk = BH * tiles * tiles;
  if (tid == 0) ticket_s = atomicAdd(sync, 1);
  __syncthreads();
  const int ticket = ticket_s, t = ticket / per_chunk, rest = ticket - t * per_chunk;
  const int bh = rest / (tiles * tiles), tile = rest - bh * tiles * tiles;
  const int b = bh / H, hh = bh - b * H;
  const int d0 = (tile / tiles) * kSF, e0 = (tile % tiles) * kSF;
  const bool n_tile = e0 == 0, m_thread = tile == 0 && tid == 0;
  const int nc = S / c, ns = ceil_div(c, kSFStep);
  const long long head0 = static_cast<long long>(b) * S * H + hh;
  const long long pos0 = static_cast<long long>(t) * c;
  const int dkp = (dk + 15) & ~15;
  const Carry wsc = carry_of(ws, static_cast<long long>(BH) * nc, dkp);
  int* flags = sync + 1;  // [chunk][batch x head][tile]: C entering that chunk is written

  // step s: positions 32 s .. of the chunk into buffer s & 1
  auto issue = [&](int s) {
    if (s >= ns) {
      cp_async_commit();
      return;
    }
    for (int i = tid; i < kSFStep * (kSF / 4) * 2; i += kSFThreads) {
      const int which = i / (kSFStep * (kSF / 4)), x = i - which * (kSFStep * (kSF / 4));
      const int r = x / (kSF / 4), col = (x % (kSF / 4)) * 4, j = s * kSFStep + r;
      const int base = which ? e0 : d0;
      const float* src = (which ? v : k) + (head0 + (pos0 + j) * H) * dk + base + col;
      float* dst = which ? &sm.v[s & 1][r][col] : &sm.k[s & 1][r][col];
      copy4(dst, src, k, j < c ? base + col : dk, dk, vec);
    }
    cp_async_commit();
  };
  issue(0);

  // the gates: m through the groups before chunk t's, then its group
  const int g0 = (t / kGateGroup) * kGateGroup, gi = t - g0;
  float m = 0.f;
  for (int g = 0; g <= g0; g += kGateGroup) {
    group_gates<kSFThreads / 32>(sm, log_i, log_f, head0, H, c, ns * kSFStep, g,
                                 min(kGateGroup, nc - g), m);
    m = sm.m_next[min(kGateGroup, nc - g) - 1];
  }
  const float* wj = sm.w[gi];
  const float decay = sm.decay[gi], m_next = sm.m_next[gi];

  float U[8][8], part[8][8], un = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int x = 0; x < 8; ++x) U[a][x] = 0.f;
  for (int s = 0; s < ns; ++s) {
    cp_async_wait_all();
    for (int i = tid; i < kSFStep * (kSF / 4); i += kSFThreads) {  // own pieces: w_j v_j
      const int r = i / (kSF / 4), col = (i % (kSF / 4)) * 4;
      float4* x = reinterpret_cast<float4*>(&sm.v[s & 1][r][col]);
      const float w = wj[s * kSFStep + r];
      float4 y = *x;
      y.x = w * y.x;
      y.y = w * y.y;
      y.z = w * y.z;
      y.w = w * y.w;
      *x = y;
    }
    __syncthreads();  // step s has landed everywhere; step s - 1's buffer is consumed
    issue(s + 1);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int x = 0; x < 8; ++x) part[a][x] = 0.f;
    float unp = 0.f;
#pragma unroll 4
    for (int r = 0; r < kSFStep; ++r) {
      const float4 ka = *reinterpret_cast<const float4*>(&sm.k[s & 1][r][4 * tr]);
      const float4 kb = *reinterpret_cast<const float4*>(&sm.k[s & 1][r][32 + 4 * tr]);
      const float4 va = *reinterpret_cast<const float4*>(&sm.v[s & 1][r][4 * tc]);
      const float4 vb = *reinterpret_cast<const float4*>(&sm.v[s & 1][r][32 + 4 * tc]);
      const float kd[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float ve[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int x = 0; x < 8; ++x) part[a][x] = fmaf(kd[a], ve[x], part[a][x]);
      if (n_tile) unp = fmaf(wj[s * kSFStep + r], sm.k[s & 1][r][tid], unp);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int x = 0; x < 8; ++x) U[a][x] += part[a][x];
    un += unp;
  }

  // the chain: C_t (and n_t) from chunk t - 1's block, then C_{t+1}
  const long long p = static_cast<long long>(bh) * nc + t;  // the carry entering chunk t
  if (t > 0) {
    if (tid == 0) {
      const int* flag = flags + (static_cast<long long>(t) * BH + bh) * tiles * tiles + tile;
      for (int spins = 0; ld_acquire(flag) == 0; ++spins) {
        if (spins > (1 << 22)) __trap();
        __nanosleep(64);
      }
    }
    __syncthreads();
  }
  const bool last = t + 1 == nc;
  const float* Cin = wsc.C + p * dkp * dkp;
  float* Cdst = last ? C_out + static_cast<long long>(bh) * dk * dk : wsc.C + (p + 1) * dkp * dkp;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int d = d0 + (a < 4 ? 4 * tr + a : 32 + 4 * tr + a - 4);
    if (d >= dk) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = e0 + 32 * half + 4 * tc;
      const long long at = static_cast<long long>(d) * dk + e;
      float cin[4] = {0.f, 0.f, 0.f, 0.f};
      if (t > 0) {
        if (vec && e + 3 < dk) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(Cin + at));
          cin[0] = x.x;
          cin[1] = x.y;
          cin[2] = x.z;
          cin[3] = x.w;
        } else {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (e + y < dk) cin[y] = __ldcg(Cin + at + y);
        }
      }
      float o[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) o[y] = fmaf(decay, cin[y], U[a][4 * half + y]);
      if (vec && e + 3 < dk) {
        *reinterpret_cast<float4*>(Cdst + at) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (e + y < dk) Cdst[at + y] = o[y];
      }
    }
  }
  if (n_tile && d0 + tid < dk) {
    const float nin = t > 0 ? __ldcg(wsc.n + p * dkp + d0 + tid) : 0.f;
    (last ? n_out + static_cast<long long>(bh) * dk : wsc.n + (p + 1) * dkp)[d0 + tid] =
        fmaf(decay, nin, un);
  }
  if (m_thread) *(last ? m_out + bh : wsc.m + p + 1) = m_next;
  if (!last) {
    __syncthreads();  // the block's part of C_{t+1} is written
    if (tid == 0) {
      __threadfence();
      st_release(flags + (static_cast<long long>(t + 1) * BH + bh) * tiles * tiles + tile, 1);
    }
  }
}

// The output pass: one block per (batch x head, chunk, 192 value columns,
// row part); part p takes the chunk's 32-row tiles p and 3 - p, which
// share the causal work evenly (two blocks a 192-column group, so a chunk's
// q k^T is formed once a group: ceil(dk / 192) times).  Its 64 rows, local
// r: tile lo = p for r < 32, tile hi = 3 - p above.
constexpr int kOF = 192;                        // value columns of a block
constexpr int kOFRows = 64;                     // rows of a block
constexpr int kOFParts = 2;                     // row parts of a chunk
constexpr int kOFDepth = 16;                    // dk a staged step of q k^T, q C and q.n
constexpr int kOFJStep = 32;                    // positions a staged step of W v
constexpr int kOFQcThreads = 192;               // warps 0-5: an 8 x 8 tile of q C, then of h
constexpr int kOFSTiles = 68;                   // then 68 threads: an 8 x 8 tile of S each
constexpr int kOFThreads = 288;                 // 9 warps; warp 8's lanes 8 .. 31 take q.n
constexpr int kOFPq = kOFDepth + 4;             // pitch of the q and k rows (+ 4 every 8 rows)
constexpr int kOFQ = kOFRows * kOFPq + (kOFRows / 8) * 4;
constexpr int kOFK = kMaxChunk * kOFPq + (kMaxChunk / 8) * 4;
constexpr int kOFBuf = kOFQ + kOFK + kOFDepth * kOF + kOFDepth;  // floats of a ring buffer
constexpr int kOFPw = kMaxChunk + 1;            // pitch of W's rows
constexpr int kOFStages = 3;                    // buffers in the ring
constexpr int kOFSums = kOFQcThreads + kOFSTiles;  // threads with running sums in shared memory
static_assert(kOFJStep * kOF <= kOFBuf && kOFBuf % 4 == 0, "a buffer holds a step of v");
constexpr size_t kOFSmem = (kOFStages * static_cast<size_t>(kOFBuf) + kOFRows * kOFPw +
                            2 * kMaxChunk + 4 * kOFRows + 64 * kOFSums) * sizeof(float);

// q or k row r of a staged step: 16 floats, 4 more every 8 rows, so the
// 8 rows of an S tile lie on distinct banks
__device__ __forceinline__ int of_row(int r) { return r * kOFPq + (r >> 3) * 4; }

// Phase 1, over dk in steps of 16: warps 0-5 form q C for the block's 64
// rows x 192 columns (thread (tr, tc): rows tr + 8 a, columns 4 tc + {0..3,
// 96..99}), threads 192 .. 259 the causal 8 x 8 tiles of S = q k^T (8-row
// bands of each 32-row tile up to the diagonal: 16 lo + 10 + 16 hi + 10 =
// 68), warp 8's lanes 8 .. 31 q.n, with q scaled as it lands: each step's
// 16-term FMA chain is added to the running sum, so a sum over dk rounds
// like 16 + dk / 16 terms (one chain over dk leaves xlstm's f32 layers more
// elements off f64 than plain f32 does; these sums leave fewer).  A step's 64 partial sums stay in registers and the running
// sums in shared memory, element-major (a 9-warp block gets 168 registers a
// thread, which the two sets of 64 would pass).  Then W = S exp(D - m_i) into shared memory, the row sums
// (16 chains of 8, added in pairs), den = rowsum + inter q.n, and q C
// becomes inter q C, to which phase 2, over positions in steps of 32, adds
// each step's W v; h = that / max(|den|, exp(-m_i)).  The steps flow
// through a ring of three cp.async buffers, one barrier a step.
// One block an SM: two of 9 warps would leave 96 registers a thread
// (warps are allocated in pairs), where the 8 x 8 tiles spill.
__global__ void __launch_bounds__(kOFThreads, 1)
mlstm_out_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ log_i,
              const float* __restrict__ log_f, const float* __restrict__ ws,
              float* __restrict__ h, float* __restrict__ den_out, int S, int H, int dk, int c,
              float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* sW = ring + kOFStages * kOFBuf;
  float* scs = sW + kOFRows * kOFPw;
  float* sli = scs + kMaxChunk;
  float* smi = sli + kMaxChunk;
  float* sinter = smi + kOFRows;
  float* slim = sinter + kOFRows;
  float* sqn = slim + kOFRows;
  float* sacc = sqn + kOFRows;  // [64][kOFSums]: element e of thread t at e * kOFSums + t

  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int vg = blockIdx.z / kOFParts, row_part = blockIdx.z % kOFParts;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = row_part, hi = 3 - row_part;
  const bool lo_on = 32 * lo < c, hi_on = 32 * hi < c;
  if (!lo_on) return;  // no row of this part lies within the chunk
  const int krows = 32 * ((hi_on ? hi : lo) + 1);  // positions the block's rows reach
  const int jmax = min(c, krows);
  const int nd = ceil_div(dk, kOFDepth), nv = ceil_div(jmax, kOFJStep), nsteps = nd + nv;
  const int nc = S / c, e0 = vg * kOF;
  const long long row0 =
      (static_cast<long long>(b) * S + static_cast<long long>(chunk) * c) * H + hh;
  const bool carry_in = chunk > 0;
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const int dkp = (dk + 15) & ~15;
  const Carry wsc = carry_of(const_cast<float*>(ws), static_cast<long long>(gridDim.x) * nc, dkp);
  const float* Cp = wsc.C + p * dkp * dkp;
  auto row_of = [lo, hi](int r) { return r < 32 ? 32 * lo + r : 32 * hi + r - 32; };

  // roles: q C / h tile (tr, tc); S tile (rb, cb); q.n rows
  const bool qc_thread = tid < kOFQcThreads;
  const int tc = (warp % 3) * 8 + (lane & 7), tr = (warp / 3) * 4 + (lane >> 3);
  const bool s_thread = tid >= kOFQcThreads && tid < kOFQcThreads + kOFSTiles;
  int rb = 0, cb = 0;
  if (s_thread) {
    for (int half = 0, n = 0, s = tid - kOFQcThreads; half < 2; ++half)
      for (int band = 0; band < 4; ++band) {
        const int cnt = 4 * (half ? hi : lo) + band + 1;
        if (s >= n && s < n + cnt) {
          rb = 4 * half + band;
          cb = s - n;
        }
        n += cnt;
      }
  }
  const bool qn_lane = warp == 8 && lane >= 8;

  // step st into buffer st % kOFStages, one cp.async group: dk step (q, k, the
  // carry's C and n) or positions step (v)
  auto issue = [&](int st) {
    if (st >= nsteps) {
      cp_async_commit();  // empty: keeps the group count regular
      return;
    }
    float* buf = ring + (st % kOFStages) * kOFBuf;
    if (st < nd) {
      const int d0 = st * kOFDepth;
      constexpr int kPc = kOFDepth / 4;  // pieces a row
      for (int i = tid; i < (kOFRows + kMaxChunk) * kPc; i += kOFThreads) {
        const int r = i / kPc, col = (i % kPc) * 4;
        const bool is_q = r < kOFRows;
        const int rr = is_q ? r : r - kOFRows, pos = is_q ? row_of(rr) : rr;
        if (!is_q && rr >= krows) continue;
        const float* src = (is_q ? q : k) + (row0 + static_cast<long long>(pos) * H) * dk + d0 + col;
        copy4(buf + (is_q ? 0 : kOFQ) + of_row(rr) + col, src, q, pos < c ? d0 + col : dk, dk,
              vec);
      }
      if (carry_in) {
        float* sC = buf + kOFQ + kOFK;
        for (int i = tid; i < kOFDepth * (kOF / 4) + kPc; i += kOFThreads) {
          if (i < kOFDepth * (kOF / 4)) {
            const int dd = i / (kOF / 4), col = (i % (kOF / 4)) * 4;
            copy4(sC + dd * kOF + col, Cp + static_cast<long long>(d0 + dd) * dk + e0 + col, ws,
                  d0 + dd < dk ? e0 + col : dk, dk, vec);
          } else {
            const int col = (i - kOFDepth * (kOF / 4)) * 4;
            copy4(sC + kOFDepth * kOF + col, wsc.n + p * dkp + d0 + col, ws, d0 + col, dk, vec);
          }
        }
      }
    } else {
      const int j0 = (st - nd) * kOFJStep;
      for (int i = tid; i < kOFJStep * (kOF / 4); i += kOFThreads) {
        const int r = i / (kOF / 4), col = (i % (kOF / 4)) * 4;
        const float* src = v + (row0 + static_cast<long long>(j0 + r) * H) * dk + e0 + col;
        copy4(buf + r * kOF + col, src, v, j0 + r < c ? e0 + col : dk, dk, vec);
      }
    }
    cp_async_commit();
  };
  for (int st = 0; st < kOFStages - 1; ++st) issue(st);

  // the chunk's gates, W zeroed (entries no S tile writes stay 0)
  for (int i = tid; i < kOFRows * kOFPw; i += kOFThreads) sW[i] = 0.f;
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, scs, c, lane);
    for (int j = lane; j < c; j += 32) sli[j] = log_i[row0 + static_cast<long long>(j) * H];
    for (int j = c + lane; j < kMaxChunk; j += 32) scs[j] = sli[j] = 0.f;
  }
  const float m_prev = carry_in ? wsc.m[p] : 0.f;
  __syncthreads();
  if (tid < 4 * kOFRows) {  // m_i and inter_i of local row tid / 4, four lanes a row
    const int r = tid >> 2, i = row_of(r);
    const float csi = i < c ? scs[i] : 0.f;
    float dmax = -INFINITY;
    for (int j = tid & 3; j <= i && j < c; j += 4) dmax = fmaxf(dmax, csi - scs[j] + sli[j]);
    dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, 1));
    dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, 2));
    if ((tid & 3) == 0) {
      const float mi = fmaxf(dmax, csi + m_prev);
      smi[r] = i < c ? mi : 0.f;
      sinter[r] = i < c ? expf(csi + m_prev - mi) : 0.f;
    }
  }

  float part[8][8], qn[3] = {0.f, 0.f, 0.f};
  float* acc = sacc + tid;  // this thread's running sums, element 8 a + x at (8 a + x) kOFSums

  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait_group<kOFStages - 2>();  // this thread's copies of step st have landed
    const float* buf = ring + (st % kOFStages) * kOFBuf;
    if (st < nd) {  // scale this thread's own pieces of q as they land
      float* sq = const_cast<float*>(buf);
      constexpr int kPc = kOFDepth / 4;
      for (int i = tid; i < kOFRows * kPc; i += kOFThreads) {
        float4* x = reinterpret_cast<float4*>(sq + of_row(i / kPc) + (i % kPc) * 4);
        float4 y = *x;
        y.x *= scale;
        y.y *= scale;
        y.z *= scale;
        y.w *= scale;
        *x = y;
      }
    }
    __syncthreads();  // step st has landed everywhere; step st - 1's buffer is consumed
    issue(st + kOFStages - 1);
    if (st < nd) {
      const float* sq = buf;
      const float* sk = buf + kOFQ;
      const float* sC = sk + kOFK;
      const float* sn = sC + kOFDepth * kOF;
      if (qc_thread && carry_in) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int x = 0; x < 8; ++x) part[a][x] = 0.f;
#pragma unroll 2
        for (int f = 0; f < kOFDepth; ++f) {
          float a[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) a[x] = sq[of_row(tr + 8 * x) + f];
          const float4 c0 = *reinterpret_cast<const float4*>(sC + f * kOF + 4 * tc);
          const float4 c1 = *reinterpret_cast<const float4*>(sC + f * kOF + 96 + 4 * tc);
          const float bv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y) part[x][y] = fmaf(a[x], bv[y], part[x][y]);
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            acc[(8 * a + x) * kOFSums] = (st == 0 ? 0.f : acc[(8 * a + x) * kOFSums]) + part[a][x];
      } else if (s_thread) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int x = 0; x < 8; ++x) part[a][x] = 0.f;
#pragma unroll 2
        for (int f = 0; f < kOFDepth; ++f) {
          float a[8], bk[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            a[x] = sq[of_row(8 * rb + x) + f];
            bk[x] = sk[of_row(8 * cb + x) + f];
          }
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y) part[x][y] = fmaf(a[x], bk[y], part[x][y]);
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            acc[(8 * a + x) * kOFSums] = (st == 0 ? 0.f : acc[(8 * a + x) * kOFSums]) + part[a][x];
      } else if (qn_lane && carry_in) {
        float qp[3] = {0.f, 0.f, 0.f};
        for (int f = 0; f < kOFDepth; ++f) {
          const float nf = sn[f];
#pragma unroll
          for (int x = 0; x < 3; ++x)
            if (lane - 8 + 24 * x < kOFRows)
              qp[x] = fmaf(sq[of_row(lane - 8 + 24 * x) + f], nf, qp[x]);
        }
#pragma unroll
        for (int x = 0; x < 3; ++x) qn[x] += qp[x];
      }
      if (st == nd - 1) {
        // S is whole: W = S exp(D - m_i) (j <= i < c); q C becomes inter q C
        if (s_thread) {
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int r = 8 * rb + x, i = row_of(r);
            const float csi = scs[i], mi = smi[r];
#pragma unroll
            for (int y = 0; y < 8; ++y) {
              const int j = 8 * cb + y;
              if (i < c && j <= i)
                sW[r * kOFPw + j] = acc[(8 * x + y) * kOFSums] * expf(csi - scs[j] + sli[j] - mi);
            }
          }
        } else if (qn_lane) {
#pragma unroll
          for (int x = 0; x < 3; ++x)
            if (lane - 8 + 24 * x < kOFRows) sqn[lane - 8 + 24 * x] = qn[x];
        } else if (qc_thread) {  // (chunk 0 has no carry: its sums start at 0)
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float in = sinter[tr + 8 * x];
#pragma unroll
            for (int y = 0; y < 8; ++y)
              acc[(8 * x + y) * kOFSums] = carry_in ? acc[(8 * x + y) * kOFSums] * in : 0.f;
          }
        }
        __syncthreads();  // W and q.n are written
        if (tid < 4 * kOFRows) {  // row sums: lane q4 of a row's four takes j = q4 mod 4
          const int r = tid >> 2, i = row_of(r);
          const float* wr = sW + r * kOFPw + (tid & 3);
          float ch[4];  // in four chains of 8 (j = q4 + 4 (8 x + 0 .. 7)), added in pairs
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            ch[x] = 0.f;
#pragma unroll
            for (int y = 0; y < 8; ++y) ch[x] += wr[4 * (8 * x + y)];  // W is 0 past jmax
          }
          float rs = (ch[0] + ch[1]) + (ch[2] + ch[3]);
          rs += __shfl_xor_sync(kFull, rs, 1);
          rs += __shfl_xor_sync(kFull, rs, 2);
          if ((tid & 3) == 0 && i < c) {
            const float den = fmaf(sinter[r], sqn[r], rs);
            slim[r] = fmaxf(fabsf(den), expf(-smi[r]));
            if (den_out != nullptr && vg == 0) den_out[row0 + static_cast<long long>(i) * H] = den;
          }
        }
      }
      continue;
    }
    // phase 2: W v over positions j0 .. j0 + 31, for rows whose tile reaches them
    if (!qc_thread) continue;
    const int j0 = (st - nd) * kOFJStep;
    const float* sv = buf;
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int x = 0; x < 8; ++x) part[a][x] = 0.f;
    if (j0 < 32 * (lo + 1)) {
#pragma unroll 2
      for (int jj = 0; jj < kOFJStep; ++jj) {
        float a[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) a[x] = sW[(tr + 8 * x) * kOFPw + j0 + jj];
        const float4 v0 = *reinterpret_cast<const float4*>(sv + jj * kOF + 4 * tc);
        const float4 v1 = *reinterpret_cast<const float4*>(sv + jj * kOF + 96 + 4 * tc);
        const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) part[x][y] = fmaf(a[x], bv[y], part[x][y]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[(8 * a + x) * kOFSums] += part[a][x];
    } else {  // only the hi tile's rows (x >= 4) reach these positions
#pragma unroll 2
      for (int jj = 0; jj < kOFJStep; ++jj) {
        float a[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = sW[(tr + 8 * (x + 4)) * kOFPw + j0 + jj];
        const float4 v0 = *reinterpret_cast<const float4*>(sv + jj * kOF + 4 * tc);
        const float4 v1 = *reinterpret_cast<const float4*>(sv + jj * kOF + 96 + 4 * tc);
        const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) part[x + 4][y] = fmaf(a[x], bv[y], part[x + 4][y]);
      }
#pragma unroll
      for (int a = 4; a < 8; ++a)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[(8 * a + x) * kOFSums] += part[a][x];
    }
  }
  cp_async_wait_all();
  if (!qc_thread) return;
  // h = (inter q C + W v) / max(|den|, exp(-m_i))
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int r = tr + 8 * x, i = row_of(r);
    if (i >= c) continue;
    const float lim = slim[r];
    float* hr = h + (row0 + static_cast<long long>(i) * H) * dk;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = e0 + 96 * half + 4 * tc;
      const float* ax = acc + (8 * x + 4 * half) * kOFSums;
      const float o0 = ax[0] / lim, o1 = ax[kOFSums] / lim;
      const float o2 = ax[2 * kOFSums] / lim, o3 = ax[3 * kOFSums] / lim;
      if (vec && e + 3 < dk) {
        *reinterpret_cast<float4*>(hr + e) = make_float4(o0, o1, o2, o3);
      } else {
        const float o[4] = {o0, o1, o2, o3};
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (e + y < dk) hr[e + y] = o[y];
      }
    }
  }
}

// ------------------------------------------------------------------ launch

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* li,
                        const float* lf, float* h, float* den, float* C, float* n, float* m,
                        float* ws, int B, int S, int H, int dk, int c, int tiles, int e_tiles,
                        int value_tiles, float scale, cudaStream_t stream) {
  const bool vec = dk % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(ws)) & 15u) == 0;
  cudaError_t err = set_max_dynamic_smem(mlstm_state_tc, sizeof(StateTC));
  if (err != cudaSuccess) return err;
  const size_t out_smem = out_layout(dk).total;
  err = set_max_dynamic_smem(mlstm_out_tc, out_smem);
  if (err != cudaSuccess) return err;
  mlstm_state_tc<<<dim3(B * H, tiles, e_tiles), kStateWarps * 32, sizeof(StateTC), stream>>>(
      k, v, li, lf, ws, C, n, m, S, H, dk, c, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_out_tc<<<dim3(B * H, S / c, value_tiles), kOutWarps * 32, out_smem, stream>>>(
      q, k, v, li, lf, ws, h, den, S, H, dk, c, scale, vec);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* li,
                       const float* lf, float* h, float* den, float* C, float* n, float* m,
                       float* ws, int B, int S, int H, int dk, int c, int tiles, int value_tiles,
                       float scale, cudaStream_t stream) {
  const bool vec = dk % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(h) |
                     reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(ws)) & 15u) == 0;
  cudaError_t err = set_max_dynamic_smem(mlstm_out_f32, kOFSmem);
  if (err != cudaSuccess) return err;
  // the state pass's ticket counter and flags, after the carries (the plan's
  // workspace), zeroed on the stream
  const int nc = S / c, dkp = (dk + 15) & ~15, chunks = nc - 1 + (C != nullptr);
  int* sync = reinterpret_cast<int*>(ws + static_cast<long long>(B) * H * nc * (dkp * dkp + dkp + 1));
  if (chunks > 0) {
    err = cudaMemsetAsync(sync, 0, (1 + static_cast<size_t>(nc) * B * H * tiles * tiles) * sizeof(int),
                          stream);
    if (err != cudaSuccess) return err;
    mlstm_state_f32<<<chunks * B * H * tiles * tiles, kSFThreads, 0, stream>>>(
        k, v, li, lf, ws, sync, C, n, m, B * H, S, H, dk, c, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mlstm_out_f32<<<dim3(B * H, S / c, value_tiles * kOFParts), kOFThreads, kOFSmem, stream>>>(
      q, k, v, li, lf, ws, h, den, S, H, dk, c, scale, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

extern "C" int repro_mlstm_chunk_max_dk() { return repro::kMaxDk; }
extern "C" int repro_mlstm_chunk_max_chunk() { return repro::kMaxChunk; }

// q, k, v (B, S, H, dk) in `dtype`; log_i, log_f (B, S, H) f32; h (B, S, H,
// dk) f32; den (B, S, H) f32 or null: each row's denominator before
// max(|den|, exp(-m_i)), which the backward (csrc/mlstm_chunk_bwd.cu) reads
// to take the forward's branch; C (B, H, dk, dk), n (B, H, dk), m (B, H)
// f32, all three null or none; ws f32, B * H * (S / c) * (dkp^2 + dkp + 1) floats (dkp: dk rounded
// up to 16; f32 inputs then the state pass's 1 + B * H * (S / c) * ceil(dk / 64)^2 int32
// ticket and flags, zeroed here), 16-byte aligned.  c divides S.  The wrapper's plan gives the
// grids' tiles: the state pass's `state_tiles` tiles of 64 dk rows and
// `state_e_tiles` of value columns (96 in bf16, 64 in f32), and the output
// pass's `value_tiles` of 192 value columns (f32: two blocks each, one a
// row part); a plan that does not cover dk exactly is refused.  Two launches on
// `stream`, the state pass and the output pass (f32: after a memset of the
// state pass's flags).  Returns the CUDA error of
// the launches (0 on success).
extern "C" int repro_mlstm_chunk(int device, int dtype, const void* q, const void* k,
                                 const void* v, const void* log_i, const void* log_f, void* h,
                                 void* den, void* C, void* n, void* m, void* ws, int B, int S,
                                 int H, int dk,
                                 int c, int state_tiles, int state_e_tiles, int value_tiles,
                                 float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (dk <= 0 || dk > repro::kMaxDk || c <= 0 || c > repro::kMaxChunk || S % c)
    return cudaErrorInvalidValue;
  const bool tc = dtype == repro::kBFloat16;
  const int state_e = tc ? repro::kStateE : repro::kSF;
  const int value_tile = tc ? repro::kValueGroup * repro::kTile : repro::kOF;
  if (state_tiles != repro::ceil_div(dk, repro::kTile) ||
      state_e_tiles != repro::ceil_div(dk, state_e) ||
      value_tiles != repro::ceil_div(dk, value_tile))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto li = static_cast<const float*>(log_i);
  auto lf = static_cast<const float*>(log_f);
  auto hp = static_cast<float*>(h);
  auto dp = static_cast<float*>(den);
  auto Cp = static_cast<float*>(C);
  auto np = static_cast<float*>(n);
  auto mp = static_cast<float*>(m);
  auto wp = static_cast<float*>(ws);
  if (dtype == repro::kFloat32)
    return repro::launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), li, lf, hp, dp, Cp, np, mp, wp, B, S,
                             H, dk, c, state_tiles, value_tiles, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_bf16(static_cast<const repro::bf16*>(q),
                              static_cast<const repro::bf16*>(k),
                              static_cast<const repro::bf16*>(v), li, lf, hp, dp, Cp, np, mp, wp,
                              B, S, H, dk, c, state_tiles, state_e_tiles, value_tiles, scale, s);
  return cudaErrorInvalidValue;
}
