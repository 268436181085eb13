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
// - f32: the same two passes with the products on the CUDA cores; the
//   output pass takes 32 value columns a block and keeps C row-major.
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
constexpr int kE32 = 32;           // f32 output pass: value columns a block
constexpr int kStateE = 96;        // bf16 state pass: value columns of a block's tile of C
constexpr int kStateWarps = 12;    // bf16 state pass: 6 x 2 warps on a 96 x 64 tile of C^T
constexpr int kGateGroup = 16;     // bf16 state pass: chunks whose carry moves are taken at once
constexpr int kOutWarps = 8;       // bf16 output pass: 16 positions a warp
constexpr int kOutStages = 3;      // bf16 output pass: steps in the ring of buffers
constexpr int kValueGroup = 3;     // bf16 output pass: 64-wide value tiles a block
constexpr int kF32Threads = 256;

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
// whole block: warp w takes chunks w and w + 12 (loading both chunks' gates
// before it needs them): their cumsum (warp_cumsum's order, in registers),
// total and dec_j = total - csum_j + log_i_j (into w) and max_j dec_j; then
// one thread runs the m chain through them from `m`; then every thread
// turns dec_j into w_j = exp(dec_j - m').  `m` enters the group.
__device__ void group_gates(StateTC& sm, const float* log_i, const float* log_f, long long head0,
                            int H, int c, int rows, int g0, int n, float m) {
  constexpr int kRun = kMaxChunk / 32, kPer = (kGateGroup + kStateWarps - 1) / kStateWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (c + 31) >> 5, j0 = lane * per;
  float lf[kPer][kRun], li[kPer][kRun];
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int i = warp + x * kStateWarps;
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
    const int i = warp + x * kStateWarps;
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
    if (gi == 0) group_gates(sm, log_i, log_f, head0, H, c, rows, ch, min(kGateGroup, nc - ch), m);
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

struct StateF32 {
  float k[kMaxChunk][kTile + 1];  // k rows of a chunk, this block's dk columns
  float wv[kMaxChunk][kTile];     // w_j v_j, this block's value columns
  float cs[kMaxChunk], li[kMaxChunk], w[kMaxChunk];
  float decay, m_next;
};

__global__ void __launch_bounds__(kF32Threads)
mlstm_state_f32(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ log_i, const float* __restrict__ log_f,
                float* __restrict__ ws, float* __restrict__ C_out, float* __restrict__ n_out,
                float* __restrict__ m_out, int S, int H, int dk, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateF32& sm = *reinterpret_cast<StateF32*>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  const int d0 = blockIdx.y * kTile, e0 = blockIdx.z * kTile;
  const bool n_tile = blockIdx.z == 0, m_tile = n_tile && blockIdx.y == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ty = tid >> 4, tx = tid & 15;
  const int nc = S / c;
  const long long head0 = static_cast<long long>(b) * S * H + hh;
  const int dkp = (dk + 15) & ~15;
  const Carry wsc = carry_of(ws, static_cast<long long>(gridDim.x) * nc, dkp);
  const bool want_final = C_out != nullptr;

  // thread (ty, tx) holds C[d0 + ty + 16 a][e0 + tx + 16 bb]; thread d < 64
  // of an n tile holds n[d0 + d]
  float C[4][4] = {}, nrow = 0.f, m = 0.f;
  for (int ch = 0; ch < nc; ++ch) {
    const long long pos = static_cast<long long>(ch) * c;
    if (warp == 0) {
      warp_cumsum(log_f + head0 + pos * H, H, sm.cs, c, lane);
      for (int j = lane; j < c; j += 32) sm.li[j] = log_i[head0 + (pos + j) * H];
      __syncwarp();
      warp_carry(sm.cs, sm.li, sm.w, c, c, m, lane, &sm.decay, &sm.m_next);
    }
    __syncthreads();
    const bool update = ch + 1 < nc || want_final;
    if (update)
      for (int i = tid; i < c * kTile; i += kF32Threads) {
        const int r = i / kTile, col = i % kTile;
        const long long src = (head0 + (pos + r) * H) * dk;
        sm.k[r][col] = d0 + col < dk ? k[src + d0 + col] : 0.f;
        sm.wv[r][col] = e0 + col < dk ? sm.w[r] * v[src + e0 + col] : 0.f;
      }
    __syncthreads();
    if (update) {
      float u[4][4] = {};
      for (int j = 0; j < c; ++j) {
        float kd[4], ve[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) kd[a] = sm.k[j][ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) ve[bb] = sm.wv[j][tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) u[a][bb] = fmaf(kd[a], ve[bb], u[a][bb]);
      }
      const float decay = sm.decay;
      m = sm.m_next;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) C[a][bb] = decay * C[a][bb] + u[a][bb];
      if (n_tile && tid < kTile) {
        float un = 0.f;
        for (int j = 0; j < c; ++j) un = fmaf(sm.w[j], sm.k[j][tid], un);
        nrow = decay * nrow + un;
      }
      const bool last = ch + 1 == nc;
      const long long p = static_cast<long long>(bh) * nc + ch + 1;
      float* Cdst = last ? C_out + static_cast<long long>(bh) * dk * dk : wsc.C + p * dkp * dkp;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int d = d0 + ty + 16 * a, e = e0 + tx + 16 * bb;
          if (d < dk && e < dk) Cdst[static_cast<long long>(d) * dk + e] = C[a][bb];
        }
      if (n_tile && tid < kTile && d0 + tid < dk)
        (last ? n_out + static_cast<long long>(bh) * dk : wsc.n + p * dkp)[d0 + tid] = nrow;
      if (m_tile && tid == 0) *(last ? m_out + bh : wsc.m + p) = m;
    }
    __syncthreads();
  }
}

struct OutF32Layout {
  int lds;  // pitch of the score rows: c + 1
  size_t s, C, n, v, q, k, li, cs, mi, inter, rsum, qn, total;  // float offsets
};
constexpr int kTD = 32;        // dk columns per q / k tile
constexpr int kLdT = kTD + 1;  // pitch of the q / k tile rows
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kRowsPerWarp = kMaxChunk / kF32Warps;  // 16

__host__ __device__ inline OutF32Layout out_f32_layout(int dk, int c) {
  OutF32Layout L;
  L.lds = c + 1;
  L.s = 0;
  L.C = L.s + static_cast<size_t>(c) * L.lds;
  L.n = L.C + static_cast<size_t>(dk) * kE32;
  L.v = L.n + dk;
  L.q = L.v + static_cast<size_t>(c) * kE32;
  L.k = L.q + static_cast<size_t>(kMaxChunk) * kLdT;
  L.li = L.k + static_cast<size_t>(kMaxChunk) * kLdT;
  L.cs = L.li + kMaxChunk;
  L.mi = L.cs + kMaxChunk;
  L.inter = L.mi + kMaxChunk;
  L.rsum = L.inter + kMaxChunk;
  L.qn = L.rsum + kMaxChunk;
  L.total = L.qn + kMaxChunk;
  return L;
}

// One block per (batch x head, chunk, 32 value columns), 256 threads: the
// scores in a 16 x 16 thread grid (8 x 8 each, blocks above the diagonal
// skipped), q C and q.n for rows warp + 8 a, over 32-wide dk tiles of q
// and k whose partial sums are added to the running ones (a sum over dk
// rounds like 32 + dk / 32 terms); one warp per row for W; then W v.
__global__ void __launch_bounds__(kF32Threads, 1)
mlstm_out_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ log_i,
              const float* __restrict__ log_f, const float* __restrict__ ws,
              float* __restrict__ h, float* __restrict__ den_out, int S, int H, int dk, int c,
              float scale) {
  extern __shared__ float smem[];
  const OutF32Layout L = out_f32_layout(dk, c);
  float* sS = smem + L.s;
  float* sC = smem + L.C;
  float* sN = smem + L.n;
  float* sV = smem + L.v;
  float* sQ = smem + L.q;
  float* sK = smem + L.k;
  float* sLi = smem + L.li;
  float* sCs = smem + L.cs;
  float* sMi = smem + L.mi;
  float* sInter = smem + L.inter;
  float* sRsum = smem + L.rsum;
  float* sQn = smem + L.qn;

  const int bh = blockIdx.x, chunk = blockIdx.y, e0 = blockIdx.z * kE32;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int ecol = e0 + lane;
  const bool col_ok = ecol < dk;
  const int nc = S / c;
  const long long tstride = static_cast<long long>(H) * dk;
  const long long row0 =
      (static_cast<long long>(b) * S + static_cast<long long>(chunk) * c) * H + hh;
  const long long head0 = row0 * dk;  // (b, t0, hh, 0) in q, k, v, h
  const bool carry_in = chunk > 0;
  const long long p = static_cast<long long>(bh) * nc + chunk;
  const int dkp = (dk + 15) & ~15;
  const Carry wsc = carry_of(const_cast<float*>(ws), static_cast<long long>(gridDim.x) * nc, dkp);

  // 1. the carry's columns, v's columns and the chunk's gates
  for (int i = tid; i < dk * kE32; i += kF32Threads) {
    const int d = i / kE32, e = i - d * kE32;
    sC[i] = carry_in && e0 + e < dk ? wsc.C[p * dkp * dkp + static_cast<long long>(d) * dk + e0 + e]
                                    : 0.f;
  }
  for (int i = tid; i < dk; i += kF32Threads) sN[i] = carry_in ? wsc.n[p * dkp + i] : 0.f;
  for (int j = tid; j < c * kE32; j += kF32Threads) {
    const int r = j / kE32, e = j - r * kE32;
    sV[j] = e0 + e < dk ? v[head0 + r * tstride + e0 + e] : 0.f;
  }
  if (warp == 0) {
    warp_cumsum(log_f + row0, H, sCs, c, lane);
    for (int j = lane; j < c; j += 32) sLi[j] = log_i[row0 + static_cast<long long>(j) * H];
  }
  const float m = carry_in ? wsc.m[p] : 0.f;

  // a 32-wide tile of q (scaled) or k at columns d0.., rows past c and
  // columns past dk zero
  auto load_tile = [&](const float* src, float* dst, int d0, float mult) {
    for (int i = tid; i < kMaxChunk * kTD; i += kF32Threads) {
      const int r = i / kTD, dd = i - r * kTD;
      dst[r * kLdT + dd] = r < c && d0 + dd < dk ? src[head0 + r * tstride + d0 + dd] * mult : 0.f;
    }
  };

  // 2. scores q k^T, and q C[:, this block's columns] and q.n for rows
  //    warp + 8 a, over dk tiles
  float qc[kRowsPerWarp], qn[kRowsPerWarp];
#pragma unroll
  for (int a = 0; a < kRowsPerWarp; ++a) qc[a] = qn[a] = 0.f;
  for (int d0 = 0; d0 < dk; d0 += kTD) {
    __syncthreads();  // the previous tile is consumed (and step 1 is written)
    load_tile(q, sQ, d0, scale);
    load_tile(k, sK, d0, 1.f);
    __syncthreads();
    float acc[8][8], qct[kRowsPerWarp];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) acc[a][bb] = 0.f;
#pragma unroll
    for (int a = 0; a < kRowsPerWarp; ++a) qct[a] = 0.f;
    for (int dd = 0; dd < kTD; ++dd) {
      float qa[8], kb[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) qa[a] = sQ[(ty + 16 * a) * kLdT + dd];
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) kb[bb] = sK[(tx + 16 * bb) * kLdT + dd];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb <= a; ++bb) acc[a][bb] += qa[a] * kb[bb];
      const float cde = d0 + dd < dk ? sC[(d0 + dd) * kE32 + lane] : 0.f;
#pragma unroll
      for (int a = 0; a < kRowsPerWarp; ++a) qct[a] += sQ[(warp + kF32Warps * a) * kLdT + dd] * cde;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int bb = 0; bb <= a; ++bb) {
        const int i = ty + 16 * a, j = tx + 16 * bb;
        if (i < c && j < c) sS[i * L.lds + j] = d0 == 0 ? acc[a][bb] : sS[i * L.lds + j] + acc[a][bb];
      }
#pragma unroll
    for (int a = 0; a < kRowsPerWarp; ++a) qc[a] += qct[a];
    const float nd = d0 + lane < dk ? sN[d0 + lane] : 0.f;
#pragma unroll
    for (int a = 0; a < kRowsPerWarp; ++a) qn[a] += sQ[(warp + kF32Warps * a) * kLdT + lane] * nd;
  }
#pragma unroll
  for (int a = 0; a < kRowsPerWarp; ++a) {
    const float s = warp_sum(qn[a]);
    const int i = warp + kF32Warps * a;
    if (lane == 0 && i < c) sQn[i] = s;
  }
  __syncthreads();

  // 3. one warp per row: the masked log weights D, the stabilizer m_i,
  //    W = scores * exp(D - m_i) (0 above the diagonal) and its row sum
  for (int i = warp; i < c; i += kF32Warps) {
    const float csi = sCs[i];
    const float g = csi + m;
    float dmax = -INFINITY;
    for (int j = lane; j <= i; j += 32) dmax = fmaxf(dmax, csi - sCs[j] + sLi[j]);
    const float mi = fmaxf(warp_max(dmax), g);
    float rsum = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float w = j <= i ? sS[i * L.lds + j] * expf(csi - sCs[j] + sLi[j] - mi) : 0.f;
      sS[i * L.lds + j] = w;
      rsum += w;
    }
    rsum = warp_sum(rsum);
    if (lane == 0) {
      sMi[i] = mi;
      sInter[i] = expf(g - mi);
      sRsum[i] = rsum;
    }
  }
  __syncthreads();

  // 4. h = (W v + inter * q C) / max(|rowsum W + inter * q.n|, exp(-m_i))
  //    for rows warp + 8 a and this block's columns
#pragma unroll
  for (int a = 0; a < kRowsPerWarp; ++a) {
    const int i = warp + kF32Warps * a;
    if (i >= c) break;
    const float* srow = sS + i * L.lds;
    float num = 0.f;
    for (int j0 = 0; j0 <= i; j0 += 32) {  // 32-term partial sums
      const int jend = min(i + 1, j0 + 32);
      float part = 0.f;
      for (int j = j0; j < jend; ++j) part += srow[j] * sV[j * kE32 + lane];
      num += part;
    }
    const float inter = sInter[i];
    num += inter * qc[a];
    const float den = sRsum[i] + inter * sQn[i];
    if (col_ok) h[head0 + i * tstride + ecol] = num / fmaxf(fabsf(den), expf(-sMi[i]));
    if (den_out != nullptr && blockIdx.z == 0 && lane == 0)  // for the backward
      den_out[row0 + static_cast<long long>(i) * H] = den;
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* li,
                        const float* lf, float* h, float* den, float* C, float* n, float* m,
                        float* ws, int B, int S, int H, int dk, int c, int tiles, int e_tiles,
                        int value_tiles, float scale, cudaStream_t stream) {
  const bool vec = dk % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(ws)) & 15u) == 0;
  cudaError_t err = allow_smem(mlstm_state_tc, sizeof(StateTC));
  if (err != cudaSuccess) return err;
  const size_t out_smem = out_layout(dk).total;
  err = allow_smem(mlstm_out_tc, out_smem);
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
  const size_t out_smem = out_f32_layout(dk, c).total * sizeof(float);
  cudaError_t err = allow_smem(mlstm_state_f32, sizeof(StateF32));
  if (err != cudaSuccess) return err;
  err = allow_smem(mlstm_out_f32, out_smem);
  if (err != cudaSuccess) return err;
  mlstm_state_f32<<<dim3(B * H, tiles, tiles), kF32Threads, sizeof(StateF32), stream>>>(
      k, v, li, lf, ws, C, n, m, S, H, dk, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_out_f32<<<dim3(B * H, S / c, value_tiles), kF32Threads, out_smem, stream>>>(
      q, k, v, li, lf, ws, h, den, S, H, dk, c, scale);
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
// up to 16), 16-byte aligned.  c divides S.  The wrapper's plan gives the
// grids' tiles: the state pass's `state_tiles` tiles of 64 dk rows and
// `state_e_tiles` of value columns (96 in bf16, 64 in f32), and the output
// pass's `value_tiles` of value columns (192 in bf16, 32 in f32); a plan
// that does not cover dk exactly is refused.  Two launches on
// `stream`, the state pass and the output pass.  Returns the CUDA error of
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
  const int state_e = tc ? repro::kStateE : repro::kTile;
  const int value_tile = tc ? repro::kValueGroup * repro::kTile : repro::kE32;
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
