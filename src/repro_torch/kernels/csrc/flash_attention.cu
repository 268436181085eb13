// Causal (or full) GQA flash attention, forward, for Hopper (sm_90a), with
// an optional sliding window (local attention).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel):
// out = softmax(q k^T / sqrt(D), causal mask) v over q (B, S, H, D) and the
// compact k, v (B, S, KV, D), with query head h reading KV head h / G.  Also
// returns lse = m + log(max(l, 1e-30)) (B, S, H) f32, and divides by
// max(l, 1e-30), as the TPU kernel does.  With window > 0 a query at
// position i sees only keys j with i - window < j (recurrentgemma's local
// layers; the reference computes them with models/layers.py::
// local_band_attention, whose plain statement is kernels/ref.py::
// causal_attention_ref(window=)).
//
// What bounds it on the H100: operations.  A causal pass does 2*B*H*S^2*D
// flops (QK^T and PV over the lower triangle) on 2*B*S*(H + KV)*D elements
// moved, so at S = 1024, D = 256 it sits far above the ~295 flop/byte ridge.
//
// Design, rather than a copy of the TPU grid (which walks KV tiles as its
// innermost sequential axis and carries (m, l, acc) in VMEM across steps),
// common to the variants below:
// - one thread block per (batch, KV head, q tile, head chunk).  Its 64 rows
//   are (query position, query head) pairs: BQ positions times GC heads of
//   one KV group (GC = min(G, 64), BQ = 64 / GC).  Each K/V tile is loaded
//   once into shared memory for all GC heads that read it: at gemma's G = 8
//   that is 8x fewer K/V reads than one block per query head;
// - the block loops over KV tiles up to the diagonal only, and masks the
//   ragged last tile (any S, no padding), so causal blocks never touch the
//   upper triangle;
// - with a window, the loop starts at the tile that holds key
//   q0 - window + 1, so a block reads about (window + 64) / tile tiles
//   whatever its position; keys inside the band's ragged edges are masked;
// - the online-softmax state (m, l) and the output accumulator are f32.
//   Tiles above 48 KB of shared memory opt into dynamic shared memory (at
//   most 232,448 bytes).
//
// The tensor-core variant (bf16, D a multiple of 16, 16-byte aligned rows):
// - both products are bf16 mma.sync.m16n8k16 with f32 sums (mma.cuh, shared
//   with the backward, where mma.sync beat wgmma at D = 256).  Q, K and V
//   sit in shared memory as bf16 rows padded by 16 bytes (pitch D + 8) and
//   reach the tensor cores by ldmatrix (.trans for V);
// - S, P and O never leave registers: S stays in its m16n8 accumulator
//   fragments, a row's max and sum come from the quad of lanes that holds
//   the row (two shuffles), and P is re-packed from the accumulator layout
//   straight into A fragments.  P is split into bf16 hi + lo fragments and
//   both are multiplied with V (one extra mma per step), so the product
//   keeps about 16 bits of P, near the TPU kernel's f32 P V.  (P rounded
//   once to bf16 moves nearly every output by an ulp; the reference's
//   near-hard attention turns that into different logits two layers on);
// - 8 warps and K/V tiles of 64 keys, two buffers each, filled by cp.async
//   while the other is multiplied (rows past S zero-filled).  Warp w takes
//   rows 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of every tile, with
//   its own (m, l) and O of 16 rows x D in registers (128 floats a lane at
//   D = 256).  At the end the two warps of a row slice exchange half of O
//   and (m, l) through the free K/V buffers; each merges, in the fixed
//   order (keys 0-31) + (keys 32-63), and writes half the columns;
// - shared memory at D = 256: Q 33,792 + K/V 4 x 33,792 = 168,960 bytes,
//   one block per SM (87,040 at D = 128);
// - only edge tiles (crossing the causal diagonal, the band's lower edge or
//   S) do the mask arithmetic; interior tiles skip it;
// - the grid is one dimension ordered heaviest q tile first over every
//   (batch, KV head, head chunk), the longest-first plan: at gemma-2b's
//   (1, 1024, 8, 1, 256) it is 128 blocks (8 positions x 8 heads each) on
//   132 SMs, one wave whose length is the last q tile's 16 key tiles (the
//   mean is 8.5); at the train step's batch 2, 256 blocks, and the second
//   wave takes the light ones; recurrentgemma's windowed (1, 4096, 16, 1,
//   256) is 1,024 blocks of about 33 key tiles each.  Pairing tile i with
//   n - 1 - i would halve the blocks below one wave and not shorten it.
//
// The CUDA-core variant (f32, or a head dim the tensor-core one refuses):
// - f32 stays on the CUDA cores on purpose: each score is the sequential
//   f32 FMA chain over the head dim that cuBLAS's f32 GEMM (the plain
//   path's einsum) also takes, so the f32 forward gives the plain path's
//   bits on the reference's nearly hard attention.  The f32 train-step
//   checks need that: a split-TF32 tensor-core forward (PERF.md),
//   closer to an f64 run than plain f32 is, still moved the 2-layer
//   gemma-2b gradients 0.065 of a leaf's largest entry from the plain
//   path's (the gate is 1e-3): scores in the hundreds turn a few ulps of
//   difference into different probabilities where two keys nearly tie,
//   and the next layer amplifies them.  The f32 backward runs its other
//   products on the tensor cores but recomputes these same scores, bit for
//   bit (fma4 in tf32.cuh; flash_attention_bwd.cu);
// - four threads own one row: each computes 8 of the tile's 32 scores, the
//   row's max and sum come from two shuffles, the probabilities go through
//   shared memory to the same four threads (one warp, so __syncwarp), and
//   each thread keeps a quarter of the row's f32 accumulator (columns 16 c
//   + 4 sub .. + 3) in registers.  Products run in f32 on the CUDA cores,
//   so f32 inputs keep their f32 accuracy;
// - tiles are staged in shared memory as f32 whatever the input type, in
//   rows of whole 4-column pieces padded by 4 floats (pitch D + 4 at D a
//   multiple of 4), and every shared-memory read is 16 bytes: four steps
//   of a score's chain, or four of a thread's output columns.  K and V
//   have two buffers, the next tile filled while this one is used: by
//   16-byte cp.async for f32 rows of whole pieces on 16-byte boundaries
//   (rows past S zero-filled), element by element for the rest (bf16,
//   other head dims, unaligned rows), with the same arithmetic either way.
//   208,128 bytes at D = 256, one block per SM.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "tf32.cuh"

namespace repro {
namespace {

constexpr float kMaskValue = -1e30f;  // the TPU kernel's mask value

// ------------------------------------------------------ tensor-core variant

constexpr int kTcRows = 64;   // (position, head) rows per block
constexpr int kTcKeys = 64;   // keys per K/V tile
constexpr int kTcThreads = 256;  // 8 warps: 4 row slices x 2 key halves
constexpr int kTcHalf = kTcKeys / 2;  // keys of a tile one warp takes

struct TcLayout {
  int ld;  // pitch of the bf16 Q, K and V rows: D + 8 (16 bytes of padding)
  size_t q, k, v, total;  // byte offsets in dynamic shared memory
};

// Every region starts on a 16-byte boundary, as cp.async and ldmatrix need.
// After the last tile, the K/V buffers hold the warps' exchanged halves of O.
__host__ __device__ inline TcLayout tc_layout(int D) {
  TcLayout L;
  L.ld = D + 8;
  const size_t tile = static_cast<size_t>(kTcKeys) * L.ld * 2;
  L.q = 0;
  L.k = L.q + static_cast<size_t>(kTcRows) * L.ld * 2;
  L.v = L.k + 2 * tile;  // two buffers each for K and V
  L.total = L.v + 2 * tile;
  return L;
}

// DMAX: the head dims up to DMAX (multiples of 16) share one register
// budget: a warp keeps 16 rows x DMAX columns of O (DMAX / 8 accumulator
// tiles of 16 x 8, 4 floats a lane each).  One block per SM: held to two
// (128 registers), DMAX = 128 ran 1.5x faster but spilled 44 bytes, so the
// compiler keeps its 149 there (PERF.md).
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                    int S, int H, int KV, int D, int GC, int BQ, int causal, int window,
                    float scale) {
  constexpr int kNt = DMAX / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const TcLayout L = tc_layout(D);
  const int ld = L.ld;
  auto* sQ = reinterpret_cast<bf16*>(tc_smem + L.q);
  auto* sK = reinterpret_cast<bf16*>(tc_smem + L.k);  // 2 buffers
  auto* sV = reinterpret_cast<bf16*>(tc_smem + L.v);  // 2 buffers
  const int G = H / KV;
  // block order: heaviest q tiles first, over every (batch, KV head) and
  // head chunk, so that the blocks of a second wave are the light ones
  const int ntq = (S + BQ - 1) / BQ, nch = (G + GC - 1) / GC;
  const int nbk = gridDim.x / ntq;  // B * KV * nch blocks share a q tile
  const int qt = ntq - 1 - static_cast<int>(blockIdx.x) / nbk;
  const int rest = static_cast<int>(blockIdx.x) % nbk;
  const int g0 = rest / (nbk / nch) * GC, bkv = rest % (nbk / nch);
  const int q0 = qt * BQ;
  const int b = bkv / KV, kvh = bkv - b * KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row and column pair
  const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .., keys 32 wn .. of each tile
  const int rows = BQ * GC;
  const int chunks = D / 8;  // 16-byte pieces of a row
  const int tile_elems = kTcKeys * ld;
  const int nfr = D / 8;     // 8-column accumulator tiles of a row

  // row r of the tile is query position q0 + r / GC, head kvh*G + g0 + r % GC
  for (int i = tid; i < kTcRows * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    const bool ok = r < rows && qp < S && g < G;
    const long long off =
        ok ? ((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + c * 8 : 0;
    cp_async16(sQ + r * ld + c * 8, q + off, ok);
  }
  // a thread copies piece c_ld of rows r_ld, r_ld + r_step, ... of each
  // K/V tile (no division per piece)
  const int r_step = kTcThreads / chunks, c_ld = tid % chunks;
  const int r_ld = tid < r_step * chunks ? tid / chunks : kTcKeys;
  const long long kv0 = (static_cast<long long>(b) * S * KV + kvh) * D + c_ld * 8;
  auto load_kv = [&](int tile, int buf) {
    const int off_s = buf * tile_elems + c_ld * 8;
    for (int r = r_ld; r < kTcKeys; r += r_step) {
      const int kp = tile * kTcKeys + r;
      const bool ok = kp < S;
      const long long off = ok ? kv0 + static_cast<long long>(kp) * KV * D : 0;
      cp_async16(sK + off_s + r * ld, k + off, ok);
      cp_async16(sV + off_s + r * ld, v + off, ok);
    }
  };

  // causal: the last key any row of this tile attends to is q0 + BQ - 1;
  // window: the first is q0 - window + 1
  const int q_last = q0 + BQ - 1;
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + kTcKeys - 1) / kTcKeys;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kTcKeys : 0;
  load_kv(t_first, t_first & 1);
  cp_async_commit();  // Q and the first K/V tile

  // this thread's two rows are 16 wm + gq and + 8: query positions
  // q0 + row / GC
  float o[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  for (int t = t_first; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // tile t (and Q) landed for every thread
    const bf16* cK = sK + (t & 1) * tile_elems;
    const bf16* cV = sV + (t & 1) * tile_elems;
    const int k0 = t * kTcKeys;
    const int kw = k0 + kTcHalf * wn;  // this warp's first key

    // S = Q K^T: rows 16 wm .., keys kw .. kw + 31, in four 8-key tiles
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      unsigned aq[4];
      load_a(aq, sQ, ld, 16 * wm, kk, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned bk[4];
        load_b_nmajor(bk, cK, ld, kTcHalf * wn + 16 * jj, kk, lane);
        mma16816(s[2 * jj], aq, bk[0], bk[1]);
        mma16816(s[2 * jj + 1], aq, bk[2], bk[3]);
      }
    }

    // scale and mask; only a tile that crosses the causal diagonal, the
    // band's lower edge or S does the mask arithmetic
    const bool edge = k0 + kTcKeys > S || (causal && k0 + kTcKeys - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kp = kw + 8 * j + 2 * tq + (e & 1);
          const int qp = q0 + (16 * wm + gq + 8 * (e >> 1)) / GC;
          const bool ok =
              kp < S && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
          x = ok ? x : kMaskValue;
        }
        s[j][e] = x;
      }

    // online softmax per row (mma.cuh); P is then split into bf16 hi + lo
    // A fragments in registers (one bf16 rounding of P fails the f64 gate:
    // see the header)
    float corr[2];
    softmax_step(s, m, l, corr, kMaskValue);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += (P_hi + P_lo) V over this warp's 32 keys: two k-steps of 16,
    // whose A fragments are the score tiles 2 kk and 2 kk + 1 re-packed
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned ah[4], al[4];
      p_frags_hi_lo(s[2 * kk], s[2 * kk + 1], ah, al);
#pragma unroll
      for (int jj = 0; jj < kNt / 2; ++jj) {
        if (2 * jj < nfr) {
          unsigned bv[4];
          load_b_kmajor(bv, cV, ld, 16 * jj, kTcHalf * wn + 16 * kk, lane);
          mma16816(o[2 * jj], ah, bv[0], bv[1]);
          mma16816(o[2 * jj], al, bv[0], bv[1]);
          mma16816(o[2 * jj + 1], ah, bv[2], bv[3]);
          mma16816(o[2 * jj + 1], al, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait_all();

  // the two warps of a row slice (wn = 0, 1) hold partial (m, l, O) over
  // the two key halves of every tile.  Each finalizes half the columns,
  // wn * D / 2 ..: it leaves the other half, and its (m, l), in the K/V
  // buffers (free now; 256 D + 4096 bytes of their 512 (D + 8)) for its
  // partner, then merges the partner's, always in the order (wn = 0) +
  // (wn = 1), so the result does not depend on the warp
  const int half = nfr / 2;  // accumulator tiles of half a row
  float4* xo = reinterpret_cast<float4*>(tc_smem + L.k);  // (8 warps, half, 32 lanes)
  float4* xml = xo + kTcThreads / 32 * half * 32;         // (8 warps, 32 lanes)
  const int partner = warp ^ 4;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int jl = j - (1 - wn) * half;  // index within the exported half
    if (j < nfr && jl >= 0 && jl < half)
      xo[(warp * half + jl) * 32 + lane] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  xml[warp * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  __syncthreads();
  const float4 pml = xml[partner * 32 + lane];
  const float pm[2] = {pml.x, pml.y}, pl[2] = {pml.z, pml.w};
  float wa[2], wb[2], den[2], mt[2];  // weights of wn = 0 and wn = 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m0 = wn == 0 ? m[h] : pm[h], m1 = wn == 0 ? pm[h] : m[h];
    const float l0 = wn == 0 ? l[h] : pl[h], l1 = wn == 0 ? pl[h] : l[h];
    mt[h] = fmaxf(m0, m1);
    wa[h] = expf(m0 - mt[h]);
    wb[h] = expf(m1 - mt[h]);
    den[h] = fmaxf(l0 * wa[h] + l1 * wb[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wm + gq + 8 * h;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    if (r >= rows || qp >= S || g >= G) continue;
    const long long orow = (static_cast<long long>(b) * S + qp) * H + kvh * G + g;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int jl = j - wn * half;
      if (j >= nfr || jl < 0 || jl >= half) continue;
      const float4 x = xo[(partner * half + jl) * 32 + lane];
      const float p0 = h ? x.z : x.x, p1 = h ? x.w : x.y;
      const float a0 = wn == 0 ? o[j][2 * h] : p0, b0 = wn == 0 ? p0 : o[j][2 * h];
      const float a1 = wn == 0 ? o[j][2 * h + 1] : p1, b1 = wn == 0 ? p1 : o[j][2 * h + 1];
      *reinterpret_cast<unsigned*>(out + orow * D + 8 * j + 2 * tq) =
          pack_bf16((a0 * wa[h] + b0 * wb[h]) / den[h], (a1 * wa[h] + b1 * wb[h]) / den[h]);
    }
    if (lse != nullptr && wn == 0 && tq == 0) lse[orow] = mt[h] + logf(den[h]);
  }
}

// ------------------------------------------------------- CUDA-core variant

constexpr int kRows = 64;      // (position, head) rows per block
constexpr int kKeys = 32;      // keys per KV tile
constexpr int kThreads = 256;  // 4 per row
constexpr int kSub = kThreads / kRows;
constexpr int kKeysPerThread = kKeys / kSub;

// f32 rows of whole 4-column pieces (D rounded up, zero past D) and 4
// floats of padding
__host__ __device__ inline int cc_pitch(int D) { return (D + 3) / 4 * 4 + 4; }

__host__ __device__ inline size_t smem_floats(int D) {
  // Q (kRows rows), two buffers each of K and V (kKeys rows), P (kRows x kKeys+1)
  return static_cast<size_t>(kRows + 4 * kKeys) * cc_pitch(D) +
         static_cast<size_t>(kRows) * (kKeys + 1);
}

// Columns e .. e + 3 of a row as f32 into shared memory, zero past D or
// where !ok: one 16-byte cp.async when `vec` (f32 rows of whole pieces on
// 16-byte boundaries), else element by element.
template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool ok, int e, int D, bool vec) {
  if (vec) {
    cp_async16(dst, src, ok);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = ok && e + i < D ? to_f32(src[i]) : 0.f;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int KV, int D,
                 int GC, int BQ, int causal, int window, float scale, int vec) {
  constexpr int kChunks = DMAX / 16;  // a thread's 4-column pieces of a row, at most
  extern __shared__ __align__(16) float smem[];
  const int Dp = cc_pitch(D);
  float* sQ = smem;                // (kRows, Dp)
  float* sK = sQ + kRows * Dp;     // 2 x (kKeys, Dp)
  float* sV = sK + 2 * kKeys * Dp;  // 2 x (kKeys, Dp)
  float* sP = sV + 2 * kKeys * Dp;  // (kRows, kKeys + 1)
  const int G = H / KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int g0 = blockIdx.z * GC;
  const int tid = threadIdx.x;
  const int r = tid / kSub, sub = tid - r * kSub;
  const int rows = BQ * GC;
  const int pieces = Dp / 4 - 1;  // 4-column pieces of a row

  // row rr of the tile is query position q0 + rr / GC, head kvh*G + g0 + rr % GC
  for (int i = tid; i < kRows * pieces; i += kThreads) {
    const int rr = i / pieces, c = i - rr * pieces;
    const int qp = q0 + rr / GC, g = g0 + rr % GC;
    const bool ok = rr < rows && qp < S && g < G;
    const long long off =
        ok ? ((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + c * 4 : 0;
    stage4(sQ + rr * Dp + c * 4, q + off, ok, c * 4, D, vec);
  }
  auto load_kv = [&](int k0, int buf) {
    for (int i = tid; i < kKeys * pieces; i += kThreads) {
      const int kk = i / pieces, c = i - kk * pieces;
      const int kp = k0 + kk;
      const bool ok = kp < S;
      const long long off =
          ok ? ((static_cast<long long>(b) * S + kp) * KV + kvh) * D + c * 4 : 0;
      stage4(sK + (buf * kKeys + kk) * Dp + c * 4, k + off, ok, c * 4, D, vec);
      stage4(sV + (buf * kKeys + kk) * Dp + c * 4, v + off, ok, c * 4, D, vec);
    }
  };
  const int qpos = q0 + r / GC, g = g0 + r % GC;
  const bool row_ok = r < rows && qpos < S && g < G;

  float m = kMaskValue, l = 0.f;
  float acc[4 * kChunks];
#pragma unroll
  for (int c = 0; c < 4 * kChunks; ++c) acc[c] = 0.f;

  // causal: the last key any row of this tile attends to is q0 + BQ - 1;
  // window: the first is q0 - window + 1
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int kstart = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  load_kv(kstart, 0);
  cp_async_commit();  // Q and the first K/V tile
  for (int k0 = kstart, buf = 0; k0 < kend; k0 += kKeys, buf ^= 1) {
    if (k0 + kKeys < kend) load_kv(k0 + kKeys, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // tile k0 (and Q) landed for every thread
    const float* cK = sK + buf * kKeys * Dp;
    const float* cV = sV + buf * kKeys * Dp;

    // this thread's keys sub, sub + 4, ...: each score the FMA chain over
    // the head dim (fma4), as the f32 backward recomputes it
    float s[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.f;
    for (int e = 0; e < Dp - 4; e += 4) {
      const float4 qe = *reinterpret_cast<const float4*>(sQ + r * Dp + e);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        s[j] = fma4(s[j], qe, *reinterpret_cast<const float4*>(cK + (sub + kSub * j) * Dp + e));
    }
    float tile_max = kMaskValue;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int kp = k0 + sub + kSub * j;
      const bool ok =
          kp < S && (!causal || kp <= qpos) && (window <= 0 || qpos - kp < window);
      s[j] = ok ? s[j] * scale : kMaskValue;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // the row's four threads are neighbouring lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int kk = sub + kSub * j;
      const float p = s[j] > kMaskValue ? expf(s[j] - m_new) : 0.f;
      psum += p;
      sP[r * (kKeys + 1) + kk] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities are read by the same four threads
#pragma unroll
    for (int c = 0; c < 4 * kChunks; ++c) acc[c] *= corr;
    // columns 16 c + 4 sub .. + 3: the four threads of a row read
    // neighbouring banks
    for (int kk = 0; kk < kKeys; ++kk) {
      const float p = sP[r * (kKeys + 1) + kk];
      const float* vrow = cV + kk * Dp + 4 * sub;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (16 * c + 4 * sub < D) {
          const float4 ve = *reinterpret_cast<const float4*>(vrow + 16 * c);
          acc[4 * c] = __fmaf_rn(p, ve.x, acc[4 * c]);
          acc[4 * c + 1] = __fmaf_rn(p, ve.y, acc[4 * c + 1]);
          acc[4 * c + 2] = __fmaf_rn(p, ve.z, acc[4 * c + 2]);
          acc[4 * c + 3] = __fmaf_rn(p, ve.w, acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();  // this K/V buffer and sP are free for the next tile
  }
  cp_async_wait_all();

  if (!row_ok) return;
  const long long orow = (static_cast<long long>(b) * S + qpos) * H + kvh * G + g;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int e = 16 * c + 4 * sub;
    if (e >= D) continue;
    if (vec) {
      *reinterpret_cast<float4*>(out + orow * D + e) =
          make_float4(acc[4 * c] / den, acc[4 * c + 1] / den, acc[4 * c + 2] / den,
                      acc[4 * c + 3] / den);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e + i < D) out[orow * D + e + i] = from_f32<T>(acc[4 * c + i] / den);
    }
  }
  if (lse != nullptr && sub == 0) lse[orow] = m + logf(den);
}

template <typename T, int DMAX>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                     int S, int H, int KV, int D, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int G = H / KV;
  const int GC = G < kRows ? G : kRows;
  const int BQ = kRows / GC;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = set_max_dynamic_smem(flash_fwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies and stores: f32 rows of whole pieces on 16-byte boundaries
  const int vec = sizeof(T) == 4 && D % 4 == 0 && aligned16(q, k, v, out);
  dim3 grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, KV, D, GC, BQ, causal, window, scale, vec);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int S, int H, int KV, int D, int causal, int window, float scale,
                        cudaStream_t stream) {
  const int G = H / KV;
  const int GC = G < kTcRows ? G : kTcRows;
  const int BQ = kTcRows / GC;
  const size_t smem = tc_layout(D).total;
  cudaError_t err = set_max_dynamic_smem(flash_fwd_tc_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  // one dimension: the kernel orders its blocks heaviest q tile first
  const long long blocks =
      static_cast<long long>((S + BQ - 1) / BQ) * B * KV * ((G + GC - 1) / GC);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tc_kernel<DMAX><<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, S, H, KV, D,
      GC, BQ, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                      int S, int H, int KV, int D, int causal, int window, float scale,
                      cudaStream_t stream) {
  if (D <= 64)
    return launch_tc_d<64>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, stream);
  if (D <= 128)
    return launch_tc_d<128>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, stream);
  return launch_tc_d<256>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int S, int H, int KV, int D, int causal, int window, float scale,
                   cudaStream_t stream) {
  if (D <= 64)
    return launch_d<T, 64>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, stream);
  if (D <= 128)
    return launch_d<T, 128>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, stream);
  if (D <= 256)
    return launch_d<T, 256>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// The largest head dim the kernel takes (the CUDA-core variant keeps its
// accumulator in registers).  Both variants fit their shared memory at it:
// 208,128 bytes for the CUDA-core one, 168,960 for the tensor-core one.
extern "C" int repro_flash_attention_max_head_dim() { return 256; }

// The variant a call with these arguments takes (tf32.cuh: 0 CUDA cores,
// 1 bf16 tensor cores, 2 the f32 backward's split TF32 on the tensor
// cores): `x` is the forward's out or the backward's dout, or null;
// `backward` picks the kernel.
extern "C" int repro_flash_attention_route(int dtype, int D, const void* q, const void* k,
                                           const void* v, const void* x, int backward) {
  return repro::flash_route(dtype, D, q, k, v, x, backward != 0);
}

// q and out (B, S, H, D), k and v (B, S, KV, D) in `dtype`; lse (B, S, H) f32
// or null; window 0 for global attention, else the local window.  Rows the
// bf16 tensor-core variant takes go to it, the rest to the CUDA-core
// variant.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int repro_flash_attention(int device, int dtype, const void* q, const void* k,
                                     const void* v, void* out, void* lse, int B, int S, int H,
                                     int KV, int D, int causal, int window, float scale,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (repro::flash_route(dtype, D, q, k, v, out, false) == repro::kRouteBf16Tc)
    return repro::launch_tc(q, k, v, out, l, B, S, H, KV, D, causal, window, scale, s);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, out, l, B, S, H, KV, D, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, out, l, B, S, H, KV, D, causal, window, scale,
                                        s);
  return cudaErrorInvalidValue;
}
