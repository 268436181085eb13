// Causal (or full, or windowed) GQA flash attention, backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/flash_attention.py::flash_attention_bwd
// (_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel).  Given q, out, dO
// (B, S, H, D), the compact k, v (B, S, KV, D), the forward's lse (B, S, H)
// f32 and delta = rowsum(dO * out) (B, S, H) f32, it computes, with query
// head h reading KV head h / G and p = exp(q k^T * scale - lse):
//   dp = dO v^T,  ds = p * (dp - delta) * scale,
//   dq = ds k,  dk = sum over the G heads of ds^T q,  dv = the same of p^T dO.
//
// What bounds it on the H100: operations.  The causal half of five
// products, 5 * 2 * B * H * (S^2 / 2) * D flops (10.7 GFLOP at gemma-2b's
// (1, 1024, 8, 1, 256)), on 4 * B * S * (H + KV) * D elements moved.  In
// f32: 67 TFLOP/s on the CUDA cores (0.160 ms there), or about 165 TFLOP/s
// with three TF32 products per f32 product on the tensor cores (0.065 ms;
// here the dP products take four, and the score products, recomputed in
// both passes, run on the CUDA cores: 0.064 ms of CUDA-core work).
//
// Common to the variants, rather than a copy of the TPU grid (which walks
// the other axis as its innermost sequential grid dimension and carries the
// sums in VMEM):
// - a dq pass and a dk/dv pass.  Every output element is written once,
//   after a loop in a fixed order, and no atomics are used, so two runs
//   give the same bits;
// - tiles of 64 rows that are (query position, query head) pairs of one KV
//   group, as in the forward (GC = min(G, 64) heads times BQ = 64 / GC
//   positions), so each K/V tile is read once for the GC heads that use it;
//   G > 64 takes several head chunks;
// - any S: rows past S load as zero and every probability is masked by
//   key < S (and key <= query when causal).  Blocks above the diagonal are
//   never visited: the dq pass walks the key tiles from the diagonal back
//   to 0, the dk/dv pass the query tiles from the diagonal on;
// - a sliding window (window > 0: recurrentgemma's local layers) masks
//   every pair but 0 <= q - k < window, as the forward does; the dq pass
//   then starts its key tiles at the one that holds q0 - window + 1 and the
//   dk/dv pass ends its query tiles before k0 + (key tile) + window - 1, so
//   a block walks about (window + tile) / tile tiles whatever S is (the
//   wrapper's split plan, `_dkv_splits`, counts the windowed range);
// - p, dp, delta and ds are f32.
//
// The bf16 tensor-core variant (D a multiple of 16 up to 256, 16-byte
// aligned rows; the same test as the forward's tensor-core variant):
// - all five products are bf16 mma.sync.m16n8k16 with f32 sums, their
//   operands read from shared memory by ldmatrix (.trans for the operands
//   that are stored k-major: dO and q in dv, dk; k in dq).  Not wgmma:
//   S and dP (and S^T, dP^T) do fit it (64 rows, depth D, both operands
//   K-major in shared memory), but in these tiles each warpgroup gets an
//   m64n32 product, and a version that ran them on wgmma (128-byte
//   swizzle, or none) took 0.30-0.32 ms at gemma-2b's shape against this
//   kernel's 0.25 in the same call (scripts/bench_flash_bwd.py; PERF.md).
//   Larger wgmma tiles do not fit the shared memory at D = 256 with two
//   buffers;
// - operands live in shared memory as bf16 rows padded by 16 bytes (pitch
//   D + 8), so the eight rows an ldmatrix reads fall in eight different
//   16-byte bank groups.  They arrive by cp.async (16-byte pieces, rows
//   past S zero-filled) into two buffers: the next tile is in flight while
//   this one is multiplied;
// - 8 warps.  In the score products (S and dP: 64 x 64, depth D) warp w
//   takes rows 16 (w % 4) .. + 15 and columns 32 (w / 4) .. + 31; p and ds
//   are formed in registers, rounded once to bf16 and written to shared
//   memory; in the gradient products (64 x D, depth 64) warp w takes rows
//   16 (w % 4) .. + 15 and the half D / 2 * (w / 4) .. of the columns, whose
//   f32 sums stay in registers from the first tile to the last;
// - p and ds are rounded to bf16 once before their products (no hi + lo
//   split as in the forward): each enters a sum of many terms of both
//   signs whose result is itself rounded to bf16, and the checks
//   (2e-2 of each output's largest entry, the bf16 train step) hold;
// - dq pass: one block per (q tile, batch x KV head, head chunk), Q and dO
//   in shared memory once, K/V tiles of 64 keys double-buffered.  At
//   gemma-2b's (1, 1024, 8, 1, 256): 128 blocks, 211,968 bytes of shared
//   memory each, one block per SM;
// - dk/dv pass: one block per (64-key tile, batch x KV head, split), K and
//   V in shared memory once, Q/dO tiles with their lse, delta and
//   positions double-buffered.  A key tile's query tiles (for every head
//   chunk) are cut into `nsplit` ranges of whole tiles, one block each, so
//   that a narrow batch still fills the card: at gemma-2b's shape 16 key
//   tiles x 8 splits = 128 blocks (1 x 1024: the wrapper's plan), 222,720
//   bytes of shared memory each.  With nsplit > 1 each block writes its f32
//   partial dk, dv (nsplit, B, S, KV, D) and a third kernel sums the splits
//   in order and rounds to bf16 (16 MB of f32 traffic at gemma's train
//   shape, about 5 us); with nsplit = 1 the block writes dk, dv itself.
//
// The f32 tensor-core variant (f32, D a multiple of 8 up to 256, 16-byte
// aligned rows):
// - the scores S (and S^T) are the f32 forward's own, bit for bit: the FMA
//   chain over the head dim on the CUDA cores (scores_f32, tf32.cuh), so
//   p = exp(s - lse) meets the forward's lse as the CUDA-core variant's p
//   does.  Scores in the hundreds (the reference's init) make p near
//   one-hot, and a score rounded any other way leaves p off by the
//   difference: split-TF32 scores put the gradients of gemma-2b's f32
//   calls up to 17x farther from an f64 run than the CUDA-core variant's
//   (PERF.md).  Held by chip_smoke.check_flash_near_hard;
// - the other four products are split TF32 on mma.sync.m16n8k8 (tf32.cuh):
//   each f32 operand is hi + lo in TF32; dP and dP^T take all four
//   products of terms, the gradient products lo hi + hi lo + hi hi, about
//   2^-21 of |a b|.  p, dp, delta and ds stay f32 and are split like any
//   operand (rounding them to bf16 would fail the f32 checks).  Each 8-deep
//   step of dP, dP^T, each 32-key tile of dS K and each 64-row item of P^T
//   dO, dS^T Q sums from zero on the tensor cores and is added to f32
//   running sums (the tensor cores' sums truncate);
// - the bf16 variant's two passes with 32-key tiles, f32 rows at pitch
//   D + 4 and one buffer per operand, each refilled by cp.async while
//   another product runs: dq pass (Q, dO, K, V, ds): 62,464 bytes at
//   D = 64, 111,616 at 128, 209,920 at 256; dk/dv pass (K, V, Q, dO, p^T,
//   ds^T): 71,424, 120,576, 218,880.  ds and p^T, ds^T go through shared
//   memory at pitches 40 and 72 (8 mod 16);
// - warps: dq pass 4 row slices x 2 key halves for S and dP (S in the
//   accumulator layout of dP, 8 scores a lane), 4 row slices
//   x 2 column halves for dS K; dk/dv pass 2 key slices x 4 row quarters
//   for S^T and dP^T, 2 key slices x 4 column quarters for the gradients;
// - filling the card under the causal triangle: the dq pass cuts each q
//   tile's key tiles into nsplit_dq ranges (the wrapper's `_dq_splits`: 2
//   at gemma-2b's shape, where one block per q tile leaves the heaviest
//   block twice the mean), one dimension heaviest first, their f32
//   partials summed in order by flash_bwd_sum_kernel; the dk/dv pass gives
//   block i key tiles i and n - 1 - i in turn, so every block has the same
//   rows, and cuts them into the split plan's query ranges (`_dkv_splits`
//   with paired blocks: 16 pairs x 8 = 128 blocks at gemma-2b's shape).
//   No atomics: two runs give the same bits.
//
// The CUDA-core variant (f32 at a head dim off 8 or on unaligned rows, or
// a bf16 head dim the tensor-core one refuses) does its products in f32 on
// the CUDA cores, so f32 inputs keep their f32 accuracy:
// - dq pass: one block per (batch, KV head, q tile, head chunk), keeping
//   dq in f32 registers;
// - dk/dv pass: one block per (batch, KV head, 16-key tile), walking every
//   head chunk of the group, so dk and dv need no group sum outside;
// - tiles are staged in shared memory as f32 rows padded to D + 1 floats,
//   so column reads do not collide in a bank.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "tf32.cuh"

namespace repro {
namespace {

constexpr int kRows = 64;      // (position, head) rows per tile
constexpr int kThreads = 256;  // 4 per row in the score phase
constexpr int kSub = kThreads / kRows;
constexpr int kQKeys = 32;     // keys per tile of the dq pass
constexpr int kKvKeys = 16;    // keys per block of the dk/dv pass
constexpr int kKvSub = kThreads / kKvKeys;  // threads per key accumulating dk, dv

__host__ __device__ inline size_t dq_smem_floats(int D) {
  // Q and dO tiles (kRows x D+1), K and V tiles (kQKeys x D+1), dS (kRows x kQKeys+1)
  return static_cast<size_t>(2 * kRows + 2 * kQKeys) * (D + 1) +
         static_cast<size_t>(kRows) * (kQKeys + 1);
}

__host__ __device__ inline size_t dkv_smem_floats(int D) {
  // Q and dO tiles (kRows x D+1), K and V (kKvKeys x D+1), P and dS (kRows x kKvKeys+1)
  return static_cast<size_t>(2 * kRows + 2 * kKvKeys) * (D + 1) +
         2 * static_cast<size_t>(kRows) * (kKvKeys + 1);
}

// Stage rows q0 .. of (position, head) pairs of q and dO as f32: row r is
// query position q0 + r / GC, head kvh * G + g0 + r % GC; rows past S or G
// load as zero.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ q, const T* __restrict__ dout,
                                          float* sQ, float* sdO, int b, int kvh, int q0, int g0,
                                          int S, int H, int G, int D, int GC, int BQ) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int rr = i / D, e = i - rr * D;
    const int qp = q0 + rr / GC, g = g0 + rr % GC;
    float x = 0.f, y = 0.f;
    if (rr < BQ * GC && qp < S && g < G) {
      const long long off = ((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + e;
      x = to_f32(q[off]);
      y = to_f32(dout[off]);
    }
    sQ[rr * Dp + e] = x;
    sdO[rr * Dp + e] = y;
  }
}

// Stage keys k0 .. k0 + n - 1 of KV head kvh as f32; keys past S load as zero.
template <typename T>
__device__ __forceinline__ void load_keys(const T* __restrict__ k, const T* __restrict__ v,
                                          float* sK, float* sV, int b, int kvh, int k0, int n,
                                          int S, int KV, int D) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int kk = i / D, e = i - kk * D;
    const int kp = k0 + kk;
    float kx = 0.f, vx = 0.f;
    if (kp < S) {
      const long long off = ((static_cast<long long>(b) * S + kp) * KV + kvh) * D + e;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    sK[kk * Dp + e] = kx;
    sV[kk * Dp + e] = vx;
  }
}

// ------------------------------------------------------------------ dq pass

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int KV,
                    int D, int GC, int BQ, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* sQ = smem;                 // (kRows, Dp)
  float* sdO = sQ + kRows * Dp;     // (kRows, Dp)
  float* sK = sdO + kRows * Dp;     // (kQKeys, Dp)
  float* sV = sK + kQKeys * Dp;     // (kQKeys, Dp)
  float* sDS = sV + kQKeys * Dp;    // (kRows, kQKeys + 1)
  const int G = H / KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int g0 = blockIdx.z * GC;
  const int tid = threadIdx.x;
  const int r = tid / kSub, sub = tid - r * kSub;

  load_rows(q, dout, sQ, sdO, b, kvh, q0, g0, S, H, G, D, GC, BQ);
  const int qpos = q0 + r / GC, g = g0 + r % GC;
  const bool row_ok = r < BQ * GC && qpos < S && g < G;
  const long long orow = (static_cast<long long>(b) * S + qpos) * H + kvh * G + g;
  const float row_lse = row_ok ? lse[orow] : 0.f;
  const float row_delta = row_ok ? delta[orow] : 0.f;

  float acc[DMAX / kSub];
#pragma unroll
  for (int c = 0; c < DMAX / kSub; ++c) acc[c] = 0.f;

  // causal: the last key any row of this tile attends to is q0 + BQ - 1
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + kQKeys - 1) / kQKeys;
  // window: the first key any row sees is q0 - window + 1
  const int tfirst = window > 0 ? max(0, q0 - window + 1) / kQKeys : 0;
  for (int t = ntiles - 1; t >= tfirst; --t) {
    const int k0 = t * kQKeys;
    __syncthreads();  // the previous tile's reads are done (and sQ, sdO are written)
    load_keys(k, v, sK, sV, b, kvh, k0, kQKeys, S, KV, D);
    __syncthreads();

    // this thread's keys sub, sub + 4, ...: s = q k^T, dp = dO v^T
    constexpr int kPer = kQKeys / kSub;
    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = dp[j] = 0.f;
    for (int e = 0; e < D; ++e) {
      const float qe = sQ[r * Dp + e], de = sdO[r * Dp + e];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[j] += qe * sK[(sub + kSub * j) * Dp + e];
        dp[j] += de * sV[(sub + kSub * j) * Dp + e];
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int kk = sub + kSub * j, kp = k0 + kk;
      const bool ok = row_ok && kp < S && (!causal || kp <= qpos) &&
                      (window <= 0 || qpos - kp < window);
      const float p = ok ? expf(s[j] * scale - row_lse) : 0.f;
      sDS[r * (kQKeys + 1) + kk] = p * (dp[j] - row_delta) * scale;
    }
    __syncwarp();  // the row's dS is read by the same four threads

    // dq += dS k: each thread keeps a quarter of its row (D/4 values)
    for (int kk = 0; kk < kQKeys; ++kk) {
      const float ds = sDS[r * (kQKeys + 1) + kk];
      const float* krow = sK + kk * Dp + sub;
#pragma unroll
      for (int c = 0; c < DMAX / kSub; ++c)
        if (sub + kSub * c < D) acc[c] += ds * krow[kSub * c];
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int c = 0; c < DMAX / kSub; ++c) {
    const int e = sub + kSub * c;
    if (e < D) dq[orow * D + e] = from_f32<T>(acc[c]);
  }
}

// --------------------------------------------------------------- dk/dv pass

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int KV, int D, int GC, int BQ, int causal, int window,
                     float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* sQ = smem;                   // (kRows, Dp)
  float* sdO = sQ + kRows * Dp;       // (kRows, Dp)
  float* sK = sdO + kRows * Dp;       // (kKvKeys, Dp)
  float* sV = sK + kKvKeys * Dp;      // (kKvKeys, Dp)
  float* sP = sV + kKvKeys * Dp;      // (kRows, kKvKeys + 1)
  float* sDS = sP + kRows * (kKvKeys + 1);
  const int G = H / KV;
  const int k0 = blockIdx.x * kKvKeys;  // the first key tiles have the most rows: first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int tid = threadIdx.x;
  // score phase: four threads per row, keys sub, sub + 4, ...
  const int r = tid / kSub, sub = tid - r * kSub;
  // accumulate phase: kKvSub threads per key, elements a_sub, a_sub + kKvSub, ...
  const int a_key = tid / kKvSub, a_sub = tid - a_key * kKvSub;

  load_keys(k, v, sK, sV, b, kvh, k0, kKvKeys, S, KV, D);
  float dk_acc[DMAX / kKvSub], dv_acc[DMAX / kKvSub];
#pragma unroll
  for (int c = 0; c < DMAX / kKvSub; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  // causal: no query before k0 attends to this block's keys
  const int qstart = causal ? k0 : 0;
  // window: no query from k0 + kKvKeys + window - 1 on sees this block's keys
  const int qend = window > 0 ? min(S, k0 + kKvKeys + window - 1) : S;
  for (int g0 = 0; g0 < G; g0 += GC) {
    for (int q0 = qstart; q0 < qend; q0 += BQ) {
      __syncthreads();  // the previous tile's reads are done (and sK, sV are written)
      load_rows(q, dout, sQ, sdO, b, kvh, q0, g0, S, H, G, D, GC, BQ);
      __syncthreads();

      const int qpos = q0 + r / GC, g = g0 + r % GC;
      const bool row_ok = r < BQ * GC && qpos < S && g < G;
      const long long orow = (static_cast<long long>(b) * S + qpos) * H + kvh * G + g;
      const float row_lse = row_ok ? lse[orow] : 0.f;
      const float row_delta = row_ok ? delta[orow] : 0.f;
      constexpr int kPer = kKvKeys / kSub;
      float s[kPer], dp[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[j] = dp[j] = 0.f;
      for (int e = 0; e < D; ++e) {
        const float qe = sQ[r * Dp + e], de = sdO[r * Dp + e];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[j] += qe * sK[(sub + kSub * j) * Dp + e];
          dp[j] += de * sV[(sub + kSub * j) * Dp + e];
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kk = sub + kSub * j, kp = k0 + kk;
        const bool ok = row_ok && kp < S && (!causal || kp <= qpos) &&
                      (window <= 0 || qpos - kp < window);
        const float p = ok ? expf(s[j] * scale - row_lse) : 0.f;
        sP[r * (kKvKeys + 1) + kk] = p;
        sDS[r * (kKvKeys + 1) + kk] = p * (dp[j] - row_delta) * scale;
      }
      __syncthreads();  // P and dS of every row are read by every key's threads

      // dv += P^T dO, dk += dS^T q for this thread's key and elements
      for (int rr = 0; rr < kRows; ++rr) {
        const float p = sP[rr * (kKvKeys + 1) + a_key];
        const float ds = sDS[rr * (kKvKeys + 1) + a_key];
        const float* qrow = sQ + rr * Dp + a_sub;
        const float* dorow = sdO + rr * Dp + a_sub;
#pragma unroll
        for (int c = 0; c < DMAX / kKvSub; ++c) {
          if (a_sub + kKvSub * c < D) {
            dv_acc[c] += p * dorow[kKvSub * c];
            dk_acc[c] += ds * qrow[kKvSub * c];
          }
        }
      }
    }
  }

  const int kp = k0 + a_key;
  if (kp >= S) return;
  const long long krow = ((static_cast<long long>(b) * S + kp) * KV + kvh) * D;
#pragma unroll
  for (int c = 0; c < DMAX / kKvSub; ++c) {
    const int e = a_sub + kKvSub * c;
    if (e < D) {
      dk[krow + e] = from_f32<T>(dk_acc[c]);
      dv[krow + e] = from_f32<T>(dv_acc[c]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                     int S, int H, int KV, int D, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int G = H / KV;
  const int GC = G < kRows ? G : kRows;
  const int BQ = kRows / GC;
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(dout);

  const size_t dq_smem = dq_smem_floats(D) * sizeof(float);
  cudaError_t err = set_max_dynamic_smem(flash_bwd_dq_kernel<T, DMAX>, dq_smem);
  if (err != cudaSuccess) return err;
  dim3 dq_grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_bwd_dq_kernel<T, DMAX><<<dq_grid, kThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, KV, D, GC, BQ, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_smem_floats(D) * sizeof(float);
  err = set_max_dynamic_smem(flash_bwd_dkv_kernel<T, DMAX>, dkv_smem);
  if (err != cudaSuccess) return err;
  dim3 dkv_grid((S + kKvKeys - 1) / kKvKeys, B * KV);
  flash_bwd_dkv_kernel<T, DMAX><<<dkv_grid, kThreads, dkv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, D, GC,
      BQ, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   int S, int H, int KV, int D, int causal, int window, float scale,
                   cudaStream_t stream) {
  if (D <= 64)
    return launch_d<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal,
                           window, scale, stream);
  if (D <= 128)
    return launch_d<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal,
                            window, scale, stream);
  if (D <= 256)
    return launch_d<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal,
                            window, scale, stream);
  return cudaErrorInvalidValue;
}


// ------------------------------------------------------ tensor-core variant

constexpr int kTcRows = 64;  // (position, head) rows per Q tile
constexpr int kTcKeys = 64;  // keys per K/V tile
constexpr int kTcThreads = 256;
constexpr int kLdP = kTcKeys + 8;  // pitch of the bf16 p / ds tiles (64 + 16 bytes)

// Byte offsets in dynamic shared memory; every region starts on a 16-byte
// boundary, as cp.async and ldmatrix need.
struct DqLayout {
  int ld;  // pitch of the bf16 Q, dO, K, V rows: D + 8
  size_t q, dout, k, v, ds, total;
};
__host__ __device__ inline DqLayout dq_layout(int D) {
  DqLayout L;
  L.ld = D + 8;
  const size_t tile = static_cast<size_t>(kTcRows) * L.ld * 2;  // 64 rows (or keys)
  L.q = 0;
  L.dout = L.q + tile;
  L.k = L.dout + tile;  // two buffers each for K and V
  L.v = L.k + 2 * tile;
  L.ds = L.v + 2 * tile;
  L.total = L.ds + static_cast<size_t>(kTcRows) * kLdP * 2;
  return L;
}

struct DkvLayout {
  int ld;
  size_t k, v, q, dout, pt, dst, lse, delta, pos, total;
};
__host__ __device__ inline DkvLayout dkv_layout(int D) {
  DkvLayout L;
  L.ld = D + 8;
  const size_t tile = static_cast<size_t>(kTcRows) * L.ld * 2;
  L.k = 0;
  L.v = L.k + tile;
  L.q = L.v + tile;  // two buffers each for Q and dO
  L.dout = L.q + 2 * tile;
  L.pt = L.dout + 2 * tile;  // p^T and ds^T: (64 keys, 64 rows)
  L.dst = L.pt + static_cast<size_t>(kTcKeys) * kLdP * 2;
  L.lse = L.dst + static_cast<size_t>(kTcKeys) * kLdP * 2;  // two buffers of 64 f32
  L.delta = L.lse + 2 * kTcRows * 4;
  L.pos = L.delta + 2 * kTcRows * 4;  // two buffers of 64 int: query position, -1 if none
  L.total = L.pos + 2 * kTcRows * 4;
  return L;
}

// Stage rows of (position, head) pairs of q and dO: row r is query position
// q0 + r / GC, head kvh * G + g0 + r % GC; rows past S or G load as zero.
__device__ __forceinline__ void tc_load_rows(const bf16* __restrict__ q,
                                             const bf16* __restrict__ dout, bf16* sQ, bf16* sdO,
                                             int ld, int b, int kvh, int q0, int g0, int S, int H,
                                             int G, int D, int GC, int BQ) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kTcRows * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    const bool ok = r < BQ * GC && qp < S && g < G;
    const long long off =
        ok ? ((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + c * 8 : 0;
    cp_async16(sQ + r * ld + c * 8, q + off, ok);
    cp_async16(sdO + r * ld + c * 8, dout + off, ok);
  }
}

// Stage keys k0 .. k0 + 63 of KV head kvh; keys past S load as zero.
__device__ __forceinline__ void tc_load_keys(const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, bf16* sK, bf16* sV,
                                             int ld, int b, int kvh, int k0, int S, int KV,
                                             int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kTcKeys * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int kp = k0 + r;
    const bool ok = kp < S;
    const long long off = ok ? ((static_cast<long long>(b) * S + kp) * KV + kvh) * D + c * 8 : 0;
    cp_async16(sK + r * ld + c * 8, k + off, ok);
    cp_async16(sV + r * ld + c * 8, v + off, ok);
  }
}

// ------------------------------------------------------------ dq pass (TC)

// DMAX: head dims up to DMAX share one register budget: a warp keeps
// 16 rows x DMAX / 2 columns of dq (DMAX / 16 accumulator tiles).
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int S, int H, int KV, int D, int GC, int BQ,
                       int causal, int window, float scale) {
  constexpr int kNt = DMAX / 16;  // 8-column accumulator tiles a warp, at most
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const DqLayout L = dq_layout(D);
  const int ld = L.ld;
  auto* sQ = reinterpret_cast<bf16*>(tc_smem + L.q);
  auto* sdO = reinterpret_cast<bf16*>(tc_smem + L.dout);
  auto* sK = reinterpret_cast<bf16*>(tc_smem + L.k);  // 2 buffers
  auto* sV = reinterpret_cast<bf16*>(tc_smem + L.v);  // 2 buffers
  auto* sdS = reinterpret_cast<bf16*>(tc_smem + L.ds);
  const int G = H / KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int g0 = blockIdx.z * GC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row and column pair
  const int wm = warp & 3, wn = warp >> 2;
  const int tile_elems = kTcKeys * ld;
  const int half = D / 2;
  const int npairs = (half + 15) / 16;

  tc_load_rows(q, dout, sQ, sdO, ld, b, kvh, q0, g0, S, H, G, D, GC, BQ);
  const int kend = causal ? min(S, q0 + BQ) : S;  // the last key any row attends to, + 1
  const int ntk = (kend + kTcKeys - 1) / kTcKeys;
  // window: the first key any row sees is q0 - window + 1
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kTcKeys : 0;
  tc_load_keys(k, v, sK + ((ntk - 1) & 1) * tile_elems, sV + ((ntk - 1) & 1) * tile_elems, ld, b,
               kvh, (ntk - 1) * kTcKeys, S, KV, D);
  cp_async_commit();

  // this thread's two score rows: 16 wm + gq and + 8
  int row_pos[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wm + gq + 8 * h;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    const bool ok = r < BQ * GC && qp < S && g < G;
    const long long orow = (static_cast<long long>(b) * S + qp) * H + kvh * G + g;
    row_pos[h] = ok ? qp : -1;
    row_lse[h] = ok ? lse[orow] : 0.f;
    row_delta[h] = ok ? delta[orow] : 0.f;
  }

  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = ntk - 1; t >= t_first; --t) {  // from the diagonal back to the first key seen
    if (t > t_first)
      tc_load_keys(k, v, sK + ((t - 1) & 1) * tile_elems, sV + ((t - 1) & 1) * tile_elems, ld, b,
                   kvh, (t - 1) * kTcKeys, S, KV, D);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // tile t (and Q, dO) landed for every thread
    const bf16* cK = sK + (t & 1) * tile_elems;
    const bf16* cV = sV + (t & 1) * tile_elems;
    const int k0 = t * kTcKeys;

    // S = Q K^T and dP = dO V^T: rows 16 wm .., keys 32 wn ..
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      unsigned aq[4], ado[4];
      load_a(aq, sQ, ld, 16 * wm, kk, lane);
      load_a(ado, sdO, ld, 16 * wm, kk, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned bk[4], bv[4];
        load_b_nmajor(bk, cK, ld, 32 * wn + 16 * jj, kk, lane);
        load_b_nmajor(bv, cV, ld, 32 * wn + 16 * jj, kk, lane);
        mma16816(s[2 * jj], aq, bk[0], bk[1]);
        mma16816(s[2 * jj + 1], aq, bk[2], bk[3]);
        mma16816(dp[2 * jj], ado, bv[0], bv[1]);
        mma16816(dp[2 * jj + 1], ado, bv[2], bv[3]);
      }
    }
    // ds = p (dp - delta) scale in f32, rounded once to bf16 into sdS
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 32 * wn + 8 * j + 2 * tq + e;
          const int qp = row_pos[h];
          const bool ok = qp >= 0 && kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          const float p = ok ? expf(s[j][2 * h + e] * scale - row_lse[h]) : 0.f;
          ds[e] = p * (dp[j][2 * h + e] - row_delta[h]) * scale;
        }
        *reinterpret_cast<unsigned*>(sdS + (16 * wm + gq + 8 * h) * kLdP + 32 * wn + 8 * j +
                                     2 * tq) = pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();  // every warp's ds is written

    // dq += dS K: rows 16 wm .., columns half * wn ..
#pragma unroll
    for (int kk = 0; kk < kTcKeys; kk += 16) {
      unsigned a[4];
      load_a(a, sdS, kLdP, 16 * wm, kk, lane);
#pragma unroll
      for (int jj = 0; jj < kNt / 2; ++jj) {
        if (jj < npairs) {
          unsigned bk[4];
          load_b_kmajor(bk, cK, ld, half * wn + 16 * jj, kk, lane);
          mma16816(acc[2 * jj], a, bk[0], bk[1]);
          mma16816(acc[2 * jj + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this K/V buffer and sdS are free for the next tile
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wm + gq + 8 * h;
    if (row_pos[h] < 0) continue;
    const int g = g0 + r % GC;
    const long long orow = (static_cast<long long>(b) * S + row_pos[h]) * H + kvh * G + g;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int col = 8 * j + 2 * tq;  // within this warp's half
      if (col < half)
        *reinterpret_cast<unsigned*>(dq + orow * D + half * wn + col) =
            pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// --------------------------------------------------------- dk/dv pass (TC)

template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ part_dk, float* __restrict__ part_dv, int B, int S,
                        int H, int KV, int D, int GC, int BQ, int causal, int window,
                        float scale) {
  constexpr int kNt = DMAX / 16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const DkvLayout L = dkv_layout(D);
  const int ld = L.ld;
  auto* sK = reinterpret_cast<bf16*>(tc_smem + L.k);
  auto* sV = reinterpret_cast<bf16*>(tc_smem + L.v);
  auto* sQ = reinterpret_cast<bf16*>(tc_smem + L.q);      // 2 buffers
  auto* sdO = reinterpret_cast<bf16*>(tc_smem + L.dout);  // 2 buffers
  auto* sPt = reinterpret_cast<bf16*>(tc_smem + L.pt);    // (64 keys, 64 rows)
  auto* sdSt = reinterpret_cast<bf16*>(tc_smem + L.dst);
  auto* sLse = reinterpret_cast<float*>(tc_smem + L.lse);      // 2 x 64
  auto* sDelta = reinterpret_cast<float*>(tc_smem + L.delta);  // 2 x 64
  auto* sPos = reinterpret_cast<int*>(tc_smem + L.pos);        // 2 x 64
  const int G = H / KV;
  const int k0 = blockIdx.x * kTcKeys;  // the first key tiles have the most rows: first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int tile_elems = kTcRows * ld;
  const int half = D / 2;
  const int npairs = (half + 15) / 16;

  // this key tile's work: for each head chunk, the query tiles from the
  // diagonal on (all of them when not causal), up to the last query that
  // sees a key of the tile (k0 + 64 + window - 2 with a window); split
  // `split` takes the items [lo, hi) of that list, in order
  const int nch = (G + GC - 1) / GC;
  const int qt_first = causal ? k0 / BQ : 0;
  const int q_end = window > 0 ? min(S, k0 + kTcKeys + window - 1) : S;
  const int per = (q_end + BQ - 1) / BQ - qt_first;
  const long long total = static_cast<long long>(nch) * per;
  const int lo = static_cast<int>(total * split / nsplit);
  const int hi = static_cast<int>(total * (split + 1) / nsplit);

  auto load_item = [&](int item, int buf) {
    const int ch = item / per, qt = qt_first + item - ch * per;
    const int q0 = qt * BQ, g0 = ch * GC;
    tc_load_rows(q, dout, sQ + buf * tile_elems, sdO + buf * tile_elems, ld, b, kvh, q0, g0, S,
                 H, G, D, GC, BQ);
    for (int r = threadIdx.x; r < kTcRows; r += kTcThreads) {
      const int qp = q0 + r / GC, g = g0 + r % GC;
      const bool ok = r < BQ * GC && qp < S && g < G;
      const long long orow = ok ? (static_cast<long long>(b) * S + qp) * H + kvh * G + g : 0;
      cp_async4(sLse + buf * kTcRows + r, lse + orow, ok);
      cp_async4(sDelta + buf * kTcRows + r, delta + orow, ok);
      sPos[buf * kTcRows + r] = ok ? qp : -1;
    }
  };

  tc_load_keys(k, v, sK, sV, ld, b, kvh, k0, S, KV, D);
  if (lo < hi) load_item(lo, 0);
  cp_async_commit();

  float acc_dk[kNt][4], acc_dv[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  for (int item = lo; item < hi; ++item) {
    const int buf = (item - lo) & 1;
    if (item + 1 < hi) load_item(item + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this item's rows (and K, V) landed for every thread
    const bf16* cQ = sQ + buf * tile_elems;
    const bf16* cdO = sdO + buf * tile_elems;
    const float* cLse = sLse + buf * kTcRows;
    const float* cDelta = sDelta + buf * kTcRows;
    const int* cPos = sPos + buf * kTcRows;

    // S^T = K Q^T and dP^T = V dO^T: keys 16 wm .., rows 32 wn ..
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      unsigned ak[4], av[4];
      load_a(ak, sK, ld, 16 * wm, kk, lane);
      load_a(av, sV, ld, 16 * wm, kk, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned bq[4], bdo[4];
        load_b_nmajor(bq, cQ, ld, 32 * wn + 16 * jj, kk, lane);
        load_b_nmajor(bdo, cdO, ld, 32 * wn + 16 * jj, kk, lane);
        mma16816(st[2 * jj], ak, bq[0], bq[1]);
        mma16816(st[2 * jj + 1], ak, bq[2], bq[3]);
        mma16816(dpt[2 * jj], av, bdo[0], bdo[1]);
        mma16816(dpt[2 * jj + 1], av, bdo[2], bdo[3]);
      }
    }
    // p^T and ds^T in f32, rounded once to bf16 into sPt, sdSt
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = 16 * wm + gq + 8 * h;  // key within the tile
        const int kp = k0 + kl;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 32 * wn + 8 * j + 2 * tq + e;
          const int qp = cPos[r];
          const bool ok = qp >= 0 && kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          p[e] = ok ? expf(st[j][2 * h + e] * scale - cLse[r]) : 0.f;
          ds[e] = p[e] * (dpt[j][2 * h + e] - cDelta[r]) * scale;
        }
        const int off = kl * kLdP + 32 * wn + 8 * j + 2 * tq;
        *reinterpret_cast<unsigned*>(sPt + off) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<unsigned*>(sdSt + off) = pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();  // every warp's p^T, ds^T are written

    // dv += P^T dO, dk += dS^T Q: keys 16 wm .., columns half * wn ..
#pragma unroll
    for (int kk = 0; kk < kTcRows; kk += 16) {
      unsigned ap[4], ads[4];
      load_a(ap, sPt, kLdP, 16 * wm, kk, lane);
      load_a(ads, sdSt, kLdP, 16 * wm, kk, lane);
#pragma unroll
      for (int jj = 0; jj < kNt / 2; ++jj) {
        if (jj < npairs) {
          unsigned bdo[4], bq[4];
          load_b_kmajor(bdo, cdO, ld, half * wn + 16 * jj, kk, lane);
          load_b_kmajor(bq, cQ, ld, half * wn + 16 * jj, kk, lane);
          mma16816(acc_dv[2 * jj], ap, bdo[0], bdo[1]);
          mma16816(acc_dv[2 * jj + 1], ap, bdo[2], bdo[3]);
          mma16816(acc_dk[2 * jj], ads, bq[0], bq[1]);
          mma16816(acc_dk[2 * jj + 1], ads, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this item's buffers and sPt, sdSt are free
  }
  cp_async_wait_all();

  // dk, dv of keys 16 wm + gq (+ 8): bf16 when this block holds every
  // query of its keys, else this split's f32 partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + 16 * wm + gq + 8 * h;
    if (kp >= S) continue;
    const long long krow = (static_cast<long long>(b) * S + kp) * KV + kvh;
    const long long prow = static_cast<long long>(split) * B * S * KV + krow;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col >= half) continue;
      const int e = half * wn + col;
      if (nsplit == 1) {
        *reinterpret_cast<unsigned*>(dk + krow * D + e) =
            pack_bf16(acc_dk[j][2 * h], acc_dk[j][2 * h + 1]);
        *reinterpret_cast<unsigned*>(dv + krow * D + e) =
            pack_bf16(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(part_dk + prow * D + e) =
            make_float2(acc_dk[j][2 * h], acc_dk[j][2 * h + 1]);
        *reinterpret_cast<float2*>(part_dv + prow * D + e) =
            make_float2(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
      }
    }
  }
}

// Four sums of the splits, stored as bf16 (rounded) or f32.
__device__ __forceinline__ void store4(bf16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// dk, dv = the sum over the nsplit partials (nsplit, n) f32, in order, in
// T; four elements a thread and step.  Without part_dv only dk (the f32
// dq pass's partials of dq).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                     T* __restrict__ dk, T* __restrict__ dv, long long n, int nsplit) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < n;
       i += step) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int s = 0; s < nsplit; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part_dk + s * n + i);
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      if (part_dv != nullptr) {
        const float4 y = *reinterpret_cast<const float4*>(part_dv + s * n + i);
        c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
      }
    }
    store4(dk + i, a);
    if (part_dv != nullptr) store4(dv + i, c);
  }
}

template <typename T>
cudaError_t launch_sum(const float* part_dk, const float* part_dv, void* dk, void* dv,
                       long long n, int nsplit, cudaStream_t stream) {
  const long long blocks = (n / 4 + 255) / 256;
  flash_bwd_sum_kernel<T><<<static_cast<int>(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      part_dk, part_dv, static_cast<T*>(dk), static_cast<T*>(dv), n, nsplit);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        float* part, int nsplit, int B, int S, int H, int KV, int D, int causal,
                        int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int GC = G < kTcRows ? G : kTcRows;
  const int BQ = kTcRows / GC;
  const auto* tq = static_cast<const bf16*>(q);
  const auto* tk = static_cast<const bf16*>(k);
  const auto* tv = static_cast<const bf16*>(v);
  const auto* tdo = static_cast<const bf16*>(dout);

  const size_t dq_smem = dq_layout(D).total;
  cudaError_t err = set_max_dynamic_smem(flash_bwd_dq_tc_kernel<DMAX>, dq_smem);
  if (err != cudaSuccess) return err;
  dim3 dq_grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_bwd_dq_tc_kernel<DMAX><<<dq_grid, kTcThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), S, H, KV, D, GC, BQ, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_layout(D).total;
  err = set_max_dynamic_smem(flash_bwd_dkv_tc_kernel<DMAX>, dkv_smem);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * S * KV * D;
  float* part_dk = nsplit > 1 ? part : nullptr;
  float* part_dv = nsplit > 1 ? part + nsplit * n : nullptr;
  dim3 dkv_grid((S + kTcKeys - 1) / kTcKeys, B * KV, nsplit);
  flash_bwd_dkv_tc_kernel<DMAX><<<dkv_grid, kTcThreads, dkv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part_dk,
      part_dv, B, S, H, KV, D, GC, BQ, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_sum<bf16>(part_dk, part_dv, dk, dv, n, nsplit, stream);
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv,
                      float* part, int nsplit, int B, int S, int H, int KV, int D, int causal,
                      int window, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_tc_d<64>(q, k, v, dout, lse, delta, dq, dk, dv, part, nsplit, B, S, H, KV, D,
                           causal, window, scale, stream);
  if (D <= 128)
    return launch_tc_d<128>(q, k, v, dout, lse, delta, dq, dk, dv, part, nsplit, B, S, H, KV, D,
                            causal, window, scale, stream);
  return launch_tc_d<256>(q, k, v, dout, lse, delta, dq, dk, dv, part, nsplit, B, S, H, KV, D,
                          causal, window, scale, stream);
}


// --------------------------------------------------- f32 tensor-core variant

constexpr int kF32Keys = 32;         // keys per K/V tile of both f32 passes
constexpr int kLdDs = kF32Keys + 8;  // pitch of the dq pass's f32 ds tile (8 mod 16)
constexpr int kLdPt = kTcRows + 8;   // pitch of the dk/dv pass's f32 p^T, ds^T tiles

// Byte offsets in dynamic shared memory, one buffer per operand; every
// region starts on a 16-byte boundary.  The operand rows (pitch D + 4,
// tf32.cuh) come first: the reads of a last, half-filled pair of 8-column
// tiles (D an odd multiple of 8) run up to 16 bytes into the next region,
// in columns that are never stored.
struct DqF32Layout {
  int ld;
  size_t q, dout, k, v, ds, total;
};
__host__ __device__ inline DqF32Layout dq_f32_layout(int D) {
  DqF32Layout L;
  L.ld = D + 4;
  const size_t row = static_cast<size_t>(L.ld) * 4;
  L.q = 0;
  L.dout = L.q + kTcRows * row;
  L.k = L.dout + kTcRows * row;
  L.v = L.k + kF32Keys * row;
  L.ds = L.v + kF32Keys * row;
  L.total = L.ds + static_cast<size_t>(kTcRows) * kLdDs * 4;
  return L;
}

struct DkvF32Layout {
  int ld;
  size_t k, v, q, dout, pt, dst, lse, delta, pos, total;
};
__host__ __device__ inline DkvF32Layout dkv_f32_layout(int D) {
  DkvF32Layout L;
  L.ld = D + 4;
  const size_t row = static_cast<size_t>(L.ld) * 4;
  L.k = 0;
  L.v = L.k + kF32Keys * row;
  L.q = L.v + kF32Keys * row;
  L.dout = L.q + kTcRows * row;
  L.pt = L.dout + kTcRows * row;  // p^T and ds^T: (32 keys, 64 rows)
  L.dst = L.pt + static_cast<size_t>(kF32Keys) * kLdPt * 4;
  L.lse = L.dst + static_cast<size_t>(kF32Keys) * kLdPt * 4;  // 64 f32
  L.delta = L.lse + kTcRows * 4;
  L.pos = L.delta + kTcRows * 4;  // 64 int: query position, -1 if none
  L.total = L.pos + kTcRows * 4;
  return L;
}

// Rows of (position, head) pairs of one f32 (B, S, H, D) tensor: row r is
// query position q0 + r / GC, head kvh * G + g0 + r % GC; rows past S or G
// load as zero.
__device__ __forceinline__ void f32_stage_rows(const float* __restrict__ src, float* dst, int ld,
                                               int b, int kvh, int q0, int g0, int S, int H,
                                               int G, int D, int GC, int BQ) {
  const int chunks = D / 4;
  for (int i = threadIdx.x; i < kTcRows * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    const bool ok = r < BQ * GC && qp < S && g < G;
    const long long off =
        ok ? ((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + c * 4 : 0;
    cp_async16(dst + r * ld + c * 4, src + off, ok);
  }
}

// Keys k0 .. k0 + 31 of KV head kvh of one f32 (B, S, KV, D) tensor; keys
// past S load as zero.
__device__ __forceinline__ void f32_stage_keys(const float* __restrict__ src, float* dst, int ld,
                                               int b, int kvh, int k0, int S, int KV, int D) {
  const int chunks = D / 4;
  for (int i = threadIdx.x; i < kF32Keys * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int kp = k0 + r;
    const bool ok = kp < S;
    const long long off = ok ? ((static_cast<long long>(b) * S + kp) * KV + kvh) * D + c * 4 : 0;
    cp_async16(dst + r * ld + c * 4, src + off, ok);
  }
}

// acc += A B for rows m0 .. m0 + 15 of A and the pairs p0 .. p0 + np - 1
// of 8-column tiles of B (np <= NP), over KSTEPS steps of 8: A in the
// paired k order from `a` (pitch 8 mod 16: ds, p^T, ds^T), B k-major from
// `bk` (pitch 4 mod 8: K, dO, Q).  One run: the steps sum from zero on the
// tensor cores, then add to acc in f32.
template <int NP, int KSTEPS>
__device__ __forceinline__ void grad_tf32(float (&acc)[2 * NP][4], const float* a, int lda,
                                          const float* bk, int ld, int m0, int p0, int np,
                                          int lane) {
  float c[2 * NP][4];
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    float x[4];
    unsigned at[kTerms][4];
    lda_f32_paired(x, a, lda, m0, 8 * ks, lane);
    split_tf32<kTerms, 4>(x, at);
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) {
      if (jj < np) {
        float y[2][2];
        unsigned bt[2][kTerms][2];
        ldb_f32_kmajor_pair(y, bk, ld, 16 * (p0 + jj), 8 * ks, lane);
        split_tf32<kTerms, 2>(y[0], bt[0]);
        split_tf32<kTerms, 2>(y[1], bt[1]);
        mma_split<kTerms, kTerms, kOrder>(c[2 * jj], at, bt[0]);
        mma_split<kTerms, kTerms, kOrder>(c[2 * jj + 1], at, bt[1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += c[i][e];
}

// ------------------------------------------------------------ dq pass (f32)

// DMAX: head dims up to DMAX (multiples of 8) share one register budget:
// a warp keeps 16 rows x DMAX / 2 columns of dq (DMAX / 32 pairs of tiles).
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, float* __restrict__ part_dq, int B, int S,
                        int H, int KV, int D, int GC, int BQ, int nsq, int causal, int window,
                        float scale) {
  constexpr int kNp = DMAX / 32;
  extern __shared__ __align__(128) unsigned char f32_smem[];
  const DqF32Layout L = dq_f32_layout(D);
  const int ld = L.ld;
  auto* sQ = reinterpret_cast<float*>(f32_smem + L.q);
  auto* sdO = reinterpret_cast<float*>(f32_smem + L.dout);
  auto* sK = reinterpret_cast<float*>(f32_smem + L.k);
  auto* sV = reinterpret_cast<float*>(f32_smem + L.v);
  auto* sdS = reinterpret_cast<float*>(f32_smem + L.ds);
  const int G = H / KV;
  // one dimension, heaviest q tile first over every (key range, batch x KV
  // head, head chunk)
  const int ntq = (S + BQ - 1) / BQ;
  const int nbk = gridDim.x / ntq;  // blocks that share a q tile
  const int q0 = (ntq - 1 - static_cast<int>(blockIdx.x) / nbk) * BQ;
  const int rest = static_cast<int>(blockIdx.x) % nbk;
  const int sq = rest % nsq, bkv = rest / nsq % (B * KV);
  const int g0 = rest / nsq / (B * KV) * GC;
  const int b = bkv / KV, kvh = bkv - b * KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm ..; keys 16 wn .. / column half wn
  const int npair = (D / 8 + 1) / 2;        // pairs of 8-column tiles of a row
  const int hp = (npair + 1) / 2;
  const int p0 = hp * wn, np = min(hp, npair - p0);  // this warp's pairs

  f32_stage_rows(q, sQ, ld, b, kvh, q0, g0, S, H, G, D, GC, BQ);
  f32_stage_rows(dout, sdO, ld, b, kvh, q0, g0, S, H, G, D, GC, BQ);
  const int kend = causal ? min(S, q0 + BQ) : S;  // the last key any row attends to, + 1
  const int ntk = (kend + kF32Keys - 1) / kF32Keys;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kF32Keys : 0;
  // this block's key range sq of nsq: tiles [t_lo, t_hi) of the q tile's
  const int t_lo = t_first + (ntk - t_first) * sq / nsq;
  const int t_hi = t_first + (ntk - t_first) * (sq + 1) / nsq;
  // one buffer each: V(t - 1) lands while S and dq of tile t are
  // computed, K(t - 1) while dP of tile t - 1 is
  if (t_hi > t_lo) f32_stage_keys(v, sV, ld, b, kvh, (t_hi - 1) * kF32Keys, S, KV, D);
  cp_async_commit();  // Q, dO and the last V tile
  if (t_hi > t_lo) f32_stage_keys(k, sK, ld, b, kvh, (t_hi - 1) * kF32Keys, S, KV, D);
  cp_async_commit();

  int row_pos[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wm + gq + 8 * h;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    const bool ok = r < BQ * GC && qp < S && g < G;
    const long long orow = (static_cast<long long>(b) * S + qp) * H + kvh * G + g;
    row_pos[h] = ok ? qp : -1;
    row_lse[h] = ok ? lse[orow] : 0.f;
    row_delta[h] = ok ? delta[orow] : 0.f;
  }

  float acc[2 * kNp][4];
#pragma unroll
  for (int j = 0; j < 2 * kNp; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = t_hi - 1; t >= t_lo; --t) {  // from the diagonal back to the first key seen
    const int k0 = t * kF32Keys;
    cp_async_wait_one();
    __syncthreads();  // V(t) (and Q, dO) landed for every thread
    // dP = dO V^T, S = Q K^T: rows 16 wm .., keys 16 wn .. (two 8-key tiles)
    float dp[2][4], s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] = 0.f;
    scores_tf32(dp, sdO, sV + 16 * wn * ld, ld, 16 * wm, D, lane);
    __syncthreads();  // every warp is done with V(t)
    if (t > t_lo) f32_stage_keys(v, sV, ld, b, kvh, k0 - kF32Keys, S, KV, D);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // K(t) landed for every thread
    scores_f32(s, sQ, sK + 16 * wn * ld, ld, 16 * wm, D, lane);  // the forward's bits
    // ds = p (dp - delta) scale in f32 into sdS
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 16 * wn + 8 * j + 2 * tq + e;
          const int qp = row_pos[h];
          const bool ok = qp >= 0 && kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          const float p = ok ? expf(s[j][2 * h + e] * scale - row_lse[h]) : 0.f;
          ds[e] = p * (dp[j][2 * h + e] - row_delta[h]) * scale;
        }
        *reinterpret_cast<float2*>(sdS + (16 * wm + gq + 8 * h) * kLdDs + 16 * wn + 8 * j +
                                   2 * tq) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // every warp's ds is written
    // dq += dS K: rows 16 wm .., this warp's pairs of column tiles
    grad_tf32<kNp, kF32Keys / 8>(acc, sdS, kLdDs, sK, ld, 16 * wm, p0, np, lane);
    __syncthreads();  // every warp is done with K(t) and sdS
    if (t > t_lo) f32_stage_keys(k, sK, ld, b, kvh, k0 - kF32Keys, S, KV, D);
    cp_async_commit();
  }
  cp_async_wait_all();

  // dq of this warp's rows and columns, or this key range's f32 partial
  // (zero for an empty range) when nsq > 1
  float* to = nsq == 1 ? dq : part_dq + static_cast<long long>(sq) * B * S * H * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wm + gq + 8 * h;
    if (row_pos[h] < 0) continue;
    const int g = g0 + r % GC;
    const long long orow = (static_cast<long long>(b) * S + row_pos[h]) * H + kvh * G + g;
#pragma unroll
    for (int jj = 0; jj < kNp; ++jj) {
      const int col = 16 * (p0 + jj) + 4 * tq;
      if (jj < np && col < D)
        *reinterpret_cast<float4*>(to + orow * D + col) =
            c_pair_row(acc[2 * jj], acc[2 * jj + 1], h);
    }
  }
}

// -------------------------------------------------------- dk/dv pass (f32)

// DMAX: a warp keeps 16 keys x DMAX / 4 columns of dk and of dv (DMAX / 64
// pairs of tiles each).  Block x takes key tiles x and ntiles - 1 - x in
// turn (one when they meet), so that under causal masking every block has
// the same rows to walk: the first key tiles have the most.
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ part_dk, float* __restrict__ part_dv, int B, int S,
                         int H, int KV, int D, int GC, int BQ, int causal, int window,
                         float scale) {
  constexpr int kNp = DMAX / 64;
  extern __shared__ __align__(128) unsigned char f32_smem[];
  const DkvF32Layout L = dkv_f32_layout(D);
  const int ld = L.ld;
  auto* sK = reinterpret_cast<float*>(f32_smem + L.k);
  auto* sV = reinterpret_cast<float*>(f32_smem + L.v);
  auto* sQ = reinterpret_cast<float*>(f32_smem + L.q);
  auto* sdO = reinterpret_cast<float*>(f32_smem + L.dout);
  auto* sPt = reinterpret_cast<float*>(f32_smem + L.pt);    // (32 keys, 64 rows)
  auto* sdSt = reinterpret_cast<float*>(f32_smem + L.dst);
  auto* sLse = reinterpret_cast<float*>(f32_smem + L.lse);
  auto* sDelta = reinterpret_cast<float*>(f32_smem + L.delta);
  auto* sPos = reinterpret_cast<int*>(f32_smem + L.pos);
  const int G = H / KV;
  const int ntiles = (S + kF32Keys - 1) / kF32Keys;
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wk = warp & 1, wr = warp >> 1;  // keys 16 wk ..; rows 16 wr .. / column quarter wr
  const int npair = (D / 8 + 1) / 2;
  const int qp4 = (npair + 3) / 4;
  const int p0 = qp4 * wr, np = min(qp4, npair - p0);  // this warp's pairs
  const int nch = (G + GC - 1) / GC;

  for (int turn = 0; turn < 2; ++turn) {
    const int kt = turn == 0 ? static_cast<int>(blockIdx.x) : ntiles - 1 - blockIdx.x;
    if (turn == 1 && kt == static_cast<int>(blockIdx.x)) break;
    const int k0 = kt * kF32Keys;
    // this key tile's work, cut into splits as the bf16 variant's
    const int qt_first = causal ? k0 / BQ : 0;
    const int q_end = window > 0 ? min(S, k0 + kF32Keys + window - 1) : S;
    const int per = (q_end + BQ - 1) / BQ - qt_first;
    const long long total = static_cast<long long>(nch) * per;
    const int lo = static_cast<int>(total * split / nsplit);
    const int hi = static_cast<int>(total * (split + 1) / nsplit);

    auto item_rows = [&](int item, int& q0, int& g0) {
      const int ch = item / per;
      q0 = (qt_first + item - ch * per) * BQ;
      g0 = ch * GC;
    };
    auto load_dout = [&](int item) {  // dO rows with their lse, delta and positions
      int q0, g0;
      item_rows(item, q0, g0);
      f32_stage_rows(dout, sdO, ld, b, kvh, q0, g0, S, H, G, D, GC, BQ);
      for (int r = threadIdx.x; r < kTcRows; r += kTcThreads) {
        const int qp = q0 + r / GC, g = g0 + r % GC;
        const bool ok = r < BQ * GC && qp < S && g < G;
        const long long orow = ok ? (static_cast<long long>(b) * S + qp) * H + kvh * G + g : 0;
        cp_async4(sLse + r, lse + orow, ok);
        cp_async4(sDelta + r, delta + orow, ok);
        sPos[r] = ok ? qp : -1;
      }
    };
    auto load_q = [&](int item) {
      int q0, g0;
      item_rows(item, q0, g0);
      f32_stage_rows(q, sQ, ld, b, kvh, q0, g0, S, H, G, D, GC, BQ);
    };

    // one buffer each: dO of item i + 1 lands while dk of item i is
    // computed, Q of item i + 1 while dP^T of item i + 1 is
    __syncthreads();  // the first turn's reads of every buffer are done
    f32_stage_keys(k, sK, ld, b, kvh, k0, S, KV, D);
    f32_stage_keys(v, sV, ld, b, kvh, k0, S, KV, D);
    if (lo < hi) load_dout(lo);
    cp_async_commit();  // K, V and the first item's dO
    if (lo < hi) load_q(lo);
    cp_async_commit();

    float acc_dk[2 * kNp][4], acc_dv[2 * kNp][4];
#pragma unroll
    for (int j = 0; j < 2 * kNp; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

    for (int item = lo; item < hi; ++item) {
      cp_async_wait_one();
      __syncthreads();  // this item's dO, lse, delta, positions (and K, V) landed
      // dP^T = V dO^T, S^T = K Q^T: keys 16 wk .., rows 16 wr .. (two 8-row tiles)
      float dpt[2][4], st[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = st[j][e] = 0.f;
      scores_tf32<2, true>(dpt, sV, sdO + 16 * wr * ld, ld, 16 * wk, D, lane);
      cp_async_wait_all();
      __syncthreads();  // this item's Q landed for every thread
      scores_f32(st, sK, sQ + 16 * wr * ld, ld, 16 * wk, D, lane);  // the forward's bits
      // p^T and ds^T in f32 into sPt, sdSt
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kl = 16 * wk + gq + 8 * h;  // key within the tile
          const int kp = k0 + kl;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 16 * wr + 8 * j + 2 * tq + e;
            const int qp = sPos[r];
            const bool ok = qp >= 0 && kp < S && (!causal || kp <= qp) &&
                            (window <= 0 || qp - kp < window);
            p[e] = ok ? expf(st[j][2 * h + e] * scale - sLse[r]) : 0.f;
            ds[e] = p[e] * (dpt[j][2 * h + e] - sDelta[r]) * scale;
          }
          const int off = kl * kLdPt + 16 * wr + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(sPt + off) = make_float2(p[0], p[1]);
          *reinterpret_cast<float2*>(sdSt + off) = make_float2(ds[0], ds[1]);
        }
      }
      __syncthreads();  // every warp's p^T, ds^T are written
      // dv += P^T dO, then dk += dS^T Q: keys 16 wk .., this warp's pairs of
      // column tiles, over the item's 64 rows
      grad_tf32<kNp, kTcRows / 8>(acc_dv, sPt, kLdPt, sdO, ld, 16 * wk, p0, np, lane);
      __syncthreads();  // every warp is done with dO and the positions
      if (item + 1 < hi) load_dout(item + 1);
      cp_async_commit();  // possibly empty: keeps the group count regular
      grad_tf32<kNp, kTcRows / 8>(acc_dk, sdSt, kLdPt, sQ, ld, 16 * wk, p0, np, lane);
      __syncthreads();  // every warp is done with Q, p^T and ds^T
      if (item + 1 < hi) load_q(item + 1);
      cp_async_commit();
    }
    cp_async_wait_all();

    // dk, dv of keys 16 wk + gq (+ 8): f32 when this block holds every
    // query of its keys, else this split's partial (zero for an empty one)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = k0 + 16 * wk + gq + 8 * h;
      if (kp >= S) continue;
      const long long krow = (static_cast<long long>(b) * S + kp) * KV + kvh;
      const long long prow = static_cast<long long>(split) * B * S * KV + krow;
#pragma unroll
      for (int jj = 0; jj < kNp; ++jj) {
        const int col = 16 * (p0 + jj) + 4 * tq;
        if (jj >= np || col >= D) continue;
        const float4 xk = c_pair_row(acc_dk[2 * jj], acc_dk[2 * jj + 1], h);
        const float4 xv = c_pair_row(acc_dv[2 * jj], acc_dv[2 * jj + 1], h);
        float* to_k = nsplit == 1 ? dk + krow * D : part_dk + prow * D;
        float* to_v = nsplit == 1 ? dv + krow * D : part_dv + prow * D;
        *reinterpret_cast<float4*>(to_k + col) = xk;
        *reinterpret_cast<float4*>(to_v + col) = xv;
      }
    }
  }
}

template <int DMAX>
cudaError_t launch_f32_d(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, void* dk, void* dv,
                         float* part, int nsplit, float* part_dq, int nsq, int B, int S, int H,
                         int KV, int D, int causal, int window, float scale,
                         cudaStream_t stream) {
  const int G = H / KV;
  const int GC = G < kTcRows ? G : kTcRows;
  const int BQ = kTcRows / GC;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fdo = static_cast<const float*>(dout);

  const size_t dq_smem = dq_f32_layout(D).total;
  cudaError_t err = set_max_dynamic_smem(flash_bwd_dq_f32_kernel<DMAX>, dq_smem);
  if (err != cudaSuccess) return err;
  // one dimension: the kernel orders its blocks heaviest q tile first
  const long long dq_blocks =
      static_cast<long long>((S + BQ - 1) / BQ) * nsq * B * KV * ((G + GC - 1) / GC);
  if (dq_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto dq_grid = static_cast<unsigned>(dq_blocks);
  flash_bwd_dq_f32_kernel<DMAX><<<dq_grid, kTcThreads, dq_smem, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dq), part_dq, B, S, H, KV, D, GC, BQ,
      nsq, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nsq > 1) {
    err = launch_sum<float>(part_dq, nullptr, dq, nullptr,
                            static_cast<long long>(B) * S * H * D, nsq, stream);
    if (err != cudaSuccess) return err;
  }

  const size_t dkv_smem = dkv_f32_layout(D).total;
  err = set_max_dynamic_smem(flash_bwd_dkv_f32_kernel<DMAX>, dkv_smem);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * S * KV * D;
  float* part_dk = nsplit > 1 ? part : nullptr;
  float* part_dv = nsplit > 1 ? part + nsplit * n : nullptr;
  // one block per pair of key tiles (i, ntiles - 1 - i)
  dim3 dkv_grid(((S + kF32Keys - 1) / kF32Keys + 1) / 2, B * KV, nsplit);
  flash_bwd_dkv_f32_kernel<DMAX><<<dkv_grid, kTcThreads, dkv_smem, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), part_dk,
      part_dv, B, S, H, KV, D, GC, BQ, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_sum<float>(part_dk, part_dv, dk, dv, n, nsplit, stream);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       float* part, int nsplit, float* part_dq, int nsq, int B, int S, int H,
                       int KV, int D, int causal, int window, float scale,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch_f32_d<64>(q, k, v, dout, lse, delta, dq, dk, dv, part, nsplit, part_dq, nsq,
                            B, S, H, KV, D, causal, window, scale, stream);
  if (D <= 128)
    return launch_f32_d<128>(q, k, v, dout, lse, delta, dq, dk, dv, part, nsplit, part_dq, nsq,
                             B, S, H, KV, D, causal, window, scale, stream);
  return launch_f32_d<256>(q, k, v, dout, lse, delta, dq, dk, dv, part, nsplit, part_dq, nsq, B,
                           S, H, KV, D, causal, window, scale, stream);
}

}  // namespace
}  // namespace repro

// Keys a tile of the bf16 tensor-core dk/dv pass holds (the wrapper's split
// plan counts its blocks from it), and of the f32 one.
extern "C" int repro_flash_attention_bwd_key_tile() { return repro::kTcKeys; }
extern "C" int repro_flash_attention_bwd_f32_key_tile() { return repro::kF32Keys; }

// q, out's gradient dout and dq (B, S, H, D), k, v, dk, dv (B, S, KV, D), all
// in `dtype`; lse and delta (B, S, H) f32; window 0 for global attention,
// else the local window (query i sees keys j with i - window < j), as in the
// forward.  Head dims up to 256 (the forward's limit).  Rows the
// tensor-core variants take (repro_flash_attention_route) go to them, with
// the dk/dv pass cut into `nsplit` query ranges; nsplit > 1 needs `part`,
// f32 scratch of 2 * nsplit * B * S * KV * D.  The f32 one also cuts its dq
// pass into `nsplit_dq` key ranges; nsplit_dq > 1 needs `part_dq`, f32
// scratch of nsplit_dq * B * S * H * D (the other variants take 1 and
// null).  The rest go to the CUDA-core
// variant (nsplit and part unused), whose dq pass takes 205,824 bytes of
// shared memory at D = 256 and its dk/dv pass 173,184.  A failed launch is
// returned, never retried on another variant.  Launches the dq pass, then
// the dk/dv pass (then the sum of the splits) on `stream`.  Returns the
// CUDA error of the launches (0 on success).
extern "C" int repro_flash_attention_bwd(int device, int dtype, const void* q, const void* k,
                                         const void* v, const void* dout, const void* lse,
                                         const void* delta, void* dq, void* dk, void* dv,
                                         void* part, int nsplit, void* part_dq, int nsplit_dq,
                                         int B, int S, int H, int KV, int D, int causal,
                                         int window, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  const int route = repro::flash_route(dtype, D, q, k, v, dout, true);
  if (nsplit_dq < 1 || (nsplit_dq > 1 && (part_dq == nullptr || route != repro::kRouteF32Tc)))
    return cudaErrorInvalidValue;
  if (route != repro::kRouteCudaCores) {
    if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return cudaErrorInvalidValue;
    auto* pt = static_cast<float*>(part);
    if (route == repro::kRouteBf16Tc)
      return repro::launch_tc(q, k, v, dout, l, d, dq, dk, dv, pt, nsplit, B, S, H, KV, D,
                              causal, window, scale, s);
    return repro::launch_f32(q, k, v, dout, l, d, dq, dk, dv, pt, nsplit,
                             static_cast<float*>(part_dq), nsplit_dq, B, S, H, KV, D, causal,
                             window, scale, s);
  }
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, D, causal, window,
                                scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, D, causal,
                                        window, scale, s);
  return cudaErrorInvalidValue;
}
