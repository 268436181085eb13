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
// (1, 1024, 8, 1, 256)), on 4 * B * S * (H + KV) * D elements moved.
//
// Common to both variants, rather than a copy of the TPU grid (which walks
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
// The tensor-core variant (bf16, D a multiple of 16 up to 256, 16-byte
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
// The CUDA-core variant (f32, or a bf16 head dim the tensor-core one
// refuses) does its products in f32 on the CUDA cores, so f32 inputs keep
// their f32 accuracy:
// - dq pass: one block per (batch, KV head, q tile, head chunk), keeping
//   dq in f32 registers;
// - dk/dv pass: one block per (batch, KV head, 16-key tile), walking every
//   head chunk of the group, so dk and dv need no group sum outside;
// - tiles are staged in shared memory as f32 rows padded to D + 1 floats,
//   so column reads do not collide in a bank.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

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

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
  cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<T, DMAX>, dq_smem);
  if (err != cudaSuccess) return err;
  dim3 dq_grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_bwd_dq_kernel<T, DMAX><<<dq_grid, kThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, KV, D, GC, BQ, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_smem_floats(D) * sizeof(float);
  err = opt_in_smem(flash_bwd_dkv_kernel<T, DMAX>, dkv_smem);
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

// dk, dv = the sum over the nsplit partials (nsplit, n) f32, in order,
// rounded to bf16; four elements a thread and step.
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, long long n, int nsplit) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < n;
       i += step) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int s = 0; s < nsplit; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part_dk + s * n + i);
      const float4 y = *reinterpret_cast<const float4*>(part_dv + s * n + i);
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
    }
    *reinterpret_cast<uint2*>(dk + i) = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
    *reinterpret_cast<uint2*>(dv + i) = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
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
  cudaError_t err = opt_in_smem(flash_bwd_dq_tc_kernel<DMAX>, dq_smem);
  if (err != cudaSuccess) return err;
  dim3 dq_grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_bwd_dq_tc_kernel<DMAX><<<dq_grid, kTcThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), S, H, KV, D, GC, BQ, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_layout(D).total;
  err = opt_in_smem(flash_bwd_dkv_tc_kernel<DMAX>, dkv_smem);
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
  const long long blocks = (n / 4 + 255) / 256;
  flash_bwd_sum_kernel<<<static_cast<int>(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      part_dk, part_dv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, nsplit);
  return cudaGetLastError();
}

// The tensor-core variant takes bf16 rows of whole 16-element steps that
// start on 16-byte boundaries (cp.async copies 16 bytes at a time).
bool use_tc(int dtype, int D, const void* q, const void* k, const void* v, const void* dout) {
  const auto bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  return dtype == kBFloat16 && D % 16 == 0 && D <= 256 && bits % 16 == 0;
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

}  // namespace
}  // namespace repro

// Keys a tile of the tensor-core dk/dv pass holds (the wrapper's split plan
// counts its blocks from it).
extern "C" int repro_flash_attention_bwd_key_tile() { return repro::kTcKeys; }

// q, out's gradient dout and dq (B, S, H, D), k, v, dk, dv (B, S, KV, D), all
// in `dtype`; lse and delta (B, S, H) f32; window 0 for global attention,
// else the local window (query i sees keys j with i - window < j), as in the
// forward.  Head dims up to 256 (the forward's limit).  bf16 rows that
// the tensor-core variant takes go to it, with the dk/dv pass cut into
// `nsplit` query ranges; nsplit > 1 needs `part`, f32
// scratch of 2 * nsplit * B * S * KV * D.  The rest go to the CUDA-core
// variant (nsplit and part unused), whose dq pass takes 205,824 bytes of
// shared memory at D = 256 and its dk/dv pass 173,184.  Launches the dq
// pass, then the dk/dv pass (then the sum of the splits) on `stream`.
// Returns the CUDA error of the launches (0 on success).
extern "C" int repro_flash_attention_bwd(int device, int dtype, const void* q, const void* k,
                                         const void* v, const void* dout, const void* lse,
                                         const void* delta, void* dq, void* dk, void* dv,
                                         void* part, int nsplit, int B, int S, int H, int KV,
                                         int D, int causal, int window, float scale,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  if (repro::use_tc(dtype, D, q, k, v, dout)) {
    if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return cudaErrorInvalidValue;
    return repro::launch_tc(q, k, v, dout, l, d, dq, dk, dv, static_cast<float*>(part), nsplit,
                            B, S, H, KV, D, causal, window, scale, s);
  }
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, D, causal, window,
                                scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, D, causal,
                                        window, scale, s);
  return cudaErrorInvalidValue;
}
