// Causal (or full) GQA flash attention, backward, for Hopper (sm_90a).
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
// products, 5 * 2 * B * H * (S^2 / 2) * D flops, on 4 * B * S * (H + KV) * D
// elements moved.  This first version does its products in f32 on the CUDA
// cores, as the forward's CUDA-core variant does, so its ceiling is the f32
// rate and, below that, shared-memory loads.  Tensor cores are later work.
//
// Design, rather than a copy of the TPU grid (which walks the other axis as
// its innermost sequential grid dimension and carries the sums in VMEM):
// - two kernels, each output element written by exactly one thread after a
//   loop in a fixed order: no atomics, so two runs give the same bits;
// - dq pass: one block per (batch, KV head, q tile, head chunk), its 64 rows
//   being (query position, query head) pairs of one KV group as in the
//   forward.  It walks the key tiles from the diagonal back to 0 and keeps
//   dq in f32 registers;
// - dk/dv pass: one block per (batch, KV head, 16-key tile).  It walks the
//   query tiles from the diagonal to the end, for every head chunk of the
//   group, and keeps dk and dv of its keys in f32 registers.  So, unlike the
//   TPU kernel, it never writes per-head (B, S, H, D) f32 partials and
//   needs no group sum outside;
// - p, dp, delta and ds stay f32; only operands loaded from bf16 are
//   rounded (they are widened on load).  Tiles are staged in shared memory
//   as f32 rows padded to D + 1 floats, so column reads do not collide in a
//   bank;
// - any S: rows past S load as zero and every probability is masked by
//   key < S (and key <= query when causal), so the ragged last tile and the
//   padded rows contribute nothing.  Blocks above the diagonal are never
//   visited.
#include "common.cuh"

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
                    int D, int GC, int BQ, int causal, float scale) {
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
  for (int t = ntiles - 1; t >= 0; --t) {
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
      const bool ok = row_ok && kp < S && (!causal || kp <= qpos);
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
                     int S, int H, int KV, int D, int GC, int BQ, int causal, float scale) {
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
  for (int g0 = 0; g0 < G; g0 += GC) {
    for (int q0 = qstart; q0 < S; q0 += BQ) {
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
        const bool ok = row_ok && kp < S && (!causal || kp <= qpos);
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
                     int S, int H, int KV, int D, int causal, float scale, cudaStream_t stream) {
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
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, KV, D, GC, BQ, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_smem_floats(D) * sizeof(float);
  err = opt_in_smem(flash_bwd_dkv_kernel<T, DMAX>, dkv_smem);
  if (err != cudaSuccess) return err;
  dim3 dkv_grid((S + kKvKeys - 1) / kKvKeys, B * KV);
  flash_bwd_dkv_kernel<T, DMAX><<<dkv_grid, kThreads, dkv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, D, GC,
      BQ, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   int S, int H, int KV, int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_d<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal, scale,
                           stream);
  if (D <= 128)
    return launch_d<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal,
                            scale, stream);
  if (D <= 256)
    return launch_d<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, D, causal,
                            scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// q, out's gradient dout and dq (B, S, H, D), k, v, dk, dv (B, S, KV, D), all
// in `dtype`; lse and delta (B, S, H) f32.  Head dims up to 256 (the forward's
// limit): there the dq pass takes 205,824 bytes of shared memory and the
// dk/dv pass 173,184.  Launches the dq pass, then the dk/dv pass, on
// `stream`.  Returns the CUDA error of the launches (0 on success).
extern "C" int repro_flash_attention_bwd(int device, int dtype, const void* q, const void* k,
                                         const void* v, const void* dout, const void* lse,
                                         const void* delta, void* dq, void* dk, void* dv, int B,
                                         int S, int H, int KV, int D, int causal, float scale,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, D, causal, scale,
                                s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, D, causal,
                                        scale, s);
  return cudaErrorInvalidValue;
}
