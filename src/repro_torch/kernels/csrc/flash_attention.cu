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
// common to both variants below:
// - one thread block per (batch, KV head, q tile, head chunk).  Its 64 rows
//   are (query position, query head) pairs: BQ positions times GC heads of
//   one KV group (GC = min(G, 64), BQ = 64 / GC).  Each K/V tile is loaded
//   once into shared memory for all GC heads that read it: at gemma's G = 8
//   that is 8x fewer K/V reads than one block per query head;
// - the block loops over KV tiles of 32 keys up to the diagonal only, and
//   masks the ragged last tile (any S, no padding), so causal blocks never
//   touch the upper triangle and the heaviest q tiles are launched first;
// - with a window, the loop starts at the tile that holds key
//   q0 - window + 1, so a block reads about (window + 64) / 32 tiles
//   whatever its position; keys inside the band's ragged edges are masked;
// - the online-softmax state (m, l) and the output accumulator are f32.
//   Tiles above 48 KB of shared memory opt into dynamic shared memory (at
//   most 232,448 bytes).
//
// The tensor-core variant (bf16, D a multiple of 16, 16-byte aligned rows):
// - four warps, each owning 16 of the 64 rows from the scores to the output,
//   so the only block-wide barriers are around the K/V tiles;
// - K/V tiles arrive by cp.async into two buffers: tile t + 1 is in flight
//   while tile t is computed.  Rows past S are zero-filled by the copy;
// - S = Q K^T and O += P V are bf16 wmma products (16x16x16, f32 sums): Q,
//   K, V and P sit in shared memory as bf16 rows padded by 16 bytes, S as
//   f32 rows; the f32 accumulator O stays in registers (D/16 fragments a
//   warp) from the first tile to the last;
// - P is split into bf16 hi + lo parts and both are multiplied with V, so
//   the product keeps about 16 bits of P, near the TPU kernel's f32 P V.
//   (P rounded once to bf16 moves nearly every output by an ulp; the
//   reference's near-hard attention turns that into different logits two
//   layers on);
// - two lanes own a row for the softmax (16 scores each, one shuffle); the
//   rescale of O by exp(m_old - m_new) reads the rows of a thread's
//   accumulator elements from the sm_80+ fragment layout.
//
// The CUDA-core variant (f32, or a head dim the tensor-core one refuses):
// - four threads own one row: each computes 8 of the tile's 32 scores, the
//   row's max and sum come from two shuffles, the probabilities go through
//   shared memory to the same four threads (one warp, so __syncwarp), and
//   each thread keeps a quarter of the row's f32 accumulator (D/4 values)
//   in registers.  Products run in f32 on the CUDA cores, so f32 inputs
//   keep their f32 accuracy;
// - tiles are staged in shared memory as f32 whatever the input type, with
//   rows padded to D + 1 floats so the column reads do not collide in a
//   bank: 140,032 bytes at D = 256.
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr float kMaskValue = -1e30f;  // the TPU kernel's mask value

// ------------------------------------------------------ tensor-core variant

constexpr int kTcRows = 64;   // (position, head) rows per block, 16 per warp
constexpr int kTcKeys = 32;   // keys per KV tile
constexpr int kTcWarps = kTcRows / 16;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kLdS = kTcKeys + 4;  // f32 score rows (a multiple of 4 floats)
constexpr int kLdP = kTcKeys + 8;  // bf16 probability rows (of 8 elements)

struct TcLayout {
  int ldh;  // pitch of the bf16 Q, K and V rows: D + 8 (16 bytes of padding)
  int ldo;  // pitch of the f32 O rows staged for the output: D + 4
  size_t q, k, v, s, ph, pl, total;  // byte offsets in dynamic shared memory
};

// Every region starts on a 32-byte boundary, as wmma's loads and stores
// need.  After the last tile, O is staged where the K/V buffers were.
__host__ __device__ inline TcLayout tc_layout(int D) {
  TcLayout L;
  L.ldh = D + 8;
  L.ldo = D + 4;
  const size_t kv_tile = static_cast<size_t>(kTcKeys) * L.ldh * 2;
  L.q = 0;
  L.k = L.q + static_cast<size_t>(kTcRows) * L.ldh * 2;
  L.v = L.k + 2 * kv_tile;  // two buffers each for K and V
  L.s = L.v + 2 * kv_tile;
  L.ph = L.s + static_cast<size_t>(kTcRows) * kLdS * 4;
  L.pl = L.ph + static_cast<size_t>(kTcRows) * kLdP * 2;
  L.total = L.pl + static_cast<size_t>(kTcRows) * kLdP * 2;
  return L;
}

// DMAX: the head dims up to DMAX (multiples of 16) share one register
// budget of DMAX / 16 accumulator fragments.
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, int KV, int D, int GC, int BQ,
                    int causal, int window, float scale) {
  using namespace nvcuda;
  using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  constexpr int kFrags = DMAX / 16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const TcLayout L = tc_layout(D);
  auto* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.q);
  auto* sK = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.k);  // 2 buffers
  auto* sV = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.v);  // 2 buffers
  auto* sS = reinterpret_cast<float*>(tc_smem + L.s);
  auto* sPh = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.ph);
  auto* sPl = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.pl);
  const int G = H / KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int g0 = blockIdx.z * GC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = BQ * GC;
  const int nfr = D / 16;    // 16-wide column blocks of a row
  const int chunks = D / 8;  // 16-byte pieces of a row
  const int tile_elems = kTcKeys * L.ldh;

  // row r of the tile is query position q0 + r / GC, head kvh*G + g0 + r % GC
  for (int i = tid; i < kTcRows * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int qp = q0 + r / GC, g = g0 + r % GC;
    const bool ok = r < rows && qp < S && g < G;
    const long long off =
        ok ? ((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + c * 8 : 0;
    cp_async16(sQ + r * L.ldh + c * 8, q + off, ok);
  }
  auto load_kv = [&](int tile, int buf) {
    __nv_bfloat16* dk = sK + buf * tile_elems;
    __nv_bfloat16* dv = sV + buf * tile_elems;
    for (int i = tid; i < kTcKeys * chunks; i += kTcThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int kp = tile * kTcKeys + r;
      const bool ok = kp < S;
      const long long off = ok ? ((static_cast<long long>(b) * S + kp) * KV + kvh) * D + c * 8 : 0;
      cp_async16(dk + r * L.ldh + c * 8, k + off, ok);
      cp_async16(dv + r * L.ldh + c * 8, v + off, ok);
    }
  };

  // causal: the last key any row of this tile attends to is q0 + BQ - 1;
  // window: the first is q0 - window + 1
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + kTcKeys - 1) / kTcKeys;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kTcKeys : 0;
  load_kv(t_first, t_first & 1);
  cp_async_commit();  // Q and the first K/V tile

  // this warp's 16 rows: their accumulator in registers, D/16 fragments
  FragAcc o[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(o[j], 0.f);
  // two lanes per row for the softmax
  const int r_own = warp * 16 + (lane >> 1), side = lane & 1;
  const int qpos = q0 + r_own / GC;
  float m = kMaskValue, l = 0.f;

  for (int t = t_first; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // tile t (and Q) landed for every thread
    const __nv_bfloat16* cK = sK + (t & 1) * tile_elems;
    const __nv_bfloat16* cV = sV + (t & 1) * tile_elems;

    // S = Q K^T for this warp's 16 rows: one Q fragment per 16 dims feeds
    // both key blocks, whose two sums run side by side
    FragAcc acc[kTcKeys / 16];
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int kk = 0; kk < nfr; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, sQ + warp * 16 * L.ldh + kk * 16, L.ldh);
#pragma unroll
      for (int j = 0; j < kTcKeys / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, cK + j * 16 * L.ldh + kk * 16, L.ldh);
        wmma::mma_sync(acc[j], a, bk, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j)
      wmma::store_matrix_sync(sS + warp * 16 * kLdS + j * 16, acc[j], kLdS, wmma::mem_row_major);
    __syncwarp();

    // online softmax: lanes 2r and 2r + 1 take 16 keys each of row r.  P is
    // split into bf16 hi + lo parts, so P V keeps about 16 bits of P, near
    // the TPU kernel's f32 product
    float corr;
    {
      const int kbase = t * kTcKeys + side * 16;
      const float* srow = sS + r_own * kLdS + side * 16;
      float s[16];
      float tile_max = kMaskValue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kp = kbase + j;
        const bool ok =
            kp < S && (!causal || kp <= qpos) && (window <= 0 || qpos - kp < window);
        s[j] = ok ? srow[j] * scale : kMaskValue;
        tile_max = fmaxf(tile_max, s[j]);
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      const float m_new = fmaxf(m, tile_max);
      corr = expf(m - m_new);
      float psum = 0.f;
      __nv_bfloat16* ph = sPh + r_own * kLdP + side * 16;
      __nv_bfloat16* pl = sPl + r_own * kLdP + side * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = s[j] > kMaskValue ? expf(s[j] - m_new) : 0.f;
        psum += p;
        const __nv_bfloat16 hi = __float2bfloat16_rn(p);
        ph[j] = hi;
        pl[j] = __float2bfloat16_rn(p - __bfloat162float(hi));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l = l * corr + psum;
      m = m_new;
    }
    // rescale the accumulator: a thread's fragment elements lie in rows
    // lane/4 (elements 0, 1, 4, 5) and lane/4 + 8 (2, 3, 6, 7) of the
    // warp's 16, the sm_80+ layout of a 16x16 f32 accumulator
    const float c_top = __shfl_sync(0xffffffffu, corr, 2 * (lane >> 2));
    const float c_bot = __shfl_sync(0xffffffffu, corr, 2 * ((lane >> 2) + 8));
#pragma unroll
    for (int j = 0; j < kFrags; ++j)
#pragma unroll
      for (int i = 0; i < o[j].num_elements; ++i) o[j].x[i] *= (i & 2) ? c_bot : c_top;
    __syncwarp();

    // O += (P_hi + P_lo) V for this warp's 16 rows
    FragA pah[kTcKeys / 16], pal[kTcKeys / 16];
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      wmma::load_matrix_sync(pah[kk], sPh + warp * 16 * kLdP + kk * 16, kLdP);
      wmma::load_matrix_sync(pal[kk], sPl + warp * 16 * kLdP + kk * 16, kLdP);
    }
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      if (j >= nfr) continue;
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, cV + kk * 16 * L.ldh + j * 16, L.ldh);
        wmma::mma_sync(o[j], pah[kk], vb, o[j]);
        wmma::mma_sync(o[j], pal[kk], vb, o[j]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // stage O in the K/V buffers (free now), then out = O / max(l, 1e-30) row
  // by row (coalesced) and lse = m + log(max(l, 1e-30))
  float* oW = reinterpret_cast<float*>(tc_smem + L.k) + warp * 16 * L.ldo;
#pragma unroll
  for (int j = 0; j < kFrags; ++j)
    if (j < nfr) wmma::store_matrix_sync(oW + j * 16, o[j], L.ldo, wmma::mem_row_major);
  __syncwarp();
  const float den = fmaxf(l, 1e-30f);
  for (int r = 0; r < 16; ++r) {
    const float d = __shfl_sync(0xffffffffu, den, 2 * r);
    const float mr = __shfl_sync(0xffffffffu, m, 2 * r);
    const int rr = warp * 16 + r;
    const int qp = q0 + rr / GC, g = g0 + rr % GC;
    if (rr >= rows || qp >= S || g >= G) continue;  // the same for the whole warp
    const long long orow = (static_cast<long long>(b) * S + qp) * H + kvh * G + g;
    for (int e = lane; e < D; e += 32)
      out[orow * D + e] = __float2bfloat16_rn(oW[r * L.ldo + e] / d);
    if (lse != nullptr && lane == 0) lse[orow] = mr + logf(d);
  }
}

// ------------------------------------------------------- CUDA-core variant

constexpr int kRows = 64;      // (position, head) rows per block
constexpr int kKeys = 32;      // keys per KV tile
constexpr int kThreads = 256;  // 4 per row
constexpr int kSub = kThreads / kRows;
constexpr int kKeysPerThread = kKeys / kSub;

__host__ __device__ inline size_t smem_floats(int D) {
  // Q tile (kRows x D+1), K and V tiles (kKeys x D+1 each), P (kRows x kKeys+1)
  return static_cast<size_t>(kRows + 2 * kKeys) * (D + 1) +
         static_cast<size_t>(kRows) * (kKeys + 1);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int KV, int D,
                 int GC, int BQ, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* sQ = smem;               // (kRows, Dp)
  float* sK = sQ + kRows * Dp;    // (kKeys, Dp)
  float* sV = sK + kKeys * Dp;    // (kKeys, Dp)
  float* sP = sV + kKeys * Dp;    // (kRows, kKeys + 1)
  const int G = H / KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int g0 = blockIdx.z * GC;
  const int tid = threadIdx.x;
  const int r = tid / kSub, sub = tid - r * kSub;
  const int rows = BQ * GC;

  // row r of the tile is query position q0 + r / GC, head kvh*G + g0 + r % GC
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D, e = i - rr * D;
    const int qp = q0 + rr / GC, g = g0 + rr % GC;
    float x = 0.f;
    if (rr < rows && qp < S && g < G)
      x = to_f32(q[((static_cast<long long>(b) * S + qp) * H + kvh * G + g) * D + e]);
    sQ[rr * Dp + e] = x;
  }
  const int qpos = q0 + r / GC, g = g0 + r % GC;
  const bool row_ok = r < rows && qpos < S && g < G;

  float m = kMaskValue, l = 0.f;
  float acc[DMAX / kSub];
#pragma unroll
  for (int c = 0; c < DMAX / kSub; ++c) acc[c] = 0.f;

  // causal: the last key any row of this tile attends to is q0 + BQ - 1;
  // window: the first is q0 - window + 1
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int kstart = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  for (int k0 = kstart; k0 < kend; k0 += kKeys) {
    __syncthreads();  // the previous tile's K/V reads are done (and sQ is written)
    for (int i = tid; i < kKeys * D; i += kThreads) {
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
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.f;
    for (int e = 0; e < D; ++e) {
      const float qe = sQ[r * Dp + e];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[j] += qe * sK[(sub + kSub * j) * Dp + e];
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
    for (int c = 0; c < DMAX / kSub; ++c) acc[c] *= corr;
    for (int kk = 0; kk < kKeys; ++kk) {
      const float p = sP[r * (kKeys + 1) + kk];
      const float* vrow = sV + kk * Dp + sub;
#pragma unroll
      for (int c = 0; c < DMAX / kSub; ++c)
        if (sub + kSub * c < D) acc[c] += p * vrow[kSub * c];
    }
    __syncwarp();  // sP is rewritten by the next tile
  }

  if (!row_ok) return;
  const long long orow = (static_cast<long long>(b) * S + qpos) * H + kvh * G + g;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < DMAX / kSub; ++c) {
    const int e = sub + kSub * c;
    if (e < D) out[orow * D + e] = from_f32<T>(acc[c] / den);
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
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, KV, D, GC, BQ, causal, window, scale);
  return cudaGetLastError();
}

// The tensor-core variant takes bf16 rows of whole 16-element steps that
// start on 16-byte boundaries (cp.async copies 16 bytes at a time).
bool use_tc(int dtype, int D, const void* q, const void* k, const void* v, const void* out) {
  const auto bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  return dtype == kBFloat16 && D % 16 == 0 && D <= 256 && bits % 16 == 0;
}

template <int DMAX>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int S, int H, int KV, int D, int causal, int window, float scale,
                        cudaStream_t stream) {
  const int G = H / KV;
  const int GC = G < kTcRows ? G : kTcRows;
  const int BQ = kTcRows / GC;
  const size_t smem = tc_layout(D).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<DMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + BQ - 1) / BQ, B * KV, (G + GC - 1) / GC);
  flash_fwd_tc_kernel<DMAX><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, S, H, KV, D,
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
// 140,032 bytes for the CUDA-core one, 120,832 for the tensor-core one.
extern "C" int repro_flash_attention_max_head_dim() { return 256; }

// q and out (B, S, H, D), k and v (B, S, KV, D) in `dtype`; lse (B, S, H) f32
// or null; window 0 for global attention, else the local window.  bf16 rows
// that the tensor-core variant takes go to it, the rest to the CUDA-core
// variant.  Returns the CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention(int device, int dtype, const void* q, const void* k,
                                     const void* v, void* out, void* lse, int B, int S, int H,
                                     int KV, int D, int causal, int window, float scale,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (repro::use_tc(dtype, D, q, k, v, out))
    return repro::launch_tc(q, k, v, out, l, B, S, H, KV, D, causal, window, scale, s);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, out, l, B, S, H, KV, D, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, out, l, B, S, H, KV, D, causal, window, scale,
                                        s);
  return cudaErrorInvalidValue;
}

