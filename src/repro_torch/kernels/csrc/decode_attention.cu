// GQA decode attention over a dense cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (_decode_kernel):
// one query token per sequence attends to its cache (B, Smax, KV, D); the
// positions below min(length, Smax) are valid (a length past Smax means the
// whole cache, as the model's plain decode layer reads it); all G query
// heads of one KV head are handled together.  A sequence of length 0 gives 0
// (acc / max(l, 1e-30) with acc == 0).
//
// What bounds it on the H100: bytes.  Every valid K/V element is read once
// for 2*G flops each (G = 8 for gemma-2b, 5 for qwen3-14b), about 4-8 flops
// per byte in bf16, far under the ~295 flop/byte ridge.  Reading at the
// card's rate needs many blocks in flight, and B * KV is small in decode
// (8 at gemma-2b with batch 8).
//
// Design, rather than a copy of the TPU grid (which walks the cache axis as
// a sequential grid dimension and pads Smax up to block_k):
// - split-K: the cache axis is cut into `nsplit` chunks of `chunk`
//   positions, and one thread block takes one (chunk, KV head, sequence).
//   The wrapper plans the chunks from the shapes alone (never from
//   `lengths`, which would sync the host), for the variant that runs
//   (`repro_decode_attention_tensor_cores`).  Both variants' chunks are
//   whole 16-key steps, at least 64 keys, as short as keep the grid within
//   one wave of one block per SM: (B 8, Smax 1024, KV 1) 16 chunks of 64 =
//   128 blocks; qwen3-14b's (B 8, KV 8) 3 of 352 = 192.  At the serving
//   shapes the floor holds: the fixed-slot serve's (B 4, Smax 256) and the
//   decode after a 1024-token prefill (B 1) take 16 blocks, recurrentgemma's
//   ring (B 1, Smax 2048) 32.  Tensor-core chunks of 16 or 32 positions
//   filled 64-128 SMs there and measured slower.  A block reads its own
//   length, and loops only over the valid positions of its chunk (a block
//   whose chunk starts past it writes only (m, l) = (-1e30, 0) and stops).
//   No padding: the ragged end is masked;
// - each block leaves its unnormalised (acc, m, l), and a second kernel
//   (decode_combine.cuh, shared with the paged kernel) combines the chunks
//   of one (sequence, head), skipping the empty ones, in split order:
//   out = sum_c acc_c e^(m_c - M) / max(sum_c l_c e^(m_c - M), 1e-30).
//
// The tensor-core variant (bf16, D a multiple of 16 up to 256, G <= 16,
// 16-byte aligned rows):
// - K/V arrive by 16-byte cp.async as bf16 rows padded by 16 bytes (pitch
//   D + 8), in tiles of 64 keys; a chunk of at most 64 keys is one tile,
//   issued at once, a longer one runs through two buffers (tile t + 1 in
//   flight while tile t is computed).  Nothing is widened to f32 in shared
//   memory;
// - both products run on mma.sync.m16n8k16 (mma.cuh), with the G query
//   heads as the m = 16 rows (zero rows past G): S = q K^T, and O += P V
//   with V by ldmatrix.trans.  With the heads on the rows, P goes from the
//   score accumulator to the A fragments of P V in registers, as in the
//   flash forward; with G on the n = 8 side, P^T would need eight shuffles
//   a step or a trip through shared memory.  The rows past G cost mma
//   issue slots only, and this kernel is bound by bytes: a 64-key tile is
//   64 KB at D = 256, about 2.6 us of one SM's share of the card's rate,
//   and its 384 mma.sync are a few hundred cycles;
// - 4 warps: warp w takes keys 16 w .. + 15 of every tile, with its own
//   (m, l) and f32 O (16 rows x D, in registers: 128 floats a lane at
//   D = 256); P is split into bf16 hi + lo A fragments (one extra mma a
//   step), so P V keeps about 16 bits of P.  At the end the warps merge
//   through shared memory in warp order, and the block writes its partial;
// - shared memory at D = 256: 76,032 bytes for a one-tile chunk, 143,616
//   for a longer one.
//
// The CUDA-core variant (f32, and bf16 the tensor-core one refuses: G > 16,
// D not a multiple of 16 or over 256, unaligned rows) is the split body of
// decode_split.cuh, shared with the paged kernel's f32 path: a cp.async ring
// of 16-key tiles, q and O in registers, f32 FMA.  Its chunks are whole
// 16-key tiles, at least four, planned for one block per SM
// (CUDA_CORE_PLAN).
#include <cstdint>

#include "common.cuh"
#include "decode_combine.cuh"
#include "decode_split.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr float kMaskValue = -1e30f;  // the reference's mask value

// ------------------------------------------------------ tensor-core variant

constexpr int kStep = 16;      // keys of one mma k-step; chunks are whole steps
constexpr int kStage = 64;     // keys of one staged tile: one k-step per warp
constexpr int kTcThreads = 128;
constexpr int kTcHeads = 16;   // query heads of the m = 16 side (G <= 16)

struct TcLayout {
  int ld, rows, nbuf;  // bf16 row pitch D + 8; keys of a buffer; buffers
  size_t q, k, v, total;  // byte offsets in dynamic shared memory
};

// q (16 head rows), then nbuf buffers each of K and V (`rows` keys); after
// the last tile the same bytes hold the four warps' partials (256 D + 2048
// bytes), so the total is the larger of the two.  Every region starts on a
// 16-byte boundary, as cp.async and ldmatrix need.
__host__ __device__ inline TcLayout tc_layout(int D, int chunk) {
  TcLayout L;
  L.ld = D + 8;
  L.rows = chunk < kStage ? (chunk + kStep - 1) / kStep * kStep : kStage;
  L.nbuf = chunk > kStage ? 2 : 1;
  const size_t buf = static_cast<size_t>(L.rows) * L.ld * 2;
  L.q = 0;
  L.k = static_cast<size_t>(kTcHeads) * L.ld * 2;
  L.v = L.k + L.nbuf * buf;
  const size_t ring = L.v + L.nbuf * buf;
  const size_t merge = static_cast<size_t>(256) * D + 2048;
  L.total = ring > merge ? ring : merge;
  return L;
}

// DMAX: head dims up to DMAX share one register budget (DMAX / 8
// accumulator tiles a warp).
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
                 const bf16* __restrict__ v_cache, const int* __restrict__ lengths,
                 float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int KV, int D,
                 int Smax, int chunk, float scale) {
  constexpr int kNt = DMAX / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int G = H / KV;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row (head) and column pair
  // partial of head h = kvh*G + g at [(b*H + h) * nsplit + split]
  const long long slot0 = (static_cast<long long>(b) * H + kvh * G) * nsplit + split;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);
  const int start = split * chunk;
  const int end = start + chunk < len ? start + chunk : len;
  if (start >= end) {  // nothing of this sequence in the chunk: an empty partial
    for (int g = tid; g < G; g += kTcThreads) {
      part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit)] = kMaskValue;
      part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit) + 1] = 0.f;
    }
    return;
  }

  const TcLayout L = tc_layout(D, chunk);
  const int ld = L.ld, chunks = D / 8;
  auto* sQ = reinterpret_cast<bf16*>(tc_smem + L.q);
  auto* sK = reinterpret_cast<bf16*>(tc_smem + L.k);
  auto* sV = reinterpret_cast<bf16*>(tc_smem + L.v);
  // q's G heads as rows 0 .. G - 1 (rows up to 16 zero-filled)
  for (int i = tid; i < kTcHeads * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r < G;
    const long long off = ok ? (static_cast<long long>(b) * H + kvh * G + r) * D + c * 8 : 0;
    cp_async16(sQ + r * ld + c * 8, q + off, ok);
  }
  // tile s: keys start + 64 s .., rounded up to whole k-steps (the keys past
  // the end zero-filled, so that p = 0 meets finite V)
  auto load = [&](int s) {
    const int s0 = start + s * kStage;
    const int n = end - s0 < kStage ? end - s0 : kStage;
    const int n16 = (n + kStep - 1) / kStep * kStep;
    bf16* dk = sK + (s % L.nbuf) * L.rows * ld;
    bf16* dv = sV + (s % L.nbuf) * L.rows * ld;
    for (int i = tid; i < n16 * chunks; i += kTcThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const bool ok = r < n;
      const long long off =
          ok ? ((static_cast<long long>(b) * Smax + s0 + r) * KV + kvh) * D + c * 8 : 0;
      cp_async16(dk + r * ld + c * 8, k_cache + off, ok);
      cp_async16(dv + r * ld + c * 8, v_cache + off, ok);
    }
  };

  const int ntiles = (end - start + kStage - 1) / kStage;
  load(0);
  cp_async_commit();  // q and the first tile

  float o[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  const int nfr = D / 8;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // tile t (and q) landed for every thread
    const int kw = start + t * kStage + kStep * warp;  // this warp's 16 keys
    if (kw < end) {  // the same for the whole warp
      const bf16* cK = sK + (t % L.nbuf) * L.rows * ld;
      const bf16* cV = sV + (t % L.nbuf) * L.rows * ld;
      // S = q K^T: 16 head rows x this warp's 16 keys, two 8-key tiles
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int kk = 0; kk < D; kk += 16) {
        unsigned aq[4], bk[4];
        load_a(aq, sQ, ld, 0, kk, lane);
        load_b_nmajor(bk, cK, ld, kStep * warp, kk, lane);
        mma16816(s[0], aq, bk[0], bk[1]);
        mma16816(s[1], aq, bk[2], bk[3]);
      }
      const bool edge = kw + kStep > end;  // only the last k-step is ragged
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e] * scale;
          s[j][e] = edge && kw + 8 * j + 2 * tq + (e & 1) >= end ? kMaskValue : x;
        }
      float corr[2];
      softmax_step(s, m, l, corr, kMaskValue);
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      // O += (P_hi + P_lo) V over the 16 keys
      unsigned ah[4], al[4];
      p_frags_hi_lo(s[0], s[1], ah, al);
#pragma unroll
      for (int jj = 0; jj < kNt / 2; ++jj) {
        if (2 * jj < nfr) {
          unsigned bv[4];
          load_b_kmajor(bv, cV, ld, 16 * jj, kStep * warp, lane);
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

  // merge the four warps' (m, l, O) in warp order through shared memory
  // (free now): warp w finalizes the accumulator tiles j = w, w + 4, ...
  float4* xo = reinterpret_cast<float4*>(tc_smem);  // (4 warps, nfr, 32 lanes)
  float4* xml = xo + 4 * nfr * 32;                  // (4 warps, 32 lanes)
#pragma unroll
  for (int j = 0; j < kNt; ++j)
    if (j < nfr) xo[(warp * nfr + j) * 32 + lane] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  xml[warp * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  __syncthreads();
  float wt[4][2], mt[2] = {kMaskValue, kMaskValue}, lt[2] = {0.f, 0.f};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float4 x = xml[w * 32 + lane];
    mt[0] = fmaxf(mt[0], x.x);
    mt[1] = fmaxf(mt[1], x.y);
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float4 x = xml[w * 32 + lane];
    wt[w][0] = expf(x.x - mt[0]);
    wt[w][1] = expf(x.y - mt[1]);
    lt[0] += x.z * wt[w][0];
    lt[1] += x.w * wt[w][1];
  }
  for (int j = warp; j < nfr; j += 4) {
    float2 acc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 x = xo[(w * nfr + j) * 32 + lane];
      acc[0].x += x.x * wt[w][0];
      acc[0].y += x.y * wt[w][0];
      acc[1].x += x.z * wt[w][1];
      acc[1].y += x.w * wt[w][1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = gq + 8 * h;
      if (g < G)
        *reinterpret_cast<float2*>(part_acc + (slot0 + static_cast<long long>(g) * nsplit) * D +
                                   8 * j + 2 * tq) = acc[h];
    }
  }
  if (warp == 0 && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = gq + 8 * h;
      if (g < G) {
        part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit)] = mt[h];
        part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit) + 1] = lt[h];
      }
    }
  }
}

// The tensor-core variant takes bf16 rows of whole 16-element steps that
// start on 16-byte boundaries, G <= 16 heads a KV head and chunks of whole
// k-steps.
bool use_tc(int dtype, int G, int D, int chunk, const void* q, const void* k, const void* v) {
  const auto bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v);
  return dtype == kBFloat16 && D % 16 == 0 && D <= 256 && G <= kTcHeads && chunk % kStep == 0 &&
         bits % 16 == 0;
}

template <int DMAX>
cudaError_t launch_tc_d(const void* q, const void* k_cache, const void* v_cache,
                        const int* lengths, float* part_acc, float* part_ml, void* out,
                        float* lse, int B, int H, int KV, int D, int Smax, int chunk,
                        int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = tc_layout(D, chunk).total;
  cudaError_t err = set_max_dynamic_smem(decode_tc_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  decode_tc_kernel<DMAX><<<dim3(nsplit, KV, B), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
      static_cast<const bf16*>(v_cache), lengths, part_acc, part_ml, H, KV, D, Smax, chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode_combine<bf16>(part_acc, part_ml, out, B, H, D, nsplit, stream, lse);
}

cudaError_t launch_tc(const void* q, const void* k_cache, const void* v_cache, const int* lengths,
                      float* part_acc, float* part_ml, void* out, float* lse, int B, int H,
                      int KV, int D, int Smax, int chunk, int nsplit, float scale,
                      cudaStream_t stream) {
  if (D <= 64)
    return launch_tc_d<64>(q, k_cache, v_cache, lengths, part_acc, part_ml, out, lse, B, H, KV,
                           D, Smax, chunk, nsplit, scale, stream);
  if (D <= 128)
    return launch_tc_d<128>(q, k_cache, v_cache, lengths, part_acc, part_ml, out, lse, B, H, KV,
                            D, Smax, chunk, nsplit, scale, stream);
  return launch_tc_d<256>(q, k_cache, v_cache, lengths, part_acc, part_ml, out, lse, B, H, KV, D,
                          Smax, chunk, nsplit, scale, stream);
}

}  // namespace
}  // namespace repro

// Bytes of dynamic shared memory one split block needs, whichever variant
// the arguments pick (the wrapper checks it against the device's limit;
// -1: a head dim the CUDA-core body does not take).
extern "C" long long repro_decode_attention_smem_bytes(int dtype, int G, int D, int chunk) {
  const long long cuda_core =
      repro::split::smem_bytes(dtype == repro::kBFloat16 ? 2 : 4, G, D, chunk, 0);
  if (cuda_core < 0) return -1;
  if (dtype != repro::kBFloat16 || D % 16 || D > 256 || G > repro::kTcHeads) return cuda_core;
  const long long tc = static_cast<long long>(repro::tc_layout(D, chunk).total);
  return tc > cuda_core ? tc : cuda_core;  // unaligned rows take the CUDA-core variant
}

// 1 when these inputs take the tensor-core variant (with chunks of whole
// 16-key steps), 0 when they take the CUDA-core one: the wrapper plans the
// chunks for the variant that runs.
extern "C" int repro_decode_attention_tensor_cores(int dtype, int G, int D, const void* q,
                                                   const void* k_cache, const void* v_cache) {
  return repro::use_tc(dtype, G, D, repro::kStep, q, k_cache, v_cache) ? 1 : 0;
}

// q and out (B, H, D), caches (B, Smax, KV, D) in `dtype`; lengths (B,)
// int32; lse (B, H) f32 or null: each row's log-sum-exp (decode_combine.cuh);
// scratch: part_acc (B, H, nsplit, D) and part_ml (B, H, nsplit, 2) f32,
// with nsplit * chunk >= Smax.  bf16 that the tensor-core variant takes
// goes to it, the rest to the CUDA-core split body (decode_split.cuh).  Returns the CUDA error of
// the launches (0 on success).
extern "C" int repro_decode_attention(int device, int dtype, const void* q, const void* k_cache,
                                      const void* v_cache, const void* lengths, void* part_acc,
                                      void* part_ml, void* out, void* lse, int B, int H,
                                      int KV, int D, int Smax, int chunk, int nsplit,
                                      float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (nsplit < 1 || chunk < 1 || KV < 1 || H % KV ||
      static_cast<long long>(nsplit) * chunk < Smax)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  auto pa = static_cast<float*>(part_acc);
  auto pml = static_cast<float*>(part_ml);
  auto plse = static_cast<float*>(lse);
  if (repro::use_tc(dtype, H / KV, D, chunk, q, k_cache, v_cache))
    return repro::launch_tc(q, k_cache, v_cache, len, pa, pml, out, plse, B, H, KV, D, Smax,
                            chunk, nsplit, scale, s);
  repro::split::Args a{};
  a.q = q;
  a.k = k_cache;
  a.v = v_cache;
  a.lengths = len;
  a.part_acc = pa;
  a.part_ml = pml;
  a.out = out;
  a.lse = plse;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.cap = Smax;
  a.chunk = chunk;
  a.scale = scale;
  if (dtype == repro::kFloat32) return repro::split::launch<float, false>(a, B, nsplit, s);
  if (dtype == repro::kBFloat16)
    return repro::split::launch<__nv_bfloat16, false>(a, B, nsplit, s);
  return cudaErrorInvalidValue;
}

// The rank-ordered merge of n partial decode outputs, each over a slice of
// the cache: part_acc (B, H, n, D) f32 holds rank r's normalised output at
// [b, h, r], part_ml (B, H, n, 2) f32 its (log-sum-exp, 1), or (-1e30, 0)
// for a rank whose slice held no valid position; out (B, H, D) in `dtype`.
// The combine pass of the split kernels, with the ranks as its splits.
extern "C" int repro_decode_merge(int device, int dtype, const void* part_acc,
                                  const void* part_ml, void* out, int B, int H, int D, int n,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (n < 1 || D < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const float*>(part_acc);
  auto pml = static_cast<const float*>(part_ml);
  if (dtype == repro::kFloat32)
    return repro::launch_decode_combine<float>(pa, pml, out, B, H, D, n, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_decode_combine<__nv_bfloat16>(pa, pml, out, B, H, D, n, s);
  return cudaErrorInvalidValue;
}
