// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::paged_decode_attention
// (_paged_decode_kernel): one query token per sequence attends to its K/V
// cache, which lives in pages of a shared pool (num_blocks, block_size, KV, D)
// named through a block table (B, T); positions >= length are masked and all
// G query heads of one KV head are handled together.  Block 0 is the
// engine's scratch block; a length past T * block_size attends to the whole
// table, and a length of 0 gives 0.
//
// What bounds it on the H100: bytes.  Every K/V element a sequence holds is
// read once for 2*G flops each (G = 8 for gemma-2b, 5 for qwen3-14b), about
// 4-8 flops per byte in bf16, far under the ~295 flop/byte ridge.  So the
// card's 3.35 TB/s is reached only with many blocks in flight and many bytes
// in flight in each.
//
// Design, rather than a copy of the TPU grid (which walks the T blocks of a
// sequence as a sequential grid axis):
// - split-K over the page list: grid (nsplit, KV, B).  The wrapper cuts the
//   table's T * block_size positions into nsplit chunks of `chunk` positions
//   from the shapes alone (never from `lengths`, which would sync the host),
//   aiming at two or more blocks per SM; a chunk is a whole number of pages
//   and of tiles.  A block whose chunk starts past its sequence's length
//   writes an empty partial (m = -1e30, l = 0) and stops; the combine pass
//   (decode_combine.cuh, shared with the dense kernel) skips it;
// - a block stages its slice of the table row in shared memory once, then
//   fetches K/V rows as 16-byte cp.async pieces (one warp per row, so the
//   table lookup is once per row, not per element) into two tile buffers:
//   tile t + 1 is in flight while tile t is computed.  The tiles stay in the
//   pool's dtype in shared memory and are widened to f32 at use, so a bf16
//   tile of 32 tokens at D = 256 takes 16 KB a buffer for K and for V.  Rows
//   that are not whole aligned 16-byte pieces (an odd D, an unaligned pool)
//   are copied element by element instead;
// - scores: eight lanes per key, each lane a 1/8 slice of D, one K piece
//   widened once for up to eight query heads, then three shuffles a head;
//   one warp per query head updates (m, l) over the tile's keys; the f32
//   accumulator (G x D) stays in shared memory, each 16-byte piece owned by
//   one thread, which adds p * V over the tile's keys.
//
// That body was written and tuned for bf16.  f32 pools take the CUDA-core
// split body of decode_split.cuh instead, the one the dense kernel's f32
// path runs, with the page lookup as its row address: a cp.async ring of
// 16-key tiles, q and O in registers, f32 FMA, chunks of whole pages and at
// least 64 keys planned for one block per SM (_paged_cuda_core_splits).
#include <cstdint>

#include "common.cuh"
#include "decode_combine.cuh"
#include "decode_split.cuh"

namespace repro {
namespace {

constexpr int kTileMax = 32;  // tokens per tile at most: one lane per token in the softmax
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = 8;  // lanes that share one key's dot products
constexpr int kHeadGroup = 8;    // query heads whose dots one K piece feeds
constexpr float kMaskValue = -1e30f;  // the reference's mask value

struct Layout {
  size_t k, v, q, acc, s, m, l, corr, tab, total;  // byte offsets in dynamic shared memory
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// K and V: two buffers of `tile` rows of D elements each; q and acc (G, D)
// f32; scores (G, kTileMax) f32; m, l, corr (G,) f32; the table slice
// (`pages` ints).
__host__ __device__ inline Layout layout(int es, int G, int D, int tile, int pages) {
  Layout L;
  const size_t buf = align16(static_cast<size_t>(tile) * D * es);
  const size_t gd = static_cast<size_t>(G) * D * 4;
  L.k = 0;
  L.v = L.k + 2 * buf;
  L.q = L.v + 2 * buf;
  L.acc = L.q + align16(gd);
  L.s = L.acc + align16(gd);
  L.m = L.s + align16(static_cast<size_t>(G) * kTileMax * 4);
  L.l = L.m + static_cast<size_t>(G) * 4;
  L.corr = L.l + static_cast<size_t>(G) * 4;
  L.tab = align16(L.corr + static_cast<size_t>(G) * 4);
  L.total = L.tab + static_cast<size_t>(pages) * 4;
  return L;
}

// N elements of `src` (shared memory) widened to f32: one 16-byte load when
// N elements make 16 bytes, element by element otherwise.
template <int N>
__device__ __forceinline__ void widen(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 x = reinterpret_cast<const float4*>(src)[j];
      dst[4 * j] = x.x;
      dst[4 * j + 1] = x.y;
      dst[4 * j + 2] = x.z;
      dst[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = src[j];
  }
}
template <int N>
__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = __bfloat162float(src[j]);
  }
}
template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(dst)[j] =
          make_float4(src[4 * j], src[4 * j + 1], src[4 * j + 2], src[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = src[j];
  }
}

// kVec: every pool row is whole 16-byte pieces from a 16-byte aligned base.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ tables,
                   const int* __restrict__ lengths, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int H, int KV, int D, int bs, int T_blocks,
                   int chunk, int tile, float scale) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements a piece
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // partial of head h = kvh*G + g at [(b*H + h) * nsplit + split]
  const long long slot0 = (static_cast<long long>(b) * H + kvh * G) * nsplit + split;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T_blocks * bs ? T_blocks * bs : len);
  const int start = split * chunk;
  const int end = start + chunk < len ? start + chunk : len;
  if (start >= end) {  // nothing of this sequence in the chunk: an empty partial
    for (int g = tid; g < G; g += kThreads) {
      part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit)] = kMaskValue;
      part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit) + 1] = 0.f;
    }
    return;
  }

  const Layout L = layout(sizeof(T), G, D, tile, chunk / bs);
  T* sk = reinterpret_cast<T*>(smem + L.k);  // two buffers of (tile, D)
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* sq = reinterpret_cast<float*>(smem + L.q);      // (G, D)
  float* sacc = reinterpret_cast<float*>(smem + L.acc);  // (G, D) running numerator
  float* ss = reinterpret_cast<float*>(smem + L.s);      // (G, kTileMax) scores, then p
  float* sm = reinterpret_cast<float*>(smem + L.m);      // (G,) running max
  float* sl = reinterpret_cast<float*>(smem + L.l);      // (G,) running denominator
  float* scorr = reinterpret_cast<float*>(smem + L.corr);  // (G,) rescale of this tile
  int* stab = reinterpret_cast<int*>(smem + L.tab);      // pages of [start, end)
  const size_t buf_elems = (L.v - L.k) / 2 / sizeof(T);

  const int page0 = start / bs;
  const int* tab = tables + static_cast<long long>(b) * T_blocks;
  for (int i = tid; i <= (end - 1) / bs - page0; i += kThreads) stab[i] = tab[page0 + i];
  const long long head0 = (static_cast<long long>(b) * H + static_cast<long long>(kvh) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    sq[i] = to_f32(q[head0 + i]);
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kMaskValue;
    sl[g] = 0.f;
  }
  __syncthreads();  // the table slice is read by every warp below

  // tile t's K/V rows into buffer t & 1: one warp per row, its lanes on the
  // row's 16-byte pieces
  auto fetch = [&](int t) {
    const int t0 = start + t * tile;
    const int n = end - t0 < tile ? end - t0 : tile;
    T* dk = sk + (t & 1) * buf_elems;
    T* dv = sv + (t & 1) * buf_elems;
    for (int r = warp; r < n; r += kWarps) {
      const int p = t0 + r;
      const long long row =
          (static_cast<long long>(stab[p / bs - page0]) * bs + p % bs) * KV + kvh;
      const T* srck = k_pool + row * D;
      const T* srcv = v_pool + row * D;
      if (kVec) {
        for (int c = lane * kPer; c < D; c += 32 * kPer) {
          cp_async16(dk + r * D + c, srck + c);
          cp_async16(dv + r * D + c, srcv + c);
        }
      } else {
        for (int e = lane; e < D; e += 32) {
          dk[r * D + e] = srck[e];
          dv[r * D + e] = srcv[e];
        }
      }
    }
  };

  const int ntiles = (end - start + tile - 1) / tile;
  const int pieces = D / kPer;
  fetch(0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) fetch(t + 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_one();
    __syncthreads();  // tile t landed for every thread
    const int t0 = start + t * tile;
    const int n = end - t0 < tile ? end - t0 : tile;
    const T* ck = sk + (t & 1) * buf_elems;
    const T* cv = sv + (t & 1) * buf_elems;

    // scores: key r is taken by eight neighbouring lanes (every lane runs
    // the shuffles; rows past n read row 0 and write nothing)
    {
      const int r = warp * (32 / kLanesPerKey) + lane / kLanesPerKey;
      const int j = lane % kLanesPerKey;
      const T* krow = ck + (r < n ? r : 0) * D;
      for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
        float dot[kHeadGroup];
#pragma unroll
        for (int gg = 0; gg < kHeadGroup; ++gg) dot[gg] = 0.f;
        for (int c = j; c < pieces; c += kLanesPerKey) {
          float kx[kPer];
          widen<kPer>(krow + c * kPer, kx);
#pragma unroll
          for (int gg = 0; gg < kHeadGroup; ++gg) {
            if (g0 + gg < G) {
              float qx[kPer];
              widen<kPer>(sq + (g0 + gg) * D + c * kPer, qx);
#pragma unroll
              for (int e = 0; e < kPer; ++e) dot[gg] += qx[e] * kx[e];
            }
          }
        }
#pragma unroll
        for (int gg = 0; gg < kHeadGroup; ++gg) {
          dot[gg] += __shfl_xor_sync(0xffffffffu, dot[gg], 1);
          dot[gg] += __shfl_xor_sync(0xffffffffu, dot[gg], 2);
          dot[gg] += __shfl_xor_sync(0xffffffffu, dot[gg], 4);
        }
        // lane j of the key's eight writes head g0 + j
#pragma unroll
        for (int gg = 0; gg < kHeadGroup; ++gg)
          if (gg == j && r < n && g0 + gg < G) ss[(g0 + gg) * kTileMax + r] = dot[gg] * scale;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < n ? ss[g * kTileMax + lane] : kMaskValue;
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane < n) ss[g * kTileMax + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p V, one 16-byte piece of one head a thread
    for (int i = tid; i < G * pieces; i += kThreads) {
      const int g = i / pieces, c = i - g * pieces;
      float a[kPer];
      widen<kPer>(sacc + g * D + c * kPer, a);
      const float corr = scorr[g];
#pragma unroll
      for (int e = 0; e < kPer; ++e) a[e] *= corr;
      for (int r = 0; r < n; ++r) {
        const float p = ss[g * kTileMax + r];
        float vx[kPer];
        widen<kPer>(cv + r * D + c * kPer, vx);
#pragma unroll
        for (int e = 0; e < kPer; ++e) a[e] += p * vx[e];
      }
      store_f32<kPer>(sacc + g * D + c * kPer, a);
    }
    __syncthreads();  // the next fetch overwrites this buffer, ss and scorr
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i - g * D;
    part_acc[(slot0 + static_cast<long long>(g) * nsplit) * D + e] = sacc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit)] = sm[g];
    part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit) + 1] = sl[g];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* lengths, float* part_acc, float* part_ml, void* out, int B, int H,
                   int KV, int D, int bs, int T_blocks, int chunk, int tile, int nsplit,
                   float scale, cudaStream_t stream) {
  const size_t smem = layout(sizeof(T), H / KV, D, tile, chunk / bs).total;
  const auto bits = reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  const bool vec = (D * sizeof(T)) % 16 == 0 && bits % 16 == 0;
  auto kernel = vec ? paged_split_kernel<T, true> : paged_split_kernel<T, false>;
  cudaError_t err = set_max_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, part_acc, part_ml, H, KV, D, bs, T_blocks, chunk, tile, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode_combine<T>(part_acc, part_ml, out, B, H, D, nsplit, stream);
}

}  // namespace
}  // namespace repro

// Bytes of dynamic shared memory one split block needs for chunks of
// `chunk` positions, pages of `bs` (the wrapper checks it against the
// device's limit before launching; -1: a head dim the f32 body does not
// take).  `tile` is the bf16 kernel's; f32 ignores it.
extern "C" long long repro_paged_decode_smem_bytes(int dtype, int G, int D, int tile, int chunk,
                                                   int bs) {
  if (dtype == repro::kFloat32) return repro::split::smem_bytes(4, G, D, chunk, chunk / bs);
  return static_cast<long long>(repro::layout(2, G, D, tile, chunk / bs).total);
}

// The most tokens a tile may hold (the wrapper picks tile <= this).
extern "C" int repro_paged_decode_max_tile() { return repro::kTileMax; }

// q and out (B, H, D), pools (N, bs, KV, D) in `dtype`; tables (B, T) and
// lengths (B,) int32; scratch: part_acc (B, H, nsplit, D) and part_ml
// (B, H, nsplit, 2) f32.  chunk is a multiple of bs and nsplit * chunk >=
// T * bs; for bf16, chunk is also a multiple of tile (tile <= 32).  f32
// takes the split body of decode_split.cuh, bf16 the kernel above.  Returns
// the CUDA error of the launches (0 on success).
extern "C" int repro_paged_decode_attention(int device, int dtype, const void* q,
                                            const void* k_pool, const void* v_pool,
                                            const void* tables, const void* lengths,
                                            void* part_acc, void* part_ml, void* out, int B,
                                            int H, int KV, int D, int bs, int T_blocks,
                                            int chunk, int tile, int nsplit, float scale,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (bs < 1 || KV < 1 || H % KV || chunk < 1 || chunk % bs || nsplit < 1 ||
      static_cast<long long>(nsplit) * chunk < static_cast<long long>(T_blocks) * bs)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const int*>(tables);
  auto len = static_cast<const int*>(lengths);
  auto pa = static_cast<float*>(part_acc);
  auto pml = static_cast<float*>(part_ml);
  if (dtype == repro::kFloat32) {
    repro::split::Args a{};
    a.q = q;
    a.k = k_pool;
    a.v = v_pool;
    a.lengths = len;
    a.tables = tab;
    a.part_acc = pa;
    a.part_ml = pml;
    a.out = out;
    a.H = H;
    a.KV = KV;
    a.D = D;
    a.cap = T_blocks * bs;
    a.bs = bs;
    a.T_blocks = T_blocks;
    a.chunk = chunk;
    a.scale = scale;
    return repro::split::launch<float, true>(a, B, nsplit, s);
  }
  if (dtype == repro::kBFloat16) {
    if (tile < 1 || tile > repro::kTileMax || chunk % tile) return cudaErrorInvalidValue;
    return repro::launch<__nv_bfloat16>(q, k_pool, v_pool, tab, len, pa, pml, out, B, H, KV, D,
                                        bs, T_blocks, chunk, tile, nsplit, scale, s);
  }
  return cudaErrorInvalidValue;
}
