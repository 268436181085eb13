// The CUDA-core split body of GQA decode attention, shared by the dense
// kernel (decode_attention.cu: f32, and bf16 the tensor-core variant
// refuses) and the paged one (paged_decode_attention.cu: f32).
//
// It replaces the online-softmax body of the Pallas TPU kernels
// src/repro/kernels/decode_attention.py::decode_attention (_decode_kernel)
// and ::paged_decode_attention (_paged_decode_kernel): one query token per
// sequence against the positions below min(length, capacity) of its cache,
// all G query heads of one KV head together; a length of 0 gives 0.  The
// two entry points differ only in where key p's row comes from: a dense
// cache address, or a page looked up in the slice of the block table that
// the block staged once.  So the f32 engines, dense and paged, run the same
// arithmetic.
//
// What bounds it on the H100: bytes.  Every valid K/V element is read once
// for 2 G flops (G = 8 at gemma-2b, 5 at qwen3-14b, 16 at
// recurrentgemma-9b): at 3.35 TB/s that asks at most ~27 TFLOP/s of the 67
// the f32 CUDA cores give, so f32 FMA suffices and split-TF32 tensor cores
// would buy nothing (they also part from plain f32 where sums cancel).
//
// Design:
// - split-K as before: grid (nsplit, KV, B), one block a chunk of one
//   (KV head, sequence), a plan made from the shapes alone
//   (decode_attention.py: CUDA_CORE_PLAN, _paged_cuda_core_splits).  A
//   block whose chunk starts past its sequence's length writes only
//   (m, l) = (-1e30, 0) and stops; the others leave an unnormalised
//   (acc, m, l) that decode_combine.cuh combines in split order;
// - bytes in flight: K and V arrive as 16-byte cp.async copies (4-byte
//   ones for rows that are not whole aligned 16-byte pieces; element
//   copies only for bf16 rows of odd length), one warp a row, into a ring
//   of stages of 32 keys (at D <= 256) kept in the input's dtype (f32 is
//   not widened: it is f32).  Stage u + 1 is fetched before stage u is
//   computed, one block barrier a stage; at D = 256 f32 a stage is 64 KB.
//   A chunk of one stage takes a ring of one, so that two blocks fit an SM;
// - registers for q and O: eight warps, four head warps (head g on warp
//   g % 4, up to slots() heads each) times two key groups (each taking
//   one 16-key half of every stage, with its own (m, l, O), merged in a
//   fixed order at the end).  Every lane holds a slice of E = D / 32
//   elements (rounded up to a power of two; pieces at lane + 32 j) of each
//   of its heads' q and O.  Heads past 4 slots() (G > 8 at D = 256) take
//   further passes over the chunk, which read it again.  Eight warps, and
//   two blocks an SM where registers and shared memory allow, keep the
//   FMA chains' latency hidden: with four warps an SM the body was bound
//   by instruction latency, not bytes (PERF.md);
// - scores: a lane's partial dot product over its slice is one short FMA
//   chain (E terms); eight keys' partials go through one butterfly that
//   leaves key r's sum on lanes r mod 8 (nine shuffles for eight keys, a
//   fixed order: lane pairs by bits 2, 1, 0, then 3, 4), so a dot product
//   over D is a blocked sum, not one long chain;
// - softmax per 16-key tile on the lanes that hold the scores (three
//   shuffles for the max and three for the sum); p goes through a
//   per-warp row of shared memory to every lane; P V: each V element is
//   read from shared memory once by each warp and used for all of the
//   warp's heads, in a 16-term FMA chain a tile, then O = O corr + pv.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "decode_combine.cuh"

namespace repro {
namespace {
namespace split {

constexpr int kHeadWarps = 4;  // warps that share out a key group's heads
constexpr float kMask = -1e30f;  // the reference's mask value
constexpr int kMaxE = 32;        // D <= 32 kMaxE = 1024

// E: elements of D a lane holds (a power of two, 32 E >= D)
__host__ __device__ constexpr int groups(int E) { return E <= 16 ? 2 : 1; }  // key groups
__host__ __device__ constexpr int threads(int E) { return 32 * kHeadWarps * groups(E); }
__host__ __device__ constexpr int tile_keys(int E) { return E <= 8 ? 16 : 8; }  // a group's keys
__host__ __device__ constexpr int stage_keys(int E) { return groups(E) * tile_keys(E); }
// heads a warp holds: 4 (E <= 4), 2 (E = 8, 16), 1 (E = 32), so that q, O
// and the partial sums fit two blocks an SM where E <= 8
__host__ __device__ constexpr int slots(int E) { return E <= 4 ? 4 : E <= 16 ? 2 : 1; }
__host__ __device__ constexpr int min_blocks(int E) { return E <= 8 ? 2 : 1; }
__host__ __device__ constexpr int piece(int E) { return E < 4 ? E : 4; }         // elements a load

inline int lane_elems(int D) {
  for (int E = 1; E <= kMaxE; E *= 2)
    if (32 * E >= D) return E;
  return 0;  // wider than the body takes
}

struct Layout {
  size_t k, v, q, p, mo, mml, tab, total;  // byte offsets in dynamic shared memory
};

// Ring stages: two (one computed while the next lands), or one where a
// block can only ever see one stage (a chunk of one stage, one pass).
inline int ring_stages(int E, int G, int chunk) {
  const int heads = kHeadWarps * slots(E);
  const long long most = static_cast<long long>((chunk + stage_keys(E) - 1) / stage_keys(E)) *
                         ((G + heads - 1) / heads);
  return most > 1 ? 2 : 1;
}

// the K and V rings (`stages` x stage_keys rows of 32 E elements, `es`
// bytes each), q (G rows of 32 E f32), each warp's p (slots x tile f32),
// the second key group's O and (m, l) for the merge, the table slice
// (`pages` ints).  Every region starts on a 16-byte boundary.
__host__ __device__ inline Layout layout(int es, int E, int G, int stages, int pages) {
  Layout L;
  const size_t ring = static_cast<size_t>(stages) * stage_keys(E) * 32 * E * es;
  const size_t merged = groups(E) > 1 ? static_cast<size_t>(kHeadWarps) * slots(E) : 0;
  L.k = 0;
  L.v = ring;
  L.q = 2 * ring;
  L.p = L.q + static_cast<size_t>(G) * 32 * E * 4;
  L.mo = L.p + static_cast<size_t>(threads(E) / 32) * slots(E) * tile_keys(E) * 4;
  L.mml = L.mo + merged * 32 * E * 4;
  L.tab = L.mml + merged * 2 * 4 + 8;  // (+ 8: keeps 16-byte alignment)
  L.total = L.tab + static_cast<size_t>(pages) * 4;
  return L;
}

// how K/V rows are copied: whole aligned 16-byte pieces, 4-byte pieces, or
// element by element (bf16 rows of odd length)
enum Copy { kCopy16 = 0, kCopy4 = 1, kCopy1 = 2 };

struct Args {
  const void* q;
  const void* k;  // dense: cache (B, cap, KV, D); paged: pool (N, bs, KV, D)
  const void* v;
  const int* lengths;
  const int* tables;  // paged: (B, T_blocks)
  float* part_acc;    // (B, H, nsplit, D)
  float* part_ml;     // (B, H, nsplit, 2)
  void* out;
  float* lse;  // (B, H) or null: the combine's log-sum-exp (dense only)
  int H, KV, D;
  int cap;  // positions a sequence can hold: Smax, or T_blocks * bs
  int bs, T_blocks, chunk, copy;
  int stages;  // ring stages (ring_stages)
  float scale;
};

// this lane's slice of one row (32 E elements in shared memory) as f32:
// pieces of piece(E) elements at lane + 32 j
template <int E>
__device__ __forceinline__ void load_slice(const float* row, int lane, float (&x)[E]) {
  constexpr int W = piece(E);
#pragma unroll
  for (int j = 0; j < E / W; ++j) {
    const float* p = row + W * (lane + 32 * j);
    if constexpr (W == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      x[4 * j] = t.x;
      x[4 * j + 1] = t.y;
      x[4 * j + 2] = t.z;
      x[4 * j + 3] = t.w;
    } else if constexpr (W == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      x[2 * j] = t.x;
      x[2 * j + 1] = t.y;
    } else {
      x[j] = p[0];
    }
  }
}
template <int E>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* row, int lane, float (&x)[E]) {
  constexpr int W = piece(E);
#pragma unroll
  for (int j = 0; j < E / W; ++j) {
    const __nv_bfloat16* p = row + W * (lane + 32 * j);
    if constexpr (W == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
      x[4 * j] = a.x;
      x[4 * j + 1] = a.y;
      x[4 * j + 2] = b.x;
      x[4 * j + 3] = b.y;
    } else if constexpr (W == 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      x[2 * j] = a.x;
      x[2 * j + 1] = a.y;
    } else {
      x[j] = __bfloat162float(p[0]);
    }
  }
}

// Eight keys' partial dot products (one per lane) summed over the warp:
// returns key (lane & 7)'s sum, the same on the four lanes that hold it.
// Lanes pair by bits 2, 1, 0 (each step keeps half the keys and sends the
// other half), then by bits 3 and 4: a fixed tree for every key.
__device__ __forceinline__ float reduce8(const float (&v)[8], int lane) {
  const bool h4 = lane & 4, h2 = lane & 2, h1 = lane & 1;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h4 ? v[i] : v[i + 4];
    a[i] = (h4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h2 ? a[i] : a[i + 2];
    b[i] = (h2 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float send = h1 ? b[0] : b[1];
  float c = (h1 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, send, 1);
  c += __shfl_xor_sync(0xffffffffu, c, 8);
  c += __shfl_xor_sync(0xffffffffu, c, 16);
  return c;
}

template <typename T, int E, bool kPaged>
__global__ void __launch_bounds__(threads(E), min_blocks(E)) split_kernel(const Args a) {
  constexpr int W = piece(E), kTile = tile_keys(E), kSlots = slots(E);
  constexpr int kGroups = groups(E), kStage = stage_keys(E);
  constexpr int kThreads = threads(E), kWarps = kThreads / 32;
  constexpr int Dp = 32 * E;  // row pitch in shared memory, in elements
  constexpr int kHeads = kHeadWarps * kSlots;  // heads a pass
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.H / a.KV, D = a.D;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = warp % kHeadWarps, kg = warp / kHeadWarps;  // head warp, key group
  // partial of head h = kvh*G + g at [(b*H + h) * nsplit + split]
  const long long slot0 = (static_cast<long long>(b) * a.H + kvh * G) * nsplit + split;

  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > a.cap ? a.cap : len);
  const int start = split * a.chunk;
  const int end = start + a.chunk < len ? start + a.chunk : len;
  if (start >= end) {  // nothing of this sequence in the chunk: an empty partial
    for (int g = tid; g < G; g += kThreads) {
      a.part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit)] = kMask;
      a.part_ml[2 * (slot0 + static_cast<long long>(g) * nsplit) + 1] = 0.f;
    }
    return;
  }

  const int nstage = a.stages;
  const Layout L = layout(sizeof(T), E, G, nstage, kPaged ? a.chunk / a.bs : 0);
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* sq = reinterpret_cast<float*>(smem + L.q);
  float* sp = reinterpret_cast<float*>(smem + L.p) + warp * kSlots * kTile;  // this warp's p
  float* smo = reinterpret_cast<float*>(smem + L.mo);
  float* smml = reinterpret_cast<float*>(smem + L.mml);
  int* stab = reinterpret_cast<int*>(smem + L.tab);
  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);

  const int page0 = kPaged ? start / a.bs : 0;
  if constexpr (kPaged) {
    const int* tab = a.tables + static_cast<long long>(b) * a.T_blocks;
    for (int i = tid; i <= (end - 1) / a.bs - page0; i += kThreads) stab[i] = tab[page0 + i];
    __syncthreads();  // every warp's copies read the table slice
  }
  // element offset of position p's K/V row
  auto row = [&](int p) -> long long {
    if constexpr (kPaged)
      return ((static_cast<long long>(stab[p / a.bs - page0]) * a.bs + p % a.bs) * a.KV + kvh) * D;
    return ((static_cast<long long>(b) * a.cap + p) * a.KV + kvh) * D;
  };
  const int nst = (end - start + kStage - 1) / kStage;      // stages a pass
  const int total = nst * ((G + kHeads - 1) / kHeads);      // over all passes
  // stage u (of pass u / nst) into ring buffer u % nstage: one warp a row,
  // its lanes on the row's pieces; rows past the chunk's end zero-filled,
  // so that p = 0 meets finite V
  auto fetch = [&](int u) {
    const int s0 = start + (u % nst) * kStage;
    const int n = end - s0 < kStage ? end - s0 : kStage;
    T* dk = sk + (u % nstage) * kStage * Dp;
    T* dv = sv + (u % nstage) * kStage * Dp;
    for (int r = warp; r < kStage; r += kWarps) {
      const bool ok = r < n;
      const long long off = ok ? row(s0 + r) : 0;
      const T* srk = kc + off;
      const T* srv = vc + off;
      T* drk = dk + r * Dp;
      T* drv = dv + r * Dp;
      if (a.copy == kCopy16) {
        constexpr int kPer = 16 / sizeof(T);
        for (int c = lane * kPer; c < D; c += 32 * kPer) {
          cp_async16(drk + c, srk + c, ok);
          cp_async16(drv + c, srv + c, ok);
        }
      } else if (a.copy == kCopy4) {
        constexpr int kPer = 4 / sizeof(T);
        for (int c = lane * kPer; c < D; c += 32 * kPer) {
          cp_async4(drk + c, srk + c, ok);
          cp_async4(drv + c, srv + c, ok);
        }
      } else {
        for (int e = lane; e < D; e += 32) {
          drk[e] = ok ? srk[e] : from_f32<T>(0.f);
          drv[e] = ok ? srv[e] : from_f32<T>(0.f);
        }
      }
    }
  };
  fetch(0);
  cp_async_commit();

  // while the first stage lands: q of the G heads as f32 (zero past D), and
  // zeros in the ring's columns past D, which no copy writes
  const long long head0 = (static_cast<long long>(b) * a.H + static_cast<long long>(kvh) * G) * D;
  for (int i = tid; i < G * Dp; i += kThreads) {
    const int g = i / Dp, e = i - g * Dp;
    sq[i] = e < D ? to_f32(q[head0 + static_cast<long long>(g) * D + e]) : 0.f;
  }
  if (D < Dp) {
    const int pad = Dp - D;
    for (int i = tid; i < nstage * kStage * pad; i += kThreads) {
      const int r = i / pad, e = D + (i - r * pad);
      sk[r * Dp + e] = from_f32<T>(0.f);
      sv[r * Dp + e] = from_f32<T>(0.f);
    }
  }

  float qr[kSlots][E], o[kSlots][E], m[kSlots], l[kSlots];
  int nact = 0;  // this warp's heads in the current pass (slots 0 .. nact - 1)
  for (int u = 0; u < total; ++u) {
    cp_async_wait_all();
    __syncthreads();  // stage u landed for every thread; every warp left stage u - 1
    if (u + 1 < total) fetch(u + 1);  // (two stages whenever there is a next)
    cp_async_commit();
    const int pass = u / nst, st = u - pass * nst;
    const int g0 = pass * kHeads + hw;  // slot s holds head g0 + kHeadWarps s
    if (st == 0) {
      nact = G > g0 ? (G - g0 + kHeadWarps - 1) / kHeadWarps : 0;
      nact = nact < kSlots ? nact : kSlots;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < nact) load_slice<E>(sq + (g0 + kHeadWarps * s) * Dp, lane, qr[s]);
#pragma unroll
        for (int e = 0; e < E; ++e) o[s][e] = 0.f;
        m[s] = kMask;
        l[s] = 0.f;
      }
    }
    // this key group's tile of the stage: keys t0 .. t0 + kTile - 1
    const int t0 = start + st * kStage + kg * kTile;
    if (nact > 0 && t0 < end) {  // the same for the whole warp
      const T* ck = sk + ((u % nstage) * kStage + kg * kTile) * Dp;
      const T* cv = sv + ((u % nstage) * kStage + kg * kTile) * Dp;
      // scores: key t0 + 8 kb + (lane & 7) on this lane
      float sc[kSlots][kTile / 8];
#pragma unroll
      for (int kb = 0; kb < kTile / 8; ++kb) {
        float part[kSlots][8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float kx[E];
          load_slice<E>(ck + (8 * kb + r) * Dp, lane, kx);
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            float acc = 0.f;
            if (s < nact) {
#pragma unroll
              for (int e = 0; e < E; ++e) acc = fmaf(qr[s][e], kx[e], acc);
            }
            part[s][r] = acc;
          }
        }
        const bool valid = t0 + 8 * kb + (lane & 7) < end;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s < nact) {
            const float x = reduce8(part[s], lane) * a.scale;
            sc[s][kb] = valid ? x : kMask;
          }
        }
      }
      // online softmax over the tile, then O = O corr + sum_r p_r V_r
      float corr[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < nact) {
          float mt = sc[s][0];
#pragma unroll
          for (int kb = 1; kb < kTile / 8; ++kb) mt = fmaxf(mt, sc[s][kb]);
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
          const float mn = fmaxf(m[s], mt);
          corr[s] = expf(m[s] - mn);
          float pk[kTile / 8];
#pragma unroll
          for (int kb = 0; kb < kTile / 8; ++kb)
            pk[kb] = t0 + 8 * kb + (lane & 7) < end ? expf(sc[s][kb] - mn) : 0.f;
          float ps = pk[0];
#pragma unroll
          for (int kb = 1; kb < kTile / 8; ++kb) ps += pk[kb];
          ps += __shfl_xor_sync(0xffffffffu, ps, 1);
          ps += __shfl_xor_sync(0xffffffffu, ps, 2);
          ps += __shfl_xor_sync(0xffffffffu, ps, 4);
          l[s] = fmaf(l[s], corr[s], ps);
          m[s] = mn;
          if (lane < 8) {
#pragma unroll
            for (int kb = 0; kb < kTile / 8; ++kb) sp[s * kTile + 8 * kb + lane] = pk[kb];
          }
        }
      }
      __syncwarp();  // p of every key on every lane
      float pv[kSlots][E];
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int e = 0; e < E; ++e) pv[s][e] = 0.f;
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        float vx[E];
        load_slice<E>(cv + r * Dp, lane, vx);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s < nact) {
            const float p = sp[s * kTile + r];
#pragma unroll
            for (int e = 0; e < E; ++e) pv[s][e] = fmaf(p, vx[e], pv[s][e]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (s < nact) {
#pragma unroll
          for (int e = 0; e < E; ++e) o[s][e] = fmaf(o[s][e], corr[s], pv[s][e]);
        }
      __syncwarp();  // every lane read p before the next tile rewrites it
    }
    if (st == nst - 1) {  // the pass's partials
      if constexpr (kGroups > 1) {  // key group 1's (m, l, O) into key group 0's
        if (kg == 1) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            if (s < nact) {
              float* dst = smo + (hw * kSlots + s) * Dp;
#pragma unroll
              for (int j = 0; j < E / W; ++j)
#pragma unroll
                for (int w = 0; w < W; ++w) dst[W * (lane + 32 * j) + w] = o[s][W * j + w];
              if (lane == 0) {
                smml[2 * (hw * kSlots + s)] = m[s];
                smml[2 * (hw * kSlots + s) + 1] = l[s];
              }
            }
          }
        }
        __syncthreads();
        if (kg == 0) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            if (s < nact) {
              const float* src = smo + (hw * kSlots + s) * Dp;
              const float m1 = smml[2 * (hw * kSlots + s)];
              const float l1 = smml[2 * (hw * kSlots + s) + 1];
              const float mn = fmaxf(m[s], m1);
              const float w0 = expf(m[s] - mn), w1 = expf(m1 - mn);
#pragma unroll
              for (int j = 0; j < E / W; ++j)
#pragma unroll
                for (int w = 0; w < W; ++w)
                  o[s][W * j + w] = fmaf(src[W * (lane + 32 * j) + w], w1, o[s][W * j + w] * w0);
              l[s] = fmaf(l1, w1, l[s] * w0);
              m[s] = mn;
            }
          }
        }
      }
      if (kg == 0) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s < nact) {
            const long long sl = slot0 + static_cast<long long>(g0 + kHeadWarps * s) * nsplit;
            float* dst = a.part_acc + sl * D;
#pragma unroll
            for (int j = 0; j < E / W; ++j) {
              const int e0 = W * (lane + 32 * j);
              if (e0 + W <= D && D % W == 0) {
                if constexpr (W == 4)
                  *reinterpret_cast<float4*>(dst + e0) =
                      make_float4(o[s][4 * j], o[s][4 * j + 1], o[s][4 * j + 2], o[s][4 * j + 3]);
                else if constexpr (W == 2)
                  *reinterpret_cast<float2*>(dst + e0) = make_float2(o[s][2 * j], o[s][2 * j + 1]);
                else
                  dst[e0] = o[s][j];
              } else {
#pragma unroll
                for (int w = 0; w < W; ++w)
                  if (e0 + w < D) dst[e0 + w] = o[s][W * j + w];
              }
            }
            if (lane == 0) {
              a.part_ml[2 * sl] = m[s];
              a.part_ml[2 * sl + 1] = l[s];
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

template <typename T, int E, bool kPaged>
cudaError_t launch_e(Args a, int B, int nsplit, cudaStream_t stream) {
  a.stages = ring_stages(E, a.H / a.KV, a.chunk);
  const size_t smem =
      layout(sizeof(T), E, a.H / a.KV, a.stages, kPaged ? a.chunk / a.bs : 0).total;
  auto kernel = split_kernel<T, E, kPaged>;
  cudaError_t err = set_max_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nsplit, a.KV, B), threads(E), smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode_combine<T>(a.part_acc, a.part_ml, a.out, B, a.H, a.D, nsplit, stream,
                                  a.lse);
}

// Bytes of dynamic shared memory a block needs (-1: D wider than the body
// takes) for chunks of `chunk` positions; `pages` is the table slice of a
// paged chunk (0 for dense).
inline long long smem_bytes(int es, int G, int D, int chunk, int pages) {
  const int E = lane_elems(D);
  return E ? static_cast<long long>(layout(es, E, G, ring_stages(E, G, chunk), pages).total)
           : -1;
}

// The split pass for these arguments' D, then the combine pass.  a.copy is
// set here from the rows' length and the K/V pointers' alignment.
template <typename T, bool kPaged>
cudaError_t launch(Args a, int B, int nsplit, cudaStream_t stream) {
  const auto bits = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
  const size_t row_bytes = static_cast<size_t>(a.D) * sizeof(T);
  a.copy = row_bytes % 16 == 0 && bits % 16 == 0 ? kCopy16
           : row_bytes % 4 == 0 && bits % 4 == 0 ? kCopy4
                                                 : kCopy1;
  switch (lane_elems(a.D)) {
    case 1: return launch_e<T, 1, kPaged>(a, B, nsplit, stream);
    case 2: return launch_e<T, 2, kPaged>(a, B, nsplit, stream);
    case 4: return launch_e<T, 4, kPaged>(a, B, nsplit, stream);
    case 8: return launch_e<T, 8, kPaged>(a, B, nsplit, stream);
    case 16: return launch_e<T, 16, kPaged>(a, B, nsplit, stream);
    case 32: return launch_e<T, 32, kPaged>(a, B, nsplit, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace split
}  // namespace
}  // namespace repro
