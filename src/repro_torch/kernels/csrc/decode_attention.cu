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
//   positions (the wrapper picks them so the grid holds about two blocks
//   per SM), and one thread block takes one (chunk, KV head, sequence).  A
//   block reads its own length and loops only over the valid positions of
//   its chunk, in tiles of kTile; chunks past the length end at once.  No
//   padding: the ragged end is masked by the loop bound;
// - inside a block the tile's K/V rows are staged in shared memory as f32,
//   neighbouring threads on neighbouring 16-byte pieces (element by element
//   where a row is not made of aligned 16-byte pieces); each warp computes G x
//   kTile scores as shuffled dot products; one warp per query head updates
//   (m, l); the f32 accumulator (G x D) stays in shared memory, each element
//   owned by one thread (the body of the paged kernel, over a dense row);
// - each block writes its unnormalised (acc, m, l) to a scratch buffer, and
//   a second kernel (decode_combine.cuh, shared with the paged kernel)
//   combines the chunks of one (sequence, head):
//   out = sum_c acc_c e^(m_c - M) / max(sum_c l_c e^(m_c - M), 1e-30).
#include <cstdint>

#include "common.cuh"
#include "decode_combine.cuh"

namespace repro {
namespace {

constexpr int kTile = 32;  // tokens per tile; <= 32 (one lane per token in the softmax)
constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;  // the reference's mask value

__host__ __device__ inline size_t smem_floats(int G, int D) {
  // q, acc (G*D each); K, V tiles (kTile*D each); scores (G*kTile); m, l, corr (G each)
  return 2 * static_cast<size_t>(G) * D + 2 * static_cast<size_t>(kTile) * D +
         static_cast<size_t>(G) * kTile + 3 * static_cast<size_t>(G);
}

// 16 bytes of `src` (4 f32 or 8 bf16 values), widened to f32 in `dst`.
__device__ __forceinline__ void load16_f32(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// kVec: every cache row is whole 16-byte pieces from a 16-byte aligned base.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int KV,
                    int D, int Smax, int chunk, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  float* sq = smem;              // (G, D) query heads of this KV head
  float* sacc = sq + G * D;      // (G, D) running numerator
  float* sk = sacc + G * D;      // (kTile, D)
  float* sv = sk + kTile * D;    // (kTile, D)
  float* ss = sv + kTile * D;    // (G, kTile) scores, then probabilities
  float* sm = ss + G * kTile;    // (G,) running max
  float* sl = sm + G;            // (G,) running denominator
  float* scorr = sl + G;         // (G,) rescale of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);
  const int start = split * chunk;
  const int end = start + chunk < len ? start + chunk : len;
  const long long head0 = (static_cast<long long>(b) * H + static_cast<long long>(kvh) * G) * D;

  for (int i = tid; i < G * D; i += blockDim.x) {
    sq[i] = start < end ? to_f32(q[head0 + i]) : 0.f;
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    sm[g] = kMaskValue;
    sl[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = end - t0 < kTile ? end - t0 : kTile;
    if (kVec) {
      constexpr int kPer = 16 / sizeof(T);  // elements in a 16-byte piece
#pragma unroll 4
      for (int i = tid * kPer; i < n * D; i += blockDim.x * kPer) {
        const int r = i / D, e = i - r * D;
        const long long row = (static_cast<long long>(b) * Smax + t0 + r) * KV + kvh;
        load16_f32(k_cache + row * D + e, sk + i);
        load16_f32(v_cache + row * D + e, sv + i);
      }
    } else {
      for (int i = tid; i < n * D; i += blockDim.x) {
        const int r = i / D, e = i - r * D;
        const long long row = (static_cast<long long>(b) * Smax + t0 + r) * KV + kvh;
        sk[i] = to_f32(k_cache[row * D + e]);
        sv[i] = to_f32(v_cache[row * D + e]);
      }
    }
    __syncthreads();
    for (int pair = warp; pair < G * n; pair += nwarps) {
      const int g = pair / n, r = pair - g * n;
      float dot = 0.f;
      for (int e = lane; e < D; e += 32) dot += sq[g * D + e] * sk[r * D + e];
      dot = warp_sum(dot);
      if (lane == 0) ss[g * kTile + r] = dot * scale;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      const float s = lane < n ? ss[g * kTile + lane] : kMaskValue;
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane < n) ss[g * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, e = i - g * D;
      float a = sacc[i] * scorr[g];
      for (int r = 0; r < n; ++r) a += ss[g * kTile + r] * sv[r * D + e];
      sacc[i] = a;
    }
    __syncthreads();  // the next tile overwrites sk, sv and ss
  }

  // partials of head h = kvh*G + g at [(b*H + h) * nsplit + split]
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, e = i - g * D;
    const long long slot = (static_cast<long long>(b) * H + kvh * G + g) * nsplit + split;
    part_acc[slot * D + e] = sacc[i];
  }
  for (int g = tid; g < G; g += blockDim.x) {
    const long long slot = (static_cast<long long>(b) * H + kvh * G + g) * nsplit + split;
    part_ml[2 * slot] = sm[g];
    part_ml[2 * slot + 1] = sl[g];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache, const int* lengths,
                   float* part_acc, float* part_ml, void* out, int B, int H, int KV, int D,
                   int Smax, int chunk, int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  const auto bits = reinterpret_cast<uintptr_t>(k_cache) | reinterpret_cast<uintptr_t>(v_cache);
  const bool vec = (D * sizeof(T)) % 16 == 0 && bits % 16 == 0;
  auto kernel = vec ? decode_split_kernel<T, true> : decode_split_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      lengths, part_acc, part_ml, H, KV, D, Smax, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode_combine<T>(part_acc, part_ml, out, B, H, D, nsplit, stream);
}

}  // namespace
}  // namespace repro

// Bytes of dynamic shared memory one split block needs (the wrapper checks
// it against the device's limit before launching).
extern "C" long long repro_decode_attention_smem_bytes(int G, int D) {
  return static_cast<long long>(repro::smem_floats(G, D) * sizeof(float));
}

// The tile the split kernel walks a chunk in: chunks are multiples of it.
extern "C" int repro_decode_attention_tile() { return repro::kTile; }

// q and out (B, H, D), caches (B, Smax, KV, D) in `dtype`; lengths (B,)
// int32; scratch: part_acc (B, H, nsplit, D) and part_ml (B, H, nsplit, 2)
// f32, with nsplit * chunk >= Smax.  Returns the CUDA error of the launches
// (0 on success).
extern "C" int repro_decode_attention(int device, int dtype, const void* q, const void* k_cache,
                                      const void* v_cache, const void* lengths, void* part_acc,
                                      void* part_ml, void* out, int B, int H, int KV, int D,
                                      int Smax, int chunk, int nsplit, float scale,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (nsplit < 1 || chunk < 1 || static_cast<long long>(nsplit) * chunk < Smax)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  auto pa = static_cast<float*>(part_acc);
  auto pml = static_cast<float*>(part_ml);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k_cache, v_cache, len, pa, pml, out, B, H, KV, D, Smax, chunk,
                                nsplit, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k_cache, v_cache, len, pa, pml, out, B, H, KV, D,
                                        Smax, chunk, nsplit, scale, s);
  return cudaErrorInvalidValue;
}
