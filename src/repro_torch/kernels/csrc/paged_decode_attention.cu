// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::paged_decode_attention
// (_paged_decode_kernel): one query token per sequence attends to its K/V
// cache, which lives in pages of a shared pool (num_blocks, block_size, KV, D)
// named through a block table (B, T); positions >= length are masked and all
// G query heads of one KV head are handled together.
//
// What bounds it on the H100: bytes.  Every K/V element a sequence holds is
// read once for 2*G flops each (G = 8 for gemma-2b, 5 for qwen3-14b), about
// 4-8 flops per byte in bf16, far under the ~295 flop/byte ridge.
//
// Design, rather than a copy of the TPU grid:
// - one thread block per (sequence, KV head).  The block reads its own
//   length and table row (no scalar prefetch on the GPU) and loops only
//   over the positions that exist, where the TPU grid visits all T blocks
//   and skips the rest;
// - positions are taken in tiles of kTile tokens whatever the page size:
//   each K/V row (D contiguous elements) is gathered through the table with
//   neighbouring threads on neighbouring elements, converted to f32 and
//   staged in shared memory, so block sizes 2..32 all take one code path;
// - each warp computes G x kTile scores as shuffled dot products; one warp
//   per query head then does the online-softmax update of (m, l); the
//   f32 accumulator (G x D) stays in shared memory, each element owned by
//   one thread;
// - known limit: at B * KV = 8 blocks (gemma-2b, batch 8) the kernel uses 8
//   of the 132 SMs, so it reaches a small share of the card's bandwidth.
//   Splitting the sequence across blocks (split-K with a combine pass) and
//   asynchronous copies are the next steps.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kTile = 16;  // tokens per tile; <= 32 (one lane per token in the softmax)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's mask value

__host__ __device__ inline size_t smem_floats(int G, int D) {
  // q, acc (G*D each); K, V tiles (kTile*D each); scores (G*kTile); m, l, corr (G each)
  return 2 * static_cast<size_t>(G) * D + 2 * static_cast<size_t>(kTile) * D +
         static_cast<size_t>(G) * kTile + 3 * static_cast<size_t>(G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV, int D,
                    int bs, int T_blocks, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int b = blockIdx.x, kvh = blockIdx.y;
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
  len = len < 0 ? 0 : (len > T_blocks * bs ? T_blocks * bs : len);
  const int* tab = tables + static_cast<long long>(b) * T_blocks;
  const long long head0 = (static_cast<long long>(b) * H + static_cast<long long>(kvh) * G) * D;

  for (int i = tid; i < G * D; i += blockDim.x) {
    sq[i] = to_f32(q[head0 + i]);
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = len - t0 < kTile ? len - t0 : kTile;
    for (int i = tid; i < n * D; i += blockDim.x) {
      const int r = i / D, e = i - r * D;
      const int p = t0 + r;
      const long long row =
          (static_cast<long long>(tab[p / bs]) * bs + p % bs) * KV + kvh;
      sk[i] = to_f32(k_pool[row * D + e]);
      sv[i] = to_f32(v_pool[row * D + e]);
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
      const float s = lane < n ? ss[g * kTile + lane] : kNegInf;
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

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    out[head0 + i] = from_f32<T>(sacc[i] / fmaxf(sl[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* lengths, void* out, int B, int H, int KV, int D, int bs,
                   int T_blocks, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, KV);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, static_cast<T*>(out), H, KV, D, bs, T_blocks, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the device's limit before launching).
extern "C" long long repro_paged_decode_smem_bytes(int G, int D) {
  return static_cast<long long>(repro::smem_floats(G, D) * sizeof(float));
}

// q (B, H, D), pools (N, bs, KV, D) and out (B, H, D) in `dtype`;
// tables (B, T) and lengths (B,) int32.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int repro_paged_decode_attention(int device, int dtype, const void* q,
                                            const void* k_pool, const void* v_pool,
                                            const void* tables, const void* lengths, void* out,
                                            int B, int H, int KV, int D, int bs, int T_blocks,
                                            float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const int*>(tables);
  auto len = static_cast<const int*>(lengths);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k_pool, v_pool, tab, len, out, B, H, KV, D, bs, T_blocks,
                                scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k_pool, v_pool, tab, len, out, B, H, KV, D, bs,
                                        T_blocks, scale, s);
  return cudaErrorInvalidValue;
}
