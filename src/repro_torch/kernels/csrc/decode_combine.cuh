// The combine pass shared by the split-K decode kernels (dense:
// decode_attention.cu, paged: paged_decode_attention.cu).  Each split block
// of one (sequence, head) leaves its unnormalised online-softmax partial:
// acc (B, H, nsplit, D) f32 and (m, l) (B, H, nsplit, 2) f32.  A split that
// held no valid position leaves m = -1e30, l = 0 and may leave acc unwritten:
// its weight is 0 and its acc is never read.
//   out = sum_c acc_c e^(m_c - M) / max(sum_c l_c e^(m_c - M), 1e-30),
// summed over c in order, so the result does not depend on the launch.
// Where `lse` (B, H) f32 is given, it also writes M + log(sum_c l_c e^(m_c -
// M)), the log-sum-exp of the row's scaled scores, or -1e30 for a row with
// no valid position.  The same pass merges the partials of ranks that each
// attended a slice of the cache (decode_attention.cu's repro_decode_merge):
// a rank's normalised output as acc, m its log-sum-exp and l 1 (0 for an
// empty slice) give sum_r o_r e^(lse_r - M) / sum_r e^(lse_r - M).
#pragma once

#include "common.cuh"

namespace repro {
namespace {

constexpr int kCombineThreads = 256;

// One block per (head, sequence); dynamic shared memory: 2 * nsplit words.
// Warp 0 lists the non-empty splits with their weights e^(m_c - M) and
// sums the denominator; then each thread adds the listed splits' acc for
// its elements, in split order, eight loads in flight at a time.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      T* __restrict__ out, float* __restrict__ lse, int H, int D,
                      int nsplit) {
  extern __shared__ float sw[];  // (nsplit,) weights of the listed splits
  int* sidx = reinterpret_cast<int*>(sw + nsplit);  // (nsplit,) their indices, in order
  __shared__ int s_count;
  __shared__ float s_den;
  const long long bh = static_cast<long long>(blockIdx.y) * H + blockIdx.x;
  const float* ml = part_ml + 2 * bh * nsplit;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    float m_all = -1e30f;
    for (int c = lane; c < nsplit; c += 32) m_all = fmaxf(m_all, ml[2 * c]);
    m_all = warp_max(m_all);
    int count = 0;
    for (int c0 = 0; c0 < nsplit; c0 += 32) {
      const int c = c0 + lane;
      const bool full = c < nsplit && ml[2 * c + 1] > 0.f;
      const unsigned mask = __ballot_sync(0xffffffffu, full);
      if (full) {
        const int at = count + __popc(mask & ((1u << lane) - 1));
        sidx[at] = c;
        sw[at] = expf(ml[2 * c] - m_all);
      }
      count += __popc(mask);
    }
    __syncwarp();
    if (lane == 0) {
      float l_all = 0.f;
      for (int i = 0; i < count; ++i) l_all += ml[2 * sidx[i] + 1] * sw[i];
      s_den = fmaxf(l_all, 1e-30f);
      s_count = count;
      if (lse != nullptr) lse[bh] = count > 0 ? m_all + logf(l_all) : -1e30f;
    }
  }
  __syncthreads();
  const int count = s_count;
  const float den = s_den;
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    const float* pa = part_acc + bh * nsplit * D + e;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < count; ++i) a += pa[static_cast<long long>(sidx[i]) * D] * sw[i];
    out[bh * D + e] = from_f32<T>(a / den);
  }
}

template <typename T>
cudaError_t launch_decode_combine(const float* part_acc, const float* part_ml, void* out, int B,
                                  int H, int D, int nsplit, cudaStream_t stream,
                                  float* lse = nullptr) {
  decode_combine_kernel<T><<<dim3(H, B), kCombineThreads, 2 * nsplit * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<T*>(out), lse, H, D, nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro
