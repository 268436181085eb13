// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * (1 + scale), with the
// statistics in f32 and the result written in x's dtype.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once for about four flops, two orders of magnitude under the card's
// ridge.  At the serving path's shapes (8 rows of 2048, or 64*8 rows of
// 128) the whole tensor is tens of KB, so one launch is latency bound.
//
// Design: one thread block per row.  Each thread strides over the row, so
// neighbouring threads read neighbouring elements (coalesced); the f32 sum
// of squares is reduced with warp shuffles, then across warps through
// shared memory in a fixed order (deterministic).  The second pass
// re-reads the row, which hits L1.  The block width follows the row width
// (32 threads for d=128, 256 for d=2048) so no thread idles for long.
#include "common.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* yr = out + static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_sums[w];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float y = to_f32(xr[i]) * inv;
    yr[i] = from_f32<T>(y * (1.f + scale[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  int threads = ((d / 8 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x (rows, d) and out (rows, d) in `dtype`; scale (d,) f32.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int repro_rmsnorm(int device, int dtype, const void* x, const void* scale, void* out,
                             int rows, int d, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return repro::launch<float>(x, scale, out, rows, d, eps, s);
  if (dtype == repro::kBFloat16) return repro::launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
