// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * (1 + scale), with the
// statistics in f32 and the result written in x's dtype.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once for about four flops, two orders of magnitude under the card's
// ridge.  At the serving path's shapes (8 rows of 2048, or 64*8 rows of
// 128) the whole tensor is tens of KB, so one launch is latency bound: the
// least it can take is one memory round trip for the loads and one for the
// stores.
//
// Design, for the widths the configs use (128 ... 6144; `Plan` below):
// - a group of LANES lanes owns a row.  Each lane loads VPL 16-byte
//   vectors of the row (8 bf16 or 4 f32; vector v * LANES + lane, so
//   neighbouring lanes read neighbouring bytes), and the matching f32
//   `scale` vectors, all before any arithmetic, and keeps them in
//   registers: the row is read once, and the write reuses the registers;
// - the f32 sum of squares is reduced with xor shuffles inside the group:
//   no shared memory, no barrier.  LANES is the fewest lanes that keep a
//   lane's share of x and scale within about 96 registers.  Rows of 2560
//   and more in f32 (4096 and more in bf16) need 64 or 128 lanes: there
//   the two or four warps of a row add their partial sums through shared
//   memory behind a named barrier of just those warps;
// - a block holds several groups (rows), and the launch narrows its blocks
//   (down to one group) until the grid has two blocks per SM, so the
//   decode shapes spread over as many SMs as they have rows;
// - every sum runs in one fixed order, so two launches give equal bits.
// Any other width, or a row pointer that is not 16-byte aligned, takes the
// scalar variant: one warp a row, strided 2-byte or 4-byte loads, a second
// pass over the row (from L1) for the write.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;  // the most threads a block takes

// The lanes that own a row of NVEC 16-byte vectors: the fewest (8 ... 128)
// that divide the row evenly with at most VMAX vectors a lane.
constexpr int pick_lanes(int nvec, int vmax) {
  for (int lanes = 8; lanes <= 128; lanes *= 2)
    if (nvec % lanes == 0 && nvec / lanes <= vmax) return lanes;
  return 0;
}

template <typename T, int D>
struct Plan {
  static constexpr int kEpv = 16 / static_cast<int>(sizeof(T));  // elements a vector
  // registers a vector costs: 4 of x and kEpv of f32 scale
  static constexpr int kVmax = sizeof(T) == 2 ? 8 : 12;
  static constexpr int kLanes = pick_lanes(D / kEpv, kVmax);
  static constexpr int kVpl = D / kEpv / (kLanes > 0 ? kLanes : 1);
  static_assert(D % kEpv == 0 && kLanes > 0, "no register plan for this width");
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void unpack(const uint4& v, float* f, const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, const __nv_bfloat16*) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
                   int rows, float eps) {
  using P = Plan<T, D>;
  constexpr int kLanes = P::kLanes, kVpl = P::kVpl, kEpv = P::kEpv;
  constexpr int kSpv = kEpv / 4;  // f32 scale vectors per x vector
  const int tid = threadIdx.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const int row = static_cast<int>(gtid / kLanes);
  const int lane = static_cast<int>(gtid % kLanes);
  // a row's group stays whole even past the last row: it loads zeros and
  // stores nothing, and still meets its shuffles and barrier
  const bool valid = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * D);
  const float4* sr = reinterpret_cast<const float4*>(scale);

  uint4 xv[kVpl];
  float4 sv[kVpl * kSpv];
#pragma unroll
  for (int v = 0; v < kVpl; ++v)
    xv[v] = valid ? __ldg(xr + v * kLanes + lane) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int v = 0; v < kVpl; ++v)
#pragma unroll
    for (int s = 0; s < kSpv; ++s) sv[v * kSpv + s] = __ldg(sr + (v * kLanes + lane) * kSpv + s);

  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < kVpl; ++v) {
    float f[kEpv];
    unpack(xv[v], f, static_cast<const T*>(nullptr));
#pragma unroll
    for (int e = 0; e < kEpv; ++e) ss = fmaf(f[e], f[e], ss);
  }
  constexpr int kWidth = kLanes < 32 ? kLanes : 32;
  const unsigned mask = kWidth == 32 ? 0xffffffffu
                                     : ((1u << kWidth) - 1u) << ((tid & 31) & ~(kWidth - 1));
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(mask, ss, o);
  if constexpr (kLanes > 32) {  // the row's warps add their sums in warp order
    constexpr int kWarpsPerRow = kLanes / 32;
    __shared__ float part[kThreads / 32];
    const int team = tid / kLanes;
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    named_barrier(1 + team, kLanes);
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) ss += part[team * kWarpsPerRow + w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  if (!valid) return;
  uint4* yr = reinterpret_cast<uint4*>(out + static_cast<long long>(row) * D);
#pragma unroll
  for (int v = 0; v < kVpl; ++v) {
    float f[kEpv];
    unpack(xv[v], f, static_cast<const T*>(nullptr));
    const float* s = reinterpret_cast<const float*>(&sv[v * kSpv]);
#pragma unroll
    for (int e = 0; e < kEpv; ++e) f[e] = f[e] * inv * (1.f + s[e]);
    yr[v * kLanes + lane] = pack(f, static_cast<const T*>(nullptr));
  }
}

// Any width and alignment: one warp a row, two passes over it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      T* __restrict__ out, int rows, int d, float eps) {
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int row = static_cast<int>(gtid >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + static_cast<long long>(row) * d;
  T* yr = out + static_cast<long long>(row) * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32) yr[i] = from_f32<T>(to_f32(xr[i]) * inv * (1.f + scale[i]));
}

int sm_count(int device) {
  static int cached[64];
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

// Threads a block for `units` groups of `unit` threads: as many groups as
// fit kThreads, halved while the grid has fewer than two blocks an SM.
int block_threads(long long units, int unit, int sms) {
  int per = kThreads / unit;
  while (per > 1 && (units + per - 1) / per < 2LL * sms) per /= 2;
  return per * unit;
}

template <typename T, int D>
cudaError_t launch_vec(const void* x, const void* scale, void* out, int rows, float eps,
                       int sms, cudaStream_t stream) {
  constexpr int kLanes = Plan<T, D>::kLanes;
  const int unit = kLanes < 32 ? 32 : kLanes;
  const long long threads_total = static_cast<long long>(rows) * kLanes;
  const int threads = block_threads((threads_total + unit - 1) / unit, unit, sms);
  const long long blocks = (threads_total + threads - 1) / threads;
  rmsnorm_vec_kernel<T, D><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), rows,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   int sms, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
        reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (aligned) {
    switch (d) {
      case 128: return launch_vec<T, 128>(x, scale, out, rows, eps, sms, stream);
      case 256: return launch_vec<T, 256>(x, scale, out, rows, eps, sms, stream);
      case 768: return launch_vec<T, 768>(x, scale, out, rows, eps, sms, stream);
      case 1536: return launch_vec<T, 1536>(x, scale, out, rows, eps, sms, stream);
      case 2048: return launch_vec<T, 2048>(x, scale, out, rows, eps, sms, stream);
      case 2560: return launch_vec<T, 2560>(x, scale, out, rows, eps, sms, stream);
      case 4096: return launch_vec<T, 4096>(x, scale, out, rows, eps, sms, stream);
      case 5120: return launch_vec<T, 5120>(x, scale, out, rows, eps, sms, stream);
      case 6144: return launch_vec<T, 6144>(x, scale, out, rows, eps, sms, stream);
      default: break;
    }
  }
  const int threads = block_threads(rows, 32, sms);
  const long long blocks = (static_cast<long long>(rows) * 32 + threads - 1) / threads;
  rmsnorm_scalar_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), rows, d,
      eps);
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
  const int sms = repro::sm_count(device);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return repro::launch<float>(x, scale, out, rows, d, eps, sms, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(x, scale, out, rows, d, eps, sms, s);
  return cudaErrorInvalidValue;
}
