// RG-LRU linear recurrence, backward, for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas
// TPU kernel has no backward; the reference differentiates its associative
// scan, src/repro/models/recurrent.py:229-249).  For h_t = a_t h_{t-1} + b_t
// with a_t = exp(log_a_t) and h_{-1} = 0, given the forward's h and the
// output's gradient dh, all (B, S, C) f32, it runs the reverse linear scan
//   g_t = dh_t + a_{t+1} g_{t+1}   (g past the end is 0),
// and writes db_t = g_t and dlog_a_t = g_t * a_t * h_{t-1}.
//
// What bounds it on the H100: bytes.  Three f32 reads (log_a, h, dh) and two
// writes (dlog_a, db) an element, 20 bytes for a few flops: at
// recurrentgemma-9b's (1, 4096, 4096) 336 MB, a 0.100 ms bound at 3.35 TB/s.
//
// Design: the forward kernel's (csrc/rglru_scan.cu), run backwards in time.
// - a block owns kLanes = 32 channels of one batch row and walks its stages
//   of kSteps time steps from the last to the first, so g never leaves the
//   block;
// - its scan warp keeps one channel's g in each lane's register and runs
//   the dependent chain (one FMA a step) over a stage held in shared
//   memory, overwriting dh with g;
// - its three helper warps keep kDepth stages ahead in flight with cp.async
//   into a ring of kDepth + 2 slots of three tiles (log_a, dh, and h shifted
//   one step back, so row t of a stage holds h_{t-1}: 0 at t = 0), 196,608
//   bytes; each helper exponentiates the pieces of log_a it copied, and
//   stores a finished stage: db = g and dlog_a = g * a * h_{t-1} (16 bytes
//   a thread and array);
// - one barrier a stage, as in the forward: in iteration i the scan warp
//   runs stage i (counted from the end) while the helpers issue stage
//   i + kDepth, store stage i - 1 and exponentiate stage i + 1;
// - each step is fma(a_{t+1}, g, dh_t), and a_{t+1} of a stage's last row
//   is carried from the stage after it in a register, so the result does
//   not depend on the stage length and two calls agree bit for bit; no
//   atomics;
// - steps past S load as zero (exp(0) = 1, dh = 0: g stays 0 until the
//   last real step) and channels past C likewise; neither is stored.
//   Rows whose channels are not whole 16-byte pieces from 16-byte aligned
//   bases take 4-byte copies (kVec = 1).  Any B <= 65535, S, C.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kLanes = 32;        // channels of a block: one a lane of the scan warp
constexpr int kHelpers = 3 * 32;  // threads of the helper warps
constexpr int kThreads = 32 + kHelpers;
constexpr int kSteps = 128;  // time steps of a stage
constexpr int kDepth = 2;    // stages of loads in flight ahead of the scan
constexpr int kSlots = kDepth + 2;
constexpr int kTile = kSteps * kLanes;
constexpr size_t kSmemBytes = kSlots * 3 * kTile * sizeof(float);  // (a, dh then g, h_{t-1})

template <int kVec>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ log_a, const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ dlog_a,
                      float* __restrict__ db, int S, int C) {
  constexpr int kPieces = kTile / kVec;  // copies of one input's stage
  extern __shared__ float4 smem_v4[];
  float* smem = reinterpret_cast<float*>(smem_v4);
  const int c0 = blockIdx.x * kLanes;
  const long long row0 = static_cast<long long>(blockIdx.y) * S;  // the batch row's first step
  const int stages = (S + kSteps - 1) / kSteps;
  const int tid = threadIdx.x;
  // the i-th stage from the end, and its slot: exp(log_a), dh (then g), h_{t-1}
  auto stage_of = [&](int i) { return stages - 1 - i; };
  auto slot_a = [&](int i) { return smem + (i % kSlots) * 3 * kTile; };

  // piece p of stage k: smem offset p * kVec, time step t, channel c
  auto where = [&](int k, int p, int& t, long long& off) {
    const int r = p * kVec / kLanes, c = c0 + p * kVec % kLanes;
    t = k * kSteps + r;
    off = (row0 + t) * C + c;
    return t < S && c < C;  // kVec = 4: C is whole pieces, so all or none
  };
  auto load = [&](int i) {
    float* a = slot_a(i);
    const int k = stage_of(i);
    for (int p = tid - 32; p < kPieces; p += kHelpers) {
      int t;
      long long off;
      const bool ok = where(k, p, t, off);
      const bool prev = ok && t > 0;  // h_{t-1}; zero at t = 0
      const long long poff = prev ? off - C : 0;
      if (!ok) off = 0;  // zero-filled: no byte is read
      if (kVec == 4) {
        cp_async16(a + p * 4, log_a + off, ok);
        cp_async16(a + kTile + p * 4, dh + off, ok);
        cp_async16(a + 2 * kTile + p * 4, h + poff, prev);
      } else {
        cp_async4(a + p, log_a + off, ok);
        cp_async4(a + kTile + p, dh + off, ok);
        cp_async4(a + 2 * kTile + p, h + poff, prev);
      }
    }
  };
  auto exponentiate = [&](int i) {  // the pieces this thread copied
    float* a = slot_a(i);
    for (int p = tid - 32; p < kPieces; p += kHelpers) {
      if (kVec == 4) {
        float4 v = *reinterpret_cast<float4*>(a + p * 4);
        v.x = expf(v.x);
        v.y = expf(v.y);
        v.z = expf(v.z);
        v.w = expf(v.w);
        *reinterpret_cast<float4*>(a + p * 4) = v;
      } else {
        a[p] = expf(a[p]);
      }
    }
  };
  auto store = [&](int i) {
    const float* a = slot_a(i);
    const float* g = a + kTile;
    const float* hp = a + 2 * kTile;
    const int k = stage_of(i);
    for (int p = tid - 32; p < kPieces; p += kHelpers) {
      int t;
      long long off;
      if (!where(k, p, t, off)) continue;
      if (kVec == 4) {
        const float4 gv = *reinterpret_cast<const float4*>(g + p * 4);
        const float4 av = *reinterpret_cast<const float4*>(a + p * 4);
        const float4 hv = *reinterpret_cast<const float4*>(hp + p * 4);
        *reinterpret_cast<float4*>(db + off) = gv;
        *reinterpret_cast<float4*>(dlog_a + off) =
            make_float4(gv.x * av.x * hv.x, gv.y * av.y * hv.y, gv.z * av.z * hv.z,
                        gv.w * av.w * hv.w);
      } else {
        db[off] = g[p];
        dlog_a[off] = g[p] * a[p] * hp[p];
      }
    }
  };

  if (tid >= 32) {  // prologue: the last kDepth stages in flight, the last exponentiated
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (i < stages) load(i);
      cp_async_commit();
    }
    cp_async_wait_group<kDepth - 1>();
    exponentiate(0);
  }
  __syncthreads();
  float grad = 0.f, a_next = 0.f;
  for (int i = 0; i <= stages; ++i) {
    if (tid < 32) {
      if (i < stages) {
        const float* a = slot_a(i);
        float* gb = slot_a(i) + kTile;
#pragma unroll 16
        for (int t = kSteps - 1; t >= 0; --t) {
          grad = fmaf(a_next, grad, gb[t * kLanes + tid]);
          gb[t * kLanes + tid] = grad;
          a_next = a[t * kLanes + tid];
        }
      }
    } else {
      if (i + kDepth < stages) load(i + kDepth);
      // one group an iteration, empty or not, so that waiting for all but
      // the newest kDepth - 1 groups means stage i + 1 has landed
      cp_async_commit();
      if (i > 0) store(i - 1);
      cp_async_wait_group<kDepth - 1>();
      if (i + 1 < stages) exponentiate(i + 1);
    }
    __syncthreads();
  }
}

template <int kVec>
cudaError_t launch(const float* log_a, const float* h, const float* dh, float* dlog_a, float* db,
                   int B, int S, int C, cudaStream_t stream) {
  auto kernel = rglru_scan_bwd_kernel<kVec>;
  cudaError_t err = set_max_dynamic_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((C + kLanes - 1) / kLanes, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(log_a, h, dh, dlog_a, db, S, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// log_a, h (the forward's output), dh, dlog_a, db (B, S, C) f32, contiguous.
// Returns the CUDA error of the launch (0 on success):
// cudaErrorInvalidConfiguration for B > 65535.
extern "C" int repro_rglru_scan_bwd(int device, const void* log_a, const void* h, const void* dh,
                                    void* dlog_a, void* db, int B, int S, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidConfiguration;
  if (B == 0 || S == 0 || C == 0) return cudaSuccess;
  auto la = static_cast<const float*>(log_a);
  auto hh = static_cast<const float*>(h);
  auto g = static_cast<const float*>(dh);
  auto dla = static_cast<float*>(dlog_a);
  auto dbb = static_cast<float*>(db);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      !((reinterpret_cast<uintptr_t>(log_a) | reinterpret_cast<uintptr_t>(h) |
         reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(dlog_a) |
         reinterpret_cast<uintptr_t>(db)) & 15u);
  return C % 4 == 0 && aligned ? repro::launch<4>(la, hh, g, dla, dbb, B, S, C, s)
                               : repro::launch<1>(la, hh, g, dla, dbb, B, S, C, s);
}
