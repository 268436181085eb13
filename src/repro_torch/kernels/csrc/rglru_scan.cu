// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel): h_t = exp(log_a_t) * h_{t-1} + b_t from h_{-1} = 0,
// elementwise over channels, log_a, b and h (B, S, C) f32.
//
// What bounds it on the H100: bytes.  It does 3 flops per element and moves
// 12 bytes (two f32 reads, one write), far below the ~20 flop/byte f32 ridge.
// At recurrentgemma-9b's prefill shape (1, 4096, 4096) that is 192 MiB, a
// 0.060 ms bound at 3.35 TB/s.  Reaching it needs some 2-3 MB of loads in
// flight across the card (Little's law at a loaded DRAM latency near 1 us),
// yet a batch row of 4,096 channels has only 4,096 independent recurrences.
//
// Design:
// - a block owns kLanes = 32 channels of one batch row and walks the whole
//   sequence in stages of kSteps time steps, so h never leaves the block;
// - its scan warp keeps one channel's h in each lane's register and runs the
//   dependent chain (one FMA a step) over a stage held in shared memory;
// - its three helper warps keep the stages kDepth ahead in flight with
//   cp.async into a ring of kDepth + 2 slots: at 128 steps and depth 2 that
//   is 64 KB of loads in flight a block (one block an SM at recurrentgemma's
//   128 blocks) in 128 KB of slots.  Each helper thread exponentiates the
//   pieces of log_a it copied itself (cp.async is visible to its issuer
//   after the wait) and stores the pieces of a finished stage's h, 16 bytes
//   a thread, every row of a stage one 128-byte line;
// - one barrier a stage: in iteration i the scan warp scans stage i while
//   the helpers issue stage i + kDepth, store stage i - 1 and exponentiate
//   stage i + 1.  The slot of stage i + kDepth last held stage i - 2, whose
//   store ended before the barrier, so kDepth + 2 slots suffice;
// - each step is fma(expf(log_a), h, b), as in a plain sequential loop, so
//   the result does not depend on the stage length and two calls agree bit
//   for bit;
// - channels past C and steps past S are zero-filled by the copies (exp(0) *
//   h + 0 leaves h as it is) and never stored.  Rows whose channels are not
//   whole 16-byte pieces from a 16-byte aligned base take the scalar variant
//   (kVec = 1: 4-byte copies and stores).  Any B <= 65535, S, C.
// 128 x 2 led the (steps, depth) pairs timed at
// recurrentgemma-9b's prefill shape (PERF.md, Findings).
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kLanes = 32;           // channels of a block: one a lane of the scan warp
constexpr int kHelpers = 3 * 32;     // threads of the helper warps
constexpr int kThreads = 32 + kHelpers;
constexpr int kSteps = 128;          // time steps of a stage
constexpr int kDepth = 2;            // stages of loads in flight ahead of the scan
constexpr int kSlots = kDepth + 2;
constexpr int kTile = kSteps * kLanes;
constexpr size_t kSmemBytes = kSlots * 2 * kTile * sizeof(float);  // slots of (a, b then h)

template <int kVec>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int C) {
  constexpr int kPieces = kTile / kVec;  // copies of one input's stage
  extern __shared__ float4 smem_v4[];
  float* smem = reinterpret_cast<float*>(smem_v4);
  const int c0 = blockIdx.x * kLanes;
  const long long row0 = static_cast<long long>(blockIdx.y) * S;  // the batch row's first step
  const int stages = (S + kSteps - 1) / kSteps;
  const int tid = threadIdx.x;
  // slot of stage k: exp(log_a), then b (overwritten by h in the scan)
  auto slot_a = [&](int k) { return smem + (k % kSlots) * 2 * kTile; };

  // piece p of a stage: smem offset p * kVec, time step t0 + r, channel c
  auto where = [&](int k, int p, long long& off) {
    const int r = p * kVec / kLanes, c = c0 + p * kVec % kLanes;
    const int t = k * kSteps + r;
    off = (row0 + t) * C + c;
    return t < S && c < C;  // kVec = 4: C is whole pieces, so all or none
  };
  auto load = [&](int k) {
    float* a = slot_a(k);
    for (int p = tid - 32; p < kPieces; p += kHelpers) {
      long long off;
      const bool ok = where(k, p, off);
      if (!ok) off = 0;  // zero-filled: no byte is read
      if (kVec == 4) {
        cp_async16(a + p * 4, log_a + off, ok);
        cp_async16(a + kTile + p * 4, b + off, ok);
      } else {
        cp_async4(a + p, log_a + off, ok);
        cp_async4(a + kTile + p, b + off, ok);
      }
    }
  };
  auto exponentiate = [&](int k) {  // the pieces this thread copied
    float* a = slot_a(k);
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
  auto store = [&](int k) {
    const float* hs = slot_a(k) + kTile;
    for (int p = tid - 32; p < kPieces; p += kHelpers) {
      long long off;
      if (!where(k, p, off)) continue;
      if (kVec == 4) {
        *reinterpret_cast<float4*>(h + off) = *reinterpret_cast<const float4*>(hs + p * 4);
      } else {
        h[off] = hs[p];
      }
    }
  };

  if (tid >= 32) {  // prologue: stages 0 .. kDepth - 1 in flight, stage 0 exponentiated
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (k < stages) load(k);
      cp_async_commit();
    }
    cp_async_wait_group<kDepth - 1>();
    exponentiate(0);
  }
  __syncthreads();
  float state = 0.f;
  for (int i = 0; i <= stages; ++i) {
    if (tid < 32) {
      if (i < stages) {
        float* a = slot_a(i);
        float* hb = a + kTile;
#pragma unroll 16
        for (int t = 0; t < kSteps; ++t) {
          state = a[t * kLanes + tid] * state + hb[t * kLanes + tid];
          hb[t * kLanes + tid] = state;
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
cudaError_t launch(const float* log_a, const float* b, float* h, int B, int S, int C,
                   cudaStream_t stream) {
  auto kernel = rglru_scan_kernel<kVec>;
  cudaError_t err = set_max_dynamic_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((C + kLanes - 1) / kLanes, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(log_a, b, h, S, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// log_a, b, h (B, S, C) f32, contiguous.  Returns the CUDA error of the
// launch (0 on success): cudaErrorInvalidConfiguration for B > 65535.
extern "C" int repro_rglru_scan(int device, const void* log_a, const void* b, void* h, int B,
                                int S, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidConfiguration;
  if (B == 0 || S == 0 || C == 0) return cudaSuccess;
  auto la = static_cast<const float*>(log_a);
  auto bb = static_cast<const float*>(b);
  auto hh = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte pieces where every row is whole pieces from 16-byte aligned bases
  const bool aligned = !((reinterpret_cast<uintptr_t>(log_a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(h)) & 15u);
  return C % 4 == 0 && aligned ? repro::launch<4>(la, bb, hh, B, S, C, s)
                               : repro::launch<1>(la, bb, hh, B, S, C, s);
}
