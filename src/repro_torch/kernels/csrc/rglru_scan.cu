// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel): h_t = exp(log_a_t) * h_{t-1} + b_t from h_{-1} = 0,
// elementwise over channels, log_a, b and h (B, S, C) f32.
//
// What bounds it on the H100: bytes.  It does 3 flops per element and moves
// 12 bytes (two f32 reads, one write), far below the ~20 flop/byte f32 ridge.
// At recurrentgemma-9b's prefill shape (1, 4096, 4096) that is 192 MiB, a
// 0.060 ms bound at 3.35 TB/s.
//
// Design, rather than a copy of the TPU grid (which walks time blocks as its
// innermost sequential axis and carries h in VMEM between grid steps):
// - one thread per (batch, channel) walks the whole sequence and keeps h in
//   a register, so nothing is carried between blocks.  A warp's 32 lanes are
//   32 neighbouring channels: every load and store is one 128-byte line;
// - one warp per block, so the C / 32 warps of a batch row spread over as
//   many SMs as there are (128 at C = 4096);
// - time runs in steps of kUnroll: the loads of the next step go out
//   before the current one's dependent chain of exp and FMA, so a load's
//   latency overlaps kUnroll links of the chain.  The ragged tail of S runs
//   one position at a time.  Any B, S, C.
// - Only B * C threads exist: 4,096 at recurrentgemma's prefill, which
//   leaves most of each SM's instruction slots idle.  A split of time into
//   chunks (local scans, a scan of the chunk carries, a fix-up) would use
//   more of the card; that is later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * C + c;
  const float* la = log_a + base;
  const float* bb = b + base;
  float* out = h + base;
  float state = 0.f;
  const int full = S - S % kUnroll;
  float a_cur[kUnroll], b_cur[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      a_cur[j] = la[static_cast<long long>(j) * C];
      b_cur[j] = bb[static_cast<long long>(j) * C];
    }
  }
  for (int t = 0; t < full; t += kUnroll) {
    // the next step's loads go out before this step's chain
    float a_nxt[kUnroll], b_nxt[kUnroll];
    const bool more = t + kUnroll < full;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long off = static_cast<long long>(t + kUnroll + j) * C;
      a_nxt[j] = more ? la[off] : 0.f;
      b_nxt[j] = more ? bb[off] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      state = expf(a_cur[j]) * state + b_cur[j];
      out[static_cast<long long>(t + j) * C] = state;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      a_cur[j] = a_nxt[j];
      b_cur[j] = b_nxt[j];
    }
  }
  for (int t = full; t < S; ++t) {
    const long long off = static_cast<long long>(t) * C;
    state = expf(la[off]) * state + bb[off];
    out[off] = state;
  }
}

}  // namespace
}  // namespace repro

// log_a, b, h (B, S, C) f32, contiguous.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int repro_rglru_scan(int device, const void* log_a, const void* b, void* h, int B,
                                int S, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || C == 0) return cudaSuccess;
  dim3 grid((C + repro::kThreads - 1) / repro::kThreads, B);
  repro::rglru_scan_kernel<<<grid, repro::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b), static_cast<float*>(h), S,
      C);
  return cudaGetLastError();
}
