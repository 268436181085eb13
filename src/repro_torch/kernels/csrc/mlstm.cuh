// Helpers shared by the mLSTM kernels (csrc/mlstm_chunk.cu, the forward,
// and csrc/mlstm_chunk_bwd.cu, the backward): the workspace of carries,
// the per-chunk gate arithmetic, and the f32 passes' asynchronous copies.  Both passes of both kernels take the
// chunk's cumsum and carry weights from these functions, so every block
// that needs them gets the same bits, and the backward recomputes exactly
// the forward's stabilizers.
#pragma once

#include "common.cuh"

namespace repro {
namespace {

constexpr int kMaxChunk = 128;
constexpr int kMaxDk = 512;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The workspace: for each (batch * head, chunk) entry p the carry entering
// that chunk, with dkp = dk rounded up to 16.  C's dkp^2 floats hold
// C[d][e] row-major (f32 variant, rows of dk) or in units of mma fragment
// order (bf16 variant, below).
struct Carry {
  float* C;  // [P][dkp * dkp]
  float* n;  // [P][dkp]
  float* m;  // [P]
};
__host__ __device__ inline Carry carry_of(float* ws, long long P, int dkp) {
  Carry w;
  w.C = ws;
  w.n = ws + P * dkp * dkp;
  w.m = w.n + P * dkp;
  return w;
}

// Inclusive cumsum of src[0], src[stride], ... (c values) into cs[0..c), by
// one warp in a fixed order: lane l sums its run of ceil(c / 32) values in
// order, the lanes' run totals are scanned with shuffles.
__device__ void warp_cumsum(const float* src, long long stride, float* cs, int c, int lane) {
  constexpr int kRun = kMaxChunk / 32;
  const int per = (c + 31) >> 5, j0 = lane * per;
  float loc[kRun];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int j = j0 + u;
    loc[u] = u < per && j < c ? src[j * stride] : 0.f;
    run += loc[u];
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  float acc = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) acc = 0.f;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int j = j0 + u;
    if (u < per && j < c) {
      acc += loc[u];
      cs[j] = acc;
    }
  }
}

// The carry's move to the chunk's end, by one warp: the weight w[j] of
// k_j v_j (0 for j in [c, rows)), the decay of the old carry and m'.
__device__ void warp_carry(const float* cs, const float* li, float* w, int c, int rows, float m,
                           int lane, float* decay, float* m_next) {
  const float total = cs[c - 1];
  float dmax = -INFINITY;
  for (int j = lane; j < c; j += 32) dmax = fmaxf(dmax, total - cs[j] + li[j]);
  const float mn = fmaxf(m + total, warp_max(dmax));
  for (int j = lane; j < rows; j += 32) w[j] = j < c ? expf(total - cs[j] + li[j] - mn) : 0.f;
  if (lane == 0) {
    *decay = expf(m + total - mn);
    *m_next = mn;
  }
}

// Four floats of a row at `src`, element `col` of `valid` on (zero past
// it; no byte past it is read, and `any` stands in for the source then):
// one 16-byte cp.async piece with `vec`, else four 4-byte ones.
__device__ __forceinline__ void copy4(float* dst, const float* src, const float* any, int col,
                                      int valid, bool vec) {
  if (vec) {
    cp_async16(dst, col < valid ? src : any, col < valid);
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) cp_async4(dst + x, col + x < valid ? src + x : any, col + x < valid);
  }
}

// Eight bytes (two floats) from global to shared memory, asynchronously;
// zero-filled when `valid` is false (no source byte is read then).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

}  // namespace
}  // namespace repro
