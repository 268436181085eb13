// Chunkwise-parallel stabilized mLSTM, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py::mlstm_chunk
// (_mlstm_kernel), which mirrors models/recurrent.py::mlstm_chunk_recurrence:
// per (batch, head) the matrix memory C (dk x dk), the normalizer n (dk) and
// the stabilizer m are carried over chunks of c positions; within a chunk
//   csum = cumsum(log_f), D[i,j] = csum_i - csum_j + log_i_j (j <= i),
//   m_i = max(max_j D[i,j], csum_i + m),  W = (q k^T) * exp(D - m_i),
//   num = W v + exp(csum_i + m - m_i) q C,  den = rowsum(W) + (same) q.n,
//   h = num / max(|den|, exp(-m_i)),
// then (C, n, m) move to the chunk's end.  q (scaled by 1/sqrt(dk)), k, v
// (B, S, H, dk) f32 or bf16, log_i, log_f (B, S, H) f32; h (B, S, H, dk)
// f32; optionally the final C (B, H, dk, dk), n (B, H, dk), m (B, H).
// Everything is computed in f32.
//
// What bounds it on the H100: operations.  Per chunk and (batch, head) it
// does about 2 c^2 dk (q k^T, W v) + 4 c dk^2 (q C, the C update) flops on
// 3 c dk inputs; at xlstm-125m's (1, 2048, 4, 384), chunk 128, that is
// 6.4 GFLOP on 38 MB, above the f32 CUDA-core ridge (20 flop/byte).
//
// Design, rather than a copy of the TPU grid (one grid row per (batch,
// head), C in VMEM, chunks as the sequential axis):
// - C does not fit one SM at dk = 384 (576 KiB of f32), so its value
//   columns are split: one block per (batch x head, 32 value columns).  Its
//   slice C[:, e0:e0+32] (48 KiB at dk = 384) stays in shared memory for the
//   whole sequence, and it writes h[..., e0:e0+32];
// - every block recomputes the chunk's c x c score matrix q k^T over all of
//   dk (streamed in 32-wide tiles of q and k), the gates, the stabilizers,
//   the row sums of W and the full n, identically, so den and n agree
//   between the blocks of one head without communication;
// - q C and q.n are summed in the same pass over the q tiles; then one
//   warp per row masks and weights the scores; then W v and the output;
//   then the C and n update from k tiles weighted by the carry weights;
// - the products run in f32 on the CUDA cores.  A block holds the c x c
//   scores (c + 1 floats a row), C's slice, n, v's slice and the q, k tiles:
//   170,496 bytes at dk = 384, c = 128, so one block per SM.  Any dk up to
//   512 and any c up to 128; dk need not be a multiple of 32.
// - The grid is B * H * ceil(dk / 32) blocks: 48 at xlstm-125m's width,
//   against 132 SMs.  Tensor cores, and sharing q k^T between the column
//   blocks, are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;  // 8 warps; 16 x 16 for the score tile
constexpr int kWarps = kThreads / 32;
constexpr int kE = 32;          // value columns of C per block
constexpr int kTD = 32;         // dk columns per q / k tile
constexpr int kLdT = kTD + 1;   // pitch of the q / k tile rows
constexpr int kMaxChunk = 128;  // rows of the q / k tiles
constexpr int kMaxDk = 512;
constexpr int kRowsPerWarp = kMaxChunk / kWarps;  // 16

struct Layout {
  int lds;  // pitch of the score rows: c + 1
  size_t s, C, n, v, q, k, li, cs, mi, inter, rsum, qn, w, total;  // float offsets
};

__host__ __device__ inline Layout layout(int dk, int c) {
  Layout L;
  L.lds = c + 1;
  L.s = 0;
  L.C = L.s + static_cast<size_t>(c) * L.lds;
  L.n = L.C + static_cast<size_t>(dk) * kE;
  L.v = L.n + dk;
  L.q = L.v + static_cast<size_t>(c) * kE;
  L.k = L.q + static_cast<size_t>(kMaxChunk) * kLdT;
  L.li = L.k + static_cast<size_t>(kMaxChunk) * kLdT;
  L.cs = L.li + kMaxChunk;
  L.mi = L.cs + kMaxChunk;
  L.inter = L.mi + kMaxChunk;
  L.rsum = L.inter + kMaxChunk;
  L.qn = L.rsum + kMaxChunk;
  L.w = L.qn + kMaxChunk;
  L.total = L.w + kMaxChunk;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ log_i, const float* __restrict__ log_f,
                   float* __restrict__ h, float* __restrict__ C_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int H, int dk, int c, float scale) {
  extern __shared__ float smem[];
  const Layout L = layout(dk, c);
  float* sS = smem + L.s;
  float* sC = smem + L.C;
  float* sN = smem + L.n;
  float* sV = smem + L.v;
  float* sQ = smem + L.q;
  float* sK = smem + L.k;
  float* sLi = smem + L.li;
  float* sCs = smem + L.cs;
  float* sMi = smem + L.mi;
  float* sInter = smem + L.inter;
  float* sRsum = smem + L.rsum;
  float* sQn = smem + L.qn;
  float* sW = smem + L.w;
  __shared__ float sCarry[2];  // m_next, decay of the chunk's carry update

  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh - b * H;
  const int e0 = blockIdx.y * kE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int ecol = e0 + lane;
  const bool col_ok = ecol < dk;
  const long long tstride = static_cast<long long>(H) * dk;  // one position in q, k, v, h
  const long long head0 = (static_cast<long long>(b) * S * H + hh) * dk;
  const long long gate0 = static_cast<long long>(b) * S * H + hh;

  for (int i = tid; i < dk * kE; i += kThreads) sC[i] = 0.f;
  for (int i = tid; i < dk; i += kThreads) sN[i] = 0.f;
  float m = 0.f;

  // a 32-wide tile of q (scaled) or k (weighted by sW when `weights`) at
  // columns d0.., rows past c and columns past dk zero
  auto load_tile = [&](const T* src, float* dst, int t0, int d0, float mult, bool weights) {
    for (int i = tid; i < kMaxChunk * kTD; i += kThreads) {
      const int r = i / kTD, dd = i - r * kTD;
      float x = 0.f;
      if (r < c && d0 + dd < dk) {
        x = to_f32(src[head0 + (t0 + r) * tstride + d0 + dd]) * mult;
        if (weights) x *= sW[r];
      }
      dst[r * kLdT + dd] = x;
    }
  };

  for (int t0 = 0; t0 < S; t0 += c) {
    // 1. gates of the chunk; csum in order, as a sequential cumsum
    for (int j = tid; j < c; j += kThreads) {
      sLi[j] = log_i[gate0 + static_cast<long long>(t0 + j) * H];
      sCs[j] = log_f[gate0 + static_cast<long long>(t0 + j) * H];
    }
    for (int j = tid; j < c * kE; j += kThreads) {
      const int r = j / kE, e = j - r * kE;
      sV[j] = e0 + e < dk ? to_f32(v[head0 + (t0 + r) * tstride + e0 + e]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int j = 0; j < c; ++j) {
        run += sCs[j];
        sCs[j] = run;
      }
    }

    // 2. scores q k^T (rows ty + 16 a, columns tx + 16 b; the 16 x 16
    //    blocks above the diagonal are skipped), and for rows warp + 8 a:
    //    q C[:, this block's columns] and q.n, over dk tiles.  Each tile's
    //    32-term partial sums are added to the running ones (in sS for the
    //    scores), so a sum over dk rounds like 32 + dk / 32 terms, not dk
    float qc[kRowsPerWarp], qn[kRowsPerWarp];
#pragma unroll
    for (int a = 0; a < kRowsPerWarp; ++a) qc[a] = qn[a] = 0.f;
    for (int d0 = 0; d0 < dk; d0 += kTD) {
      __syncthreads();  // the previous tile is consumed (and csum is written)
      load_tile(q, sQ, t0, d0, scale, false);
      load_tile(k, sK, t0, d0, 1.f, false);
      __syncthreads();
      float acc[8][8], qct[kRowsPerWarp];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) acc[a][bb] = 0.f;
#pragma unroll
      for (int a = 0; a < kRowsPerWarp; ++a) qct[a] = 0.f;
      for (int dd = 0; dd < kTD; ++dd) {
        float qa[8], kb[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) qa[a] = sQ[(ty + 16 * a) * kLdT + dd];
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) kb[bb] = sK[(tx + 16 * bb) * kLdT + dd];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int bb = 0; bb <= a; ++bb) acc[a][bb] += qa[a] * kb[bb];
        const float cde = d0 + dd < dk ? sC[(d0 + dd) * kE + lane] : 0.f;
#pragma unroll
        for (int a = 0; a < kRowsPerWarp; ++a) qct[a] += sQ[(warp + kWarps * a) * kLdT + dd] * cde;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb <= a; ++bb) {
          const int i = ty + 16 * a, j = tx + 16 * bb;
          if (i < c && j < c) sS[i * L.lds + j] = d0 == 0 ? acc[a][bb] : sS[i * L.lds + j] + acc[a][bb];
        }
#pragma unroll
      for (int a = 0; a < kRowsPerWarp; ++a) qc[a] += qct[a];
      const float nd = d0 + lane < dk ? sN[d0 + lane] : 0.f;
#pragma unroll
      for (int a = 0; a < kRowsPerWarp; ++a) qn[a] += sQ[(warp + kWarps * a) * kLdT + lane] * nd;
    }
#pragma unroll
    for (int a = 0; a < kRowsPerWarp; ++a) {
      const float s = warp_sum(qn[a]);
      const int i = warp + kWarps * a;
      if (lane == 0 && i < c) sQn[i] = s;
    }
    __syncthreads();

    // 3. one warp per row: the masked log weights D, the stabilizer m_i,
    //    W = scores * exp(D - m_i) (0 above the diagonal) and its row sum
    for (int i = warp; i < c; i += kWarps) {
      const float csi = sCs[i];
      const float g = csi + m;
      float dmax = -INFINITY;
      for (int j = lane; j <= i; j += 32) dmax = fmaxf(dmax, csi - sCs[j] + sLi[j]);
      const float mi = fmaxf(warp_max(dmax), g);
      float rsum = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float w = j <= i ? sS[i * L.lds + j] * expf(csi - sCs[j] + sLi[j] - mi) : 0.f;
        sS[i * L.lds + j] = w;
        rsum += w;
      }
      rsum = warp_sum(rsum);
      if (lane == 0) {
        sMi[i] = mi;
        sInter[i] = expf(g - mi);
        sRsum[i] = rsum;
      }
    }
    __syncthreads();

    // 4. h = (W v + inter * q C) / max(|rowsum W + inter * q.n|, exp(-m_i))
    //    for rows warp + 8 a and this block's columns
#pragma unroll
    for (int a = 0; a < kRowsPerWarp; ++a) {
      const int i = warp + kWarps * a;
      if (i >= c) break;
      const float* srow = sS + i * L.lds;
      float num = 0.f;
      for (int j0 = 0; j0 <= i; j0 += 32) {  // 32-term partial sums
        const int jend = min(i + 1, j0 + 32);
        float part = 0.f;
        for (int j = j0; j < jend; ++j) part += srow[j] * sV[j * kE + lane];
        num += part;
      }
      const float inter = sInter[i];
      num += inter * qc[a];
      const float den = sRsum[i] + inter * sQn[i];
      if (col_ok)
        h[head0 + (t0 + i) * tstride + ecol] = num / fmaxf(fabsf(den), expf(-sMi[i]));
    }

    // 5. the carry to the chunk's end: dec_j = total - csum_j + log_i_j,
    //    m_next = max(m + total, max_j dec_j), w_j = exp(dec_j - m_next)
    if (warp == 0) {
      const float total = sCs[c - 1];
      float dmax = -INFINITY;
      for (int j = lane; j < c; j += 32) dmax = fmaxf(dmax, total - sCs[j] + sLi[j]);
      const float m_next = fmaxf(m + total, warp_max(dmax));
      for (int j = lane; j < c; j += 32) sW[j] = expf(total - sCs[j] + sLi[j] - m_next);
      if (lane == 0) {
        sCarry[0] = m_next;
        sCarry[1] = expf(m + total - m_next);
      }
    }
    __syncthreads();
    const float decay = sCarry[1];
    m = sCarry[0];
    // C[d, cols] = decay * C + sum_j (w_j k_j[d]) v_j[cols];  n[d] = decay * n
    // + sum_j w_j k_j[d].  Warp w takes rows d0 + 4 w .. d0 + 4 w + 3 of each
    // tile, the four together (one v load feeds four products), in 32-term
    // partial sums
    constexpr int kR = kTD / kWarps;
    for (int d0 = 0; d0 < dk; d0 += kTD) {
      __syncthreads();  // the previous tile (or step 2's) is consumed
      load_tile(k, sK, t0, d0, 1.f, true);
      __syncthreads();
      const int dd0 = warp * kR;
      float cacc[kR], nacc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) cacc[r] = nacc[r] = 0.f;
      for (int j0 = 0; j0 < c; j0 += 32) {
        const int jend = min(c, j0 + 32);
        float part[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) part[r] = 0.f;
        for (int j = j0; j < jend; ++j) {
          const float vj = sV[j * kE + lane];
#pragma unroll
          for (int r = 0; r < kR; ++r) part[r] += sK[j * kLdT + dd0 + r] * vj;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) cacc[r] += part[r];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        for (int j = lane; j < c; j += 32) nacc[r] += sK[j * kLdT + dd0 + r];
        nacc[r] = warp_sum(nacc[r]);
        const int d = d0 + dd0 + r;
        if (d < dk) {
          sC[d * kE + lane] = decay * sC[d * kE + lane] + cacc[r];
          if (lane == 0) sN[d] = decay * sN[d] + nacc[r];
        }
      }
    }
    __syncthreads();  // C, n and m are the next chunk's carry
  }

  if (C_out != nullptr) {
    for (int d = warp; d < dk; d += kWarps)
      if (col_ok) C_out[(static_cast<long long>(bh) * dk + d) * dk + ecol] = sC[d * kE + lane];
    if (blockIdx.y == 0) {
      for (int d = tid; d < dk; d += kThreads) n_out[static_cast<long long>(bh) * dk + d] = sN[d];
      if (tid == 0) m_out[bh] = m;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* li, const float* lf,
                   float* h, float* C, float* n, float* m, int B, int S, int H, int dk, int c,
                   float scale, cudaStream_t stream) {
  const size_t smem = layout(dk, c).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (dk + kE - 1) / kE);
  mlstm_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), li, lf, h, C,
      n, m, S, H, dk, c, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

extern "C" int repro_mlstm_chunk_max_dk() { return repro::kMaxDk; }
extern "C" int repro_mlstm_chunk_max_chunk() { return repro::kMaxChunk; }

// q, k, v (B, S, H, dk) in `dtype`; log_i, log_f (B, S, H) f32; h (B, S, H,
// dk) f32; C (B, H, dk, dk), n (B, H, dk), m (B, H) f32, all three null or
// none.  c divides S.  Returns the CUDA error of the launch (0 on success).
extern "C" int repro_mlstm_chunk(int device, int dtype, const void* q, const void* k,
                                 const void* v, const void* log_i, const void* log_f, void* h,
                                 void* C, void* n, void* m, int B, int S, int H, int dk, int c,
                                 float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (dk <= 0 || dk > repro::kMaxDk || c <= 0 || c > repro::kMaxChunk || S % c)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto li = static_cast<const float*>(log_i);
  auto lf = static_cast<const float*>(log_f);
  auto hp = static_cast<float*>(h);
  auto Cp = static_cast<float*>(C);
  auto np = static_cast<float*>(n);
  auto mp = static_cast<float*>(m);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, li, lf, hp, Cp, np, mp, B, S, H, dk, c, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, li, lf, hp, Cp, np, mp, B, S, H, dk, c, scale, s);
  return cudaErrorInvalidValue;
}
