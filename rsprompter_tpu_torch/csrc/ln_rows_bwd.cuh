// The pieces that the backward kernels A' (ln_mlp_residual_bwd.cu) and B'
// (ln_qkv_headmajor_bwd.cu) share around the products of wgmma_gemm.cuh:
//  * load8 / store8: eight values as one 16-byte access;
//  * Frag, staged_bf16_epilogue, store_f32: a product tile's accumulators
//    written out (fragment order as in wgmma_gemm.cuh);
//  * ln_stats_kernel: z = bf16(LN(x)) and the row statistics;
//  * ln_bwd_rows_kernel: dx = bf16(LN-vjp(dz) [+ dO]) and per-block partial
//    column sums;
//  * bias_sums_kernel: those partial sums reduced in block order.
// The row kernels take rows of C = 256 V (V a template argument), one warp
// per row, lane l holding columns 256 v + 8 l .. + 7. Every sum is taken in
// a fixed order: no atomics, the same bits from run to run.
#pragma once

#include "wgmma_gemm.cuh"

namespace rsp {

constexpr int ROW_WARPS = 8;   // ln_stats: one warp per row
constexpr int LNB_WARPS = 4;   // ln_bwd_rows: warps per block
constexpr int LNB_ROWS = 16;   // ... and rows per block (partial sums)
constexpr int BS_COLS = 32;    // bias_sums: columns per block
constexpr int BS_GROUPS = 8;   // ... and row groups

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = to_f(b[u]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 raw;
  raw.x = pack_bf16(v[0], v[1]);
  raw.y = pack_bf16(v[2], v[3]);
  raw.z = pack_bf16(v[4], v[5]);
  raw.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Fragment coordinates of a consumer thread (see wgmma_gemm.cuh).
struct Frag {
  int wg, tid, warp, g, t;
  __device__ __forceinline__ Frag()
      : wg(threadIdx.x / 128), tid(threadIdx.x % 128), warp(tid / 32), g(tid % 32 / 4),
        t(tid % 4) {}
  __device__ __forceinline__ int row(int half) const { return 64 * wg + 16 * warp + g + 8 * half; }
  __device__ __forceinline__ int col(int j) const { return 8 * j + 2 * t; }
};

// The tile's fp32 sums, rounded to bf16 into shared memory (the ring, no
// longer read), handed out as 16-byte chunks: chunk(r, c, v) gets tile row
// r, columns c .. c + 7, for the rows of the calling consumer warpgroup.
template <int BN, class Chunk>
__device__ __forceinline__ void staged_bf16_epilogue(unsigned char* smem,
                                                     const float (&acc)[BN / 2], Chunk chunk) {
  constexpr int OS = BN + 8;  // bf16 staging row stride
  gemm_epilogue_begin();
  const Frag f;
  bf16* stg = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(stg + f.row(half) * OS + f.col(j)) =
          pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  named_sync(2 + f.wg, 128);
  constexpr int CH = BN / 8;  // 16-byte chunks per row
  for (int i = f.tid; i < 64 * CH; i += 128) {
    const int r = 64 * f.wg + i / CH;
    float v[8];
    load8(stg + r * OS + (i % CH) * 8, v);
    chunk(r, (i % CH) * 8, v);
  }
}

// The tile's fp32 sums stored as they are, rows < rows and columns < cols
// of out (row-major, cols wide).
template <int BN>
__device__ __forceinline__ void store_f32(const float (&acc)[BN / 2], float* out, int rows,
                                          int cols, int m0, int n0) {
  const Frag f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + f.row(half);
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + f.col(j);
      if (n < cols)
        *reinterpret_cast<float2*>(out + (size_t)m * cols + n) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// z = bf16(LN(x)) and (mu, rstd) of each of the T rows of x (T, 256 V).
template <int V>
__global__ void __launch_bounds__(ROW_WARPS * 32) ln_stats_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ z, float* __restrict__ mu_out,
    float* __restrict__ rstd_out, int T, float eps) {
  constexpr int C = 256 * V;
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= T) return;
  float v[V][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    load8(x + (size_t)row * C + 256 * i + 8 * lane, v[i]);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[i][u];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) q += (v[i][u] - mu) * (v[i][u] - mu);
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 256 * i + 8 * lane;
    float ga[8], be[8], y[8];
    load8(gamma + c, ga);
    load8(beta + c, be);
#pragma unroll
    for (int u = 0; u < 8; ++u) y[u] = (v[i][u] - mu) * rstd * ga[u] + be[u];
    store8(z + (size_t)row * C + c, y);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// dx = bf16(rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) [+ dO]),
// dxhat = dz gamma, one warp per row; part[block] = the block's LNB_ROWS rows
// of dz * xhat, dz [and dO] summed in row order per column (2 C [3 C] wide).
// RES: the layer has a residual, whose dO adds to dx (A').
template <int V, bool RES>
__global__ void __launch_bounds__(LNB_WARPS * 32) ln_bwd_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dz,
    const float* __restrict__ gamma, const bf16* __restrict__ dout,
    const float* __restrict__ mu, const float* __restrict__ rstd, bf16* __restrict__ dx,
    float* __restrict__ part, int T) {
  constexpr int C = 256 * V;
  constexpr int NS = RES ? 3 : 2;  // column sums per block
  constexpr int PER_WARP = LNB_ROWS / LNB_WARPS;
  static_assert(LNB_WARPS * NS * C * 4 <= 48 * 1024, "static shared memory");
  __shared__ __align__(16) float red[LNB_WARPS][NS * C];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float pg[V][8], pb[V][8], pd[V][8];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) pg[i][u] = pb[i][u] = pd[i][u] = 0.f;
  for (int k = 0; k < PER_WARP; ++k) {
    const int row = blockIdx.x * LNB_ROWS + warp * PER_WARP + k;
    if (row >= T) break;
    const float m = mu[row];
    const float rs = rstd[row];
    float xh[V][8], dxh[V][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 256 * i + 8 * lane;
      float dzv[8], ga[8];
      load8(x + (size_t)row * C + c, xh[i]);
      load8(dz + (size_t)row * C + c, dzv);
      load8(gamma + c, ga);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        xh[i][u] = (xh[i][u] - m) * rs;
        dxh[i][u] = dzv[u] * ga[u];
        s1 += dxh[i][u];
        s2 += dxh[i][u] * xh[i][u];
        pg[i][u] += dzv[u] * xh[i][u];
        pb[i][u] += dzv[u];
      }
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 256 * i + 8 * lane;
      float y[8];
      if constexpr (RES) {
        float dov[8];
        load8(dout + (size_t)row * C + c, dov);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          y[u] = rs * (dxh[i][u] - m1 - xh[i][u] * m2) + dov[u];
          pd[i][u] += dov[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) y[u] = rs * (dxh[i][u] - m1 - xh[i][u] * m2);
      }
      store8(dx + (size_t)row * C + c, y);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 256 * i + 8 * lane;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      red[warp][c + u] = pg[i][u];
      red[warp][C + c + u] = pb[i][u];
      if constexpr (RES) red[warp][2 * C + c + u] = pd[i][u];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NS * C; e += LNB_WARPS * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) s += red[w][e];
    part[(size_t)blockIdx.x * NS * C + e] = s;
  }
}

// bias = the column sums of bias_part (p1 rows of M), and dgamma, dbeta
// [, dres] those of ln_bwd_rows' partials (p2 rows of nsum C, nsum 0, 2 or
// 3): a block takes 32 columns in 8 row groups, each group's rows summed in
// order, then the groups in order.
__global__ void __launch_bounds__(BS_COLS * BS_GROUPS) bias_sums_kernel(
    const float* __restrict__ bias_part, int p1, int M, bf16* __restrict__ bias,
    const float* __restrict__ row_part, int p2, int C, int nsum, float* __restrict__ dgamma,
    float* __restrict__ dbeta, bf16* __restrict__ dres) {
  __shared__ float red[BS_GROUPS][BS_COLS];
  const int lane = threadIdx.x % BS_COLS;
  const int grp = threadIdx.x / BS_COLS;
  const int c = blockIdx.x * BS_COLS + lane;
  const int cols = M + nsum * C;
  const bool bias1 = c < M;
  const int rows = bias1 ? p1 : p2;
  const int ld = bias1 ? M : nsum * C;
  float s = 0.f;
  if (c < cols) {
    const float* src = bias1 ? bias_part + c : row_part + (c - M);
    const int r1 = (grp + 1) * rows / BS_GROUPS;
#pragma unroll 4
    for (int r = grp * rows / BS_GROUPS; r < r1; ++r) s += src[(size_t)r * ld];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || c >= cols) return;
  s = 0.f;
#pragma unroll
  for (int q = 0; q < BS_GROUPS; ++q) s += red[q][lane];
  const int e = c - M;
  if (bias1) bias[c] = to_bf(s);
  else if (e < C) dgamma[e] = s;
  else if (e < 2 * C) dbeta[e - C] = s;
  else dres[e - 2 * C] = to_bf(s);
}

}  // namespace rsp
