// Building blocks of the backward kernels: a tiled bf16 matrix product with
// fp32 accumulation on mma.sync.m16n8k16, and a deterministic column sum.
//
// The product computes D[m, n] = sum_k A(m, k) * B(n, k) and hands every
// element to an epilogue functor. Each operand is read through an accessor
// (`ptr(r, c)` on the matrix as it is stored, contiguous along c in runs of
// at least 8), stored either as the product wants it (A as M x K, B as N x K)
// or transposed (A as K x M, B as K x N); the template flags TA / TB say
// which. A transposed tile is kept in shared memory as it is stored and its
// mma fragments are assembled from two 16-bit reads, so a weight gradient
// (a product over the token axis) needs no transposed copy in device memory.
// Every output tile is owned by one block that walks the whole K axis in
// order: results are the same from run to run (no atomics, no split-K).
#pragma once

#include "common.cuh"

namespace rsp {

// Row-major matrix with leading dimension `ld`.
struct RowMajor {
  const bf16* p;
  int ld;
  __device__ __forceinline__ const bf16* ptr(int r, int c) const {
    return p + (size_t)r * ld + c;
  }
};

// Head-major (N, H3, S, 64) tensor read as the (N*S, H3*64) matrix of rows
// (n, s) and columns (head, d).
struct HeadMajor {
  const bf16* p;
  int S;
  int H3;
  __device__ __forceinline__ const bf16* ptr(int r, int c) const {
    const int n = r / S;
    const int s = r - n * S;
    return p + (((size_t)n * H3 + (c >> 6)) * S + s) * 64 + (c & 63);
  }
};

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int GEMM_PAD = 8;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a (rows x cols) tile of a stored matrix, starting at (r0, c0), into
// shared memory with row stride `stride`; elements outside (R, Cc) are zero.
template <class Src>
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const Src& src,
                                          int r0, int c0, int rows, int cols,
                                          int R, int Cc, int tid) {
  const int chunks = cols / 8;
  for (int i = tid; i < rows * chunks; i += GEMM_THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < R && c0 + c < Cc)
      v = *reinterpret_cast<const uint4*>(src.ptr(r0 + r, c0 + c));
    *reinterpret_cast<uint4*>(dst + r * stride + c) = v;
  }
}

template <bool TA, bool TB, class SA, class SB, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_bf16_kernel(
    SA A, SB B, Epi epi, int M, int N, int K) {
  // A tile: [BM][BK] as the product wants it, or [BK][BM] as stored
  constexpr int A_ELEMS = TA ? GEMM_BK * (GEMM_BM + GEMM_PAD) : GEMM_BM * (GEMM_BK + GEMM_PAD);
  constexpr int B_ELEMS = TB ? GEMM_BK * (GEMM_BN + GEMM_PAD) : GEMM_BN * (GEMM_BK + GEMM_PAD);
  __shared__ __align__(16) bf16 as[A_ELEMS];
  __shared__ __align__(16) bf16 bs[B_ELEMS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int wm = (warp % 2) * 32;  // warp's 32 rows
  const int wn = (warp / 2) * 32;  // warp's 32 columns

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    if (TA)
      load_tile(as, GEMM_BM + GEMM_PAD, A, k0, m0, GEMM_BK, GEMM_BM, K, M, tid);
    else
      load_tile(as, GEMM_BK + GEMM_PAD, A, m0, k0, GEMM_BM, GEMM_BK, M, K, tid);
    if (TB)
      load_tile(bs, GEMM_BN + GEMM_PAD, B, k0, n0, GEMM_BK, GEMM_BN, K, N, tid);
    else
      load_tile(bs, GEMM_BK + GEMM_PAD, B, n0, k0, GEMM_BN, GEMM_BK, N, K, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        if (TA) {
          constexpr int S = GEMM_BM + GEMM_PAD;
          const bf16* p = as + (kk + 2 * t) * S + r;
          a[i][0] = pack2(p[0], p[S]);
          a[i][1] = pack2(p[8], p[S + 8]);
          a[i][2] = pack2(p[8 * S], p[9 * S]);
          a[i][3] = pack2(p[8 * S + 8], p[9 * S + 8]);
        } else {
          load_a(a[i], as, GEMM_BK + GEMM_PAD, wm + i * 16, kk, lane);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        uint32_t b0, b1;
        if (TB) {
          constexpr int S = GEMM_BN + GEMM_PAD;
          const bf16* p = bs + (kk + 2 * t) * S + c;
          b0 = pack2(p[0], p[S]);
          b1 = pack2(p[8 * S], p[9 * S]);
        } else {
          const bf16* p = bs + c * (GEMM_BK + GEMM_PAD) + kk + 2 * t;
          b0 = ld32(p);
          b1 = ld32(p + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (m < M && n < N) epi(m, n, acc[i][j][e]);
      }
}

template <bool TA, bool TB, class SA, class SB, class Epi>
cudaError_t gemm_bf16(SA a, SB b, Epi epi, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<TA, TB, SA, SB, Epi><<<grid, GEMM_THREADS, 0, stream>>>(a, b, epi, M, N, K);
  return cudaGetLastError();
}

// Epilogue: store the fp32 sum at out[m * ld + n].
struct StoreF32 {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    out[(size_t)m * ld + n] = v;
  }
};

// Column sums of a (rows x cols) matrix read through `get(r, c)` (fp32), in
// two passes of fixed order: partial[chunk][c] over COLSUM_ROWS rows each,
// then the partials in chunk order. `partial` holds ceil(rows / COLSUM_ROWS)
// x cols floats.
constexpr int COLSUM_ROWS = 64;

template <class Get>
__global__ void colsum_partial_kernel(Get get, float* __restrict__ partial,
                                      int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * COLSUM_ROWS;
  if (c >= cols) return;
  float s = 0.f;
  const int r1 = min(rows, r0 + COLSUM_ROWS);
  for (int r = r0; r < r1; ++r) s += get(r, c);
  partial[(size_t)blockIdx.y * cols + c] = s;
}

__global__ void colsum_final_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int chunks,
                                    int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int i = 0; i < chunks; ++i) s += partial[(size_t)i * cols + c];
  out[c] = s;
}

template <class Get>
cudaError_t colsum(Get get, float* partial, float* out, int rows, int cols,
                   cudaStream_t stream) {
  const int chunks = (rows + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_partial_kernel<Get><<<dim3((cols + 127) / 128, chunks), 128, 0, stream>>>(
      get, partial, rows, cols);
  colsum_final_kernel<<<(cols + 127) / 128, 128, 0, stream>>>(partial, out,
                                                              chunks, cols);
  return cudaGetLastError();
}

// Getters for colsum.
template <class Src>
struct GetBf16 {
  Src src;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f(*src.ptr(r, c));
  }
};

struct GetF32 {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[(size_t)r * ld + c];
  }
};

__device__ __forceinline__ float erf_gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// d/dh of the exact GELU: Phi(h) + h * phi(h).
__device__ __forceinline__ float erf_gelu_grad(float h) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * h * h);
  return cdf + h * pdf;
}

// LayerNorm statistics of one C-wide bf16 row by one warp (fp32).
__device__ __forceinline__ void warp_ln_stats(const bf16* __restrict__ xr, int C,
                                              float eps, int lane, float& mu,
                                              float& rstd) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  rstd = rsqrtf(warp_sum(v) / C + eps);
}

// LayerNorm backward of one row by one warp, given dz (fp32, the gradient of
// the normalised-and-scaled output): writes
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + extra,
// where dxhat = dz * gamma and `extra` is the row of `res` (or 0), as bf16.
__device__ __forceinline__ void warp_ln_bwd_row(
    const bf16* __restrict__ xr, const float* __restrict__ dzr,
    const float* __restrict__ gamma, const bf16* __restrict__ res,
    bf16* __restrict__ dxr, int C, float mu, float rstd, int lane) {
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xh = (to_f(xr[c]) - mu) * rstd;
    const float dxh = dzr[c] * gamma[c];
    s1 += dxh;
    s2 += dxh * xh;
  }
  const float m1 = warp_sum(s1) / C;
  const float m2 = warp_sum(s2) / C;
  for (int c = lane; c < C; c += 32) {
    const float xh = (to_f(xr[c]) - mu) * rstd;
    const float dxh = dzr[c] * gamma[c];
    float v = rstd * (dxh - m1 - xh * m2);
    if (res != nullptr) v += to_f(res[c]);
    dxr[c] = to_bf(v);
  }
}

}  // namespace rsp
