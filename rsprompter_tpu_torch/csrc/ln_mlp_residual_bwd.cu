// Kernel A': backward of out = x + fc2(gelu_erf(fc1(LN(x)))).
//
// Replaces the TPU kernel rsprompter_tpu/ops/fused_mlp.py:_mlp_bwd_kernel
// (reached through _mlp_bwd_pallas). Given x, the LN and MLP parameters and
// dO it returns dx, dgamma, dbeta, dW1, db1, dW2, db2, recomputing the
// forward's z, h and gelu(h) with the forward's rounding points:
//   z  = bf16(LN(x)),  h = bf16(bf16(z W1^T) + b1),  g = bf16(gelu(h))
//   dW2 = dO^T g,  db2 = colsum(dO)
//   dh  = bf16((dO W2) * gelu'(h)),  dW1 = dh^T z,  db1 = colsum(dh)
//   dz  = dh W1 (fp32),  dx = dO + LN-vjp(dz),  dgamma / dbeta from dz
//
// Bound on the H100 at ViT-B, 512^2, batch 4 (T = 4096, C = 768, M = 3072):
// five products of 2*T*C*M = 19.3 GFLOP each (the recomputed fc1, dO W2,
// the two weight gradients and dh W1), 96.6 GFLOP, about 98 us at 989
// TFLOP/s bf16; the bytes it must move (x, dO, dx, 9.4 MB of weights and
// 18.9 MB of fp32 weight gradients) take about 11 us: operations bound it.
//
// Design: the TPU kernel sweeps token blocks in order and accumulates the
// weight gradients in resident VMEM; on the card blocks run in no order, so
// the work is split into passes, each a plain tiled product (bwd_common.cuh)
// whose output tiles each belong to one block: a per-row LN pass writes z and
// the row statistics; the fc1 product writes h (bf16) in its epilogue; the
// dO W2 product turns h into g and dh in its epilogue; the two weight
// gradients are products over the token axis read straight from the
// token-major buffers; dh W1 gives dz; a per-row pass applies the LN
// backward and the residual; column sums in two fixed-order passes give the
// bias and LN-parameter gradients. The (T, M) activations make one round
// trip through device memory (2 x 25 MB at this shape) in exchange for no
// atomics: every result is the same from run to run.
#include "bwd_common.cuh"

using rsp::bf16;

namespace {

constexpr int ROW_WARPS = 8;

// z = bf16(LN(x)) and the row statistics (mu, rstd), one warp per row.
__global__ void __launch_bounds__(ROW_WARPS * 32) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ z,
    float* __restrict__ mu_out, float* __restrict__ rstd_out, int T, int C,
    float eps) {
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= T) return;
  const bf16* xr = x + (size_t)row * C;
  float mu, rstd;
  rsp::warp_ln_stats(xr, C, eps, lane, mu, rstd);
  for (int c = lane; c < C; c += 32)
    z[(size_t)row * C + c] = rsp::to_bf((rsp::to_f(xr[c]) - mu) * rstd * gamma[c] + beta[c]);
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// fc1 epilogue: h = bf16(bf16(acc) + b1).
struct EpiH {
  bf16* h;
  const bf16* b1;
  int M;
  __device__ __forceinline__ void operator()(int t, int m, float v) const {
    h[(size_t)t * M + m] = rsp::to_bf(rsp::round_bf(v) + rsp::to_f(b1[m]));
  }
};

// dO W2 epilogue: dh = bf16(acc * gelu'(h)); h is replaced by g = gelu(h).
struct EpiDh {
  bf16* hg;
  bf16* dh;
  int M;
  __device__ __forceinline__ void operator()(int t, int m, float v) const {
    const size_t i = (size_t)t * M + m;
    const float h = rsp::to_f(hg[i]);
    dh[i] = rsp::to_bf(v * rsp::erf_gelu_grad(h));
    hg[i] = rsp::to_bf(rsp::erf_gelu(h));
  }
};

// dx = dO + LN-vjp(dz), one warp per row.
__global__ void __launch_bounds__(ROW_WARPS * 32) ln_bwd_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dz,
    const float* __restrict__ gamma, const bf16* __restrict__ dout,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    bf16* __restrict__ dx, int T, int C) {
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= T) return;
  const size_t o = (size_t)row * C;
  rsp::warp_ln_bwd_row(x + o, dz + o, gamma, dout + o, dx + o, C, mu[row],
                       rstd[row], lane);
}

// dgamma summand: dz * xhat.
struct GetDzXhat {
  const bf16* x;
  const float* dz;
  const float* mu;
  const float* rstd;
  int C;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const size_t i = (size_t)r * C + c;
    return dz[i] * ((rsp::to_f(x[i]) - mu[r]) * rstd[r]);
  }
};

}  // namespace

extern "C" int rsp_ln_mlp_residual_bwd(
    const void* x, const void* gamma, const void* beta, const void* w1,
    const void* b1, const void* w2, const void* dout, void* dx, void* dgamma,
    void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* z_ws,
    void* stats_ws, void* h_ws, void* dh_ws, void* dz_ws, void* partial_ws,
    int T, int C, int M, float eps, void* stream) {
  if (C % 8 != 0 || M % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  using rsp::RowMajor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* ga = static_cast<const float*>(gamma);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* dob = static_cast<const bf16*>(dout);
  bf16* z = static_cast<bf16*>(z_ws);
  float* mu = static_cast<float*>(stats_ws);
  float* rstd = mu + T;
  bf16* hg = static_cast<bf16*>(h_ws);
  bf16* dh = static_cast<bf16*>(dh_ws);
  float* dz = static_cast<float*>(dz_ws);
  float* part = static_cast<float*>(partial_ws);
  cudaError_t err;

  const int row_blocks = (T + ROW_WARPS - 1) / ROW_WARPS;
  ln_rows_kernel<<<row_blocks, ROW_WARPS * 32, 0, s>>>(
      xb, ga, static_cast<const float*>(beta), z, mu, rstd, T, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // h = bf16(z W1^T + b1): (T x M), K = C
  err = rsp::gemm_bf16<false, false>(RowMajor{z, C}, RowMajor{w1b, C},
                                     EpiH{hg, static_cast<const bf16*>(b1), M},
                                     T, M, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dh, g from dO W2: (T x M), K = C; W2 is stored (C x M)
  err = rsp::gemm_bf16<false, true>(RowMajor{dob, C}, RowMajor{w2b, M},
                                    EpiDh{hg, dh, M}, T, M, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW2 = dO^T g: (C x M), K = T
  err = rsp::gemm_bf16<true, true>(RowMajor{dob, C}, RowMajor{hg, M},
                                   rsp::StoreF32{static_cast<float*>(dw2), M},
                                   C, M, T, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW1 = dh^T z: (M x C), K = T
  err = rsp::gemm_bf16<true, true>(RowMajor{dh, M}, RowMajor{z, C},
                                   rsp::StoreF32{static_cast<float*>(dw1), C},
                                   M, C, T, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dz = dh W1: (T x C), K = M; W1 is stored (M x C)
  err = rsp::gemm_bf16<false, true>(RowMajor{dh, M}, RowMajor{w1b, C},
                                    rsp::StoreF32{dz, C}, T, C, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_rows_kernel<<<row_blocks, ROW_WARPS * 32, 0, s>>>(
      xb, dz, ga, dob, mu, rstd, static_cast<bf16*>(dx), T, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = rsp::colsum(GetDzXhat{xb, dz, mu, rstd, C}, part,
                    static_cast<float*>(dgamma), T, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = rsp::colsum(rsp::GetF32{dz, C}, part, static_cast<float*>(dbeta), T, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = rsp::colsum(rsp::GetBf16<RowMajor>{RowMajor{dh, M}}, part,
                    static_cast<float*>(db1), T, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = rsp::colsum(rsp::GetBf16<RowMajor>{RowMajor{dob, C}}, part,
                    static_cast<float*>(db2), T, C, s);
  return static_cast<int>(err);
}
