// Kernel B': backward of LayerNorm -> qkv projection -> head-major
// (N, 3n, S, 64), for the global and the windowed row maps of kernel B.
//
// Replaces two TPU kernels: rsprompter_tpu/ops/fused_mlp.py:
// _ln_qkv_bwd_kernel (global layers, through _ln_qkv_bwd_pallas) and
// _strip_qkv_bwd_kernel (windowed layers, through _qkv_window_bwd_pallas; the
// JAX layer applies that LayerNorm outside its kernel, the port fuses it as
// its forward does). Given x, the LN parameters, the weight and dy it returns
// dx, dgamma, dbeta, dW and db:
//   z  = bf16(LN(x)) for each token
//   dW = dy^T z over the tokens,  db = colsum(dy) over every output row, window
//        pad rows included (their q/k/v are the bias, so their dy reaches db)
//   dz = dy W (fp32) for each token;  dx = LN-vjp(dz).
// Window pad rows have z = 0 and feed no token, so they add nothing to dW,
// dz, dx, dgamma or dbeta: the two products run over the T = B*H*W tokens,
// reading each token's dy row through the window map, and only db reads the
// pad rows.
//
// Bound on the H100 at ViT-B, 512^2, batch 4: both variants are
// 2 x 2*4096*768*2304 = 29.0 GFLOP (29 us at 989 TFLOP/s bf16); the bytes
// (x, dy, dx, 3.5 MB of weight, 7 MB of fp32 weight gradient) take 10-14 us:
// operations bound both.
//
// Design: as kernel A' (ln_mlp_residual_bwd.cu) -- a per-token pass writes z
// and the row statistics, two tiled products read dy in its head-major layout
// through an accessor (no transposed copy, no gathered copy), a per-token
// pass applies the LN backward, and fixed-order column sums give db, dgamma
// and dbeta. No atomics: results are the same from run to run.
#include "bwd_common.cuh"

using rsp::bf16;

namespace {

constexpr int ROW_WARPS = 8;

// dy (N, 3n, S, 64) read as the (T, 3n*64) matrix of tokens: row t is the
// output row kernel B wrote token t to (itself for a global layer).
struct TokenDy {
  rsp::HeadMajor dy;
  int H, W, window, nwx, nwin;
  __device__ __forceinline__ const bf16* ptr(int t, int c) const {
    if (window == 0) return dy.ptr(t, c);
    const int b = t / (H * W);
    const int gy = (t / W) % H;
    const int gx = t % W;
    const int n = b * nwin + (gy / window) * nwx + gx / window;
    const int s = (gy % window) * window + gx % window;
    return dy.ptr(n * dy.S + s, c);
  }
};

// z rows (bf16) and statistics of every token, a warp per token.
__global__ void __launch_bounds__(ROW_WARPS * 32) z_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ z,
    float* __restrict__ mu_out, float* __restrict__ rstd_out, int T, int C,
    float eps) {
  const int t = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T) return;
  const bf16* xr = x + (size_t)t * C;
  bf16* zr = z + (size_t)t * C;
  float mu, rstd;
  rsp::warp_ln_stats(xr, C, eps, lane, mu, rstd);
  for (int c = lane; c < C; c += 32)
    zr[c] = rsp::to_bf((rsp::to_f(xr[c]) - mu) * rstd * gamma[c] + beta[c]);
  if (lane == 0) {
    mu_out[t] = mu;
    rstd_out[t] = rstd;
  }
}

// dx[t] = LN-vjp(dz[t]) (or dz[t] without LN), a warp per token.
__global__ void __launch_bounds__(ROW_WARPS * 32) dx_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dz,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ rstd, bf16* __restrict__ dx, int T, int C) {
  const int t = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T) return;
  const float* dzr = dz + (size_t)t * C;
  bf16* dxr = dx + (size_t)t * C;
  if (gamma != nullptr) {
    rsp::warp_ln_bwd_row(x + (size_t)t * C, dzr, gamma, nullptr, dxr, C, mu[t],
                         rstd[t], lane);
  } else {
    for (int c = lane; c < C; c += 32) dxr[c] = rsp::to_bf(dzr[c]);
  }
}

// dgamma summands: dz * xhat.
struct GetDzXhat {
  const bf16* x;
  const float* dz;
  const float* mu;
  const float* rstd;
  int C;
  __device__ __forceinline__ float operator()(int t, int c) const {
    const size_t i = (size_t)t * C + c;
    return dz[i] * ((rsp::to_f(x[i]) - mu[t]) * rstd[t]);
  }
};

}  // namespace

extern "C" int rsp_ln_qkv_headmajor_bwd(
    const void* x, const void* gamma, const void* beta, const void* w,
    const void* dy, void* dx, void* dgamma, void* dbeta, void* dw, void* db,
    void* z_ws, void* stats_ws, void* dz_ws, void* partial_ws, int B, int H,
    int W, int C, int heads3, int window, float eps, void* stream) {
  if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  using rsp::HeadMajor;
  using rsp::RowMajor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = B * H * W;
  int S = H * W, N = B, nwx = 1, nwin = 1;
  if (window != 0) {
    nwx = (W + window - 1) / window;
    nwin = ((H + window - 1) / window) * nwx;
    S = window * window;
    N = B * nwin;
  }
  const int rows = N * S;
  const int K3 = heads3 * 64;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* ga = static_cast<const float*>(gamma);
  const HeadMajor dyh{static_cast<const bf16*>(dy), S, heads3};
  const TokenDy dyt{dyh, H, W, window, nwx, nwin};
  float* mu = static_cast<float*>(stats_ws);
  float* rstd = mu + T;
  float* dz = static_cast<float*>(dz_ws);
  float* part = static_cast<float*>(partial_ws);
  cudaError_t err;

  const int row_blocks = (T + ROW_WARPS - 1) / ROW_WARPS;
  const bf16* z = xb;  // without LN the product reads x itself
  if (ga != nullptr) {
    z_rows_kernel<<<row_blocks, ROW_WARPS * 32, 0, s>>>(
        xb, ga, static_cast<const float*>(beta), static_cast<bf16*>(z_ws), mu,
        rstd, T, C, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    z = static_cast<const bf16*>(z_ws);
  }
  // dW = dy^T z: (3C x C), K = T tokens
  err = rsp::gemm_bf16<true, true>(dyt, RowMajor{z, C},
                                   rsp::StoreF32{static_cast<float*>(dw), C},
                                   K3, C, T, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dz = dy W: (T x C), K = 3C; W is stored (3C x C)
  err = rsp::gemm_bf16<false, true>(dyt, RowMajor{static_cast<const bf16*>(w), C},
                                    rsp::StoreF32{dz, C}, T, C, K3, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_rows_kernel<<<row_blocks, ROW_WARPS * 32, 0, s>>>(
      xb, dz, ga, mu, rstd, static_cast<bf16*>(dx), T, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = rsp::colsum(rsp::GetBf16<HeadMajor>{dyh}, part, static_cast<float*>(db),
                    rows, K3, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ga != nullptr) {
    err = rsp::colsum(GetDzXhat{xb, dz, mu, rstd, C}, part,
                      static_cast<float*>(dgamma), T, C, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = rsp::colsum(rsp::GetF32{dz, C}, part, static_cast<float*>(dbeta), T,
                      C, s);
  }
  return static_cast<int>(err);
}
