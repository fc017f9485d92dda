// Kernel B': backward of LayerNorm -> qkv projection -> head-major
// (N, 3n, S, d), d = 64 (ViT-B, ViT-L) or 80 (ViT-H), for the global and
// the windowed row maps of kernel B.
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
// and only db reads the pad rows.
//
// Bound on the H100 at ViT-B, 512^2, batch 4: both variants are
// 2 x 2*4096*768*2304 = 29.0 GFLOP (29 us at 989 TFLOP/s bf16); the bytes
// (x, dy, dx, 3.5 MB of weight in and 3.5 MB of bf16 weight gradient out)
// take 10-14 us: operations bound both. At ViT-H (C = 1280, 16 heads of
// 80, K3 = 3840) both are 2 x 2*4096*1280*3840 = 80.5 GFLOP (81 us); the
// window variant's dy holds 36 x 196 = 7056 rows, a pass over 54 MB more.
// At head dim 80 JAX has no kernel (XLA computes LN + qkv and its
// backward); B' takes those heads as it takes 64-wide ones: the dy copy
// moves ten 16-byte chunks a head row instead of eight, and the products
// see only K3 = 3n d.
//
// Design: kernel A''s launch structure (ln_mlp_residual_bwd.cu) with B''s
// products, its row kernels shared through ln_rows_bwd.cuh; no atomics, no
// split of K, every sum in a fixed order (the same bits from run to run):
//  1. dy_tokens: dy (N, 3n, S, d) copied to dy_t, the (T, 3C) token-major
//     matrix (row t = token t; window pad rows are not written), 16 bytes a
//     thread, and the partial column sums of every dy row, pad rows
//     included, per 64-row block (db's partials). A window's 196 rows do not
//     tile across windows for TMA, and a 3-D map per window would pad each
//     to 256 rows (2.25x the tensor work at this shape): the copy costs one
//     pass over dy instead, and both variants then share every later launch.
//  2. ln_stats: z = bf16(LN(x)) and the row statistics (without LN, z = x).
//  3. products, one launch on wgmma_gemm.cuh's TMA + wgmma mainloop, each
//     operand read as stored: first dW = dy_t^T z (A and B MN-major, K = T)
//     in 128 x 256 tiles, written in bf16; then dz = dy_t W (W stored (3C,
//     C): B MN-major, K = 3C) in 128 x 128 tiles, fp32 (without LN, dx =
//     bf16(dz) itself). At this shape the 54 weight tiles (K = 4096) run
//     beside the first of the 192 dz tiles (K = 2304).
//  4. ln_bwd_rows: dx = bf16(LN-vjp(dz)), and per 16-row block the partial
//     column sums of dz * xhat and dz (skipped without LN).
//  5. bias_sums: db, dgamma, dbeta from the partials, in block order.
#include "ln_rows_bwd.cuh"

using rsp::bf16;

namespace {

constexpr int BM = rsp::GEMM_TILE_M;
constexpr int BK = rsp::GEMM_TILE_K;
constexpr int THREADS = rsp::GEMM_THREADS_WS;
constexpr int DY_ROWS = 64;     // dy_tokens: rows per block (one db partial)
constexpr int DY_GROUPS = 16;   // ... row groups of d / 8 threads (one head row)
constexpr int MAX_V = 5;        // C = 256 V up to 1280 (ViT-H)

// 1. Block (row block, head h): rows 64 blockIdx.x .. + 63 of dy's (N*S, 3n *
// D) matrix, columns D h .. + D - 1 (D = 64 or 80: 8 or 10 16-byte chunks a
// head row). Thread (group g, chunk u) copies 16 bytes of rows g, g + 16, ..
// and sums them; the 16 groups' sums are then added in group order.
template <int D>
__global__ void __launch_bounds__(DY_GROUPS * D / 8) dy_tokens_kernel(
    const bf16* __restrict__ dy, bf16* __restrict__ dy_t, float* __restrict__ db_part,
    int rows, int S, int heads3, int H, int W, int window, int nwx, int nwin) {
  constexpr int U = D / 8;  // 16-byte chunks of a head row
  __shared__ float red[DY_GROUPS][D];
  const int h = blockIdx.y;
  const int u = threadIdx.x % U;
  const int g = threadIdx.x / U;
  const int K3 = heads3 * D;
  float cs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] = 0.f;
#pragma unroll
  for (int k = 0; k < DY_ROWS / DY_GROUPS; ++k) {
    const int r = blockIdx.x * DY_ROWS + g + DY_GROUPS * k;
    if (r >= rows) break;
    const int n = r / S;
    const int s = r - n * S;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(dy + (((size_t)n * heads3 + h) * S + s) * D + 8 * u);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[e] += rsp::to_f(v[e]);
    int t = r;  // the token of output row r (itself for a global layer)
    if (window != 0) {
      const int b = n / nwin;
      const int wi = n - b * nwin;
      const int gy = (wi / nwx) * window + s / window;
      const int gx = (wi % nwx) * window + s % window;
      t = (gy < H && gx < W) ? (b * H + gy) * W + gx : -1;  // -1: a pad row
    }
    if (t >= 0) *reinterpret_cast<uint4*>(dy_t + (size_t)t * K3 + D * h + 8 * u) = raw;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[g][8 * u + e] = cs[e];
  __syncthreads();
  if (threadIdx.x >= D) return;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < DY_GROUPS; ++q) s += red[q][threadIdx.x];
  db_part[(size_t)blockIdx.x * K3 + D * h + threadIdx.x] = s;
}

// 3. The products, one launch: the first blocks dW = dy_t^T z (K3 x C), a
// 128 x 256 tile each over K = T (A and B MN-major), in bf16; the rest dz =
// dy_t W (T x C), 128 x 128 tiles over K = K3 (B MN-major), fp32 into dz, or
// with dx given (no LN) rounded to bf16 into dx.
__global__ void __launch_bounds__(THREADS, 1) products_kernel(
    const __grid_constant__ CUtensorMap dy_mn, const __grid_constant__ CUtensorMap z_mn,
    const __grid_constant__ CUtensorMap dy_k, const __grid_constant__ CUtensorMap w_mn,
    bf16* __restrict__ dw, float* __restrict__ dz, bf16* __restrict__ dx, int T, int C,
    int K3) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::gemm_smem(smem_raw);
  const int w_tiles = ((K3 + BM - 1) / BM) * (C / 256);
  int u = blockIdx.x;
  if (u < w_tiles) {
    const int m0 = (u / (C / 256)) * BM;
    const int n0 = (u % (C / 256)) * 256;
    float acc[128];
    if (!rsp::gemm_mainloop<true, true, 256>(smem, &dy_mn, &z_mn, m0, n0, 0,
                                             (T + BK - 1) / BK, acc))
      return;
    rsp::staged_bf16_epilogue<256>(smem, acc, [&](int r, int c, float (&v)[8]) {
      if (m0 + r < K3) rsp::store8(dw + (size_t)(m0 + r) * C + n0 + c, v);
    });
    return;
  }
  u -= w_tiles;
  const int m0 = (u / (C / 128)) * BM;
  const int n0 = (u % (C / 128)) * 128;
  float acc[64];
  if (!rsp::gemm_mainloop<false, true, 128>(smem, &dy_k, &w_mn, m0, n0, 0,
                                            (K3 + BK - 1) / BK, acc))
    return;
  if (dx == nullptr) {
    rsp::store_f32<128>(acc, dz, T, C, m0, n0);
    return;
  }
  rsp::staged_bf16_epilogue<128>(smem, acc, [&](int r, int c, float (&v)[8]) {
    if (m0 + r < T) rsp::store8(dx + (size_t)(m0 + r) * C + n0 + c, v);
  });
}

template <int V>
cudaError_t run(const bf16* x, const float* gamma, const float* beta, const bf16* w,
                const bf16* dy, bf16* dx, float* dgamma, float* dbeta, bf16* dw, bf16* db,
                bf16* dy_t, bf16* z_ws, float* mu, float* dz, float* part, int B, int H, int W,
                int heads3, int d, int window, float eps, cudaStream_t s) {
  constexpr int C = 256 * V;
  const int T = B * H * W;
  const int K3 = heads3 * d;
  int S = H * W, N = B, nwx = 1, nwin = 1;
  if (window != 0) {
    nwx = (W + window - 1) / window;
    nwin = ((H + window - 1) / window) * nwx;
    S = window * window;
    N = B * nwin;
  }
  const bool ln = gamma != nullptr;
  float* rstd = mu + T;
  const int p1 = (N * S + DY_ROWS - 1) / DY_ROWS;
  const int p2 = (T + rsp::LNB_ROWS - 1) / rsp::LNB_ROWS;
  float* db_part = part;
  float* row_part = part + (size_t)p1 * K3;
  const bf16* z = ln ? z_ws : x;  // without LN dW reads x itself

  // operand maps, each read as stored: K-major (K) or MN-major (MN)
  using KA = rsp::GemmOperand<false, BM>;
  using MNA = rsp::GemmOperand<true, BM>;
  using MNB = rsp::GemmOperand<true, 256>;  // MN-major maps do not depend on the width
  CUtensorMap maps[4];
  if (!MNA::make_map(&maps[0], dy_t, T, K3) || !MNB::make_map(&maps[1], z, T, C) ||
      !KA::make_map(&maps[2], dy_t, T, K3) || !MNB::make_map(&maps[3], w, K3, C))
    return cudaErrorNotSupported;
  cudaError_t err;

  if (d == 64)
    dy_tokens_kernel<64><<<dim3(p1, heads3), DY_GROUPS * 8, 0, s>>>(
        dy, dy_t, db_part, N * S, S, heads3, H, W, window, nwx, nwin);
  else
    dy_tokens_kernel<80><<<dim3(p1, heads3), DY_GROUPS * 10, 0, s>>>(
        dy, dy_t, db_part, N * S, S, heads3, H, W, window, nwx, nwin);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (ln) {
    using rsp::ROW_WARPS;
    rsp::ln_stats_kernel<V><<<(T + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
        x, gamma, beta, z_ws, mu, rstd, T, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  constexpr int smem = rsp::GemmTile<true, true, 256>::SMEM;
  static_assert(rsp::GemmTile<false, true, 128>::SMEM <= smem, "the dz tiles fit");
  const int blocks = ((K3 + BM - 1) / BM) * (C / 256) + ((T + BM - 1) / BM) * (C / 128);
  err = cudaFuncSetAttribute(products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  products_kernel<<<blocks, THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], dw, dz,
                                                ln ? nullptr : dx, T, C, K3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (ln) {
    rsp::ln_bwd_rows_kernel<V, false><<<p2, rsp::LNB_WARPS * 32, 0, s>>>(
        x, dz, gamma, nullptr, mu, rstd, dx, row_part, T);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const int nsum = ln ? 2 : 0;
  using rsp::BS_COLS;
  rsp::bias_sums_kernel<<<(K3 + nsum * C + BS_COLS - 1) / BS_COLS, BS_COLS * rsp::BS_GROUPS,
                          0, s>>>(db_part, p1, K3, db, row_part, p2, C, nsum, dgamma, dbeta,
                                  nullptr);
  return cudaGetLastError();
}

}  // namespace

// Kernel B'. Inputs: x (B, H, W, C), w (heads3 * d, C) bf16, dy (N,
// heads3, S, d) bf16 (N = B, S = H W; with a window N = B * windows, S =
// window^2); gamma, beta (C) fp32, both null without LN. Outputs: dx (B, H,
// W, C), dw (heads3 * d, C), db (heads3 * d) bf16; dgamma, dbeta (C) fp32
// (untouched without LN). Scratch: dyt_ws (T, heads3 * d) bf16, z_ws (T, C)
// bf16, stats_ws (2, T) fp32, dz_ws (T, C) fp32, part_ws (ceil(N S / 64) *
// heads3 * d + ceil(T / 16) * 2 C) fp32, T = B H W. C a multiple of 256 up
// to 1280, d = 64 or 80.
extern "C" int rsp_ln_qkv_headmajor_bwd(
    const void* x, const void* gamma, const void* beta, const void* w, const void* dy,
    void* dx, void* dgamma, void* dbeta, void* dw, void* db, void* dyt_ws, void* z_ws,
    void* stats_ws, void* dz_ws, void* part_ws, int B, int H, int W, int C, int heads3,
    int d, int window, float eps, void* stream) {
  if (C % 256 != 0 || C < 256 || C > 256 * MAX_V || heads3 < 1 || B * H * W < 1 ||
      (d != 64 && d != 80))
    return static_cast<int>(cudaErrorInvalidValue);
  using Run = decltype(&run<1>);
  constexpr Run runs[MAX_V] = {run<1>, run<2>, run<3>, run<4>, run<5>};
  return static_cast<int>(runs[C / 256 - 1](
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<bf16*>(dw), static_cast<bf16*>(db), static_cast<bf16*>(dyt_ws),
      static_cast<bf16*>(z_ws), static_cast<float*>(stats_ws), static_cast<float*>(dz_ws),
      static_cast<float*>(part_ws), B, H, W, heads3, d, window, eps,
      static_cast<cudaStream_t>(stream)));
}
