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
// TFLOP/s bf16; the bytes it must move (x, dO, dx, 9.4 MB of weights in and
// 9.4 MB of bf16 weight gradients out) take about 8 us: operations bound it.
//
// Design: the TPU kernel sweeps token blocks in order and accumulates the
// weight gradients in resident VMEM; on the card blocks run in no order, so
// the work is six launches on the stream, every sum in a fixed order (no
// atomics, no split K: the results are the same bits from run to run). All
// five products run on the warp-specialised TMA + wgmma mainloop of
// wgmma_gemm.cuh, kernel A's, each operand read as it is stored (K-major or
// MN-major), so no transposed copy is made:
//  1. ln_stats: z = bf16(LN(x)) and the row statistics (mu, rstd).
//  2. h = z W1^T (A, B K-major), 128 x 256 tiles; epilogue h = bf16(bf16 +
//     b1) into the (T, M) buffer.
//  3. dO W2 (W2 stored (C, M): B MN-major), 128 x 256 tiles behind a
//     3-stage ring, the block's h tile fetched by TMA meanwhile; the fp32
//     tile is staged in shared memory, the epilogue writes dh = bf16(acc *
//     gelu'(h)) and g = bf16(gelu(h)) over h and sums the tile's 128 rows of
//     dh per column (db1's partials).
//  4. grads: dW2 = dO^T g and dW1 = dh^T z (A and B MN-major: K is the token
//     axis), 128 x 256 tiles, written in bf16; and dz = dh W1 (B MN-major),
//     128 x 128 tiles, fp32; one launch. At this shape the 144 weight tiles
//     (K = 4096) take one round of the 132 SMs and 12 of a second, and the
//     192 dz tiles (K = 3072, a third of the work each) queue behind them
//     and fill the SMs the second round leaves idle.
//  5. ln_bwd_rows: dx = bf16(dO + LN-vjp(dz)), one warp per row, and per
//     16-row block the partial column sums of dz * xhat, dz and dO.
//  6. bias_sums: db1, dgamma, dbeta, db2 from the partials, in block order.
// Launches 1, 5 and 6 are ln_rows_bwd.cuh's, which B' runs too.
// The (T, M) activations make one round trip through device memory (2 x 25
// MB at this shape).
// The previous design ran the products as 64 x 64 mma.sync tiles with
// synchronous loads in 15 launches plus four casts in the wrapper: 1.59 ms at this shape on an H100 80GB HBM3 at 700 W.
#include "ln_rows_bwd.cuh"

using rsp::bf16;

namespace {

constexpr int BM = rsp::GEMM_TILE_M;
constexpr int BK = rsp::GEMM_TILE_K;
constexpr int THREADS = rsp::GEMM_THREADS_WS;
using rsp::Frag;
using rsp::load8;
using rsp::staged_bf16_epilogue;
using rsp::store8;
using rsp::store_f32;

// 2. h (T, M) = bf16(bf16(z W1^T) + b1).
__global__ void __launch_bounds__(THREADS, 1) hidden_kernel(
    const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap w1map,
    const bf16* __restrict__ b1, bf16* __restrict__ h, int T, int M, int C) {
  constexpr int BN = 256;
  static_assert(BM * (BN + 8) * 2 <= rsp::GemmTile<false, false, BN>::RING,
                "staging fits the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::gemm_smem(smem_raw);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  float acc[BN / 2];
  if (!rsp::gemm_mainloop<false, false, BN>(smem, &zmap, &w1map, m0, n0, 0, C / BK, acc))
    return;
  staged_bf16_epilogue<BN>(smem, acc, [&](int r, int c, float (&v)[8]) {
    if (m0 + r >= T) return;
    float b[8];
    load8(b1 + n0 + c, b);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] += b[u];
    store8(h + (size_t)(m0 + r) * M + n0 + c, v);
  });
}

// 3. dgl = dO W2 (fp32, staged in shared memory); dh = bf16(dgl * gelu'(h))
// and g = bf16(gelu(h)) over h (one erf for both); db1_part[row tile][m] =
// the tile's 128 rows of dh summed per column in a fixed order. The block's
// h tile comes by TMA while the products run (4 boxes of 128 rows x 64,
// 128-byte swizzle, after a 3-stage ring).
struct DhTile {
  static constexpr int BN = 256;    // 32 chunks a row: a thread keeps its 8 columns
  static constexpr int STAGES = 3;
  using G = rsp::GemmTile<false, true, BN, STAGES>;
  static constexpr int FS = BN + 8;             // fp32 staging row stride
  static constexpr int SUMS = BM * FS;          // 8 partial column sums after it
  static constexpr int H_OFF = G::RING + 1024;  // after the ring's barriers
  static constexpr int H_BYTES = BM * BN * 2;
  static constexpr int SMEM = 1024 + H_OFF + H_BYTES;
  static_assert((SUMS + 8 * BN) * 4 <= G::RING, "staging fits the ring");
  static_assert(2 * STAGES * 8 + 8 <= 1024, "barriers fit before the h tile");
};

__global__ void __launch_bounds__(THREADS, 1) dh_kernel(
    const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap w2map,
    const __grid_constant__ CUtensorMap hmap, bf16* __restrict__ hg, bf16* __restrict__ dh,
    float* __restrict__ db1_part, int T, int M, int C) {
  using D = DhTile;
  constexpr int BN = D::BN;
  constexpr int FS = D::FS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::gemm_smem(smem_raw);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const unsigned char* htile = smem + D::H_OFF;
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem + D::G::RING + 2 * D::STAGES * 8);
  if (threadIdx.x == 0) {
    rsp::mbar_init(hbar, 1);
    rsp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 256) {
    rsp::mbar_expect_tx(hbar, D::H_BYTES);
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      rsp::tma_load_2d(smem + D::H_OFF + q * BM * 128, &hmap, hbar, n0 + 64 * q, m0);
  }
  float acc[BN / 2];
  if (!rsp::gemm_mainloop<false, true, BN, D::STAGES>(smem, &dmap, &w2map, m0, n0, 0,
                                                      C / BK, acc))
    return;
  rsp::gemm_epilogue_begin();
  const Frag f;
  float* stg = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(stg + f.row(half) * FS + f.col(j)) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  rsp::named_sync(2 + f.wg, 128);
  rsp::mbar_wait(hbar, 0);
  // thread tid takes chunk ch = tid % 32 of rows 64 wg + tid / 32 + 4 k
  constexpr int CH = BN / 8;
  const int ch = f.tid % CH;
  float cs[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) cs[u] = 0.f;
  for (int r = 64 * f.wg + f.tid / CH; r < 64 * (f.wg + 1); r += 128 / CH) {
    const int m = m0 + r;
    if (m >= T) break;
    // 16-byte unit ch % 8 of row r in box ch / 8, swizzled as TMA wrote it
    float hv[8], d[8], gv[8];
    load8(reinterpret_cast<const bf16*>(htile + (ch / 8) * BM * 128 + r * 128 +
                                        (((ch % 8) ^ (r % 8)) << 4)), hv);
    load8(stg + r * FS + ch * 8, d);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      // gelu = h Phi(h), gelu' = Phi(h) + h phi(h), Phi from one erf
      const float cdf = 0.5f * (1.f + erff(hv[u] * 0.70710678118654752f));
      const float pdf = 0.3989422804014327f * expf(-0.5f * hv[u] * hv[u]);
      d[u] = rsp::round_bf(d[u] * (cdf + hv[u] * pdf));
      gv[u] = hv[u] * cdf;
      cs[u] += d[u];
    }
    const size_t idx = (size_t)m * M + n0 + ch * 8;
    store8(dh + idx, d);
    store8(hg + idx, gv);
  }
  // the 8 row groups' sums (warpgroup, then tid / 32), then in group order
  float* sums = stg + D::SUMS;
  const int grp = 4 * f.wg + f.tid / CH;
#pragma unroll
  for (int u = 0; u < 8; ++u) sums[grp * BN + ch * 8 + u] = cs[u];
  rsp::named_sync(1, 256);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) s += sums[q * BN + threadIdx.x];
  db1_part[(size_t)blockIdx.y * M + n0 + threadIdx.x] = s;
}

// 4. The products over dh, one launch: the first blocks dW2 = dO^T g (C x
// M), then dW1 = dh^T z (M x C), each a 128 x 256 tile over K = T (A and B
// MN-major) written in bf16; the rest dz = dh W1 (T x C), 128 x 128 tiles
// over K = M (B MN-major), fp32.
__global__ void __launch_bounds__(THREADS, 1) grads_kernel(
    const __grid_constant__ CUtensorMap do_mn, const __grid_constant__ CUtensorMap g_mn,
    const __grid_constant__ CUtensorMap dh_mn, const __grid_constant__ CUtensorMap z_mn,
    const __grid_constant__ CUtensorMap dh_k, const __grid_constant__ CUtensorMap w1_mn,
    bf16* __restrict__ dw2, bf16* __restrict__ dw1, float* __restrict__ dz, int T, int C,
    int M) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::gemm_smem(smem_raw);
  const int w2_tiles = (C / BM) * (M / 256);
  const int w_tiles = w2_tiles + (M / BM) * (C / 256);
  int u = blockIdx.x;
  if (u < w_tiles) {
    const bool second = u >= w2_tiles;  // dW1
    if (second) u -= w2_tiles;
    const int cols = second ? C : M;
    const int m0 = (u / (cols / 256)) * BM;
    const int n0 = (u % (cols / 256)) * 256;
    float acc[128];
    if (!rsp::gemm_mainloop<true, true, 256>(smem, second ? &dh_mn : &do_mn,
                                             second ? &z_mn : &g_mn, m0, n0, 0,
                                             (T + BK - 1) / BK, acc))
      return;
    bf16* out = second ? dw1 : dw2;
    staged_bf16_epilogue<256>(smem, acc, [&](int r, int c, float (&v)[8]) {
      store8(out + (size_t)(m0 + r) * cols + n0 + c, v);
    });
    return;
  }
  u -= w_tiles;
  const int m0 = (u / (C / 128)) * BM;
  const int n0 = (u % (C / 128)) * 128;
  float acc[64];
  if (!rsp::gemm_mainloop<false, true, 128>(smem, &dh_k, &w1_mn, m0, n0, 0, M / BK, acc))
    return;
  store_f32<128>(acc, dz, T, C, m0, n0);
}

// The layout tests' harness: out (rows, cols) fp32 = A . B^T on the
// mainloop form (AMN, BMN, BN).
template <bool AMN, bool BMN, int BN>
__global__ void __launch_bounds__(THREADS, 1) f32_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    float* __restrict__ out, int rows, int cols, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::gemm_smem(smem_raw);
  const int tiles_n = (cols + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  float acc[BN / 2];
  if (!rsp::gemm_mainloop<AMN, BMN, BN>(smem, &amap, &bmap, m0, n0, 0, (K + BK - 1) / BK,
                                        acc))
    return;
  store_f32<BN>(acc, out, rows, cols, m0, n0);
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool AMN, bool BMN, int BN>
cudaError_t launch_f32(const void* a, const void* b, float* out, int rows, int cols, int K,
                       cudaStream_t s) {
  using G = rsp::GemmTile<AMN, BMN, BN>;
  CUtensorMap maps[2];
  // A stored (rows, K) or (K, rows); B stored (cols, K) or (K, cols)
  if (!(AMN ? G::A::make_map(&maps[0], a, K, rows) : G::A::make_map(&maps[0], a, rows, K)) ||
      !(BMN ? G::B::make_map(&maps[1], b, K, cols) : G::B::make_map(&maps[1], b, cols, K)))
    return cudaErrorNotSupported;
  cudaError_t err = prepare(f32_gemm_kernel<AMN, BMN, BN>, G::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = ((rows + BM - 1) / BM) * ((cols + BN - 1) / BN);
  f32_gemm_kernel<AMN, BMN, BN><<<tiles, THREADS, G::SMEM, s>>>(maps[0], maps[1], out, rows,
                                                                cols, K);
  return cudaGetLastError();
}

}  // namespace

// Kernel A'. Inputs: x (T, C), dout (T, C), w1 (M, C), b1 (M), w2 (C, M)
// bf16; gamma, beta (C) fp32. Outputs: dx (T, C), dw1 (M, C), db1 (M), dw2
// (C, M), db2 (C) bf16; dgamma, dbeta (C) fp32. Scratch: z_ws (T, C) bf16,
// stats_ws (2, T) fp32, hg_ws and dh_ws (T, M) bf16, dz_ws (T, C) fp32,
// part_ws (ceil(T / 128) * M + ceil(T / 16) * 3 C) fp32. C = 768; M a
// multiple of 256.
extern "C" int rsp_ln_mlp_residual_bwd(
    const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
    const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1,
    void* db1, void* dw2, void* db2, void* z_ws, void* stats_ws, void* hg_ws, void* dh_ws,
    void* dz_ws, void* part_ws, int T, int C, int M, float eps, void* stream) {
  constexpr int V = 3;
  if (C != 256 * V || M % 256 != 0 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dob = static_cast<const bf16*>(dout);
  const float* ga = static_cast<const float*>(gamma);
  bf16* z = static_cast<bf16*>(z_ws);
  float* mu = static_cast<float*>(stats_ws);
  float* rstd = mu + T;
  bf16* hg = static_cast<bf16*>(hg_ws);
  bf16* dh = static_cast<bf16*>(dh_ws);
  float* dz = static_cast<float*>(dz_ws);
  const int p1 = (T + BM - 1) / BM;
  const int p2 = (T + rsp::LNB_ROWS - 1) / rsp::LNB_ROWS;
  float* db1_part = static_cast<float*>(part_ws);
  float* row_part = db1_part + (size_t)p1 * M;

  // operand maps, each read as stored: K-major (K) or MN-major (MN)
  using KA = rsp::GemmOperand<false, BM>;
  using MNA = rsp::GemmOperand<true, BM>;
  using K256 = rsp::GemmOperand<false, 256>;
  using MNB = rsp::GemmOperand<true, 256>;  // MN-major maps do not depend on the width
  CUtensorMap h_maps[2], dh_maps[3], g_maps[6];
  if (!KA::make_map(&h_maps[0], z, T, C) || !K256::make_map(&h_maps[1], w1, M, C) ||
      !KA::make_map(&dh_maps[0], dob, T, C) || !MNB::make_map(&dh_maps[1], w2, C, M) ||
      !KA::make_map(&dh_maps[2], hg, T, M) ||  // dh_kernel's h tile: boxes of 128 x 64
      !MNA::make_map(&g_maps[0], dob, T, C) || !MNB::make_map(&g_maps[1], hg, T, M) ||
      !MNA::make_map(&g_maps[2], dh, T, M) || !MNB::make_map(&g_maps[3], z, T, C) ||
      !KA::make_map(&g_maps[4], dh, T, M) || !MNB::make_map(&g_maps[5], w1, M, C))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err;

  using rsp::ROW_WARPS;
  rsp::ln_stats_kernel<V><<<(T + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
      xb, ga, static_cast<const float*>(beta), z, mu, rstd, T, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  constexpr int h_smem = rsp::GemmTile<false, false, 256>::SMEM;
  if ((err = prepare(hidden_kernel, h_smem)) != cudaSuccess) return static_cast<int>(err);
  hidden_kernel<<<dim3(M / 256, p1), THREADS, h_smem, s>>>(
      h_maps[0], h_maps[1], static_cast<const bf16*>(b1), hg, T, M, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if ((err = prepare(dh_kernel, DhTile::SMEM)) != cudaSuccess) return static_cast<int>(err);
  dh_kernel<<<dim3(M / DhTile::BN, p1), THREADS, DhTile::SMEM, s>>>(
      dh_maps[0], dh_maps[1], dh_maps[2], hg, dh, db1_part, T, M, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  constexpr int g_smem = rsp::GemmTile<true, true, 256>::SMEM;
  static_assert(rsp::GemmTile<false, true, 128>::SMEM <= g_smem, "the dz tiles fit");
  const int g_blocks = (C / BM) * (M / 256) + (M / BM) * (C / 256) + p1 * (C / 128);
  if ((err = prepare(grads_kernel, g_smem)) != cudaSuccess) return static_cast<int>(err);
  grads_kernel<<<g_blocks, THREADS, g_smem, s>>>(
      g_maps[0], g_maps[1], g_maps[2], g_maps[3], g_maps[4], g_maps[5],
      static_cast<bf16*>(dw2), static_cast<bf16*>(dw1), dz, T, C, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  rsp::ln_bwd_rows_kernel<V, true><<<p2, rsp::LNB_WARPS * 32, 0, s>>>(
      xb, dz, ga, dob, mu, rstd, static_cast<bf16*>(dx), row_part, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  using rsp::BS_COLS;
  rsp::bias_sums_kernel<<<(M + 3 * C + BS_COLS - 1) / BS_COLS, BS_COLS * rsp::BS_GROUPS, 0, s>>>(
      db1_part, p1, M, static_cast<bf16*>(db1), row_part, p2, C, 3,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<bf16*>(db2));
  return static_cast<int>(cudaGetLastError());
}

// A' 's mainloop alone, for the tests of its operand layouts: out (rows,
// cols) fp32 = A . B^T, A stored (rows, K) (a_mn = 0) or (K, rows) (a_mn =
// 1), B stored (cols, K) or (K, cols); (a_mn, b_mn, bn) one of the forms A'
// runs: (0, 0, 256), (0, 1, 256), (0, 1, 128), (1, 1, 256). bf16 inputs;
// each stored row a multiple of 8 values (16 bytes), cols even.
extern "C" int rsp_wgmma_gemm_f32(const void* a, const void* b, void* out, int rows,
                                  int cols, int K, int a_mn, int b_mn, int bn,
                                  void* stream) {
  if ((a_mn ? rows : K) % 8 || (b_mn ? cols : K) % 8 || cols % 2 || rows < 1 || cols < 1 ||
      K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (!a_mn && !b_mn && bn == 256) err = launch_f32<false, false, 256>(a, b, o, rows, cols, K, s);
  if (!a_mn && b_mn && bn == 256) err = launch_f32<false, true, 256>(a, b, o, rows, cols, K, s);
  if (!a_mn && b_mn && bn == 128) err = launch_f32<false, true, 128>(a, b, o, rows, cols, K, s);
  if (a_mn && b_mn && bn == 256) err = launch_f32<true, true, 256>(a, b, o, rows, cols, K, s);
  return static_cast<int>(err);
}
