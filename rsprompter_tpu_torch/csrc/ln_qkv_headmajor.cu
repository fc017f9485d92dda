// Kernel B: LayerNorm -> qkv projection -> head-major bf16 (N, 3n, S, d),
// and kernel K12', the same projection of tokens that are already normalised.
// Heads of d = 64 (ViT-B, ViT-L) or 80 (ViT-H) columns.
//
// Replaces three TPU kernels: rsprompter_tpu/ops/fused_mlp.py:_ln_qkv_kernel
// (fused_ln_qkv, the global layers), :_strip_qkv_kernel
// (fused_qkv_window_pair, the windowed layers) and :_qkv_pair_kernel
// (fused_qkv_pair, K12, which the encoder's 'flash' route runs on tokens
// normalised and window-partitioned in torch).
//
// Bound on the H100 at ViT-B, batch 2: 29.0 GFLOP for the 8192 real tokens
// (about 29 us at 989 TFLOP/s); the bytes (12.6 MB in, 38-45 MB out) take
// 15-17 us, so tensor-core operations bound it, with the head-major output
// close behind.
//
// Design: two kernels.
//  * rsp_ln_rows, the row pass: one warp per output row gathers its token
//    through the window map (a pad position past (H, W) gets z = 0, so its
//    q / k / v are the bias alone, as in JAX, where LN runs before the zero
//    pad), normalises it with fp32 statistics and writes z in bf16 (JAX's
//    first rounding point) in the windows' row order. The padded grid never
//    exists apart from z itself, which is one pass at device-memory speed.
//  * rsp_qkv_headmajor, a pure GEMM z (M, C) x W^T (C, heads3*d) that
//    serves kernel B and K12' alike. A block owns a 128 x 256 output tile
//    (four heads of 64, 3.2 of 80) and walks only K, in 64-wide slices:
//    one producer warp keeps a 4-stage ring of z and W slices in flight by
//    TMA (128-byte swizzle, completion on mbarriers), and two consumer
//    warpgroups each run wgmma.m64n256k16 (bf16 in, fp32 accumulators in
//    registers) on 64 rows, keeping one product group in flight while the
//    next slice lands. The
//    epilogue rounds the product to bf16, adds the bias and rounds again (as
//    JAX does), stages the tile in shared memory, and writes each token's
//    head rows (128 or 160 bytes) with 16-byte coalesced stores: an
//    8-column chunk never straddles two heads, as 8 divides d. Rows past M
//    and columns past heads3*d read zeros from TMA and are not stored.
// The previous design walked all 36 heads x 12 K-slices inside each 32-row
// block (432 dependent mma.sync steps, the whole 3.5 MB weight streamed from
// L2 by each of 256-307 blocks): latency bound at 5.8-6.8% of its bound.
#include "hopper.cuh"

using rsp::bf16;

namespace {

// ------------------------------------------------------------------ row pass

constexpr int ROW_WARPS = 8;
constexpr int MAX_CHUNKS = 8;  // 16-byte chunks per lane: C <= 2048

__global__ void __launch_bounds__(ROW_WARPS * 32) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ z, int H, int W, int C,
    int window, int nwx, int nwin, int S, int rows, float eps) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (m >= rows) return;
  const int n = m / S;
  const int s = m % S;
  long token = -1;
  if (window == 0) {
    token = (long)n * S + s;
  } else {
    const int b = n / nwin;
    const int wi = n % nwin;
    const int gy = (wi / nwx) * window + s / window;
    const int gx = (wi % nwx) * window + s % window;
    if (gy < H && gx < W) token = ((long)b * H + gy) * W + gx;
  }
  const int chunks = C / 8;
  uint4* zr = reinterpret_cast<uint4*>(z + (size_t)m * C);
  if (token < 0) {
    for (int c = lane; c < chunks; c += 32) zr[c] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + token * C);
  if (gamma == nullptr) {
    for (int c = lane; c < chunks; c += 32) zr[c] = xr[c];
    return;
  }
  float v[MAX_CHUNKS][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      const uint4 raw = xr[c];
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = rsp::to_f(e[j]);
        sum += v[i][j];
      }
    }
  }
  const float mu = rsp::warp_sum(sum) / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mu;
        var += d * d;
      }
    }
  }
  const float rs = rsqrtf(rsp::warp_sum(var) / C + eps);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      const float4* g4 = reinterpret_cast<const float4*>(gamma + c * 8);
      const float4* b4 = reinterpret_cast<const float4*>(beta + c * 8);
      const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = rsp::pack_bf16((v[i][2 * j] - mu) * rs * gg[2 * j] + bb[2 * j],
                              (v[i][2 * j + 1] - mu) * rs * gg[2 * j + 1] + bb[2 * j + 1]);
      zr[c] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// ---------------------------------------------------------------- the GEMM

constexpr int BM = 128;  // two consumer warpgroups of 64 rows
constexpr int BN = 256;  // four heads
constexpr int BK = 64;   // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OSTRIDE = BN + 8;  // bf16 row stride of the epilogue's staging
constexpr int THREADS = 384;     // consumers 0-255, producer warpgroup 256-383
constexpr int GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(2 * 64 * OSTRIDE * 2 <= STAGES * STAGE_BYTES, "staging fits the ring");

__global__ void __launch_bounds__(THREADS, 1) qkv_gemm_kernel(
    const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap wmap,
    const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int S, int K,
    int heads3, int d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (rsp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  const int ktiles = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rsp::mbar_init(&full[s], 1);
      rsp::mbar_init(&empty[s], 256);
    }
    rsp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every TMA load
    rsp::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) rsp::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        rsp::mbar_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* st = smem + s * STAGE_BYTES;
        rsp::tma_load_2d(st, &zmap, &full[s], kt * BK, m0);
        rsp::tma_load_2d(st + A_BYTES, &wmap, &full[s], kt * BK, n0);
      }
    }
  } else {  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
    rsp::setmaxnreg_inc<232>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % STAGES;
      rsp::mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* a = smem + s * STAGE_BYTES + wg * (64 * 128);
      const unsigned char* b = smem + s * STAGE_BYTES + A_BYTES;
      rsp::fence_regs(acc);
      rsp::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        rsp::wgmma_m64n256k16_ss(acc, rsp::sw128_desc(a + 32 * k), rsp::sw128_desc(b + 32 * k));
      rsp::wgmma_commit();
      rsp::wgmma_wait<1>();  // the previous slice's products are done
      rsp::fence_regs(acc);
      if (kt > 0) rsp::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    rsp::wgmma_wait<0>();
    rsp::fence_regs(acc);

    // epilogue: both consumers are done with the ring before it becomes staging
    rsp::named_sync(1, 256);
    rsp::fence_async_shared();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int ncols = heads3 * d;
    bf16* stg = reinterpret_cast<bf16*>(smem) + wg * 64 * OSTRIDE;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const int gc = n0 + col;
      const float b0 = gc < ncols ? rsp::to_f(bias[gc]) : 0.f;
      const float b1 = gc + 1 < ncols ? rsp::to_f(bias[gc + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half;
        const float y0 = rsp::round_bf(acc[4 * j + 2 * half]) + b0;
        const float y1 = rsp::round_bf(acc[4 * j + 2 * half + 1]) + b1;
        *reinterpret_cast<uint32_t*>(stg + row * OSTRIDE + col) = rsp::pack_bf16(y0, y1);
      }
    }
    rsp::named_sync(2 + wg, 128);
    for (int i = tid; i < 64 * (BN / 8); i += 128) {
      const int r = i / (BN / 8);
      const int ch = i % (BN / 8);
      const int m = m0 + wg * 64 + r;
      const int col = n0 + ch * 8;
      const int head = col / d;
      if (m < M && head < heads3) {
        const int n = m / S;
        const int s = m % S;
        bf16* dst = out + (((size_t)n * heads3 + head) * S + s) * d + (col - head * d);
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(stg + r * OSTRIDE + ch * 8);
      }
    }
  }
}

}  // namespace

// Row pass of kernel B: x (B, H, W, C) -> z (N*S, C) bf16, the rows of the
// window partition (window == 0: the tokens in order); gamma == nullptr
// skips the LayerNorm (gather and zero pad only).
extern "C" int rsp_ln_rows(const void* x, const void* gamma, const void* beta, void* z,
                           int B, int H, int W, int C, int window, float eps,
                           void* stream) {
  if (C % 64 != 0 || C > 8 * MAX_CHUNKS * 32) return static_cast<int>(cudaErrorInvalidValue);
  int S, N, nwx = 1, nwin = 1;
  if (window == 0) {
    S = H * W;
    N = B;
  } else {
    const int nwy = (H + window - 1) / window;
    nwx = (W + window - 1) / window;
    nwin = nwy * nwx;
    S = window * window;
    N = B * nwin;
  }
  const int rows = N * S;
  ln_rows_kernel<<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(z), H, W, C, window, nwx,
      nwin, S, rows, eps);
  return static_cast<int>(cudaGetLastError());
}

// The GEMM of kernel B and K12': x (N*S, C) -> head-major x.W^T + b
// (N, heads3, S, d), d = 64 or 80.
extern "C" int rsp_qkv_headmajor(const void* x, const void* w, const void* bias,
                                 void* out, int N, int S, int C, int heads3, int d,
                                 void* stream) {
  if (C % BK != 0 || (d != 64 && d != 80)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = N * S;
  CUtensorMap zmap, wmap;
  const cuuint64_t zdims[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)C, (cuuint64_t)heads3 * d};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t zbox[2] = {BK, BM};
  const cuuint32_t wbox[2] = {BK, BN};
  if (!rsp::make_tensor_map(&zmap, x, 2, zdims, strides, zbox) ||
      !rsp::make_tensor_map(&wmap, w, 2, wdims, strides, wbox))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((heads3 * d + BN - 1) / BN, (M + BM - 1) / BM);
  qkv_gemm_kernel<<<grid, THREADS, GEMM_SMEM, static_cast<cudaStream_t>(stream)>>>(
      zmap, wmap, static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, S, C,
      heads3, d);
  return static_cast<int>(cudaGetLastError());
}
