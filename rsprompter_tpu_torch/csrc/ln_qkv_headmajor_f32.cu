// Kernel B at fp32: LayerNorm -> qkv projection -> head-major fp32 (N, 3n,
// S, d), and K12' at fp32, the same projection of tokens already
// normalised; heads of d = 64 or 80. The TPU kernels it stands for
// (rsprompter_tpu/ops/fused_mlp.py:_ln_qkv_kernel, :_strip_qkv_kernel and
// :_qkv_pair_kernel) compute in their inputs' dtype: fp32 in an fp32 config.
//
// Bound on the H100 at ViT-B, batch 2: 29.0 GFLOP for the 8192 real tokens,
// about 59 us at one TF32 pass (494.7 TFLOP/s), so at least about 176 us for
// 3xTF32's three; the fp32 bytes (25 MB in, 76-90 MB out) take 30-35 us.
//
// Design: two kernels, as at bf16.
//  * rsp_ln_rows_f32, the row pass (also kernel A's LN at fp32): one warp
//    per output row gathers its token through the window map (a pad
//    position past (H, W) gets z = 0, so its q / k / v are the bias alone,
//    as in JAX, where LN runs before the zero pad), normalises it with fp32
//    statistics and writes z in fp32 in the windows' row order.
//  * rsp_qkv_headmajor_f32: z (M, C) x W^T + b on tf32_gemm_mainloop
//    (tf32.cuh: 3xTF32 on wgmma, 128 x 128 tiles), each thread storing its
//    accumulator's column pairs straight to their head rows (8 bytes; a
//    pair never straddles two heads, as d is even).
#include "tf32.cuh"

namespace {

constexpr int ROW_WARPS = 8;
constexpr int MAX_CHUNKS = 16;  // 16-byte chunks per lane: C <= 2048

__global__ void __launch_bounds__(ROW_WARPS * 32) ln_rows_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ z, int H, int W, int C, int window,
    int nwx, int nwin, int S, int rows, float eps) {
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
  const int chunks = C / 4;
  float4* zr = reinterpret_cast<float4*>(z + (size_t)m * C);
  if (token < 0) {
    for (int c = lane; c < chunks; c += 32) zr[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* xr = reinterpret_cast<const float4*>(x + token * C);
  if (gamma == nullptr) {
    for (int c = lane; c < chunks; c += 32) zr[c] = xr[c];
    return;
  }
  float4 v[MAX_CHUNKS];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      v[i] = xr[c];
      sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mu = rsp::warp_sum(sum) / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if (lane + 32 * i < chunks) {
      const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
      var += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rs = rsqrtf(rsp::warp_sum(var) / C + eps);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      const float4 g = reinterpret_cast<const float4*>(gamma)[c];
      const float4 b = reinterpret_cast<const float4*>(beta)[c];
      zr[c] = make_float4((v[i].x - mu) * rs * g.x + b.x, (v[i].y - mu) * rs * g.y + b.y,
                          (v[i].z - mu) * rs * g.z + b.z, (v[i].w - mu) * rs * g.w + b.w);
    }
  }
}

__global__ void __launch_bounds__(rsp::TF32_THREADS, 1) qkv_gemm_f32_kernel(
    const float* __restrict__ zin, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int M, int S, int K, int heads3, int d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::align1024(smem_raw);
  const int ncols = heads3 * d;
  const int n0 = blockIdx.x * rsp::TF32_TILE_N;
  const int m0 = blockIdx.y * rsp::TF32_TILE_M;
  float acc[64];
  rsp::tf32_gemm_mainloop(smem, zin, w, M, ncols, K, m0, n0, acc);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= ncols) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
    const int head = col / d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 64 * wg + 16 * warp + g + 8 * half;
      if (m >= M) continue;
      const int n = m / S, s = m % S;
      float* dst = out + (((size_t)n * heads3 + head) * S + s) * d + (col - head * d);
      *reinterpret_cast<float2*>(dst) =
          make_float2(acc[4 * j + 2 * half] + bb.x, acc[4 * j + 2 * half + 1] + bb.y);
    }
  }
}

}  // namespace

// Row pass of kernel B at fp32: x (B, H, W, C) -> z (N*S, C) fp32, the rows
// of the window partition (window == 0: the tokens in order); gamma ==
// nullptr skips the LayerNorm (gather and zero pad only).
extern "C" int rsp_ln_rows_f32(const void* x, const void* gamma, const void* beta, void* z,
                               int B, int H, int W, int C, int window, float eps,
                               void* stream) {
  if (C % 4 != 0 || C > 4 * MAX_CHUNKS * 32) return static_cast<int>(cudaErrorInvalidValue);
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
  ln_rows_f32_kernel<<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(z), H, W, C, window, nwx, nwin, S,
      rows, eps);
  return static_cast<int>(cudaGetLastError());
}

// The GEMM of kernel B and K12' at fp32: x (N*S, C) -> head-major x.W^T + b
// (N, heads3, S, d), d = 64 or 80, C a multiple of 32.
extern "C" int rsp_qkv_headmajor_f32(const void* x, const void* w, const void* bias,
                                     void* out, int N, int S, int C, int heads3, int d,
                                     void* stream) {
  if (C % rsp::TF32_TILE_K != 0 || (d != 64 && d != 80))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rsp::TF32_GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * S;
  const dim3 grid((heads3 * d + rsp::TF32_TILE_N - 1) / rsp::TF32_TILE_N,
                  (M + rsp::TF32_TILE_M - 1) / rsp::TF32_TILE_M);
  qkv_gemm_f32_kernel<<<grid, rsp::TF32_THREADS, rsp::TF32_GEMM_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), M, S, C, heads3, d);
  return static_cast<int>(cudaGetLastError());
}
