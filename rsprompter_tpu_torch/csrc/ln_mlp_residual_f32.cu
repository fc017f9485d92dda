// Kernel A at fp32: out = x + fc2(gelu_erf(fc1(LN(x)))) on fp32 activations
// and weights, as the TPU kernel rsprompter_tpu/ops/fused_mlp.py:_kernel
// computes it when its inputs are fp32 (an fp32 config: SAM-det's frozen
// segmentor). Three launches, as the bf16 kernel's: the fp32 row pass
// (rsp_ln_rows_f32 of ln_qkv_headmajor_f32.cu) writes z in fp32, then this
// file's GEMM twice, fc1 with its bias and the exact GELU, fc2 with the
// residual and its bias, nothing rounded below fp32: h = gelu(z W1^T + b1),
// out = (x + h W2^T) + b2, the plain version's order.
//
// Bound on the H100 at ViT-B (T = 8192 tokens, C = 768, M = 3072): 77.3
// GFLOP, about 156 us at one TF32 pass (494.7 TFLOP/s); 3xTF32 makes three
// passes, so the products alone take at least about 470 us. The bytes (x, out,
// 18.9 MB of weights and the (T, M) hidden activation written and read
// once, all fp32) take about 45 us.
//
// Design: tf32_gemm_mainloop (tf32.cuh), a 128 x 128 tile per block of two
// warpgroups, each operand split into TF32 hi and lo on its way into shared
// memory and three wgmma passes per 8-deep slice. The epilogue works from the
// accumulator registers: each thread adds the bias (and GELU, or the
// residual) to its column pairs and stores them 8 bytes at a time.
#include "tf32.cuh"

namespace {

enum { FC1_GELU = 0, FC2_RESIDUAL = 1 };

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int MODE>
__global__ void __launch_bounds__(rsp::TF32_THREADS, 1) mlp_gemm_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ resid, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::align1024(smem_raw);
  const int n0 = blockIdx.x * rsp::TF32_TILE_N;
  const int m0 = blockIdx.y * rsp::TF32_TILE_M;
  float acc[64];
  rsp::tf32_gemm_mainloop(smem, a, w, M, N, K, m0, n0, acc);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= N) continue;  // N is a multiple of 8: col + 1 < N too
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * half;
      if (row >= M) continue;
      const size_t idx = (size_t)row * N + col;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      float2 y;
      if constexpr (MODE == FC1_GELU) {
        y = make_float2(gelu_erf(v0 + bb.x), gelu_erf(v1 + bb.y));
      } else {
        const float2 x = *reinterpret_cast<const float2*>(resid + idx);
        y = make_float2((x.x + v0) + bb.x, (x.y + v1) + bb.y);
      }
      *reinterpret_cast<float2*>(out + idx) = y;
    }
  }
}

template <int MODE>
int launch(const void* a, const void* w, const void* bias, const void* resid, void* out,
           int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_gemm_f32_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         rsp::TF32_GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + rsp::TF32_TILE_N - 1) / rsp::TF32_TILE_N,
                  (M + rsp::TF32_TILE_M - 1) / rsp::TF32_TILE_M);
  mlp_gemm_f32_kernel<MODE><<<grid, rsp::TF32_THREADS, rsp::TF32_GEMM_SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(resid),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One of kernel A's two products at fp32: a (M, K) . w (N, K)^T + bias,
// then mode 0: the exact GELU (fc1; resid unused), mode 1: the residual
// resid (M, N) added before the bias (fc2). All fp32, row-major; K a
// multiple of 32, N of 8.
extern "C" int rsp_mlp_gemm_f32(const void* a, const void* w, const void* bias,
                                const void* resid, void* out, int M, int N, int K, int mode,
                                void* stream) {
  if (K % rsp::TF32_TILE_K != 0 || N % 8 != 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == FC1_GELU) return launch<FC1_GELU>(a, w, bias, resid, out, M, N, K, s);
  if (mode == FC2_RESIDUAL) return launch<FC2_RESIDUAL>(a, w, bias, resid, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
