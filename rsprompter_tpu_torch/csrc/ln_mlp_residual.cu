// Kernel A: out = x + fc2(gelu_erf(fc1(LN(x)))) for the SAM ViT MLP half.
//
// Replaces the TPU kernel rsprompter_tpu/ops/fused_mlp.py:_kernel (reached
// through fused_mlp_residual / _fwd).
//
// Bound on the H100: at ViT-B (T = 8192 tokens, C = 768, M = 3072) the two
// products are 77.3 GFLOP, about 78 us at 989 TFLOP/s bf16; the bytes that
// must move (x in, out, 9.4 MB of weights) take under 10 us, and the hidden
// activation h (T, M) bf16, written once and read once, adds about 30 us
// of traffic that stays under the operations bound.
//
// Design: three launches on the stream, each counted by its wrapper.
//  * The row pass (rsp_ln_rows of ln_qkv_headmajor.cu, kernel B's): LN with
//    fp32 statistics, z in bf16 (JAX's first rounding point).
//  * rsp_mlp_gemm, fc1: h = bf16(gelu_erf(bf16(bf16(z W1^T) + b1))).
//  * rsp_mlp_gemm, fc2: out = bf16(x + bf16(h W2^T)) + b2, rounded as JAX.
// One GEMM serves both: a block owns a 128 x BN output tile (BN = 256 for
// fc1's 3072 columns, 128 for fc2's 768, so fc2 still has 384 tiles for the
// 132 SMs) and walks K in 64-wide slices through the mainloop of
// wgmma_gemm.cuh (shared with A'): a producer warpgroup, one thread of which
// issues the TMA loads (128-byte swizzle, mbarriers), keeps a 4-stage ring of
// A and W slices in flight, and two consumer warpgroups run wgmma (bf16 in,
// fp32 accumulators in registers) on 64 rows each, both operands K-major. The
// epilogue rounds the product to bf16 into shared memory, then each thread
// takes 16-byte chunks of it through the bias and GELU or the residual and
// stores them coalesced. Each weight is read by every row tile from L2 once
// per 128 rows, not once per 32.
// The previous design (one launch, mma.sync, BM = 32 rows per block, W1 and
// W2 streamed through cp.async by each of 256 blocks: 2.4 GB of L2 traffic
// per launch, the hidden tile kept on the SM) ran at 9% of its bound.
#include "wgmma_gemm.cuh"

using rsp::bf16;

namespace {

constexpr int BM = rsp::GEMM_TILE_M;
constexpr int THREADS = rsp::GEMM_THREADS_WS;

enum { FC1_GELU = 0, FC2_RESIDUAL = 1 };

template <int BN>
struct Gemm : rsp::GemmTile<false, false, BN> {
  static constexpr int OSTRIDE = BN + 8;  // bf16 row stride of the epilogue's staging
  static_assert(2 * 64 * OSTRIDE * 2 <= rsp::GemmTile<false, false, BN>::RING,
                "staging fits the ring");
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// out (M, N) = epilogue(a (M, K) . w (N, K)^T): see MODE
template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1) mlp_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const bf16* __restrict__ bias, const bf16* __restrict__ resid, bf16* __restrict__ out,
    int M, int N, int K) {
  using G = Gemm<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::gemm_smem(smem_raw);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
  if (!rsp::gemm_mainloop<false, false, BN>(smem, &amap, &wmap, m0, n0, 0,
                                            K / rsp::GEMM_TILE_K, acc))
    return;

  // epilogue: both consumers are done with the ring before it becomes staging
  rsp::gemm_epilogue_begin();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  bf16* stg = reinterpret_cast<bf16*>(smem) + wg * 64 * G::OSTRIDE;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;
      *reinterpret_cast<uint32_t*>(stg + row * G::OSTRIDE + 8 * j + 2 * t) =
          rsp::pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  rsp::named_sync(2 + wg, 128);
  constexpr int CH = BN / 8;  // 16-byte chunks per row
  for (int i = tid; i < 64 * CH; i += 128) {
    const int r = i / CH;
    const int col = n0 + (i % CH) * 8;
    const int m = m0 + wg * 64 + r;
    if (m >= M || col >= N) continue;
    const uint4 pv = *reinterpret_cast<const uint4*>(stg + r * G::OSTRIDE + (i % CH) * 8);
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + col);
    const bf16* p = reinterpret_cast<const bf16*>(&pv);
    const bf16* bb = reinterpret_cast<const bf16*>(&bv);
    const size_t idx = (size_t)m * N + col;
    __align__(16) bf16 y[8];
    if constexpr (MODE == FC1_GELU) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        y[u] = rsp::to_bf(gelu_erf(rsp::round_bf(rsp::to_f(p[u]) + rsp::to_f(bb[u]))));
    } else {
      const uint4 xv = *reinterpret_cast<const uint4*>(resid + idx);
      const bf16* xr = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        y[u] = rsp::to_bf(rsp::round_bf(rsp::to_f(xr[u]) + rsp::to_f(p[u])) + rsp::to_f(bb[u]));
    }
    *reinterpret_cast<uint4*>(out + idx) = *reinterpret_cast<const uint4*>(y);
  }
}

template <int BN, int MODE>
int launch(const void* a, const void* w, const void* bias, const void* resid, void* out,
           int M, int N, int K, cudaStream_t stream) {
  using G = Gemm<BN>;
  CUtensorMap amap, wmap;
  if (!G::A::make_map(&amap, a, M, K) || !G::B::make_map(&wmap, w, N, K))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(mlp_gemm_kernel<BN, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Gemm<BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mlp_gemm_kernel<BN, MODE><<<grid, THREADS, Gemm<BN>::SMEM, stream>>>(
      amap, wmap, static_cast<const bf16*>(bias), static_cast<const bf16*>(resid),
      static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One of kernel A's two products: a (M, K) . w (N, K)^T + bias, then
// mode 0: the exact GELU (fc1; resid unused), mode 1: the residual resid
// (M, N) (fc2). All bf16, row-major; K a multiple of 64, N of 8.
extern "C" int rsp_mlp_gemm(const void* a, const void* w, const void* bias,
                            const void* resid, void* out, int M, int N, int K, int mode,
                            void* stream) {
  if (K % rsp::GEMM_TILE_K != 0 || N % 8 != 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == FC1_GELU) return launch<256, FC1_GELU>(a, w, bias, resid, out, M, N, K, s);
  if (mode == FC2_RESIDUAL)
    return launch<128, FC2_RESIDUAL>(a, w, bias, resid, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
