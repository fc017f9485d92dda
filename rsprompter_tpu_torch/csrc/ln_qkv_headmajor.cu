// Kernel B: LayerNorm -> qkv projection -> head-major bf16 (N, 3n, S, 64).
//
// Replaces two TPU kernels: rsprompter_tpu/ops/fused_mlp.py:_ln_qkv_kernel
// (fused_ln_qkv, the global layers) and :_strip_qkv_kernel
// (fused_qkv_window_pair, the windowed layers).
//
// Kernel K12' is the same kernel with its LayerNorm compiled out (template
// flag LN = false), entry rsp_qkv_headmajor: flat tokens (N*S, C) -> x.W + b
// head-major (N, 3n, S, 64). It replaces fused_mlp.py:_qkv_pair_kernel
// (fused_qkv_pair) and serves the encoder's 'flash' route, whose tokens are
// already normalised (and, in windowed layers, partitioned and zero-padded)
// in torch; its rows map one to one onto the global row map with H = 1.
//
// One row map covers both cases. Output row (n, s):
//   global   (window == 0): N = B, S = H*W, token (n, s);
//   windowed (window  > 0): N = B*nwy*nwx, S = window^2, grid position
//            (b, wy*window + i, wx*window + j). A position in the pad beyond
//            (H, W) has z = 0, so its q/k/v are the bias alone -- exactly what
//            the JAX layer gives, where LayerNorm runs before the zero pad.
// The window partition and the padded grid never exist in memory.
//
// Bound on the H100 at ViT-B, batch 2: 29.0 GFLOP for the 8192 real tokens
// (about 29 us at 989 TFLOP/s); the bytes (12.6 MB in, 15-19 MB out) take
// about 10 us, so tensor-core operations bound it.
//
// Design: a block owns BM = 32 output rows; it gathers their source tokens
// and normalises them into shared memory once (fp32 statistics, bf16 out).
// It then walks the 3n heads; each head's (32 x 64) product runs on
// mma.sync.m16n8k16 (8 warps, 16 rows x 16 columns each, fp32 accumulators
// in registers) over 64-wide K slices of the weight, double-buffered in
// shared memory by cp.async so the next slice loads while this one
// multiplies. The bias add rounds to bf16 as JAX does, and each head's tile
// is written head-major straight from the registers.
#include "common.cuh"

using rsp::bf16;

namespace {

constexpr int BM = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KS = 64;            // K slice
constexpr int WSTRIDE = KS + 8;   // bf16 row stride of a weight slice

template <bool LN>
__global__ void __launch_bounds__(THREADS) ln_qkv_headmajor_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, bf16* __restrict__ out, int H, int W,
    int C, int heads3, int window, int nwx, int nwin, int S, int rows,
    float eps) {
  // x: (B, H, W, C) tokens; w: qkv weight (heads3*64, C) row-major.
  extern __shared__ __align__(128) unsigned char smem[];
  const int zstride = C + 8;
  bf16* zs = reinterpret_cast<bf16*>(smem);                           // BM x C
  bf16* ws = reinterpret_cast<bf16*>(smem + BM * zstride * 2);        // 2 x 64 x KS

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * BM;
  const int nslices = C / KS;
  const int total = heads3 * nslices;

  // first weight slice in flight while the rows are normalised
  rsp::cp_async_tile(ws, WSTRIDE, w, C, 64, 0, KS, tid, THREADS);
  rsp::cp_async_commit();

  for (int r = warp; r < BM; r += WARPS) {
    const int m = row0 + r;
    long token = -1;
    if (m < rows) {
      const int n = m / S;
      const int s = m % S;
      if (window == 0) {
        token = (long)n * S + s;
      } else {
        const int b = n / nwin;
        const int wi = n % nwin;
        const int gy = (wi / nwx) * window + s / window;
        const int gx = (wi % nwx) * window + s % window;
        if (gy < H && gx < W) token = ((long)b * H + gy) * W + gx;
      }
    }
    bf16* zr = zs + r * zstride;
    if (token < 0) {
      for (int c = lane; c < C; c += 32) zr[c] = rsp::to_bf(0.f);
    } else if constexpr (LN) {
      rsp::warp_layer_norm_row(x + token * C, gamma, beta, zr, C, eps, lane);
    } else {
      for (int c = lane; c < C; c += 32) zr[c] = x[token * C + c];
    }
  }

  constexpr int NTW = 2;    // n-tiles of 8 columns per warp
  const int wr = warp % 2;  // 16-row group
  const int wc = warp / 2;  // 16-column quarter of the head
  float acc[NTW][4];
  for (int it = 0; it < total; ++it) {
    const int head = it / nslices;
    const int ks = it % nslices;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < NTW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    if (it + 1 < total) {
      const int nh = (it + 1) / nslices;
      const int nk = (it + 1) % nslices;
      rsp::cp_async_tile(ws + ((it + 1) & 1) * 64 * WSTRIDE, WSTRIDE,
                         w + (size_t)nh * 64 * C, C, 64, nk * KS, KS, tid, THREADS);
      rsp::cp_async_commit();
      rsp::cp_async_wait<1>();
    } else {
      rsp::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wt = ws + (it & 1) * 64 * WSTRIDE;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t a[4];
      rsp::load_a(a, zs, zstride, wr * 16, ks * KS + kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const bf16* bp = wt + (wc * 8 * NTW + nt * 8 + g) * WSTRIDE + kk * 16 + t * 2;
        rsp::mma_bf16(acc[nt], a, rsp::ld32(bp), rsp::ld32(bp + 8));
      }
    }
    if (ks == nslices - 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = row0 + wr * 16 + g + half * 8;
        if (m < rows) {
          const int n = m / S;
          const int s = m % S;
          bf16* orow = out + (((size_t)n * heads3 + head) * S + s) * 64;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const int d = wc * 8 * NTW + nt * 8 + t * 2;
            const float y0 = rsp::round_bf(acc[nt][half * 2]) + rsp::to_f(bias[head * 64 + d]);
            const float y1 =
                rsp::round_bf(acc[nt][half * 2 + 1]) + rsp::to_f(bias[head * 64 + d + 1]);
            *reinterpret_cast<uint32_t*>(orow + d) = rsp::pack_bf16(y0, y1);
          }
        }
      }
    }
    __syncthreads();  // slice `it` consumed before its buffer is refilled
  }
}

template <bool LN>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           const void* bias, void* out, int B, int H, int W, int C, int heads3,
           int window, float eps, cudaStream_t stream) {
  if (C % KS != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  const int smem = BM * (C + 8) * 2 + 2 * 64 * WSTRIDE * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_headmajor_kernel<LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + BM - 1) / BM;
  ln_qkv_headmajor_kernel<LN><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), H, W, C, heads3,
      window, nwx, nwin, S, rows, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel B; gamma == nullptr skips the LayerNorm.
extern "C" int rsp_ln_qkv_headmajor(const void* x, const void* gamma,
                                    const void* beta, const void* w,
                                    const void* bias, void* out, int B, int H,
                                    int W, int C, int heads3, int window,
                                    float eps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (gamma == nullptr)
    return launch<false>(x, gamma, beta, w, bias, out, B, H, W, C, heads3,
                         window, eps, st);
  return launch<true>(x, gamma, beta, w, bias, out, B, H, W, C, heads3, window,
                      eps, st);
}

// Kernel K12': x (N*S, C) -> head-major x.W + b (N, heads3, S, 64).
extern "C" int rsp_qkv_headmajor(const void* x, const void* w, const void* bias,
                                 void* out, int N, int S, int C, int heads3,
                                 void* stream) {
  return launch<false>(x, nullptr, nullptr, w, bias, out, N, 1, S, C, heads3,
                       0, 0.f, static_cast<cudaStream_t>(stream));
}
