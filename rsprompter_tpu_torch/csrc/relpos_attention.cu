// Kernel C: softmax(q k^T * d^-0.5 + bias) v with SAM's decomposed rel-pos
// bias, bias[q, key] = fh[q, key / w] + fw[q, key % w].
//
// Replaces the TPU kernels of rsprompter_tpu/ops/fused_vit_attention.py:
// _window_kernel_pair (windowed layers), _global_kernel_pair_tiled (the
// global layers' inference default) and _global_kernel_pair (the exact-softmax
// variant). One exact online softmax in fp32 serves all three; the TPU's +-60
// logit clamp is not carried over (PARITY.md deviation 8).
//
// Inputs: qkv (N, 3n, S, 64) bf16 head-major (q heads, then k, then v), the
// factors fh (N, n, S, h) and fw (N, n, S, w) bf16 from the torch einsum.
// Output: (N, n, S, 64) bf16, and, when the caller asks for it (the
// backward does), the fp32 row log-sum-exp (N, n, S) of the biased scores.
//
// Bound on the H100 at ViT-B, batch 2: a global layer is 103 GFLOP (about
// 104 us at 989 TFLOP/s, operations-bound); a windowed layer is 5.9 GFLOP but
// moves about 70 MB (about 22 us at 3.35 TB/s, bytes-bound).
//
// Design: FlashAttention-2 style on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). A block of 4 warps owns 64 queries of one (n, head); each warp
// owns 16 and keeps its Q fragments, its scores, its probabilities and its
// output accumulator in registers: the scores' accumulator layout is reused
// as the A operand of the P.V product, so neither scores nor probabilities
// touch shared memory. Key tiles (64 rows) and transposed value tiles go
// through shared memory with a padded row stride (no bank conflicts on the
// fragment loads). The bias is rebuilt per key tile from the block's factor
// rows held in shared memory, so no (S, S) tensor exists. Keys past S in the
// last tile are masked to -inf; pad tokens inside a window are real keys and
// are not masked.
#include <math.h>

#include "common.cuh"

using rsp::bf16;
using rsp::ld32;
using rsp::mma_bf16;
using rsp::pack_bf16;

namespace {

constexpr int D = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int FMAX = 64;       // largest h or w the factor tiles hold
constexpr int KSTRIDE = D + 8;   // bf16 row stride of the K / V^T tiles
constexpr int FSTRIDE = FMAX + 1;  // fp32 row stride of the factor tiles

constexpr int OFF_K = 0;
constexpr int OFF_VT = OFF_K + BK * KSTRIDE * 2;
constexpr int OFF_FH = OFF_VT + D * KSTRIDE * 2;
constexpr int OFF_FW = OFF_FH + BQ * FSTRIDE * 4;
constexpr int SMEM = OFF_FW + BQ * FSTRIDE * 4;

__global__ void __launch_bounds__(THREADS) relpos_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ fh,
    const bf16* __restrict__ fw, bf16* __restrict__ out,
    float* __restrict__ lse, int nh, int S, int h, int w, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_K);    // [key][d]
  bf16* vts = reinterpret_cast<bf16*>(smem + OFF_VT);  // [d][key]
  float* fhs = reinterpret_cast<float*>(smem + OFF_FH);
  float* fws = reinterpret_cast<float*>(smem + OFF_FW);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const size_t plane = (size_t)S * D;
  const bf16* qp = qkv + ((size_t)n * 3 * nh + head) * plane;
  const bf16* kp = qp + (size_t)nh * plane;
  const bf16* vp = kp + (size_t)nh * plane;
  const size_t fbase = ((size_t)n * nh + head) * S;

  for (int i = threadIdx.x; i < BQ * FMAX; i += THREADS) {
    const int r = i / FMAX;
    const int j = i % FMAX;
    const bool ok = q0 + r < S;
    fhs[r * FSTRIDE + j] = (ok && j < h) ? rsp::to_f(fh[(fbase + q0 + r) * h + j]) : 0.f;
    fws[r * FSTRIDE + j] = (ok && j < w) ? rsp::to_f(fw[(fbase + q0 + r) * w + j]) : 0.f;
  }

  // this warp's 16 query rows: r0 = g and r1 = g + 8 within the warp
  const int lr0 = warp * 16 + g;  // row within the block
  const int lr1 = lr0 + 8;
  uint32_t qa[D / 16][4];
  {
    const bool ok0 = q0 + lr0 < S;
    const bool ok1 = q0 + lr1 < S;
    const bf16* row0 = qp + (size_t)(q0 + lr0) * D;
    const bf16* row1 = qp + (size_t)(q0 + lr1) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = ok0 ? ld32(row0 + c) : 0u;
      qa[kk][1] = ok1 ? ld32(row1 + c) : 0u;
      qa[kk][2] = ok0 ? ld32(row0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? ld32(row1 + c + 8) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's K / V^T fully consumed
    for (int i = threadIdx.x; i < BK * (D / 8); i += THREADS) {
      const int key = i / (D / 8);
      const int d0 = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + key < S) {
        kv = *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + key) * D + d0);
        vv = *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + key) * D + d0);
      }
      *reinterpret_cast<uint4*>(ks + key * KSTRIDE + d0) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(d0 + j) * KSTRIDE + key] = ve[j];
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp = 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = ks + (nt * 8 + g) * KSTRIDE + t * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + t * 2 + j;
        if (key < S) {
          const int kh = key / w;
          const int kw = key - kh * w;
          s[nt][j] = s[nt][j] * scale + fhs[lr0 * FSTRIDE + kh] + fws[lr0 * FSTRIDE + kw];
          s[nt][2 + j] =
              s[nt][2 + j] * scale + fhs[lr1 * FSTRIDE + kh] + fws[lr1 * FSTRIDE + kw];
        } else {
          s[nt][j] = -INFINITY;
          s[nt][2 + j] = -INFINITY;
        }
        tmax0 = fmaxf(tmax0, s[nt][j]);
        tmax1 = fmaxf(tmax1, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    // every tile holds at least one valid key, so the new max is finite
    const float mn0 = fmaxf(m0, tmax0);
    const float mn1 = fmaxf(m1, tmax1);
    const float a0 = expf(m0 - mn0);  // 0 on the first tile
    const float a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }

    // probabilities, re-packed as the A operand of P.V (k = key)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = expf(s[nt][0] - mn0);
      const float p1 = expf(s[nt][1] - mn0);
      const float p2 = expf(s[nt][2] - mn1);
      const float p3 = expf(s[nt][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      const int kk = nt / 2;
      const int hi = nt % 2;  // keys 8..15 of the 16-key chunk
      pa[kk][hi * 2 + 0] = pack_bf16(p0, p1);
      pa[kk][hi * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const bf16* vr = vts + (dt * 8 + g) * KSTRIDE + t * 2;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_bf16(o[dt], pa[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int qr0 = q0 + lr0;
  const int qr1 = q0 + lr1;
  if (lse != nullptr && t == 0) {  // row log-sum-exp for the backward
    float* lr = lse + ((size_t)n * nh + head) * S;
    if (qr0 < S) lr[qr0] = m0 + logf(l0);
    if (qr1 < S) lr[qr1] = m1 + logf(l1);
  }
  bf16* ob = out + ((size_t)n * nh + head) * plane;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (qr0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qr0 * D + c) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (qr1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qr1 * D + c) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int rsp_relpos_attention(const void* qkv, const void* fh,
                                    const void* fw, void* out, void* lse,
                                    int N, int nh, int S, int h, int w,
                                    float scale, void* stream) {
  if (h > FMAX || w > FMAX || h * w != S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, nh, N);
  relpos_attention_kernel<<<grid, THREADS, SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(fh),
      static_cast<const bf16*>(fw), static_cast<bf16*>(out),
      static_cast<float*>(lse), nh, S, h, w, scale);
  return static_cast<int>(cudaGetLastError());
}
