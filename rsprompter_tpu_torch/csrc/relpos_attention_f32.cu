// Kernel C at fp32: softmax(q k^T * d^-0.5 + bias) v with SAM's decomposed
// rel-pos bias, bias[q, key] = fh[q, key / w] + fw[q, key % w], on fp32 qkv
// and factors, as the TPU kernels of rsprompter_tpu/ops/fused_vit_attention.py
// (_window_kernel_pair, _global_kernel_pair_tiled, _global_kernel_pair)
// compute it in an fp32 config. Exact online softmax in fp32, as the bf16
// kernel's; p stays fp32 into P V.
//
// Inputs: qkv (N, 3n, S, d) fp32 head-major, d = 64 or 80, fh (N, n, S, h)
// and fw (N, n, S, w) fp32. Output (N, n, S, d) fp32. No row log-sum-exp:
// there is no fp32 backward kernel yet, and an encoder that takes gradients
// runs the bf16 kernels.
//
// Bound on the H100 at 1024^2, batch 2, ViT-B: a global layer is 103 GFLOP,
// about 208 us at one TF32 pass (494.7 TFLOP/s) and at least three times
// that for 3xTF32's three; a windowed layer moves about 134 MB of fp32
// (about 40 us at 3.35 TB/s) for 4.2 GFLOP.
//
// Design: one path for every grid up to 64 x 64. A block is one warpgroup
// and owns 64 queries of one (image, head) plane; it walks the keys in
// tiles of 64 with an online softmax.
//  * Q is the A operand of S = Q K^T from registers: each thread loads its
//    fragment once and keeps its TF32 hi and lo parts.
//  * Each key tile is loaded by the block's threads, split into hi and lo
//    and written to shared memory swizzled: K as stored (keys x d, K-major
//    for Q K^T), V transposed (d x keys), because .tf32 wgmma reads its B
//    operand K-major only and the reduction of P V runs over the keys. The
//    transpose happens in that same pass, so no transposed copy of V exists
//    in device memory and kernel B's output layout is the bf16 one.
//  * P is the A operand of P V from registers, split in registers. A TF32 A
//    fragment holds columns t and t + 4 of an 8-key slice where the score
//    accumulator holds 2 t and 2 t + 1, so the keys of each slice are
//    permuted instead of the registers: V^T's column t holds key 2 t and
//    column t + 4 key 2 t + 1.
//  * The bias is looked up from the block's factor rows, staged once in
//    shared memory in fp32 and scaled by log2 e: a score is one fma and one
//    exp2. Keys past S are masked to -inf (pad tokens inside a window are
//    real keys); K and V rows past S are zeros.
// Each product is three wgmma passes (lo.hi, hi.lo, hi.hi: tf32.cuh).
// Shared memory: K hi / lo (2 x 16 or 24 KB), V^T hi / lo (2 x 16 or 20 KB)
// and the factor rows (64 (h + w) fp32, up to 32 KB).
#include <math.h>

#include "tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;  // queries a block
constexpr int BK = 64;  // keys a tile

template <int D>
struct Tiles {
  static_assert(D == 64 || D == 80, "head dim 64 or 80");
  static constexpr int KC = (D + 31) / 32;  // 32-column chunks of a K row
  static constexpr int KCH = BK * 128;      // one chunk of the K tile
  static constexpr int KT = KC * KCH;       // the K tile, hi or lo
  static constexpr int VCH = D * 128;       // one 32-key chunk of V^T (D rows)
  static constexpr int VT = 2 * VCH;        // the V^T tile, hi or lo
  static constexpr int OFF_KHI = 0, OFF_KLO = KT, OFF_VHI = 2 * KT, OFF_VLO = 2 * KT + VT;
  static constexpr int OFF_FACT = 2 * KT + 2 * VT;
  static int smem(int h, int w) { return 1024 + OFF_FACT + BQ * (h + w) * 4; }
};

template <int D>
__device__ __forceinline__ void pv_k8(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t v) {
  if constexpr (D == 64) rsp::wgmma_m64n64k8_tf32_rs(o, p, v);
  else rsp::wgmma_m64n80k8_tf32_rs(o, p, v);
}

template <int D>
__global__ void __launch_bounds__(128) relpos_attention_f32_kernel(
    const float* __restrict__ qkv, const float* __restrict__ fh, const float* __restrict__ fw,
    float* __restrict__ out, int nh, int S, int h, int w, float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = rsp::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int head = blockIdx.y, img = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const size_t plane = (size_t)S * D;
  const float* qp = qkv + ((size_t)img * 3 * nh + head) * plane;
  const float* kp = qp + nh * plane;
  const float* vp = kp + nh * plane;
  const size_t frow = ((size_t)img * nh + head) * S + q0;  // the block's first factor row

  // the block's factor rows, scaled by log2 e; rows past S hold zeros
  float* fhs = reinterpret_cast<float*>(smem + T::OFF_FACT);
  float* fws = fhs + BQ * h;
  const int valid = min(BQ, S - q0);
  for (int i = tid; i < BQ * h; i += 128)
    fhs[i] = i < valid * h ? fh[frow * h + i] * LOG2E : 0.f;
  for (int i = tid; i < BQ * w; i += 128)
    fws[i] = i < valid * w ? fw[frow * w + i] * LOG2E : 0.f;

  // this thread's Q fragments (rows r0, r0 + 8; columns 8 s + t, + 4), split
  const int rl0 = 16 * warp + g, rl1 = rl0 + 8;
  uint32_t qh[D / 8][4], ql[D / 8][4];
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + (i & 1 ? rl1 : rl0);
      const int c = 8 * s + t + (i & 2 ? 4 : 0);
      rsp::tf32_split(r < S ? qp[(size_t)r * D + c] : 0.f, qh[s][i], ql[s][i]);
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units), rows rl0, rl1
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums
  const int ntiles = (S + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // the last tile's products are done with the tiles
    // K (keys x D) as stored and V^T (D x keys, keys permuted within each
    // 8-key slice), both split, rows past S zero
    for (int i = tid; i < BK * (D / 4); i += 128) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      const int key = k0 + r;
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 kv = key < S ? *reinterpret_cast<const float4*>(kp + (size_t)key * D + 4 * c4)
                                : z4;
      const float4 vv = key < S ? *reinterpret_cast<const float4*>(vp + (size_t)key * D + 4 * c4)
                                : z4;
      const int off = (c4 / 8) * T::KCH + rsp::sw128_off(r, c4 % 8);
      rsp::split_store4(smem + T::OFF_KHI + off, smem + T::OFF_KLO + off, kv);
      const int kpos = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
      const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 4 * c4 + e;
        const int voff = (kpos / 32) * T::VCH + rsp::sw128_off(row, (kpos % 32) / 4) +
                         (kpos % 4) * 4;
        const float hi = rsp::tf32_round(ve[e]);
        *reinterpret_cast<float*>(smem + T::OFF_VHI + voff) = hi;
        *reinterpret_cast<float*>(smem + T::OFF_VLO + voff) = rsp::tf32_round(ve[e] - hi);
      }
    }
    rsp::fence_async_shared();
    __syncthreads();

    float sc[BK / 2];  // S = Q K^T: row rl0 / rl1, key k0 + 8 j + 2 t + e at 4 j + 2 half + e
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    rsp::fence_regs(sc);
    rsp::wgmma_fence();
#pragma unroll
    for (int s = 0; s < D / 8; ++s) {
      const int off = (s / 4) * T::KCH + 32 * (s % 4);
      const uint64_t kh = rsp::sw128_desc(smem + T::OFF_KHI + off);
      const uint64_t kl = rsp::sw128_desc(smem + T::OFF_KLO + off);
      rsp::wgmma_m64n64k8_tf32_rs(sc, ql[s], kh);
      rsp::wgmma_m64n64k8_tf32_rs(sc, qh[s], kl);
      rsp::wgmma_m64n64k8_tf32_rs(sc, qh[s], kh);
    }
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(sc);

    // biased scores in log2 units, keys past S masked
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        float v0 = -INFINITY, v1 = -INFINITY;
        if (key < S) {
          const int kh = key / w, kw = key - kh * w;
          v0 = fmaf(sc[4 * j + e], scale_log2, fhs[rl0 * h + kh] + fws[rl0 * w + kw]);
          v1 = fmaf(sc[4 * j + 2 + e], scale_log2, fhs[rl1 * h + kh] + fws[rl1 * w + kw]);
        }
        sc[4 * j + e] = v0;
        sc[4 * j + 2 + e] = v1;
        tmax0 = fmaxf(tmax0, v0);
        tmax1 = fmaxf(tmax1, v1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    // every tile holds at least one valid key, so the new max is finite
    const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p00 = exp2f(sc[4 * j] - mn0), p01 = exp2f(sc[4 * j + 1] - mn0);
      const float p10 = exp2f(sc[4 * j + 2] - mn1), p11 = exp2f(sc[4 * j + 3] - mn1);
      s0 += p00 + p01;
      s1 += p10 + p11;
      // A fragment of slice j: (row rl0, key 2 t), (rl1, 2 t), (rl0, 2 t + 1), (rl1, 2 t + 1)
      rsp::tf32_split(p00, ph[j][0], pl[j][0]);
      rsp::tf32_split(p10, ph[j][1], pl[j][1]);
      rsp::tf32_split(p01, ph[j][2], pl[j][2]);
      rsp::tf32_split(p11, ph[j][3], pl[j][3]);
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    rsp::fence_regs(o);
    rsp::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int off = (j / 4) * T::VCH + 32 * (j % 4);
      const uint64_t vh = rsp::sw128_desc(smem + T::OFF_VHI + off);
      const uint64_t vl = rsp::sw128_desc(smem + T::OFF_VLO + off);
      pv_k8<D>(o, pl[j], vh);
      pv_k8<D>(o, ph[j], vl);
      pv_k8<D>(o, ph[j], vh);
    }
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* ob = out + ((size_t)img * nh + head) * plane;
  const int r0 = q0 + rl0, r1 = q0 + rl1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<float2*>(ob + (size_t)r0 * D + c) =
          make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<float2*>(ob + (size_t)r1 * D + c) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D>
int launch(const float* qkv, const float* fh, const float* fw, float* out, int N, int nh,
           int S, int h, int w, float scale, cudaStream_t stream) {
  const int smem = Tiles<D>::smem(h, w);
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, nh, N);
  relpos_attention_f32_kernel<D><<<grid, 128, smem, stream>>>(qkv, fh, fw, out, nh, S, h, w,
                                                              scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (N, 3 nh, S, d) fp32 with d = 64 or 80 -> out (N, nh, S, d) fp32.
extern "C" int rsp_relpos_attention_f32(const void* qkv, const void* fh, const void* fw,
                                        void* out, void* lse, int N, int nh, int S, int h,
                                        int w, int d, float scale, void* stream) {
  if (h > 64 || w > 64 || h * w != S || (d != 64 && d != 80) || lse != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto q = static_cast<const float*>(qkv);
  auto a = static_cast<const float*>(fh);
  auto b = static_cast<const float*>(fw);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(q, a, b, o, N, nh, S, h, w, scale, st)
                 : launch<80>(q, a, b, o, N, nh, S, h, w, scale, st);
}
