// Kernel C': backward of softmax(q k^T * scale + bias) v with SAM's
// decomposed rel-pos bias, bias[q, key] = fh[q, key / w] + fw[q, key % w].
//
// Replaces the TPU kernels of rsprompter_tpu/ops/fused_vit_attention.py:
// _window_bwd_kernel_pair (windowed layers) and _global_bwd_kernel_pair
// (global layers), both reached through _pair_bwd_kernel_call. Per head:
//   P = softmax(S),  dV = P^T dO,  dP = dO V^T,  delta = rowsum(dP * P)
//   dS = P * (dP - delta),  dQ = scale * dS K,  dK = scale * dS^T Q,
//   dfh[q, r] = sum_{key / w == r} dS[q, key],  dfw[q, c] = sum_{key % w == c} dS[q, key]
// with dS and P rounded to bf16 before their products, as the JAX body
// (_attend_one_bwd) rounds them. The factors' own backward (the rel-pos
// tables and the extra dq term) stays in torch autograd, as JAX keeps it
// outside its kernel.
//
// Inputs: qkv (N, 3n, S, 64), fh (N, n, S, h), fw (N, n, S, w), the
// forward's output O (N, n, S, 64) and dO, all bf16, and the forward's fp32
// row log-sum-exp (N, n, S). Outputs: dqkv (N, 3n, S, 64), dfh, dfw bf16;
// delta (N, n, S) fp32 is scratch.
//
// Bound on the H100 at ViT-B, 512^2, batch 4: a global layer (4 images,
// 12 heads, S = 1024) recomputes q k^T and does four more S x S x 64
// products, 5 x 2*48*1024^2*64 = 32.2 GFLOP (33 us at 989 TFLOP/s bf16); a
// windowed layer (36 windows, S = 196) is 5.3 GFLOP but moves about 40 MB
// (12 us at 3.35 TB/s).
//
// Design: FlashAttention-2's backward without the TPU's whole-row residency.
// The forward kernel (relpos_attention.cu) writes the row log-sum-exp, so P
// is recomputed tile by tile as exp(S - lse), and delta is rowsum(dO * O),
// which equals rowsum(dP * P). Two kernels, each a block of 4 warps over 64
// rows of one (n, head):
// - dq pass, per query block: walks the key tiles; q and dO fragments stay
//   in registers, dS is re-packed from its accumulators as the A operand of
//   dS K; each warp writes its 16 x 64 dS tile to shared memory and its lanes
//   add the dfh / dfw group sums into per-row accumulators in a fixed order
//   (each (row, group) owned by one lane: no atomics).
// - dk/dv pass, per key block: walks the query tiles; k and v fragments stay
//   in registers, the transposed scores S^T = K Q^T are recomputed with the
//   queries' factor rows, lse and delta staged in shared memory.
// Every gradient is written once: results are the same from run to run.
#include <math.h>

#include "common.cuh"

using rsp::bf16;
using rsp::ld32;
using rsp::mma_bf16;
using rsp::pack_bf16;

namespace {

constexpr int D = 64;
constexpr int BR = 64;  // rows (queries or keys) per block
constexpr int BT = 64;  // tile of the other axis
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int FMAX = 64;
constexpr int KSTRIDE = D + 8;     // bf16 row stride of q/k/v/dO tiles
constexpr int FSTRIDE = FMAX + 1;  // fp32 row stride of factor tiles
constexpr int DSTRIDE = BT + 4;    // fp32 row stride of a warp's dS tile

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragment (k = rows kk..kk+15 of a [row][d] tile, n = d columns dc..dc+7)
// from a tile stored row-major: the transposed read of a K, Q or dO tile.
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* tile, int kk, int dc,
                                        int lane) {
  const bf16* p = tile + (kk + 2 * (lane % 4)) * KSTRIDE + dc + lane / 4;
  b0 = pack2(p[0], p[KSTRIDE]);
  b1 = pack2(p[8 * KSTRIDE], p[9 * KSTRIDE]);
}

// A fragments of 16 rows of a (rows, 64) bf16 matrix in device memory.
__device__ __forceinline__ void load_rows_a(uint32_t (&a)[D / 16][4],
                                            const bf16* base, int r0, int r1,
                                            int S, int t) {
  const bool ok0 = r0 < S;
  const bool ok1 = r1 < S;
  const bf16* p0 = base + (size_t)r0 * D;
  const bf16* p1 = base + (size_t)r1 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    a[kk][0] = ok0 ? ld32(p0 + c) : 0u;
    a[kk][1] = ok1 ? ld32(p1 + c) : 0u;
    a[kk][2] = ok0 ? ld32(p0 + c + 8) : 0u;
    a[kk][3] = ok1 ? ld32(p1 + c + 8) : 0u;
  }
}

// Rows [r0, r0 + BT) of a (S, 64) bf16 matrix into a shared tile, 0 past S.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * KSTRIDE + c) = v;
  }
}

// Factor rows [r0, r0 + 64) of fh / fw into fp32 shared tiles, 0 past S.
__device__ __forceinline__ void load_factors(float* fhs, float* fws,
                                             const bf16* fh, const bf16* fw,
                                             size_t fbase, int r0, int S,
                                             int h, int w) {
  for (int i = threadIdx.x; i < BR * FMAX; i += THREADS) {
    const int r = i / FMAX;
    const int j = i % FMAX;
    const bool ok = r0 + r < S;
    fhs[r * FSTRIDE + j] = (ok && j < h) ? rsp::to_f(fh[(fbase + r0 + r) * h + j]) : 0.f;
    fws[r * FSTRIDE + j] = (ok && j < w) ? rsp::to_f(fw[(fbase + r0 + r) * w + j]) : 0.f;
  }
}

// dq pass shared memory
constexpr int DQ_K = 0;
constexpr int DQ_V = DQ_K + BT * KSTRIDE * 2;
constexpr int DQ_FH = DQ_V + BT * KSTRIDE * 2;
constexpr int DQ_FW = DQ_FH + BR * FSTRIDE * 4;
constexpr int DQ_DS = DQ_FW + BR * FSTRIDE * 4;
constexpr int DQ_AH = DQ_DS + WARPS * 16 * DSTRIDE * 4;
constexpr int DQ_AW = DQ_AH + WARPS * 16 * FMAX * 4;
constexpr int DQ_SMEM = DQ_AW + WARPS * 16 * FMAX * 4;

__global__ void __launch_bounds__(THREADS) relpos_attention_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ fh,
    const bf16* __restrict__ fw, const bf16* __restrict__ out,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dqkv, bf16* __restrict__ dfh, bf16* __restrict__ dfw,
    float* __restrict__ delta_out, int nh, int S, int h, int w, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + DQ_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + DQ_V);
  float* fhs = reinterpret_cast<float*>(smem + DQ_FH);
  float* fws = reinterpret_cast<float*>(smem + DQ_FW);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float* dsw = reinterpret_cast<float*>(smem + DQ_DS) + warp * 16 * DSTRIDE;
  float* ah = reinterpret_cast<float*>(smem + DQ_AH) + warp * 16 * FMAX;
  float* aw = reinterpret_cast<float*>(smem + DQ_AW) + warp * 16 * FMAX;

  const int q0 = blockIdx.x * BR;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const size_t plane = (size_t)S * D;
  const bf16* qp = qkv + ((size_t)n * 3 * nh + head) * plane;
  const bf16* kp = qp + (size_t)nh * plane;
  const bf16* vp = kp + (size_t)nh * plane;
  const size_t hb = (size_t)n * nh + head;  // (n, head) of O, dO, lse, factors
  const size_t fbase = hb * S;

  load_factors(fhs, fws, fh, fw, fbase, q0, S, h, w);
  for (int i = lane; i < 16 * FMAX; i += 32) ah[i] = aw[i] = 0.f;

  const int lr0 = warp * 16 + g;
  const int lr1 = lr0 + 8;
  const int qr0 = q0 + lr0;
  const int qr1 = q0 + lr1;
  uint32_t qa[D / 16][4];
  uint32_t da[D / 16][4];
  load_rows_a(qa, qp, qr0, qr1, S, t);
  load_rows_a(da, dout + hb * plane, qr0, qr1, S, t);

  // delta = rowsum(dO * O) over this thread's 16 columns, then the quad
  float d0 = 0.f, d1 = 0.f, ls0 = 0.f, ls1 = 0.f;
  {
    const bf16* op = out + hb * plane;
    const bf16* dp = dout + hb * plane;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kk * 16 + t * 2 + (j & 1) + (j >> 1) * 8;
        if (qr0 < S) d0 += rsp::to_f(dp[(size_t)qr0 * D + c]) * rsp::to_f(op[(size_t)qr0 * D + c]);
        if (qr1 < S) d1 += rsp::to_f(dp[(size_t)qr1 * D + c]) * rsp::to_f(op[(size_t)qr1 * D + c]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    if (qr0 < S) ls0 = lse[fbase + qr0];
    if (qr1 < S) ls1 = lse[fbase + qr1];
    if (t == 0) {
      if (qr0 < S) delta_out[fbase + qr0] = d0;
      if (qr1 < S) delta_out[fbase + qr1] = d1;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();  // previous K / V tiles consumed
    load_tile(ks, kp, k0, S);
    load_tile(vs, vp, k0, S);
    __syncthreads();

    float s[BT / 8][4];
    float dp[BT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const bf16* kr = ks + (nt * 8 + g) * KSTRIDE + t * 2;
      const bf16* vr = vs + (nt * 8 + g) * KSTRIDE + t * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
        mma_bf16(dp[nt], da[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }
    // dS (bf16-rounded) into s
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + t * 2 + j;
        float ds0 = 0.f, ds1 = 0.f;
        if (key < S) {
          const int kh = key / w;
          const int kw = key - kh * w;
          if (qr0 < S) {
            const float p = expf(s[nt][j] * scale + fhs[lr0 * FSTRIDE + kh] +
                                 fws[lr0 * FSTRIDE + kw] - ls0);
            ds0 = rsp::round_bf(p * (dp[nt][j] - d0));
          }
          if (qr1 < S) {
            const float p = expf(s[nt][2 + j] * scale + fhs[lr1 * FSTRIDE + kh] +
                                 fws[lr1 * FSTRIDE + kw] - ls1);
            ds1 = rsp::round_bf(p * (dp[nt][2 + j] - d1));
          }
        }
        s[nt][j] = ds0;
        s[nt][2 + j] = ds1;
      }
    }
    // dq += dS K
    uint32_t pa[BT / 16][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(s[nt][0], s[nt][1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        uint32_t b0, b1;
        load_bt(b0, b1, ks, kk * 16, dt * 8, lane);
        mma_bf16(acc[dt], pa[kk], b0, b1);
      }

    // dfh / dfw: the warp's dS tile through shared memory, then fixed-order
    // group sums, each (row, group) owned by one lane
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + t * 2 + j;
        dsw[g * DSTRIDE + col] = s[nt][j];
        dsw[(g + 8) * DSTRIDE + col] = s[nt][2 + j];
      }
    __syncwarp();
    const int kend = min(BT, S - k0);
    const int res0 = k0 % w;
    const int r_first = k0 / w;
    const int r_count = (k0 + kend - 1) / w - r_first + 1;
    for (int i = 0; i < 16; ++i) {
      const float* row = dsw + i * DSTRIDE;
      for (int c = lane; c < w; c += 32) {
        float sum = 0.f;
        for (int kk = (c - res0 + w) % w; kk < kend; kk += w) sum += row[kk];
        aw[i * FMAX + c] += sum;
      }
      for (int rr = lane; rr < r_count; rr += 32) {
        const int r = r_first + rr;
        const int lo = max(r * w, k0) - k0;
        const int hi = min(r * w + w, k0 + kend) - k0;
        float sum = 0.f;
        for (int kk = lo; kk < hi; ++kk) sum += row[kk];
        ah[i * FMAX + r] += sum;
      }
    }
    __syncwarp();
  }

  bf16* dq = dqkv + ((size_t)n * 3 * nh + head) * plane;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (qr0 < S)
      *reinterpret_cast<uint32_t*>(dq + (size_t)qr0 * D + c) =
          pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    if (qr1 < S)
      *reinterpret_cast<uint32_t*>(dq + (size_t)qr1 * D + c) =
          pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
  for (int i = 0; i < 16; ++i) {
    const int qr = q0 + warp * 16 + i;
    if (qr >= S) break;
    for (int c = lane; c < h; c += 32) dfh[(fbase + qr) * h + c] = rsp::to_bf(ah[i * FMAX + c]);
    for (int c = lane; c < w; c += 32) dfw[(fbase + qr) * w + c] = rsp::to_bf(aw[i * FMAX + c]);
  }
}

// dk/dv pass shared memory
constexpr int KV_Q = 0;
constexpr int KV_DO = KV_Q + BT * KSTRIDE * 2;
constexpr int KV_FH = KV_DO + BT * KSTRIDE * 2;
constexpr int KV_FW = KV_FH + BT * FSTRIDE * 4;
constexpr int KV_LSE = KV_FW + BT * FSTRIDE * 4;
constexpr int KV_DEL = KV_LSE + BT * 4;
constexpr int KV_SMEM = KV_DEL + BT * 4;

__global__ void __launch_bounds__(THREADS) relpos_attention_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ fh,
    const bf16* __restrict__ fw, const float* __restrict__ lse,
    const float* __restrict__ delta, const bf16* __restrict__ dout,
    bf16* __restrict__ dqkv, int nh, int S, int h, int w, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + KV_Q);
  bf16* dos = reinterpret_cast<bf16*>(smem + KV_DO);
  float* fhs = reinterpret_cast<float*>(smem + KV_FH);
  float* fws = reinterpret_cast<float*>(smem + KV_FW);
  float* lses = reinterpret_cast<float*>(smem + KV_LSE);
  float* dels = reinterpret_cast<float*>(smem + KV_DEL);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = blockIdx.x * BR;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const size_t plane = (size_t)S * D;
  const bf16* qp = qkv + ((size_t)n * 3 * nh + head) * plane;
  const bf16* kp = qp + (size_t)nh * plane;
  const bf16* vp = kp + (size_t)nh * plane;
  const size_t hb = (size_t)n * nh + head;
  const size_t fbase = hb * S;
  const bf16* dop = dout + hb * plane;

  // this warp's 16 keys: rows kr0 = g and kr1 = g + 8 of the accumulators
  const int kr0 = k0 + warp * 16 + g;
  const int kr1 = kr0 + 8;
  const bool kok0 = kr0 < S;
  const bool kok1 = kr1 < S;
  const int kh0 = kr0 / w, kw0 = kr0 - (kr0 / w) * w;
  const int kh1 = kr1 / w, kw1 = kr1 - (kr1 / w) * w;
  uint32_t ka[D / 16][4];
  uint32_t va[D / 16][4];
  load_rows_a(ka, kp, kr0, kr1, S, t);
  load_rows_a(va, vp, kr0, kr1, S, t);

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();  // previous query tile consumed
    load_tile(qs, qp, q0, S);
    load_tile(dos, dop, q0, S);
    load_factors(fhs, fws, fh, fw, fbase, q0, S, h, w);
    for (int i = threadIdx.x; i < BT; i += THREADS) {
      const bool ok = q0 + i < S;
      lses[i] = ok ? lse[fbase + q0 + i] : 0.f;
      dels[i] = ok ? delta[fbase + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float st[BT / 8][4];
    float dpt[BT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      const bf16* qr = qs + (nt * 8 + g) * KSTRIDE + t * 2;
      const bf16* dr = dos + (nt * 8 + g) * KSTRIDE + t * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(st[nt], ka[kk], ld32(qr + kk * 16), ld32(qr + kk * 16 + 8));
        mma_bf16(dpt[nt], va[kk], ld32(dr + kk * 16), ld32(dr + kk * 16 + 8));
      }
    }
    // P^T into st, dS^T into dpt
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = nt * 8 + t * 2 + j;
        const bool qok = q0 + ql < S;
        float p0 = 0.f, p1 = 0.f, ds0 = 0.f, ds1 = 0.f;
        if (qok && kok0) {
          p0 = expf(st[nt][j] * scale + fhs[ql * FSTRIDE + kh0] +
                    fws[ql * FSTRIDE + kw0] - lses[ql]);
          ds0 = p0 * (dpt[nt][j] - dels[ql]);
        }
        if (qok && kok1) {
          p1 = expf(st[nt][2 + j] * scale + fhs[ql * FSTRIDE + kh1] +
                    fws[ql * FSTRIDE + kw1] - lses[ql]);
          ds1 = p1 * (dpt[nt][2 + j] - dels[ql]);
        }
        st[nt][j] = p0;
        st[nt][2 + j] = p1;
        dpt[nt][j] = ds0;
        dpt[nt][2 + j] = ds1;
      }
    }
    uint32_t pa[BT / 16][4];
    uint32_t sa[BT / 16][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(st[nt][0], st[nt][1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(st[nt][2], st[nt][3]);
      sa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(dpt[nt][0], dpt[nt][1]);
      sa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dpt[nt][2], dpt[nt][3]);
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        uint32_t b0, b1;
        load_bt(b0, b1, dos, kk * 16, dt * 8, lane);
        mma_bf16(dv[dt], pa[kk], b0, b1);
        load_bt(b0, b1, qs, kk * 16, dt * 8, lane);
        mma_bf16(dk[dt], sa[kk], b0, b1);
      }
  }

  bf16* dkp = dqkv + ((size_t)n * 3 * nh + nh + head) * plane;
  bf16* dvp = dkp + (size_t)nh * plane;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (kok0) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)kr0 * D + c) =
          pack_bf16(dk[dt][0] * scale, dk[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)kr0 * D + c) = pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (kok1) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)kr1 * D + c) =
          pack_bf16(dk[dt][2] * scale, dk[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)kr1 * D + c) = pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

}  // namespace

extern "C" int rsp_relpos_attention_bwd(
    const void* qkv, const void* fh, const void* fw, const void* out,
    const void* lse, const void* dout, void* dqkv, void* dfh, void* dfw,
    void* delta_ws, int N, int nh, int S, int h, int w, float scale,
    void* stream) {
  if (h > FMAX || w > FMAX || h * w != S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_attention_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(relpos_attention_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BR - 1) / BR, nh, N);
  relpos_attention_dq_kernel<<<grid, THREADS, DQ_SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(fh),
      static_cast<const bf16*>(fw), static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), static_cast<bf16*>(dfh),
      static_cast<bf16*>(dfw), static_cast<float*>(delta_ws), nh, S, h, w,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  relpos_attention_dkdv_kernel<<<grid, THREADS, KV_SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(fh),
      static_cast<const bf16*>(fw), static_cast<const float*>(lse),
      static_cast<const float*>(delta_ws), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), nh, S, h, w, scale);
  return static_cast<int>(cudaGetLastError());
}
