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
// (_attend_one_bwd) rounds them; dfh / dfw are fp32 sums of the rounded dS.
// The factors' own backward (the rel-pos tables and the extra dq term)
// stays in torch autograd, as JAX keeps it outside its kernel.
//
// Inputs: qkv (N, 3n, S, 64), fh (N, n, S, h), fw (N, n, S, w), the
// forward's output O (N, n, S, 64) and dO, all bf16, and the forward's fp32
// row log-sum-exp (N, n, S). Outputs: dqkv (N, 3n, S, 64), dfh, dfw bf16.
// Scratch: delta (N, n, S) fp32; F = [fh | fw | 0] (N, n, S, NF) bf16; the
// group matrix E (Sp, NF) bf16. The wrapper picks NF (64, or 128 when
// h + w > 64) and Sp (S rounded up to 64: whole key tiles); keys at and past
// S read zeros.
//
// Bound on the H100 at ViT-B, 512^2, batch 4: a global layer (4 images,
// 12 heads, S = 1024) recomputes q k^T and does four more S x S x 64
// products, 5 x 2*48*1024^2*64 = 32.2 GFLOP (33 us at 989 TFLOP/s bf16); a
// windowed layer (36 windows, S = 196) is 5.3 GFLOP but moves about 40 MB
// (12 us at 3.35 TB/s).
//
// Design: FlashAttention-2's two-pass backward on Hopper's TMA and wgmma.
// P is recomputed exactly from the forward's log-sum-exp, and the bias
// enters the scores as one more tensor-core product instead of per-element
// table lookups: with E[key, f] = 1 / scale where f == key / w or
// f == h + key % w (8 for d = 64, exact in bf16), Q K^T + F E^T equals
// (Q K^T * scale + bias) / scale, so every score is one fma and one exp2
// whatever h and w are, and no thread divides by w. The same group matrix
// turns the dfh / dfw group sums into the product dS E (JAX's body computes
// ds_lo . e^T with ones): its entries are 1 / scale, a power of two, so
// scale * dS E is exactly the fp32 group sum, summed by wgmma in the
// accumulators, no shared-memory reduction and no atomics.
// - A prep kernel writes delta = rowsum(dO * O) (16-byte loads, 8 threads
//   per row), F (16-byte stores) and E.
// - One launch then runs both passes, the block's role set by blockIdx.x;
//   each block is two consumer warpgroups of 64 rows and a producer
//   warpgroup, one thread of which starts every TMA load (128-byte swizzle,
//   mbarriers, rows past S read zeros), the block's rows resident and the
//   other axis streamed in 64-wide tiles through a ring of 4 stages.
//   dq role, per 64 queries (Q, dO, F resident; K, V, E streamed):
//   S = Q K^T + F E^T and dP = dO V^T from shared memory, dS from the
//   accumulators, then dQ += dS K and df += dS E (K and E read N-major)
//   with dS straight from registers as the A operand. dk/dv role, per 64 keys (K,
//   V, E resident; Q, dO, F streamed): S^T = K Q^T + E F^T, dP^T = V dO^T,
//   then dV += P^T dO and dK += dS^T Q (Q, dO read N-major). 7 products of
//   S x S x 64 plus 3 of depth NF, against the 5 of the bound.
// Every gradient is summed in one block's registers in a fixed order and
// written once: two launches on the same inputs give the same bits.
#include <math.h>

#include "hopper.cuh"

using rsp::bf16;

namespace {

constexpr int D = 64;
constexpr int TILE = 64 * D * 2;  // 64 rows of 64 bf16 columns, 8 KB
constexpr int NWG = 2;            // consumer warpgroups per block
constexpr int ROWS = 64 * NWG;    // queries (dq role) or keys (dk/dv role) per block
// The producer is a whole warpgroup that hands its registers to the
// consumers (setmaxnreg): ptxas caps a block of 288 threads at 168
// registers, as it does one of 384, and a consumer holds five 64 x 64 fp32
// accumulators (dQ, df at NF = 128) or four (dK, dV) and the scores.
constexpr int THREADS = NWG * 128 + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// setmaxnreg.inc waits for registers that setmaxnreg.dec freed in the same
// block: the consumers may gain no more than the producer gives up
constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
static_assert(NWG * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - PRODUCER_REGS,
              "register rebalance exceeds what the producer frees");
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block: per consumer warpgroup its resident tiles,
// then the ring, then the barriers.
template <int NF>
struct Layout {
  static constexpr int NFT = NF / 64;  // 64-wide factor tiles
  static constexpr int STAGES = 4;
  static constexpr int RES = (2 + NFT) * TILE;    // Q, dO, F or K, V, E
  static constexpr int STAGE = (2 + NFT) * TILE;  // K, V, E or Q, dO, F
  static constexpr int OFF_RING = NWG * RES;
  static constexpr int OFF_BAR = OFF_RING + STAGES * STAGE;  // resident, full[], empty[]
  static constexpr int SMEM = 1024 + OFF_BAR + 128;
  static_assert(SMEM <= 232448, "shared memory exceeds what a block may use");
};

struct Args {
  const float* lse;
  const float* delta;
  bf16* dqkv;
  bf16* dfh;
  bf16* dfw;
  int nh, S, h, w;
  float scale;  // d^-0.5
  float c;      // scale * log2 e: exp2 of c * (Q K^T + F E^T) is exp of the biased score
};

// ------------------------------------------------------------------ prep

__global__ void __launch_bounds__(256) prep_kernel(
    const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const bf16* __restrict__ fh, const bf16* __restrict__ fw, float* __restrict__ delta,
    bf16* __restrict__ fcat, bf16* __restrict__ e, int rows, int S,
    int h, int w, int NF, int Sp, float inv_scale) {
  const int lane = threadIdx.x % 32;
  const long nthreads = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  // delta: 8 threads per row, 16 bytes of O and dO each; the loop runs in
  // whole warps so the shuffles see every lane
  for (long base = tid - lane; base < (long)rows * 8; base += nthreads) {
    const long i = base + lane;
    float v = 0.f;
    if (i < (long)rows * 8) {
      const uint4 o = *reinterpret_cast<const uint4*>(out + i * 8);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + i * 8);
      const bf16* ob = reinterpret_cast<const bf16*>(&o);
      const bf16* db = reinterpret_cast<const bf16*>(&d);
#pragma unroll
      for (int u = 0; u < 8; ++u) v += rsp::to_f(ob[u]) * rsp::to_f(db[u]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (i < (long)rows * 8 && lane % 8 == 0) delta[i / 8] = v;
  }
  // F = [fh | fw | 0], one 16-byte chunk per step
  const int fchunks = NF / 8;
  for (long i = tid; i < (long)rows * fchunks; i += nthreads) {
    const long row = i / fchunks;
    const int c = (int)(i % fchunks) * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = c + u;
      v[u] = f < h ? fh[row * h + f] : (f < h + w ? fw[row * w + f - h] : rsp::to_bf(0.f));
    }
    *reinterpret_cast<uint4*>(fcat + row * NF + c) = *reinterpret_cast<const uint4*>(v);
  }
  // E (Sp, NF) with 1 / scale; keys past S are 0
  for (long i = tid; i < (long)Sp * fchunks; i += nthreads) {
    const int key = (int)(i / fchunks);
    const int c = (int)(i % fchunks) * 8;
    const int fa = key / w, fb = h + key % w;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = rsp::to_bf(key < S && (c + u == fa || c + u == fb) ? inv_scale : 0.f);
    *reinterpret_cast<uint4*>(e + (long)key * NF + c) = *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------- passes

struct Maps {
  CUtensorMap qkv, dout, fcat, e;
};

// One thread: the block's resident tiles, then every streamed tile.
template <int NF>
__device__ __forceinline__ void produce(unsigned char* smem, const Maps& m, const Args& a,
                                        bool dq_role, int r0) {
  using L = Layout<NF>;
  uint64_t* resbar = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* full = resbar + 1;
  uint64_t* empty = full + L::STAGES;
  const int nh = a.nh;
  const int plane_q = blockIdx.z * 3 * nh + blockIdx.y;  // this head's q plane in qkv
  const int plane = blockIdx.z * nh + blockIdx.y;        // its dO and F plane
  rsp::mbar_expect_tx(resbar, NWG * L::RES);
  for (int i = 0; i < NWG; ++i) {
    unsigned char* res = smem + i * L::RES;
    const int row = r0 + 64 * i;
    if (dq_role) {
      rsp::tma_load_3d(res, &m.qkv, resbar, 0, row, plane_q);
      rsp::tma_load_3d(res + TILE, &m.dout, resbar, 0, row, plane);
      for (int j = 0; j < L::NFT; ++j)
        rsp::tma_load_3d(res + (2 + j) * TILE, &m.fcat, resbar, 64 * j, row, plane);
    } else {
      rsp::tma_load_3d(res, &m.qkv, resbar, 0, row, plane_q + nh);
      rsp::tma_load_3d(res + TILE, &m.qkv, resbar, 0, row, plane_q + 2 * nh);
      for (int j = 0; j < L::NFT; ++j)
        rsp::tma_load_2d(res + (2 + j) * TILE, &m.e, resbar, 64 * j, row);
    }
  }
  const int ntiles = (a.S + 63) / 64;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % L::STAGES;
    if (it >= L::STAGES) rsp::mbar_wait(&empty[s], ((it / L::STAGES) - 1) & 1);
    unsigned char* st = smem + L::OFF_RING + s * L::STAGE;
    const int x0 = 64 * it;
    rsp::mbar_expect_tx(&full[s], L::STAGE);
    if (dq_role) {
      rsp::tma_load_3d(st, &m.qkv, &full[s], 0, x0, plane_q + nh);
      rsp::tma_load_3d(st + TILE, &m.qkv, &full[s], 0, x0, plane_q + 2 * nh);
      for (int j = 0; j < L::NFT; ++j)
        rsp::tma_load_2d(st + (2 + j) * TILE, &m.e, &full[s], 64 * j, x0);
    } else {
      rsp::tma_load_3d(st, &m.qkv, &full[s], 0, x0, plane_q);
      rsp::tma_load_3d(st + TILE, &m.dout, &full[s], 0, x0, plane);
      for (int j = 0; j < L::NFT; ++j)
        rsp::tma_load_3d(st + (2 + j) * TILE, &m.fcat, &full[s], 64 * j, x0, plane);
    }
  }
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// bf16 pairs of an accumulator in the order of wgmma's register A operand
__device__ __forceinline__ void pack(uint32_t (&pa)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][(j % 2) * 2] = rsp::pack_bf16(v[4 * j], v[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = rsp::pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// acc += A B^T over 64 columns of depth 64 (A, B: swizzled 64-row tiles)
__device__ __forceinline__ void qk64(float (&acc)[32], const unsigned char* a,
                                     const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    rsp::wgmma_m64n64k16_ss(acc, rsp::sw128_desc(a + 32 * k), rsp::sw128_desc(b + 32 * k));
}
// acc += A B^T of depth NF, A and B each NF / 64 consecutive tiles
template <int NF>
__device__ __forceinline__ void bias64(float (&acc)[32], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < NF / 16; ++k) {
    const int off = (k / 4) * TILE + 32 * (k % 4);
    rsp::wgmma_m64n64k16_ss(acc, rsp::sw128_desc(a + off), rsp::sw128_desc(b + off));
  }
}

// 64 queries of one head against every key tile: dQ and dfh / dfw.
template <int NF>
__device__ __forceinline__ void consume_dq(unsigned char* smem, const Args& a, int wg,
                                           int r0) {
  using L = Layout<NF>;
  uint64_t* resbar = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* full = resbar + 1;
  uint64_t* empty = full + L::STAGES;
  const int S = a.S;
  const size_t frow = (size_t)(blockIdx.z * a.nh + blockIdx.y) * S;
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int qa = r0 + 64 * wg + 16 * (tid / 32) + g;  // this thread's rows qa, qb
  const int qb = qa + 8;
  const float ls0 = qa < S ? a.lse[frow + qa] * LOG2E : INFINITY;  // rows past S: p = 0
  const float ls1 = qb < S ? a.lse[frow + qb] * LOG2E : INFINITY;
  const float del0 = qa < S ? a.delta[frow + qa] : 0.f;
  const float del1 = qb < S ? a.delta[frow + qb] : 0.f;
  const unsigned char* res = smem + wg * L::RES;  // Q, dO, F

  float dq[32], df[L::NFT][32], sc[32], dp[32];
  uint32_t pa[4][4];
  zero(dq);
#pragma unroll
  for (int j = 0; j < L::NFT; ++j) zero(df[j]);
  rsp::mbar_wait(resbar, 0);
  const int ntiles = (S + 63) / 64;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % L::STAGES;
    rsp::mbar_wait(&full[s], (it / L::STAGES) & 1);
    const unsigned char* kt = smem + L::OFF_RING + s * L::STAGE;  // K, V, E
    zero(sc);
    zero(dp);
    rsp::fence_regs(sc);
    rsp::fence_regs(dp);
    rsp::wgmma_fence();
    qk64(sc, res, kt);                                   // Q K^T
    bias64<NF>(sc, res + 2 * TILE, kt + 2 * TILE);       // + F E^T
    qk64(dp, res + TILE, kt + TILE);                     // dO V^T
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(sc);
    rsp::fence_regs(dp);
    const int k0 = 64 * it;
    const bool partial = k0 + 64 > S;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(fmaf(sc[4 * j + e], a.c, -ls0));
        float p1 = exp2f(fmaf(sc[4 * j + 2 + e], a.c, -ls1));
        if (partial && k0 + 8 * j + 2 * t + e >= S) p0 = p1 = 0.f;
        sc[4 * j + e] = p0 * (dp[4 * j + e] - del0);  // dS
        sc[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - del1);
      }
    pack(pa, sc);
    rsp::fence_regs(dq);
#pragma unroll
    for (int j = 0; j < L::NFT; ++j) rsp::fence_regs(df[j]);
    rsp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      rsp::wgmma_m64n64k16_rs_nmajor(dq, pa[kk], rsp::sw128_desc(kt + kk * 2048));  // dS K
#pragma unroll
      for (int j = 0; j < L::NFT; ++j)  // dS E
        rsp::wgmma_m64n64k16_rs_nmajor(df[j], pa[kk],
                                       rsp::sw128_desc(kt + (2 + j) * TILE + kk * 2048));
    }
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(dq);
#pragma unroll
    for (int j = 0; j < L::NFT; ++j) rsp::fence_regs(df[j]);
    rsp::mbar_arrive(&empty[s]);
  }

  bf16* dqp = a.dqkv + ((size_t)blockIdx.z * 3 * a.nh + blockIdx.y) * S * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (qa < S)
      *reinterpret_cast<uint32_t*>(dqp + (size_t)qa * D + c) =
          rsp::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    if (qb < S)
      *reinterpret_cast<uint32_t*>(dqp + (size_t)qb * D + c) =
          rsp::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
  // df holds the group sums times 1 / scale, a power of two: times scale
  // they are exact
  const int h = a.h, w = a.w;
#pragma unroll
  for (int j = 0; j < NF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const float va = df[j / 8][4 * (j % 8) + e] * a.scale;
      const float vb = df[j / 8][4 * (j % 8) + 2 + e] * a.scale;
      if (c < h) {
        if (qa < S) a.dfh[(frow + qa) * h + c] = rsp::to_bf(va);
        if (qb < S) a.dfh[(frow + qb) * h + c] = rsp::to_bf(vb);
      } else if (c < h + w) {
        if (qa < S) a.dfw[(frow + qa) * w + c - h] = rsp::to_bf(va);
        if (qb < S) a.dfw[(frow + qb) * w + c - h] = rsp::to_bf(vb);
      }
    }
}

// 64 keys of one head against every query tile: dK and dV.
template <int NF>
__device__ __forceinline__ void consume_dkdv(unsigned char* smem, const Args& a, int wg,
                                             int r0) {
  using L = Layout<NF>;
  uint64_t* resbar = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* full = resbar + 1;
  uint64_t* empty = full + L::STAGES;
  const int S = a.S;
  const size_t frow = (size_t)(blockIdx.z * a.nh + blockIdx.y) * S;
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int ka = r0 + 64 * wg + 16 * (tid / 32) + g;  // this thread's keys ka, kb
  const int kb = ka + 8;
  const unsigned char* res = smem + wg * L::RES;  // K, V, E

  float dk[32], dv[32], st[32], dpt[32];
  uint32_t pa[4][4], sa[4][4];
  zero(dk);
  zero(dv);
  rsp::mbar_wait(resbar, 0);
  const int ntiles = (S + 63) / 64;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % L::STAGES;
    const int q0 = 64 * it;
    // log-sum-exp and delta of this thread's 16 query columns; past S the
    // log-sum-exp is +inf, so p = 0
    float lq[16], dl[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * j + 2 * t + e;
        lq[2 * j + e] = q < S ? a.lse[frow + q] * LOG2E : INFINITY;
        dl[2 * j + e] = q < S ? a.delta[frow + q] : 0.f;
      }
    rsp::mbar_wait(&full[s], (it / L::STAGES) & 1);
    const unsigned char* qt = smem + L::OFF_RING + s * L::STAGE;  // Q, dO, F
    zero(st);
    zero(dpt);
    rsp::fence_regs(st);
    rsp::fence_regs(dpt);
    rsp::wgmma_fence();
    qk64(st, res, qt);                              // K Q^T
    bias64<NF>(st, res + 2 * TILE, qt + 2 * TILE);  // + E F^T
    qk64(dpt, res + TILE, qt + TILE);               // V dO^T
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(st);
    rsp::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = lq[2 * j + e];
        const float d = dl[2 * j + e];
        const float p0 = exp2f(fmaf(st[4 * j + e], a.c, -l));
        const float p1 = exp2f(fmaf(st[4 * j + 2 + e], a.c, -l));
        st[4 * j + e] = p0;
        st[4 * j + 2 + e] = p1;
        dpt[4 * j + e] = p0 * (dpt[4 * j + e] - d);  // dS^T
        dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - d);
      }
    pack(pa, st);
    pack(sa, dpt);
    rsp::fence_regs(dk);
    rsp::fence_regs(dv);
    rsp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      rsp::wgmma_m64n64k16_rs_nmajor(dv, pa[kk], rsp::sw128_desc(qt + TILE + kk * 2048));
      rsp::wgmma_m64n64k16_rs_nmajor(dk, sa[kk], rsp::sw128_desc(qt + kk * 2048));
    }
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(dk);
    rsp::fence_regs(dv);
    rsp::mbar_arrive(&empty[s]);
  }

  bf16* dkp = a.dqkv + ((size_t)blockIdx.z * 3 * a.nh + a.nh + blockIdx.y) * S * D;
  bf16* dvp = dkp + (size_t)a.nh * S * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (ka < S) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)ka * D + c) =
          rsp::pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)ka * D + c) =
          rsp::pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (kb < S) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)kb * D + c) =
          rsp::pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)kb * D + c) =
          rsp::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// blockIdx.x < nblk: dq role over queries [ROWS * x, ...); past it the dk/dv
// role over keys; blockIdx.y the head, blockIdx.z the image or window.
template <int NF>
__global__ void __launch_bounds__(THREADS, 1) relpos_attention_bwd_kernel(
    const __grid_constant__ Maps maps, const Args args) {
  using L = Layout<NF>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (rsp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* resbar = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* full = resbar + 1;
  uint64_t* empty = full + L::STAGES;
  if (threadIdx.x == 0) {
    rsp::mbar_init(resbar, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      rsp::mbar_init(&full[s], 1);
      rsp::mbar_init(&empty[s], NWG * 128);
    }
    rsp::mbar_fence_init();
  }
  __syncthreads();
  const int nblk = (args.S + ROWS - 1) / ROWS;
  const bool dq_role = (int)blockIdx.x < nblk;
  const int r0 = (dq_role ? blockIdx.x : blockIdx.x - nblk) * ROWS;
  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    rsp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) produce<NF>(smem, maps, args, dq_role, r0);
  } else {
    rsp::setmaxnreg_inc<CONSUMER_REGS>();
    if (dq_role)
      consume_dq<NF>(smem, args, wg, r0);
    else
      consume_dkdv<NF>(smem, args, wg, r0);
  }
}

template <int NF>
int launch(const void* qkv, const void* dout, const void* fcat, const void* e,
           const Args& args, int N, int Sp, cudaStream_t stream) {
  using L = Layout<NF>;
  const int S = args.S, nh = args.nh;
  Maps m;
  const cuuint64_t qdims[3] = {D, (cuuint64_t)S, (cuuint64_t)N * 3 * nh};
  const cuuint64_t odims[3] = {D, (cuuint64_t)S, (cuuint64_t)N * nh};
  const cuuint64_t rstrides[2] = {D * 2, (cuuint64_t)S * D * 2};
  const cuuint64_t fdims[3] = {NF, (cuuint64_t)S, (cuuint64_t)N * nh};
  const cuuint64_t fstrides[2] = {NF * 2, (cuuint64_t)S * NF * 2};
  const cuuint64_t edims[2] = {NF, (cuuint64_t)Sp};
  const cuuint64_t estrides[1] = {NF * 2};
  const cuuint32_t box3[3] = {64, 64, 1};
  const cuuint32_t box2[2] = {64, 64};
  if (!rsp::make_tensor_map(&m.qkv, qkv, 3, qdims, rstrides, box3) ||
      !rsp::make_tensor_map(&m.dout, dout, 3, odims, rstrides, box3) ||
      !rsp::make_tensor_map(&m.fcat, fcat, 3, fdims, fstrides, box3) ||
      !rsp::make_tensor_map(&m.e, e, 2, edims, estrides, box2))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_bwd_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2 * ((S + ROWS - 1) / ROWS), nh, N);
  relpos_attention_bwd_kernel<NF><<<grid, THREADS, L::SMEM, stream>>>(m, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// NF and Sp size the scratch (see the header).
extern "C" int rsp_relpos_attention_bwd(
    const void* qkv, const void* fh, const void* fw, const void* out,
    const void* lse, const void* dout, void* dqkv, void* dfh, void* dfw,
    void* delta_ws, void* fcat_ws, void* e_ws, int N, int nh, int S,
    int h, int w, int NF, int Sp, float scale, void* stream) {
  if (h < 1 || w < 1 || h > 64 || w > 64 || h * w != S || (NF != 64 && NF != 128) ||
      h + w > NF || Sp < S || Sp % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // an entry of E: a power of two, so bf16 holds it and df * scale is exact
  const float inv_scale = 1.f / scale;
  int ex;
  if (frexpf(inv_scale, &ex) != 0.5f) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = N * nh * S;
  const long work = (long)rows * (NF / 8);  // the largest of the prep's loops
  const int blocks = (int)((work + 255) / 256 < 2048 ? (work + 255) / 256 : 2048);
  prep_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(fh), static_cast<const bf16*>(fw),
      static_cast<float*>(delta_ws), static_cast<bf16*>(fcat_ws), static_cast<bf16*>(e_ws),
      rows, S, h, w, NF, Sp, inv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{static_cast<const float*>(lse), static_cast<const float*>(delta_ws),
                  static_cast<bf16*>(dqkv), static_cast<bf16*>(dfh), static_cast<bf16*>(dfw),
                  nh, S, h, w, scale, scale * LOG2E};
  if (NF == 64) return launch<64>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st);
  return launch<128>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st);
}
