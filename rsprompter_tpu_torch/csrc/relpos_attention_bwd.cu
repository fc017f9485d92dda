// Kernel C': backward of softmax(q k^T * scale + bias) v with SAM's
// decomposed rel-pos bias, bias[q, key] = fh[q, key / w] + fw[q, key % w].
//
// Replaces the TPU kernels of rsprompter_tpu/ops/fused_vit_attention.py:
// _window_bwd_kernel_pair (windowed layers) and _global_bwd_kernel_pair
// (global layers), both reached through _pair_bwd_kernel_call, at head dim
// 64 (ViT-B, ViT-L); at head dim 80 (ViT-H) JAX has no kernel (XLA
// attention and its autodiff) and C' takes those heads too. Per head:
//   P = softmax(S),  dV = P^T dO,  dP = dO V^T,  delta = rowsum(dP * P)
//   dS = P * (dP - delta),  dQ = scale * dS K,  dK = scale * dS^T Q,
//   dfh[q, r] = sum_{key / w == r} dS[q, key],  dfw[q, c] = sum_{key % w == c} dS[q, key]
// with dS and P rounded to bf16 before their products, as the JAX body
// (_attend_one_bwd) rounds them; dfh / dfw are fp32 sums of the rounded dS.
// The factors' own backward (the rel-pos tables and the extra dq term)
// stays in torch autograd, as JAX keeps it outside its kernel.
//
// Inputs: qkv (N, 3n, S, d), fh (N, n, S, h), fw (N, n, S, w), the
// forward's output O (N, n, S, d) and dO, all bf16, and the forward's fp32
// row log-sum-exp (N, n, S); d = 64 or 80, scale = d^-0.5. Outputs: dqkv
// (N, 3n, S, d), dfh, dfw bf16. Scratch: delta (N, n, S) fp32; F (N, n, S,
// NFB) bf16; the group matrix E (Sp, NFB) bf16. NFS = 64 where h + w <= 64,
// else 128 (the dS E columns that hold the group sums); NFB the bias
// product's depth (NFS at d = 64; at d = 80 the columns of F's two halves,
// 64, 128 or 256), which rsp_relpos_attention_bwd_depth returns for the
// caller to size F and E; Sp is S rounded up to 64 (whole key tiles); keys
// at and past S read zeros.
//
// Bound on the H100 at ViT-B, 512^2, batch 4: a global layer (4 images,
// 12 heads, S = 1024) recomputes q k^T and does four more S x S x 64
// products, 5 x 2*48*1024^2*64 = 32.2 GFLOP (33 us at 989 TFLOP/s bf16); a
// windowed layer (36 windows, S = 196) is 5.3 GFLOP but moves about 40 MB
// (12 us at 3.35 TB/s). At ViT-H (16 heads of 80) a global layer is 53.7
// GFLOP (54 us) and a windowed one moves about 157 MB (47 us).
//
// Design: FlashAttention-2's two-pass backward on Hopper's TMA and wgmma.
// P is recomputed exactly from the forward's log-sum-exp, and the bias
// enters the scores as one more tensor-core product instead of per-element
// table lookups: Q K^T + F E^T equals (Q K^T * scale + bias) / scale, so
// every score is one fma and one exp2 whatever h and w are, and no thread
// divides by w. The same group matrix turns the dfh / dfw group sums into
// the product dS E (JAX's body computes ds_lo . e^T with ones), summed by
// wgmma in the accumulators, no shared-memory reduction and no atomics.
// E[key, f] = 1 where f == key / w or f == h + key % w, so dS E over the
// first NFS columns is the fp32 group sum itself, and F holds bf16([fh |
// fw] / scale) in columns 0 .. h + w - 1, as kernel C builds its bias.
// - d = 64: 1 / scale = 8, a power of two: that F is exact, zeros past it.
// - d = 80: 1 / scale = sqrt(80) is no power of two, so F holds the low
//   half bf16(v - bf16(v)) of v = [fh | fw] / scale too (from column h + w
//   where both halves fit 64 columns, else from NFS), E's ones repeated
//   under it: F E^T is the bias over the scale to about 16 bits, as kernel
//   C's window path builds it (and within that of the global path's fp32
//   bias), so the rows of the recomputed P sum to 1 against either path's
//   log-sum-exp. At the 64 x 64 grid (h + w = 128) the bias is 256 deep and
//   the group sums 128 wide.
// - A head of 80 columns is two 64-column chunks in shared memory, each its
//   own TMA box with 128-byte swizzle (TMA reads zeros past column 80), as
//   in kernel C: Q K^T walks K in five 16-deep steps, and dQ += dS K, dV +=
//   P^T dO, dK += dS^T Q are wgmma of N = 80 whose B descriptor steps from
//   one chunk to the next by its leading byte offset.
// - A prep kernel writes delta = rowsum(dO * O) (16-byte loads, 8 threads
//   per row), F (16-byte stores) and E.
// - One launch then runs both passes, the block's role set by blockIdx.x;
//   each block is two consumer warpgroups of 64 rows and a producer
//   warpgroup, one thread of which starts every TMA load (128-byte swizzle,
//   mbarriers, rows past S read zeros), the block's rows resident and the
//   other axis streamed in 64-wide tiles through a ring of up to 4 stages
//   (as many as fit: 4 at d = 64, 3, 2 and 1 at d = 80 as F widens).
//   dq role, per 64 queries (Q, dO, F resident; K, V, E streamed):
//   S = Q K^T + F E^T and dP = dO V^T from shared memory, dS from the
//   accumulators, then dQ += dS K and df += dS E (K and E read N-major)
//   with dS straight from registers as the A operand. dk/dv role, per 64 keys (K,
//   V, E resident; Q, dO, F streamed): S^T = K Q^T + E F^T, dP^T = V dO^T,
//   then dV += P^T dO and dK += dS^T Q (Q, dO read N-major). 7 products of
//   S x S x d plus 3 of depth NFB or NFS, against the 5 of the bound.
// Every gradient is summed in one block's registers in a fixed order and
// written once: two launches on the same inputs give the same bits.
#include <math.h>

#include "hopper.cuh"

using rsp::bf16;

namespace {

constexpr int TILE = 64 * 128;  // 64 rows of one 64-column bf16 chunk, 8 KB
constexpr int NWG = 2;          // consumer warpgroups per block
constexpr int ROWS = 64 * NWG;  // queries (dq role) or keys (dk/dv role) per block
// The producer is a whole warpgroup that hands its registers to the
// consumers (setmaxnreg): ptxas caps a block of 288 threads at 168
// registers, as it does one of 384, and a consumer holds dQ (64 x d fp32)
// and up to two 64 x 64 group-sum accumulators, or dK and dV, beside the
// scores.
constexpr int THREADS = NWG * 128 + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// setmaxnreg.inc waits for registers that setmaxnreg.dec freed in the same
// block: the consumers may gain no more than the producer gives up
constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
static_assert(NWG * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - PRODUCER_REGS,
              "register rebalance exceeds what the producer frees");
constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block at head dim D, NFS group-sum columns and NFB
// bias columns: per consumer warpgroup its resident tiles, then the ring of
// as many stages as fit (up to 4), then the barriers. A head's 64 rows are
// DC chunks of 64 columns (an 80-wide row, 160 bytes, is wider than one
// 128-byte swizzle row: TMA reads zeros past column 80 of the second).
template <int D_, int NFS_, int NFB_>
struct Layout {
  static_assert(D_ == 64 || D_ == 80, "head dim 64 or 80");
  static constexpr int D = D_, NFS = NFS_, NFB = NFB_;
  static constexpr int DC = (D + 63) / 64;
  static constexpr int HT = DC * TILE;             // 64 rows of one head
  static constexpr int NST = NFS / 64;             // dS E: group-sum tiles
  static constexpr int NBT = NFB / 64;             // F E^T: bias tiles
  static constexpr int RES = 2 * HT + NBT * TILE;  // Q, dO, F or K, V, E
  static constexpr int STAGE = RES;                // K, V, E or Q, dO, F
  static constexpr int OFF_RING = NWG * RES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 128 - OFF_RING) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 1, "one stage must fit beside the resident tiles");
  static constexpr int OFF_BAR = OFF_RING + STAGES * STAGE;  // resident, full[], empty[]
  static constexpr int SMEM = 1024 + OFF_BAR + 128;
  static_assert(SMEM <= SMEM_LIMIT, "shared memory exceeds what a block may use");
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

// F's columns at an h x w grid and head dim d (the header): the group sums'
// width, the bias product's depth, and where F's low half starts (0: no
// low half, 1 / scale a power of two)
struct Widths {
  int nfs, nfb, lo_col;
};

Widths factor_widths(int h, int w, int d) {
  int ex;
  const bool split = frexpf(sqrtf((float)d), &ex) != 0.5f;  // 1 / scale no power of two
  const int hw = h + w;
  const int nfs = hw <= 64 ? 64 : 128;
  const int lo_col = !split ? 0 : (2 * hw <= 64 ? hw : nfs);
  return {nfs, split ? (lo_col + hw + 63) / 64 * 64 : nfs, lo_col};
}

// ------------------------------------------------------------------ prep

// delta = rowsum(dO * O) over D columns; F (rows, NFB) and E (Sp, NFB):
// with v = [fh | fw] / scale taken in fp32, F = bf16(v) in columns 0 .. h +
// w - 1 and, where lo_col > 0, bf16(v - bf16(v)) from column lo_col, zeros
// elsewhere; E = 1 at f = key / w and f = h + key % w, and again lo_col on.
// Keys past S have E = 0.
__global__ void __launch_bounds__(256) prep_kernel(
    const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const bf16* __restrict__ fh, const bf16* __restrict__ fw, float* __restrict__ delta,
    bf16* __restrict__ fcat, bf16* __restrict__ e, int rows, int S, int h, int w, int D,
    int NFB, int lo_col, int Sp, float inv_scale) {
  const int lane = threadIdx.x % 32;
  const long nthreads = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int dchunks = D / 8;
  // delta: 8 threads per row, each 16-byte chunk c, c + 8, .. of O and dO;
  // the loop runs in whole warps so the shuffles see every lane
  for (long base = tid - lane; base < (long)rows * 8; base += nthreads) {
    const long i = base + lane;
    float v = 0.f;
    if (i < (long)rows * 8) {
      const long row = i / 8;
      for (int c = (int)(i % 8); c < dchunks; c += 8) {
        const uint4 o = *reinterpret_cast<const uint4*>(out + row * D + 8 * c);
        const uint4 d = *reinterpret_cast<const uint4*>(dout + row * D + 8 * c);
        const bf16* ob = reinterpret_cast<const bf16*>(&o);
        const bf16* db = reinterpret_cast<const bf16*>(&d);
#pragma unroll
        for (int u = 0; u < 8; ++u) v += rsp::to_f(ob[u]) * rsp::to_f(db[u]);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (i < (long)rows * 8 && lane % 8 == 0) delta[i / 8] = v;
  }
  // F, one 16-byte chunk per step
  const int fchunks = NFB / 8;
  const int hw = h + w;
  const bool split = lo_col > 0;
  for (long i = tid; i < (long)rows * fchunks; i += nthreads) {
    const long row = i / fchunks;
    const int c = (int)(i % fchunks) * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = c + u;
      const bool low = split && f >= lo_col;
      const int k = low ? f - lo_col : f;  // the column of [fh | fw]
      bf16 x = rsp::to_bf(0.f);
      if (k < hw) {
        const float s = rsp::to_f(k < h ? fh[row * h + k] : fw[row * w + k - h]) * inv_scale;
        const bf16 hi = rsp::to_bf(s);
        x = low ? rsp::to_bf(s - rsp::to_f(hi)) : hi;
      }
      v[u] = x;
    }
    *reinterpret_cast<uint4*>(fcat + row * NFB + c) = *reinterpret_cast<const uint4*>(v);
  }
  // E (Sp, NFB)
  for (long i = tid; i < (long)Sp * fchunks; i += nthreads) {
    const int key = (int)(i / fchunks);
    const int c = (int)(i % fchunks) * 8;
    const int fa = key / w, fb = h + key % w;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = c + u;
      const bool on = f == fa || f == fb || (split && (f - lo_col == fa || f - lo_col == fb));
      v[u] = rsp::to_bf(key < S && on ? 1.f : 0.f);
    }
    *reinterpret_cast<uint4*>(e + (long)key * NFB + c) = *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------- passes

struct Maps {
  CUtensorMap qkv, dout, fcat, e;
};

// One thread: the block's resident tiles, then every streamed tile.
template <class L>
__device__ __forceinline__ void produce(unsigned char* smem, const Maps& m, const Args& a,
                                        bool dq_role, int r0) {
  uint64_t* resbar = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* full = resbar + 1;
  uint64_t* empty = full + L::STAGES;
  const int nh = a.nh;
  const int plane_q = blockIdx.z * 3 * nh + blockIdx.y;  // this head's q plane in qkv
  const int plane = blockIdx.z * nh + blockIdx.y;        // its dO and F plane
  // 64 rows of a head plane (DC chunks) into dst
  auto head = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row, int pl) {
    for (int c = 0; c < L::DC; ++c) rsp::tma_load_3d(dst + c * TILE, map, bar, 64 * c, row, pl);
  };
  rsp::mbar_expect_tx(resbar, NWG * L::RES);
  for (int i = 0; i < NWG; ++i) {
    unsigned char* res = smem + i * L::RES;
    const int row = r0 + 64 * i;
    if (dq_role) {
      head(res, &m.qkv, resbar, row, plane_q);
      head(res + L::HT, &m.dout, resbar, row, plane);
      for (int j = 0; j < L::NBT; ++j)
        rsp::tma_load_3d(res + 2 * L::HT + j * TILE, &m.fcat, resbar, 64 * j, row, plane);
    } else {
      head(res, &m.qkv, resbar, row, plane_q + nh);
      head(res + L::HT, &m.qkv, resbar, row, plane_q + 2 * nh);
      for (int j = 0; j < L::NBT; ++j)
        rsp::tma_load_2d(res + 2 * L::HT + j * TILE, &m.e, resbar, 64 * j, row);
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
      head(st, &m.qkv, &full[s], x0, plane_q + nh);
      head(st + L::HT, &m.qkv, &full[s], x0, plane_q + 2 * nh);
      for (int j = 0; j < L::NBT; ++j)
        rsp::tma_load_2d(st + 2 * L::HT + j * TILE, &m.e, &full[s], 64 * j, x0);
    } else {
      head(st, &m.qkv, &full[s], x0, plane_q);
      head(st + L::HT, &m.dout, &full[s], x0, plane);
      for (int j = 0; j < L::NBT; ++j)
        rsp::tma_load_3d(st + 2 * L::HT + j * TILE, &m.fcat, &full[s], 64 * j, x0, plane);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// bf16 pairs of an accumulator in the order of wgmma's register A operand
__device__ __forceinline__ void pack(uint32_t (&pa)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][(j % 2) * 2] = rsp::pack_bf16(v[4 * j], v[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = rsp::pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// acc += A B^T over 64 columns, of depth K (A, B: K / 64 swizzled 64-row
// chunks each, TILE bytes apart; the depth past a head's 80 columns is not
// walked, and past them TMA wrote zeros)
template <int K>
__device__ __forceinline__ void product(float (&acc)[32], const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    const int off = (k / 4) * TILE + 32 * (k % 4);
    rsp::wgmma_m64n64k16_ss(acc, rsp::sw128_desc(a + off), rsp::sw128_desc(b + off));
  }
}

// acc (64 x D) += P (64 x 16 rows' slice, registers) * B (16 rows of a
// head tile at `b`, read N-major: its D columns as DC chunks TILE apart)
template <int D>
__device__ __forceinline__ void head_k16(float (&acc)[D / 2], const uint32_t (&p)[4],
                                         const unsigned char* b) {
  if constexpr (D == 64) rsp::wgmma_m64n64k16_rs_nmajor(acc, p, rsp::sw128_desc(b));
  else rsp::wgmma_m64n80k16_rs_nmajor(acc, p, rsp::sw128_desc_mn(b, TILE));
}

// 64 queries of one head against every key tile: dQ and dfh / dfw.
template <class L>
__device__ __forceinline__ void consume_dq(unsigned char* smem, const Args& a, int wg,
                                           int r0) {
  constexpr int D = L::D;
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

  float dq[D / 2], df[L::NST][32], sc[32], dp[32];
  uint32_t pa[4][4];
  zero(dq);
#pragma unroll
  for (int j = 0; j < L::NST; ++j) zero(df[j]);
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
    product<D>(sc, res, kt);                                  // Q K^T
    product<L::NFB>(sc, res + 2 * L::HT, kt + 2 * L::HT);     // + F E^T
    product<D>(dp, res + L::HT, kt + L::HT);                  // dO V^T
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
    for (int j = 0; j < L::NST; ++j) rsp::fence_regs(df[j]);
    rsp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      head_k16<D>(dq, pa[kk], kt + kk * 2048);  // dS K
#pragma unroll
      for (int j = 0; j < L::NST; ++j)  // dS E
        rsp::wgmma_m64n64k16_rs_nmajor(df[j], pa[kk],
                                       rsp::sw128_desc(kt + 2 * L::HT + j * TILE + kk * 2048));
    }
    rsp::wgmma_commit();
    rsp::wgmma_wait<0>();
    rsp::fence_regs(dq);
#pragma unroll
    for (int j = 0; j < L::NST; ++j) rsp::fence_regs(df[j]);
    rsp::mbar_arrive(&empty[s]);
  }

  bf16* dqp = a.dqkv + ((size_t)blockIdx.z * 3 * a.nh + blockIdx.y) * S * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (qa < S)
      *reinterpret_cast<uint32_t*>(dqp + (size_t)qa * D + c) =
          rsp::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    if (qb < S)
      *reinterpret_cast<uint32_t*>(dqp + (size_t)qb * D + c) =
          rsp::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
  // the group sums; columns past h + w (F's low half, or zeros) are not
  // stored
  const int h = a.h, w = a.w;
#pragma unroll
  for (int j = 0; j < L::NFS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const float va = df[j / 8][4 * (j % 8) + e];
      const float vb = df[j / 8][4 * (j % 8) + 2 + e];
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
template <class L>
__device__ __forceinline__ void consume_dkdv(unsigned char* smem, const Args& a, int wg,
                                             int r0) {
  constexpr int D = L::D;
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

  float dk[D / 2], dv[D / 2], st[32], dpt[32];
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
    product<D>(st, res, qt);                                // K Q^T
    product<L::NFB>(st, res + 2 * L::HT, qt + 2 * L::HT);   // + E F^T
    product<D>(dpt, res + L::HT, qt + L::HT);               // V dO^T
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
      head_k16<D>(dv, pa[kk], qt + L::HT + kk * 2048);  // P^T dO
      head_k16<D>(dk, sa[kk], qt + kk * 2048);          // dS^T Q
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
  for (int j = 0; j < D / 8; ++j) {
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
template <class L>
__global__ void __launch_bounds__(THREADS, 1) relpos_attention_bwd_kernel(
    const __grid_constant__ Maps maps, const Args args) {
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
    if (threadIdx.x == NWG * 128) produce<L>(smem, maps, args, dq_role, r0);
  } else {
    rsp::setmaxnreg_inc<CONSUMER_REGS>();
    if (dq_role)
      consume_dq<L>(smem, args, wg, r0);
    else
      consume_dkdv<L>(smem, args, wg, r0);
  }
}

template <int D, int NFS, int NFB>
int launch(const void* qkv, const void* dout, const void* fcat, const void* e,
           const Args& args, int N, int Sp, cudaStream_t stream) {
  using L = Layout<D, NFS, NFB>;
  const int S = args.S, nh = args.nh;
  Maps m;
  const cuuint64_t qdims[3] = {D, (cuuint64_t)S, (cuuint64_t)N * 3 * nh};
  const cuuint64_t odims[3] = {D, (cuuint64_t)S, (cuuint64_t)N * nh};
  const cuuint64_t rstrides[2] = {D * 2, (cuuint64_t)S * D * 2};
  const cuuint64_t fdims[3] = {NFB, (cuuint64_t)S, (cuuint64_t)N * nh};
  const cuuint64_t fstrides[2] = {NFB * 2, (cuuint64_t)S * NFB * 2};
  const cuuint64_t edims[2] = {NFB, (cuuint64_t)Sp};
  const cuuint64_t estrides[1] = {NFB * 2};
  const cuuint32_t box3[3] = {64, 64, 1};
  const cuuint32_t box2[2] = {64, 64};
  if (!rsp::make_tensor_map(&m.qkv, qkv, 3, qdims, rstrides, box3) ||
      !rsp::make_tensor_map(&m.dout, dout, 3, odims, rstrides, box3) ||
      !rsp::make_tensor_map(&m.fcat, fcat, 3, fdims, fstrides, box3) ||
      !rsp::make_tensor_map(&m.e, e, 2, edims, estrides, box2))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_bwd_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2 * ((S + ROWS - 1) / ROWS), nh, N);
  relpos_attention_bwd_kernel<L><<<grid, THREADS, L::SMEM, stream>>>(m, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The depth NFB of F and E (see the header) for an h x w grid at head dim
// d, or -1 where C' takes no such shape. No launch.
extern "C" int rsp_relpos_attention_bwd_depth(int h, int w, int d) {
  if (h < 1 || w < 1 || h > 64 || w > 64 || (d != 64 && d != 80)) return -1;
  return factor_widths(h, w, d).nfb;
}

// F and E hold rsp_relpos_attention_bwd_depth(h, w, d) columns; d = 64 or 80.
extern "C" int rsp_relpos_attention_bwd(
    const void* qkv, const void* fh, const void* fw, const void* out,
    const void* lse, const void* dout, void* dqkv, void* dfh, void* dfw,
    void* delta_ws, void* fcat_ws, void* e_ws, int N, int nh, int S,
    int h, int w, int d, int Sp, float scale, void* stream) {
  if (rsp_relpos_attention_bwd_depth(h, w, d) < 0 || h * w != S || Sp < S || Sp % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Widths wd = factor_widths(h, w, d);
  const int NFS = wd.nfs, NFB = wd.nfb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = N * nh * S;
  const long work = (long)rows * (NFB / 8 > 8 ? NFB / 8 : 8);  // the largest of the prep's loops
  const int blocks = (int)((work + 255) / 256 < 2048 ? (work + 255) / 256 : 2048);
  prep_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(fh), static_cast<const bf16*>(fw),
      static_cast<float*>(delta_ws), static_cast<bf16*>(fcat_ws), static_cast<bf16*>(e_ws),
      rows, S, h, w, d, NFB, wd.lo_col, Sp, 1.f / scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{static_cast<const float*>(lse), static_cast<const float*>(delta_ws),
                  static_cast<bf16*>(dqkv), static_cast<bf16*>(dfh), static_cast<bf16*>(dfw),
                  nh, S, h, w, scale, scale * LOG2E};
  if (d == 64)
    return NFS == 64 ? launch<64, 64, 64>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st)
                     : launch<64, 128, 128>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st);
  if (NFS == 128) return launch<80, 128, 256>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st);
  return NFB == 64 ? launch<80, 64, 64>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st)
                   : launch<80, 64, 128>(qkv, dout, fcat_ws, e_ws, args, N, Sp, st);
}
