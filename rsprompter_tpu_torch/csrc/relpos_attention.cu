// Kernel C: softmax(q k^T * d^-0.5 + bias) v with SAM's decomposed rel-pos
// bias, bias[q, key] = fh[q, key / w] + fw[q, key % w].
//
// Replaces the TPU kernels of rsprompter_tpu/ops/fused_vit_attention.py:
// _window_kernel_pair (windowed layers), _global_kernel_pair_tiled (the
// global layers' inference default) and _global_kernel_pair (the exact-softmax
// variant); at its own call sites also flash_attention.py's _fwd_kernel /
// _fwd_kernel_smallseq (K10) and the per-head _window_kernel /
// _global_kernel (K11). One exact online softmax in fp32 serves all of them;
// the TPU's +-60 logit clamp is not carried over (PARITY.md deviation 8).
//
// Inputs: qkv (N, 3n, S, d) bf16 head-major (q heads, then k, then v), with
// head dim d = 64 (ViT-B, ViT-L) or 80 (ViT-H), the factors fh (N, n, S, h)
// and fw (N, n, S, w) bf16 from the torch einsum. Output: (N, n, S, d)
// bf16, and, when the caller asks for it (the backward does), the fp32 row
// log-sum-exp (N, n, S) of the biased scores in natural-log units.
//
// Bound on the H100 at 1024^2, batch 2: a global layer is 103 GFLOP at
// ViT-B, 137 at ViT-L, 172 at ViT-H (about 104, 139 and 174 us at 989
// TFLOP/s, operations-bound); a windowed layer moves about 67, 89 and 109 MB
// (about 20, 27 and 33 us at 3.35 TB/s, bytes-bound).
//
// Head dim 80: a row of 80 bf16 is 160 bytes, wider than one 128-byte
// swizzle row. Each head is held in shared memory as two 64-column chunks,
// each its own TMA box with 128-byte swizzle: the second box starts at
// column 64 and reads zeros past column 80, so no padded copy of qkv
// exists in device memory. Q K^T walks K in five 16-deep steps (four in
// the first chunk, one in the second) and P V is one wgmma of N = 80 whose
// B descriptor steps from the first chunk to the second by its leading
// byte offset, as the MN-major operands of kernel A' do. This was chosen
// over having kernel B write heads padded to 128 columns: that would move
// 1.6x the bytes through qkv and would still need two swizzle rows a head.
// The cost is shared memory (the second chunk is 75% zeros): the window
// path holds one unit stage where d = 64 holds two.
//
// Design, FlashAttention-3 style: Q, K and V arrive by TMA (128-byte swizzle,
// mbarriers; rows past S read zeros) issued by one producer thread; consumer
// warpgroups of 64 queries each run S = Q K^T as wgmma from shared memory,
// mask keys past S to -inf (pad tokens inside a window are real keys), take
// the softmax in base 2 (log2 e folded into the scale, exp2), round p to
// bf16 and run O += P V as wgmma with P straight from the score registers as
// the A operand and V read N-major from shared memory, so nothing is
// transposed. The output is normalised after P V, staged through shared
// memory and stored 16 bytes a thread; the row log-sum-exp is converted to
// natural log before its store. Two paths:
// - Global layers (LongTile): 2 consumer warpgroups stream 128-key K / V
//   tiles through a 2-stage ring with an online softmax, each overlapping a
//   tile's softmax with the next Q K^T and the last P V. Where w divides 64
//   (the 64 x 64 and 32 x 32 grids) a column's fw term is the same in every
//   key tile and lives in registers, and fh is one value per row and 64 or
//   32 columns, folded into the row max and the exponent; other grids look
//   both factors up in the block's factor rows in shared memory (3.3x as
//   long at the 64 x 64 grid, H100 80GB HBM3 at 700 W,
//   scripts/torch_kernel_ab.py --generic-copy).
// - Windows and small grids (S <= 200, h + w <= 64; Win below): bytes-bound
//   (about 67 MB at ViT-B, 20 us), but 600 (window, head) items of 196
//   tokens made the first design latency-bound. One persistent block per
//   SM walks units (item, pair of 64-query tiles), two consumer warpgroups
//   taking a tile each, and the producer thread keeps the next unit in
//   flight while they compute, so the ring runs across items: K, V and Q
//   by TMA, and each tile's factor rows (two contiguous runs, not 16-byte
//   aligned: h + w = 28 bf16 a row) by 1-D bulk copies of their aligned
//   hulls. Every key is in one tile of N = 200 at 14 x 14 (64 or 128 for
//   smaller S): an exact single-pass softmax, 196 x 200 scores where
//   256 x 256 were computed, and warps whose 16 rows all lie past S skip
//   it. The bias is one more product, as in kernel C': with F = [hi | lo |
//   0] (64 columns, spread from the raw rows in shared memory, two threads
//   a row; hi and lo the bf16 high and low halves of [fh | fw] / scale
//   taken in fp32: hi alone is exact at d = 64, where 1 / scale = 8, and
//   hi + lo keeps about 16 bits at d = 80) and E[key, f] = 1 where f ==
//   key / w or f == h + key % w, in both halves (built once per block),
//   Q K^T + F E^T is the biased score over the scale, so a score costs one
//   fma and one exp2 and no lookup. (E's entries were 1 / scale before,
//   exact only where that is a power of two: at d = 80 every window would
//   have taken the global path; hi alone rounds the bias once more, which
//   read 2.5e-3 in a 2.1 row log-sum-exp.) Two earlier versions were slower: one that loaded each
//   tile's factor rows into registers a tile ahead (their latency still sat
//   on every tile's path), and one that wrote F to device memory in a
//   second launch (one more launch's host time a call, where the
//   three-head shape is bound by the host). Grids of 200 < S <= 256 (a
//   256^2 input's 16 x 16 global grid) take the global path.
// Windows were first one block of 4 warpgroups per (window, head): 600
// cold starts at one block per SM, a lookup per score, 256 x 256 scores
// (1.24x SDPA with a materialised bias).
#include <math.h>

#include "hopper.cuh"

using rsp::bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int QCHUNK = 64 * 128;  // 64 rows of one 64-column chunk, 8 KB

// A head of D = 64 or 80 columns is held in shared memory as DC 64-column
// chunks of 128-byte swizzled rows (an 80-wide row is 160 bytes, wider than
// one swizzle row): TMA loads each chunk as its own box, and the columns
// past D read zeros.
template <int D>
struct Head {
  static_assert(D == 64 || D == 80, "head dim 64 or 80");
  static constexpr int DC = (D + 63) / 64;
  static constexpr int QT = DC * QCHUNK;  // one warpgroup's 64-query tile
};

// Descriptor of the k-th 16-deep K slice of a K-major tile stored as
// 64-column chunks `chunk` bytes apart.
__device__ __forceinline__ uint64_t kslice_desc(const unsigned char* tile, int chunk, int k) {
  return rsp::sw128_desc(tile + (k / 4) * chunk + 32 * (k % 4));
}

// O += P V over one 16-key slice: P from registers, V's rows (keys) at `v`
// as 64-column chunks `chunk` bytes apart, read N-major.
template <int D>
__device__ __forceinline__ void pv_k16(float (&o)[D / 2], const uint32_t (&p)[4],
                                       const unsigned char* v, int chunk) {
  if constexpr (D == 64) rsp::wgmma_m64n64k16_rs_nmajor(o, p, rsp::sw128_desc(v));
  else rsp::wgmma_m64n80k16_rs_nmajor(o, p, rsp::sw128_desc_mn(v, chunk));
}

// The 16-byte chunk c of row r in a swizzled tile of 64-column chunks.
__device__ __forceinline__ unsigned char* row_chunk(unsigned char* tile, int r, int c) {
  return tile + (c / 8) * QCHUNK + r * 128 + (((c % 8) ^ (r & 7)) << 4);
}

// The global path's block: NWG = 2 consumer warpgroups of 64 queries each,
// then the producer; BK = 128 keys per tile through a K / V ring of two
// stages, each consumer overlapping a tile's softmax with the next tile's
// Q K^T and the last tile's P V, which needs about 180 registers: the
// producer is a whole warpgroup that hands its registers to the consumers
// (setmaxnreg).
template <int D_>
struct LongTile {
  static constexpr int D = D_;
  static constexpr int DC = Head<D>::DC;
  static constexpr int QT = Head<D>::QT;
  static constexpr int NWG = 2;
  static constexpr int BK = 128;
  static constexpr int BQ = 64 * NWG;
  static constexpr int STAGES = 2;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int THREADS = NWG * 128 + 128;
  // setmaxnreg.inc waits for registers that setmaxnreg.dec freed in the same
  // block: the consumers may gain no more than the producer gives up
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  static_assert(NWG * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - 24,
                "register rebalance exceeds what the producer frees");
  static constexpr int KVCHUNK = BK * 128;  // one 64-column chunk of a K or V tile
  static constexpr int KVTILE = DC * KVCHUNK;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_RING = OFF_Q + NWG * QT;              // K, V per stage
  static constexpr int OFF_BAR = OFF_RING + STAGES * 2 * KVTILE;  // q, full[], empty[]
  static constexpr int OFF_FACT = OFF_BAR + 128;                  // fp32 factor rows
};

struct Args {
  const bf16* fh;
  const bf16* fw;
  bf16* out;
  float* lse;
  int nh, S, h, w;
  float scale_log2;
};

// dst[i] = log2 e * src[qbase's rows][i] for i < n, 0 at and past `valid`:
// eight loads in flight per thread before any store, so the staging costs
// one or a few memory latencies, not one per element.
__device__ __forceinline__ void stage_rows(float* dst, const bf16* src, int n, int valid,
                                           int tid) {
  constexpr int U = 8;
  for (int base = tid; base < n; base += 128 * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 128 * u;
      v[u] = i < n && i < valid ? rsp::to_f(src[i]) * LOG2E : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + 128 * u < n) dst[base + 128 * u] = v[u];
  }
}

// One consumer warpgroup: 64 query rows against every key tile.
template <int WF, class T>
__device__ __forceinline__ void consume(unsigned char* smem, const Args& a, int wg) {
  constexpr int BK = T::BK, STAGES = T::STAGES, KVTILE = T::KVTILE, D = T::D;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  float* fact = reinterpret_cast<float*>(smem + T::OFF_FACT);
  const int S = a.S, h = a.h, w = a.w;
  const int plane_f = blockIdx.z * a.nh + blockIdx.y;
  const int ntiles = (S + BK - 1) / BK;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rl0 = 16 * warp + g;  // this thread's rows within the warpgroup
  const int rl1 = rl0 + 8;
  const int qbase = blockIdx.x * T::BQ + 64 * wg;
  const size_t frow = (size_t)plane_f * S;

  // the warpgroup's factor rows, scaled by log2 e; rows past S hold zeros
  float* fhs = fact + wg * 64 * h;
  float* fws = fact + T::NWG * 64 * h + wg * 64 * w;  // generic path only
  stage_rows(fhs, a.fh + (frow + qbase) * h, 64 * h, (S - qbase) * h, tid);
  float fwr[2][16];  // WF > 0: fw of this thread's columns mod 64, rows rl0, rl1
  if constexpr (WF > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (8 * j + 2 * t + e) % WF;
        const int qa = qbase + rl0;
        const int qb = qbase + rl1;
        fwr[0][2 * j + e] = qa < S ? rsp::to_f(a.fw[(frow + qa) * WF + c]) * LOG2E : 0.f;
        fwr[1][2 * j + e] = qb < S ? rsp::to_f(a.fw[(frow + qb) * WF + c]) * LOG2E : 0.f;
      }
    }
  } else {
    stage_rows(fws, a.fw + (frow + qbase) * w, 64 * w, (S - qbase) * w, tid);
  }
  rsp::named_sync(2 + wg, 128);
  rsp::mbar_wait(qbar, 0);
  const unsigned char* qt = smem + T::OFF_Q + wg * T::QT;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units), rows rl0, rl1
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

  // S = Q K^T of key tile `it` into sc (one wgmma group)
  auto qk = [&](int it) {
    const int s = it % STAGES;
    rsp::mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* kt = smem + T::OFF_RING + s * 2 * KVTILE;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    rsp::fence_regs(sc);
    rsp::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      rsp::wgmma_m64n128k16_ss(sc, kslice_desc(qt, QCHUNK, k), kslice_desc(kt, T::KVCHUNK, k));
    rsp::wgmma_commit();
  };
  // O += P V of key tile `it`, P from registers (one wgmma group)
  auto pv = [&](int it) {
    const unsigned char* vt = smem + T::OFF_RING + (it % STAGES) * 2 * KVTILE + KVTILE;
    rsp::fence_regs(o);
    rsp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pv_k16<D>(o, pa[kk], vt + kk * 2048, T::KVCHUNK);
    rsp::wgmma_commit();
  };
  // biased scores, new running max and p = exp2(s - max) in sc; returns the
  // factors (a0, a1) by which O and l must shrink. Keys past S (only in a
  // partial last tile) are masked to -inf.
  auto softmax = [&](int it, float& a0, float& a1) {
    const int k0 = it * BK;
    const bool partial = k0 + BK > S;
    // WF > 0: x = s * scale + fw, and fh is one value per row for each
    // WF-wide group of columns, folded into the row max and the exponent
    constexpr int G = WF > 0 ? BK / WF : 1;
    float f0[G], f1[G], gm0[G], gm1[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if constexpr (WF > 0) {
        const int kh = min(k0 / WF + gi, h - 1);
        f0[gi] = fhs[rl0 * h + kh];
        f1[gi] = fhs[rl1 * h + kh];
      } else {
        f0[gi] = f1[gi] = 0.f;
      }
      gm0[gi] = gm1[gi] = -INFINITY;
    }
    // generic path: (kh, kw) of this thread's column 8 j + 2 t, walked from
    // one division per tile (the pair's second column is kw + 1)
    int ch = 0, cw = 0;
    if constexpr (WF == 0) {
      ch = (k0 + 2 * t) / w;
      cw = k0 + 2 * t - ch * w;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int gi = WF > 0 ? (8 * j) / (WF > 0 ? WF : 1) : 0;
      if constexpr (WF == 0) {
        if (j > 0) {
          cw += 8;
          while (cw >= w) {
            cw -= w;
            ++ch;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        float v0, v1;
        if constexpr (WF > 0) {
          v0 = fmaf(sc[4 * j + e], a.scale_log2, fwr[0][2 * (j % 8) + e]);
          v1 = fmaf(sc[4 * j + 2 + e], a.scale_log2, fwr[1][2 * (j % 8) + e]);
        } else {
          const bool wrap = e == 1 && cw + 1 == w;
          const int kh = min(ch + (wrap ? 1 : 0), h - 1);
          const int kw = e == 0 ? cw : (wrap ? 0 : cw + 1);
          v0 = fmaf(sc[4 * j + e], a.scale_log2, fhs[rl0 * h + kh] + fws[rl0 * w + kw]);
          v1 = fmaf(sc[4 * j + 2 + e], a.scale_log2, fhs[rl1 * h + kh] + fws[rl1 * w + kw]);
        }
        if (partial && key >= S) v0 = v1 = -INFINITY;
        sc[4 * j + e] = v0;
        sc[4 * j + 2 + e] = v1;
        gm0[gi] = fmaxf(gm0[gi], v0);
        gm1[gi] = fmaxf(gm1[gi], v1);
      }
    }
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      tmax0 = fmaxf(tmax0, gm0[gi] + f0[gi]);
      tmax1 = fmaxf(tmax1, gm1[gi] + f1[gi]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    // every tile holds at least one valid key, so the new max is finite
    const float mn0 = fmaxf(m0, tmax0);
    const float mn1 = fmaxf(m1, tmax1);
    a0 = exp2f(m0 - mn0);  // 0 on the first tile
    a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {  // exponent offsets: max less the group's fh
      f0[gi] = mn0 - f0[gi];
      f1[gi] = mn1 - f1[gi];
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int gi = WF > 0 ? (8 * j) / (WF > 0 ? WF : 1) : 0;
      sc[4 * j] = exp2f(sc[4 * j] - f0[gi]);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - f0[gi]);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - f1[gi]);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - f1[gi]);
      s0 += sc[4 * j] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
  };
  // p rounded to bf16, in the order of wgmma's register A operand
  auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      pa[j / 2][(j % 2) * 2] = rsp::pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = rsp::pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };

  auto rescale = [&](float a0, float a1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
  };

  float a0, a1;
  qk(0);
  rsp::wgmma_wait<0>();
  rsp::fence_regs(sc);
  softmax(0, a0, a1);
  pack();
  for (int it = 1; it < ntiles; ++it) {
    qk(it);      // the next tile's scores ...
    pv(it - 1);  // ... and the last tile's P V in flight together
    rsp::wgmma_wait<1>();
    rsp::fence_regs(sc);
    softmax(it, a0, a1);  // overlaps P V
    rsp::wgmma_wait<0>();
    rsp::fence_regs(o);
    rsp::mbar_arrive(&empty[(it - 1) % STAGES]);
    rescale(a0, a1);
    pack();
  }
  pv(ntiles - 1);
  rsp::wgmma_wait<0>();
  rsp::fence_regs(o);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (a.lse != nullptr && t == 0) {  // row log-sum-exp for the backward, natural log
    float* lr = a.lse + (size_t)plane_f * S;
    if (qbase + rl0 < S) lr[qbase + rl0] = (m0 + log2f(l0)) * LN2;
    if (qbase + rl1 < S) lr[qbase + rl1] = (m1 + log2f(l1)) * LN2;
  }
  // stage the normalised rows in this warpgroup's Q tile (16-byte chunks
  // swizzled by row), then store them 16 bytes a thread
  unsigned char* st = smem + T::OFF_Q + wg * T::QT;
  rsp::fence_async_shared();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(row_chunk(st, rl0, j) + 4 * t) =
        rsp::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(row_chunk(st, rl1, j) + 4 * t) =
        rsp::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  rsp::named_sync(2 + wg, 128);
  bf16* ob = a.out + (size_t)plane_f * S * D;
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    if (qbase + r < S)
      *reinterpret_cast<uint4*>(ob + (size_t)(qbase + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(row_chunk(st, r, c));
  }
}

// WF: w when it divides 64 (its fw terms live in registers), else 0.
template <int WF, class T>
__global__ void __launch_bounds__(T::THREADS, 1) relpos_attention_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kvmap,
    const Args args) {
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (rsp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    rsp::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      rsp::mbar_init(&full[s], 1);
      rsp::mbar_init(&empty[s], T::NWG * 128);
    }
    rsp::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::NWG) {  // producer: one thread issues every TMA load
    rsp::setmaxnreg_dec<24>();
    if (threadIdx.x == T::NWG * 128) {
      const int nh = args.nh;
      const int plane_q = blockIdx.z * 3 * nh + blockIdx.y;
      const int q0 = blockIdx.x * T::BQ;
      const int ntiles = (args.S + T::BK - 1) / T::BK;
      rsp::mbar_expect_tx(qbar, T::NWG * T::QT);
      for (int i = 0; i < T::NWG; ++i)
        for (int c = 0; c < T::DC; ++c)
          rsp::tma_load_3d(smem + T::OFF_Q + i * T::QT + c * QCHUNK, &qmap, qbar, 64 * c,
                           q0 + 64 * i, plane_q);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) rsp::mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        rsp::mbar_expect_tx(&full[s], 2 * T::KVTILE);
        unsigned char* kt = smem + T::OFF_RING + s * 2 * T::KVTILE;
        for (int c = 0; c < T::DC; ++c) {
          rsp::tma_load_3d(kt + c * T::KVCHUNK, &kvmap, &full[s], 64 * c, it * T::BK,
                           plane_q + nh);
          rsp::tma_load_3d(kt + T::KVTILE + c * T::KVCHUNK, &kvmap, &full[s], 64 * c,
                           it * T::BK, plane_q + 2 * nh);
        }
      }
    }
  } else {
    rsp::setmaxnreg_inc<T::CONSUMER_REGS>();
    consume<WF, T>(smem, args, wg);
  }
}

// The tensor map of qkv (N, 3n, S, D): boxes of one 64-column chunk by
// `rows` tokens of one head plane.
bool qkv_map(CUtensorMap* map, const void* qkv, int D, int S, int planes, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return rsp::make_tensor_map(map, qkv, 3, dims, strides, box);
}

template <int WF, class T>
int launch(const void* qkv, const Args& args, int N, cudaStream_t stream) {
  CUtensorMap qmap, kvmap;
  const int planes = N * 3 * args.nh;
  if (!qkv_map(&qmap, qkv, T::D, args.S, planes, 64) ||
      !qkv_map(&kvmap, qkv, T::D, args.S, planes, T::BK))
    return static_cast<int>(cudaErrorNotSupported);
  const int smem = 1024 + T::OFF_FACT + T::NWG * 64 * (args.h + (WF > 0 ? 0 : args.w)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_attention_kernel<WF, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.S + T::BQ - 1) / T::BQ, args.nh, N);
  relpos_attention_kernel<WF, T><<<grid, T::THREADS, smem, stream>>>(qmap, kvmap, args);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------- windows

constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block may use

// The window path's block, one per SM, walks units (item, pair): item is a
// (window, head), pair p its query tiles 2p and 2p + 1, which the two
// consumer warpgroups take. One producer thread keeps the next unit in
// flight while they compute: its K, V and Q tiles by TMA, and the raw
// factor rows of each tile (rows x h of fh, rows x w of fw: contiguous
// runs) by 1-D bulk copies of their 16-byte-aligned hulls. Every key of an
// item is in one tile of BN (S rounded up to 64, 128 or 200, the score
// products' N); BNP = BN rounded up to 16 is the P V product's depth.
template <int BN_, int D_>
struct Win {
  static constexpr int BN = BN_;
  static constexpr int D = D_;
  static constexpr int BNP = (BN + 15) / 16 * 16;
  static constexpr int NWG = 2;
  static constexpr int THREADS = NWG * 128 + 128;
  static constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  static_assert(NWG * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - PRODUCER_REGS,
                "register rebalance exceeds what the producer frees");
  static constexpr int DC = Head<D>::DC;
  static constexpr int QT = Head<D>::QT;
  // unit stages: two at d = 64; an 80-wide head's K and V take two chunks
  // each, and only one stage fits in shared memory
  static constexpr int UST = D == 64 ? 2 : 1;
  static constexpr int KVCHUNK = BNP * 128;  // a 64-column chunk of K or V, and E
  static constexpr int KVT = DC * KVCHUNK;   // a K or V tile
  static constexpr int QF = QT + QCHUNK;     // a warpgroup's Q tile, then its F tile
  // a stage: K, V, then per warpgroup its Q tile (later its output's
  // staging) and its F tile, then per warpgroup its raw factor rows
  static constexpr int OFF_K = 0, OFF_V = KVT, OFF_QF = 2 * KVT;
  static constexpr int OFF_RAW = 2 * KVT + NWG * QF;
  static constexpr int OFF_E = 0;  // the group matrix E, built once
  static constexpr int OFF_RING = OFF_E + KVCHUNK;
  // the ring's stage size and the block's shared memory at `raw` bytes of
  // raw factor rows per warpgroup (stages stay 1024-byte aligned for TMA)
  static constexpr int stage(int raw) { return (OFF_RAW + NWG * raw + 1023) / 1024 * 1024; }
  static constexpr int smem(int raw) { return 1024 + OFF_RING + UST * stage(raw) + 128; }
};

struct WinArgs {
  const bf16* fh;
  const bf16* fw;
  bf16* out;
  float* lse;
  int nh, S, h, w, units, rt, pairs;  // rt: 64-query tiles per item
  int raw, stage;                     // bytes: raw rows per warpgroup, one stage
  float c;                            // scale * log2 e
  float inv_scale;                    // F's factor: 1 / scale
  int lo;  // the column of F's low half (h + w), 0 where 2 (h + w) > 64
};

// 2^x on the special-function unit, subnormal results flushed to zero (a p
// that small adds nothing to a row sum of at least 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sc += A B^T over the whole key tile, K / 16 steps (A: 64 rows, B: the
// keys; both K-major, in 64-column chunks `ca` and `cb` bytes apart)
template <int BN, int K>
__device__ __forceinline__ void scores(float (&sc)[BN / 2], const unsigned char* a, int ca,
                                       const unsigned char* b, int cb) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    const uint64_t da = kslice_desc(a, ca, k), db = kslice_desc(b, cb, k);
    if constexpr (BN == 200) rsp::wgmma_m64n200k16_ss(sc, da, db);
    else if constexpr (BN == 128) rsp::wgmma_m64n128k16_ss(sc, da, db);
    else rsp::wgmma_m64n64k16_ss(sc, da, db);
  }
}

// The 16-byte-aligned hull of a run of `n` bf16 from `p`: its start and
// bytes; the run begins (p - start) bytes in.
struct Hull {
  const unsigned char* start;
  uint32_t bytes;
};
__device__ __forceinline__ Hull hull(const bf16* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t(15), hi = (a + 2 * (uintptr_t)n + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const unsigned char*>(lo), static_cast<uint32_t>(hi - lo)};
}

// One consumer warpgroup: its query tile of every unit the block walks.
template <class W>
__device__ __forceinline__ void window_consume(unsigned char* smem, const WinArgs& a, int wg) {
  constexpr int BN = W::BN, D = W::D;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::OFF_RING + W::UST * a.stage);
  uint64_t* empty = full + W::UST;
  const int S = a.S, h = a.h, w = a.w;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rl0 = 16 * warp + g;  // this thread's rows within the tile
  const int rl1 = rl0 + 8;
  const unsigned char* es = smem + W::OFF_E;

  for (int n = 0;; ++n) {
    const int unit = blockIdx.x + n * gridDim.x;
    if (unit >= a.units) break;
    const int item = unit / a.pairs;
    const int rt = 2 * (unit % a.pairs) + wg;
    const int s = n % W::UST;
    unsigned char* st = smem + W::OFF_RING + s * a.stage;
    rsp::mbar_wait(&full[s], (n / W::UST) & 1);
    if (rt < a.rt) {
      const int q0 = 64 * rt;
      const int rows = min(64, S - q0);
      unsigned char* qt = st + W::OFF_QF + wg * W::QF;  // Q, then the output's staging
      unsigned char* fs = qt + W::QT;
      // F = [hi | lo | 0] from the raw rows (two threads a row: fh, fw):
      // hi = bf16(v), lo = bf16(v - hi) of v = [fh | fw] / scale in fp32,
      // so F E^T sums the bias over the scale to about 16 bits (at d = 64,
      // where 1 / scale = 8, hi is exact and lo zero); the columns past
      // them keep the zeros they started with
      {
        const size_t row0 = (size_t)item * S + q0;
        const bf16* ph = a.fh + row0 * h;
        const bf16* pw = a.fw + row0 * w;
        const Hull hh = hull(ph, rows * h);
        const unsigned char* raw = st + W::OFF_RAW + wg * a.raw;
        const int r = tid / 2;
        const bool is_w = tid % 2;
        const int fac = is_w ? w : h;
        const bf16* src = reinterpret_cast<const bf16*>(
            is_w ? raw + hh.bytes + (reinterpret_cast<uintptr_t>(pw) & 15)
                 : raw + (reinterpret_cast<uintptr_t>(ph) & 15)) + r * fac;
        if (r < rows) {
          for (int i = 0; i < fac; ++i) {
            const int f = (is_w ? h : 0) + i;
            const float v = rsp::to_f(src[i]) * a.inv_scale;
            const bf16 hi = rsp::to_bf(v);
            *reinterpret_cast<bf16*>(fs + r * 128 + (((f >> 3) ^ (r & 7)) << 4) + (f & 7) * 2) =
                hi;
            if (a.lo) {
              const int fl = f + a.lo;
              *reinterpret_cast<bf16*>(fs + r * 128 + (((fl >> 3) ^ (r & 7)) << 4) +
                                       (fl & 7) * 2) = rsp::to_bf(v - rsp::to_f(hi));
            }
          }
        }
        rsp::fence_async_shared();
        rsp::named_sync(2 + wg, 128);
      }
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      rsp::fence_regs(sc);
      rsp::wgmma_fence();
      scores<BN, D>(sc, qt, QCHUNK, st + W::OFF_K, W::KVCHUNK);  // Q K^T
      scores<BN, 64>(sc, fs, QCHUNK, es, W::KVCHUNK);  // + F E^T: the bias over the scale
      rsp::wgmma_commit();
      rsp::wgmma_wait<0>();
      rsp::fence_regs(sc);

      // exact softmax over the whole row in base 2; warps whose 16 rows are
      // all past S skip it (their rows are not stored)
      const bool live = q0 + 16 * warp < S;
      uint32_t pa[W::BNP / 16][4];
      float l0 = 1.f, l1 = 1.f, mc0 = 0.f, mc1 = 0.f;
      if (live) {
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int j8 = 0; j8 < BN / 8; ++j8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * j8 + 8 > S && 8 * j8 + 2 * t + e >= S) {
              sc[4 * j8 + e] = -INFINITY;
              sc[4 * j8 + 2 + e] = -INFINITY;
            }
            m0 = fmaxf(m0, sc[4 * j8 + e]);
            m1 = fmaxf(m1, sc[4 * j8 + 2 + e]);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        mc0 = m0 * a.c;  // key 0 is always valid: finite
        mc1 = m1 * a.c;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          sc[4 * i] = exp2_ftz(fmaf(sc[4 * i], a.c, -mc0));
          sc[4 * i + 1] = exp2_ftz(fmaf(sc[4 * i + 1], a.c, -mc0));
          sc[4 * i + 2] = exp2_ftz(fmaf(sc[4 * i + 2], a.c, -mc1));
          sc[4 * i + 3] = exp2_ftz(fmaf(sc[4 * i + 3], a.c, -mc1));
          s0 += sc[4 * i] + sc[4 * i + 1];
          s1 += sc[4 * i + 2] + sc[4 * i + 3];
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        l0 = s0;
        l1 = s1;
      }
      // p rounded to bf16, in the order of wgmma's register A operand; the
      // columns from BN to BNP are zeros
#pragma unroll
      for (int i = 0; i < W::BNP / 8; ++i) {
        const bool on = live && i < BN / 8;
        const int k = i < BN / 8 ? i : 0;  // a constant once unrolled
        pa[i / 2][(i % 2) * 2] = on ? rsp::pack_bf16(sc[4 * k], sc[4 * k + 1]) : 0u;
        pa[i / 2][(i % 2) * 2 + 1] = on ? rsp::pack_bf16(sc[4 * k + 2], sc[4 * k + 3]) : 0u;
      }

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      rsp::fence_regs(o);
      rsp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W::BNP / 16; ++kk)
        pv_k16<D>(o, pa[kk], st + W::OFF_V + kk * 2048, W::KVCHUNK);
      rsp::wgmma_commit();
      rsp::wgmma_wait<0>();
      rsp::fence_regs(o);

      const size_t plane = (size_t)item * S;
      if (live) {
        if (a.lse != nullptr && t == 0) {  // natural log, for the backward
          if (q0 + rl0 < S) a.lse[plane + q0 + rl0] = (mc0 + log2f(l0)) * LN2;
          if (q0 + rl1 < S) a.lse[plane + q0 + rl1] = (mc1 + log2f(l1)) * LN2;
        }
        // stage the normalised rows in the Q tile's place (16-byte chunks
        // swizzled by row): wgmma has finished reading it
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
        rsp::fence_async_shared();
#pragma unroll
        for (int j8 = 0; j8 < D / 8; ++j8) {
          *reinterpret_cast<uint32_t*>(row_chunk(qt, rl0, j8) + 4 * t) =
              rsp::pack_bf16(o[4 * j8] * inv0, o[4 * j8 + 1] * inv0);
          *reinterpret_cast<uint32_t*>(row_chunk(qt, rl1, j8) + 4 * t) =
              rsp::pack_bf16(o[4 * j8 + 2] * inv1, o[4 * j8 + 3] * inv1);
        }
      }
      rsp::named_sync(2 + wg, 128);
      bf16* ob = a.out + plane * D;
      for (int i = tid; i < 64 * (D / 8); i += 128) {
        const int r = i / (D / 8);
        const int cc = i % (D / 8);
        if (q0 + r < S)
          *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * D + cc * 8) =
              *reinterpret_cast<const uint4*>(row_chunk(qt, r, cc));
      }
    }
    rsp::fence_async_shared();  // the staging writes, before TMA refills the stage
    rsp::mbar_arrive(&empty[s]);  // this thread is done with the stage
  }
}

template <class W>
__global__ void __launch_bounds__(W::THREADS, 1) window_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kvmap,
    const WinArgs args) {
  constexpr int BN = W::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (rsp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::OFF_RING + W::UST * args.stage);
  uint64_t* empty = full + W::UST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::UST; ++s) {
      rsp::mbar_init(&full[s], 1);
      rsp::mbar_init(&empty[s], W::NWG * 128);
    }
    rsp::mbar_fence_init();
  }
  // E (keys x 64) once per block: 1 at f = key / w and f = h + key % w for
  // the keys before S, and again lo columns on (F's low half), zeros
  // elsewhere; and the F tiles zeroed, so the columns past F's never hold a
  // stale NaN for E's zeros to multiply
  const int S = args.S, h = args.h, w = args.w, lo = args.lo;
  for (int i = threadIdx.x; i < BN * 8; i += W::THREADS) {
    const int key = i / 8;
    const int c = (i % 8) * 8;
    const int fa = key < S ? key / w : -1;
    const int fb = key < S ? h + key % w : -1;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = c + u;
      const bool on = f == fa || f == fb || (lo && key < S && (f - lo == fa || f - lo == fb));
      v[u] = rsp::to_bf(on ? 1.f : 0.f);
    }
    *reinterpret_cast<uint4*>(smem + W::OFF_E + key * 128 + (((c / 8) ^ (key & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
  for (int s = 0; s < W::UST; ++s)
    for (int j = 0; j < W::NWG; ++j) {
      uint4* f = reinterpret_cast<uint4*>(smem + W::OFF_RING + s * args.stage + W::OFF_QF +
                                          j * W::QF + W::QT);
      for (int i = threadIdx.x; i < QCHUNK / 16; i += W::THREADS) f[i] = make_uint4(0, 0, 0, 0);
    }
  rsp::fence_async_shared();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg < W::NWG) {
    rsp::setmaxnreg_inc<W::CONSUMER_REGS>();
    window_consume<W>(smem, args, wg);
    return;
  }
  rsp::setmaxnreg_dec<W::PRODUCER_REGS>();
  if (threadIdx.x != W::NWG * 128) return;
  // the producer: one thread issues each unit's loads
  const int nh = args.nh;
  for (int n = 0;; ++n) {
    const int unit = blockIdx.x + n * gridDim.x;
    if (unit >= args.units) break;
    const int item = unit / args.pairs;
    const int pair = unit % args.pairs;
    const int s = n % W::UST;
    unsigned char* st = smem + W::OFF_RING + s * args.stage;
    if (n >= W::UST) rsp::mbar_wait(&empty[s], ((n / W::UST) - 1) & 1);
    const int plane_q = (item / nh) * 3 * nh + item % nh;
    const int tiles = min(2, args.rt - 2 * pair);
    Hull hh[2], hw[2];
    uint32_t bytes = 2 * W::KVT + tiles * W::QT;
    for (int j = 0; j < tiles; ++j) {
      const int q0 = 64 * (2 * pair + j);
      const int rows = min(64, S - q0);
      const size_t row0 = (size_t)item * S + q0;
      hh[j] = hull(args.fh + row0 * h, rows * h);
      hw[j] = hull(args.fw + row0 * w, rows * w);
      bytes += hh[j].bytes + hw[j].bytes;
    }
    rsp::mbar_expect_tx(&full[s], bytes);
    for (int c = 0; c < W::DC; ++c) {
      rsp::tma_load_3d(st + W::OFF_K + c * W::KVCHUNK, &kvmap, &full[s], 64 * c, 0,
                       plane_q + nh);
      rsp::tma_load_3d(st + W::OFF_V + c * W::KVCHUNK, &kvmap, &full[s], 64 * c, 0,
                       plane_q + 2 * nh);
    }
    for (int j = 0; j < tiles; ++j) {
      for (int c = 0; c < W::DC; ++c)
        rsp::tma_load_3d(st + W::OFF_QF + j * W::QF + c * QCHUNK, &qmap, &full[s], 64 * c,
                         64 * (2 * pair + j), plane_q);
      unsigned char* raw = st + W::OFF_RAW + j * args.raw;
      rsp::bulk_load(raw, hh[j].start, hh[j].bytes, &full[s]);
      rsp::bulk_load(raw + hh[j].bytes, hw[j].start, hw[j].bytes, &full[s]);
    }
  }
}

template <class W>
int launch_window(const void* qkv, WinArgs args, int N, cudaStream_t stream) {
  // raw rows per warpgroup: two hulls, each at most 2 * 64 * (h or w) + 30
  // bytes, rounded to 16
  args.raw = 128 * (args.h + args.w) + 64;
  args.stage = W::stage(args.raw);
  const int smem = W::smem(args.raw);
  CUtensorMap qmap, kvmap;
  const int planes = N * 3 * args.nh;
  if (!qkv_map(&qmap, qkv, W::D, args.S, planes, 64) ||
      !qkv_map(&kvmap, qkv, W::D, args.S, planes, W::BNP))
    return static_cast<int>(cudaErrorNotSupported);
  // once per device: the shared-memory opt-in (the most any h + w needs)
  // and the SM count (the grid)
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  if (sms[dev] == 0) {
    if ((err = cudaFuncSetAttribute(window_kernel<W>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_LIMIT)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return static_cast<int>(err);
  }
  const int grid = args.units < sms[dev] ? args.units : sms[dev];
  window_kernel<W><<<grid, W::THREADS, smem, stream>>>(qmap, kvmap, args);
  return static_cast<int>(cudaGetLastError());
}

// Whether a grid of S = h x w keys takes the window path at head dim D:
// windows and small grids, the bias as the product F E^T (F scaled by
// 1 / scale, E of ones), where the shared memory that h + w asks for fits
// and, at d = 80, F's high and low halves fit its 64 columns (h + w <= 32);
// larger S (up to 256) and the rest take the global path.
template <int D>
bool window_path(int S, int h, int w) {
  return S <= 200 && h + w <= (D == 64 ? 64 : 32) &&
         (S <= 128 || Win<200, D>::smem(128 * (h + w) + 64) <= SMEM_LIMIT);
}

template <int D>
int dispatch(const void* qkv, const Args& args, float scale, int N, cudaStream_t st) {
  const int S = args.S, h = args.h, w = args.w, nh = args.nh;
  if (window_path<D>(S, h, w)) {
    const int rt = (S + 63) / 64, pairs = (rt + 1) / 2;
    const WinArgs wa{args.fh, args.fw, args.out, args.lse, nh, S, h, w, N * nh * pairs,
                     rt, pairs, 0, 0, args.scale_log2, 1.f / scale,
                     2 * (h + w) <= 64 ? h + w : 0};
    if (S <= 64) return launch_window<Win<64, D>>(qkv, wa, N, st);
    if (S <= 128) return launch_window<Win<128, D>>(qkv, wa, N, st);
    return launch_window<Win<200, D>>(qkv, wa, N, st);
  }
  if (w == 64) return launch<64, LongTile<D>>(qkv, args, N, st);
  if (w == 32) return launch<32, LongTile<D>>(qkv, args, N, st);
  return launch<0, LongTile<D>>(qkv, args, N, st);
}

}  // namespace

// qkv (N, 3 nh, S, d) with d = 64 or 80 -> out (N, nh, S, d); lse (N, nh,
// S) fp32 when not null.
extern "C" int rsp_relpos_attention(const void* qkv, const void* fh,
                                    const void* fw, void* out, void* lse,
                                    int N, int nh, int S, int h, int w, int d,
                                    float scale, void* stream) {
  if (h > 64 || w > 64 || h * w != S || (d != 64 && d != 80))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const bf16*>(fh), static_cast<const bf16*>(fw),
                  static_cast<bf16*>(out), static_cast<float*>(lse), nh, S, h, w,
                  scale * LOG2E};
  auto st = static_cast<cudaStream_t>(stream);
  return d == 64 ? dispatch<64>(qkv, args, scale, N, st)
                 : dispatch<80>(qkv, args, scale, N, st);
}

// The path rsp_relpos_attention takes for a grid of S = h x w keys at head
// dim d: 1 the window path, 0 the global one, -1 a shape it refuses.
extern "C" int rsp_relpos_attention_route(int S, int h, int w, int d) {
  if (h > 64 || w > 64 || h * w != S || (d != 64 && d != 80)) return -1;
  return (d == 64 ? window_path<64>(S, h, w) : window_path<80>(S, h, w)) ? 1 : 0;
}
