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
// Inputs: qkv (N, 3n, S, 64) bf16 head-major (q heads, then k, then v), the
// factors fh (N, n, S, h) and fw (N, n, S, w) bf16 from the torch einsum.
// Output: (N, n, S, 64) bf16, and, when the caller asks for it (the
// backward does), the fp32 row log-sum-exp (N, n, S) of the biased scores
// in natural-log units.
//
// Bound on the H100 at ViT-B, batch 2: a global layer is 103 GFLOP (about
// 104 us at 989 TFLOP/s, operations-bound); a windowed layer is 5.9 GFLOP but
// moves about 67 MB (about 20 us at 3.35 TB/s, bytes-bound).
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
//   it. The bias is one more product, as in kernel C': with F = [fh | fw |
//   0] (64 columns, spread from the raw rows in shared memory, two threads
//   a row) and E[key, f] = 1 / scale where f == key / w or f == h + key % w
//   (8 at d = 64, exact in bf16; built once per block), Q K^T + F E^T is
//   the biased score over the scale, so a score costs one fma and one exp2
//   and no lookup. Two earlier versions were slower: one that loaded each
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

constexpr int D = 64;
constexpr int QTILE = 64 * D * 2;  // one warpgroup's Q tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The global path's block: NWG = 2 consumer warpgroups of 64 queries each,
// then the producer; BK = 128 keys per tile through a K / V ring of two
// stages, each consumer overlapping a tile's softmax with the next tile's
// Q K^T and the last tile's P V, which needs about 180 registers: the
// producer is a whole warpgroup that hands its registers to the consumers
// (setmaxnreg).
struct LongTile {
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
  static constexpr int KVTILE = BK * D * 2;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_RING = OFF_Q + NWG * QTILE;           // K, V per stage
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
  constexpr int BK = T::BK, STAGES = T::STAGES, KVTILE = T::KVTILE;
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
  const unsigned char* qt = smem + T::OFF_Q + wg * QTILE;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
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
    for (int k = 0; k < D / 16; ++k) {
      rsp::wgmma_m64n128k16_ss(sc, rsp::sw128_desc(qt + 32 * k), rsp::sw128_desc(kt + 32 * k));
    }
    rsp::wgmma_commit();
  };
  // O += P V of key tile `it`, P from registers (one wgmma group)
  auto pv = [&](int it) {
    const unsigned char* vt = smem + T::OFF_RING + (it % STAGES) * 2 * KVTILE + KVTILE;
    rsp::fence_regs(o);
    rsp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      rsp::wgmma_m64n64k16_rs_nmajor(o, pa[kk], rsp::sw128_desc(vt + kk * 2048));
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
    for (int j = 0; j < 8; ++j) {
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
  unsigned char* st = smem + T::OFF_Q + wg * QTILE;
  rsp::fence_async_shared();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(st + rl0 * 128 + ((j ^ (rl0 & 7)) * 16) + 4 * t) =
        rsp::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(st + rl1 * 128 + ((j ^ (rl1 & 7)) * 16) + 4 * t) =
        rsp::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  rsp::named_sync(2 + wg, 128);
  bf16* ob = a.out + (size_t)plane_f * S * D;
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i / 8;
    const int c = i % 8;
    if (qbase + r < S)
      *reinterpret_cast<uint4*>(ob + (size_t)(qbase + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * 128 + ((c ^ (r & 7)) * 16));
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
      rsp::mbar_expect_tx(qbar, T::NWG * QTILE);
      for (int i = 0; i < T::NWG; ++i)
        rsp::tma_load_3d(smem + T::OFF_Q + i * QTILE, &qmap, qbar, 0, q0 + 64 * i, plane_q);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) rsp::mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        rsp::mbar_expect_tx(&full[s], 2 * T::KVTILE);
        unsigned char* kt = smem + T::OFF_RING + s * 2 * T::KVTILE;
        rsp::tma_load_3d(kt, &kvmap, &full[s], 0, it * T::BK, plane_q + nh);
        rsp::tma_load_3d(kt + T::KVTILE, &kvmap, &full[s], 0, it * T::BK, plane_q + 2 * nh);
      }
    }
  } else {
    rsp::setmaxnreg_inc<T::CONSUMER_REGS>();
    consume<WF, T>(smem, args, wg);
  }
}

template <int WF, class T>
int launch(const void* qkv, const Args& args, int N, cudaStream_t stream) {
  CUtensorMap qmap, kvmap;
  const cuuint64_t dims[3] = {D, (cuuint64_t)args.S, (cuuint64_t)N * 3 * args.nh};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)args.S * D * 2};
  const cuuint32_t qbox[3] = {D, 64, 1};
  const cuuint32_t kvbox[3] = {D, T::BK, 1};
  if (!rsp::make_tensor_map(&qmap, qkv, 3, dims, strides, qbox) ||
      !rsp::make_tensor_map(&kvmap, qkv, 3, dims, strides, kvbox))
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
template <int BN_>
struct Win {
  static constexpr int BN = BN_;
  static constexpr int BNP = (BN + 15) / 16 * 16;
  static constexpr int NWG = 2;
  static constexpr int THREADS = NWG * 128 + 128;
  static constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  static_assert(NWG * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - PRODUCER_REGS,
                "register rebalance exceeds what the producer frees");
  static constexpr int UST = 2;            // unit stages
  static constexpr int KVT = BNP * D * 2;  // a K, V or E tile
  // a stage: K, V, then per warpgroup its Q tile (later its output's
  // staging) and its F tile, then per warpgroup its raw factor rows
  static constexpr int OFF_K = 0, OFF_V = KVT, OFF_QF = 2 * KVT;
  static constexpr int OFF_RAW = 2 * KVT + NWG * 2 * QTILE;
  static constexpr int OFF_E = 0;  // the group matrix E, built once
  static constexpr int OFF_RING = OFF_E + KVT;
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
  float inv_scale;                    // E's entries
};

// 2^x on the special-function unit, subnormal results flushed to zero (a p
// that small adds nothing to a row sum of at least 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T + F E^T over the whole key tile: D x N products, 4 k steps each
template <int BN>
__device__ __forceinline__ void scores(float (&sc)[BN / 2], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint64_t da = rsp::sw128_desc(a + 32 * k), db = rsp::sw128_desc(b + 32 * k);
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
template <int BN>
__device__ __forceinline__ void window_consume(unsigned char* smem, const WinArgs& a, int wg) {
  using W = Win<BN>;
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
      unsigned char* qt = st + W::OFF_QF + 2 * wg * QTILE;  // Q, then the output's staging
      unsigned char* fs = qt + QTILE;
      // F = [fh | fw | 0] from the raw rows (two threads a row: fh, fw);
      // the columns past h + w keep the zeros they started with
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
            *reinterpret_cast<bf16*>(fs + r * 128 + (((f >> 3) ^ (r & 7)) << 4) + (f & 7) * 2) =
                src[i];
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
      scores<BN>(sc, qt, st + W::OFF_K);  // Q K^T
      scores<BN>(sc, fs, es);             // + F E^T: the bias over the scale
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

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      rsp::fence_regs(o);
      rsp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W::BNP / 16; ++kk)
        rsp::wgmma_m64n64k16_rs_nmajor(o, pa[kk], rsp::sw128_desc(st + W::OFF_V + kk * 2048));
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
        for (int j8 = 0; j8 < 8; ++j8) {
          *reinterpret_cast<uint32_t*>(qt + rl0 * 128 + ((j8 ^ (rl0 & 7)) * 16) + 4 * t) =
              rsp::pack_bf16(o[4 * j8] * inv0, o[4 * j8 + 1] * inv0);
          *reinterpret_cast<uint32_t*>(qt + rl1 * 128 + ((j8 ^ (rl1 & 7)) * 16) + 4 * t) =
              rsp::pack_bf16(o[4 * j8 + 2] * inv1, o[4 * j8 + 3] * inv1);
        }
      }
      rsp::named_sync(2 + wg, 128);
      bf16* ob = a.out + plane * D;
      for (int i = tid; i < 64 * 8; i += 128) {
        const int r = i / 8;
        const int cc = i % 8;
        if (q0 + r < S)
          *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * D + cc * 8) =
              *reinterpret_cast<const uint4*>(qt + r * 128 + ((cc ^ (r & 7)) * 16));
      }
    }
    rsp::fence_async_shared();  // the staging writes, before TMA refills the stage
    rsp::mbar_arrive(&empty[s]);  // this thread is done with the stage
  }
}

template <int BN>
__global__ void __launch_bounds__(Win<BN>::THREADS, 1) window_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kvmap,
    const WinArgs args) {
  using W = Win<BN>;
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
  // E (keys x 64) once per block: 1 / scale at f = key / w and f = h + key % w
  // for the keys before S, zeros elsewhere; and the F tiles zeroed, so the
  // columns past h + w never hold a stale NaN for E's zeros to multiply
  const int S = args.S, h = args.h, w = args.w;
  for (int i = threadIdx.x; i < BN * 8; i += W::THREADS) {
    const int key = i / 8;
    const int c = (i % 8) * 8;
    const int fa = key < S ? key / w : -1;
    const int fb = key < S ? h + key % w : -1;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = rsp::to_bf(c + u == fa || c + u == fb ? args.inv_scale : 0.f);
    *reinterpret_cast<uint4*>(smem + W::OFF_E + key * 128 + (((c / 8) ^ (key & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
  for (int s = 0; s < W::UST; ++s)
    for (int j = 0; j < W::NWG; ++j) {
      uint4* f = reinterpret_cast<uint4*>(smem + W::OFF_RING + s * args.stage + W::OFF_QF +
                                          (2 * j + 1) * QTILE);
      for (int i = threadIdx.x; i < QTILE / 16; i += W::THREADS) f[i] = make_uint4(0, 0, 0, 0);
    }
  rsp::fence_async_shared();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg < W::NWG) {
    rsp::setmaxnreg_inc<W::CONSUMER_REGS>();
    window_consume<BN>(smem, args, wg);
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
    uint32_t bytes = 2 * W::KVT + tiles * QTILE;
    for (int j = 0; j < tiles; ++j) {
      const int q0 = 64 * (2 * pair + j);
      const int rows = min(64, S - q0);
      const size_t row0 = (size_t)item * S + q0;
      hh[j] = hull(args.fh + row0 * h, rows * h);
      hw[j] = hull(args.fw + row0 * w, rows * w);
      bytes += hh[j].bytes + hw[j].bytes;
    }
    rsp::mbar_expect_tx(&full[s], bytes);
    rsp::tma_load_3d(st + W::OFF_K, &kvmap, &full[s], 0, 0, plane_q + nh);
    rsp::tma_load_3d(st + W::OFF_V, &kvmap, &full[s], 0, 0, plane_q + 2 * nh);
    for (int j = 0; j < tiles; ++j) {
      rsp::tma_load_3d(st + W::OFF_QF + 2 * j * QTILE, &qmap, &full[s], 0,
                       64 * (2 * pair + j), plane_q);
      unsigned char* raw = st + W::OFF_RAW + j * args.raw;
      rsp::bulk_load(raw, hh[j].start, hh[j].bytes, &full[s]);
      rsp::bulk_load(raw + hh[j].bytes, hw[j].start, hw[j].bytes, &full[s]);
    }
  }
}

template <int BN>
int launch_window(const void* qkv, WinArgs args, int N, cudaStream_t stream) {
  using W = Win<BN>;
  // raw rows per warpgroup: two hulls, each at most 2 * 64 * (h or w) + 30
  // bytes, rounded to 16
  args.raw = 128 * (args.h + args.w) + 64;
  args.stage = W::stage(args.raw);
  const int smem = W::smem(args.raw);
  CUtensorMap qmap, kvmap;
  const cuuint64_t dims[3] = {D, (cuuint64_t)args.S, (cuuint64_t)N * 3 * args.nh};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)args.S * D * 2};
  const cuuint32_t qbox[3] = {D, 64, 1};
  const cuuint32_t kvbox[3] = {D, W::BNP, 1};
  if (!rsp::make_tensor_map(&qmap, qkv, 3, dims, strides, qbox) ||
      !rsp::make_tensor_map(&kvmap, qkv, 3, dims, strides, kvbox))
    return static_cast<int>(cudaErrorNotSupported);
  // once per device: the shared-memory opt-in (the most any h + w needs)
  // and the SM count (the grid)
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  if (sms[dev] == 0) {
    if ((err = cudaFuncSetAttribute(window_kernel<BN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_LIMIT)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return static_cast<int>(err);
  }
  const int grid = args.units < sms[dev] ? args.units : sms[dev];
  window_kernel<BN><<<grid, W::THREADS, smem, stream>>>(qmap, kvmap, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rsp_relpos_attention(const void* qkv, const void* fh,
                                    const void* fw, void* out, void* lse,
                                    int N, int nh, int S, int h, int w,
                                    float scale, void* stream) {
  if (h > 64 || w > 64 || h * w != S) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const bf16*>(fh), static_cast<const bf16*>(fw),
                  static_cast<bf16*>(out), static_cast<float*>(lse), nh, S, h, w,
                  scale * LOG2E};
  auto st = static_cast<cudaStream_t>(stream);
  // windows and small grids: the bias as the product F E^T, which needs E's
  // entries 1 / scale exact in bf16 (a power of two; 8 at d = 64) and the
  // shared memory that h + w asks for; larger S (up to 256) and the rest
  // take the global path
  int ex;
  if (S <= 200 && h + w <= 64 && frexpf(1.f / scale, &ex) == 0.5f) {
    const int rt = (S + 63) / 64, pairs = (rt + 1) / 2;
    const WinArgs wa{args.fh, args.fw, args.out, args.lse, nh, S, h, w, N * nh * pairs,
                     rt, pairs, 0, 0, scale * LOG2E, 1.f / scale};
    const int raw = 128 * (h + w) + 64;
    if (S <= 64) return launch_window<64>(qkv, wa, N, st);
    if (S <= 128) return launch_window<128>(qkv, wa, N, st);
    if (Win<200>::smem(raw) <= SMEM_LIMIT) return launch_window<200>(qkv, wa, N, st);
  }
  if (w == 64) return launch<64, LongTile>(qkv, args, N, st);
  if (w == 32) return launch<32, LongTile>(qkv, args, N, st);
  return launch<0, LongTile>(qkv, args, N, st);
}
