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
// add the bias, mask keys past S to -inf in a partial last tile (pad tokens
// inside a window are real keys), update the online softmax in base 2 (log2
// e folded into the scale and the factors, exp2f), round p to bf16 and run
// O += P V as wgmma with P straight from the score registers as the A
// operand and V read N-major from shared memory, so nothing is transposed.
// Two block shapes (Tile below): global layers stream 128-key K / V tiles
// through a 2-stage ring under 2 consumer warpgroups, each overlapping a
// tile's softmax with the next Q K^T and the last P V; windows (S <= 256)
// put all 196 queries of a (window, head) under 4 consumer warpgroups with
// every 64-key tile resident, so K and V are read once. Where w divides 64
// (the 64 x 64 and 32 x 32 global grids) a column's fw term is the same in
// every key tile and lives in registers, and fh is one value per row and 64
// or 32 columns, folded into the row max and the exponent; other grids look
// both factors up in the block's factor rows in shared memory, with the
// (key / w, key % w) pair walked from one division per tile (at the 64 x 64
// grid that path takes 3.3x as long on an H100 80GB HBM3 at 700 W, timed by
// scripts/torch_kernel_ab.py --generic-copy). The output is
// normalised after P V, staged through shared memory and stored 16 bytes a
// thread; the row log-sum-exp is converted to natural log before its store.
// The previous design used mma.sync with K / V loaded synchronously through
// registers into one buffer (V transposed by 2-byte scalar stores), expf,
// and a division plus two shared lookups per score: 3.3x SDPA global.
#include <math.h>

#include "hopper.cuh"

using rsp::bf16;

namespace {

constexpr int D = 64;
constexpr int QTILE = 64 * D * 2;  // one warpgroup's Q tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A block's shape: NWG consumer warpgroups of 64 queries each, then the
// producer; BK keys per tile. Long sequences take <2, 128>: a K / V ring of
// two 128-key stages, each consumer overlapping a tile's softmax with the
// next tile's Q K^T and the last tile's P V, which needs about 180
// registers: the producer is a whole warpgroup that hands its registers to
// the consumers (setmaxnreg). Windows (S <= 256) take <4, 64>: every query
// of a (window, head) in one block, all its 64-key tiles resident, one tile
// at a time per warpgroup (the four warpgroups overlap each other), within
// the 96 registers a thread gets at launch; the producer is one warp.
template <int NWG_, int BK_>
struct Tile {
  static constexpr int NWG = NWG_;
  static constexpr int BK = BK_;
  static constexpr int BQ = 64 * NWG;
  static constexpr int STAGES = BK == 64 ? 4 : 2;
  static constexpr bool OVERLAP = BK == 128;
  static constexpr bool REBALANCE = OVERLAP;  // producer warpgroup: 24 registers
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int THREADS = NWG * 128 + (REBALANCE ? 128 : 32);
  // setmaxnreg.inc waits for registers that setmaxnreg.dec freed in the same
  // block: the consumers may gain no more than the producer gives up
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  static_assert(!REBALANCE || NWG * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - 24,
                "register rebalance exceeds what the producer frees");
  static constexpr int KVTILE = BK * D * 2;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_RING = OFF_Q + NWG * QTILE;           // K, V per stage
  static constexpr int OFF_BAR = OFF_RING + STAGES * 2 * KVTILE;  // q, full[], empty[]
  static constexpr int OFF_FACT = OFF_BAR + 128;                  // fp32 factor rows
};
using LongTile = Tile<2, 128>;
using WindowTile = Tile<4, 64>;

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
      if constexpr (BK == 128)
        rsp::wgmma_m64n128k16_ss(sc, rsp::sw128_desc(qt + 32 * k), rsp::sw128_desc(kt + 32 * k));
      else
        rsp::wgmma_m64n64k16_ss(sc, rsp::sw128_desc(qt + 32 * k), rsp::sw128_desc(kt + 32 * k));
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
  if constexpr (!T::OVERLAP) {
    for (int it = 0; it < ntiles; ++it) {
      qk(it);
      rsp::wgmma_wait<0>();
      rsp::fence_regs(sc);
      softmax(it, a0, a1);
      rescale(a0, a1);
      pack();
      pv(it);
      rsp::wgmma_wait<0>();
      rsp::fence_regs(o);
      rsp::mbar_arrive(&empty[it % STAGES]);
    }
  } else {
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
  }

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
    if constexpr (T::REBALANCE) rsp::setmaxnreg_dec<24>();
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
    if constexpr (T::REBALANCE) rsp::setmaxnreg_inc<T::CONSUMER_REGS>();
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
  // windows look their factors up in shared memory whatever w is
  if (S <= WindowTile::BQ) return launch<0, WindowTile>(qkv, args, N, st);
  if (w == 64) return launch<64, LongTile>(qkv, args, N, st);
  if (w == 32) return launch<32, LongTile>(qkv, args, N, st);
  return launch<0, LongTile>(qkv, args, N, st);
}
