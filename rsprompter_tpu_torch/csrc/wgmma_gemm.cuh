// The warp-specialised bf16 GEMM mainloop that kernel A (ln_mlp_residual.cu)
// and its backward A' (ln_mlp_residual_bwd.cu) share.
//
// A block owns a 128 x BN output tile D = A . B^T (A: 128 x K, B: BN x K)
// and walks a range of K in 64-deep slices. A producer warpgroup, one thread
// of which issues the TMA loads (128-byte swizzle, mbarriers), keeps a ring
// of STAGES A and B slices in flight; two consumer warpgroups run wgmma on
// 64 rows each, bf16 in and fp32 accumulators in registers. The caller's
// epilogue then reads the accumulators (fragment order below) and may reuse
// the ring as staging once gemm_epilogue_begin has run.
//
// Each operand is read from device memory as it is stored, row-major:
//  * K-major (the reduction axis contiguous, e.g. activations times a
//    weight stored (out, in)): one TMA box {64 along K, rows}; rows of 128
//    bytes in shared memory, the k-th 16-deep slice 32 * k bytes in.
//  * MN-major (M or N contiguous, e.g. a weight stored (in, out), or the
//    token-major activations of a weight gradient, whose K is the token
//    axis): one TMA box {64 along M / N, 64 along K} per 64-wide chunk, each
//    chunk 8 KB of 64 K rows; the k-th slice starts 16 rows (2048 bytes)
//    further in, and the wgmma descriptor's leading byte offset steps from
//    chunk to chunk (sw128_desc_mn).
// Reads past the matrix's edge fill zeros, so a ragged M, N or K costs only
// the epilogue's guard on the rows and columns it stores.
//
// Accumulator fragment order (per consumer thread; warp = (threadIdx.x % 128)
// / 32, g = lane / 4, t = lane % 4): acc[4 j + 2 half + e] is row
// 64 wg + 16 warp + g + 8 half, column 8 j + 2 t + e of the tile.
#pragma once

#include "hopper.cuh"

namespace rsp {

constexpr int GEMM_TILE_M = 128;  // two consumer warpgroups of 64 rows
constexpr int GEMM_TILE_K = 64;   // one 128-byte swizzle row of bf16
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS_WS = 384;  // consumers 0-255, producer warpgroup 256-383

// One operand of the product: ROWS rows (M or N) of a 64-deep K slice.
template <bool MN, int ROWS>
struct GemmOperand {
  static constexpr int CHUNK = 64 * GEMM_TILE_K * 2;  // 64 rows x 64 K, bf16
  static constexpr int BYTES = ROWS * GEMM_TILE_K * 2;
  static_assert(ROWS % 64 == 0 && ROWS <= 256, "64 to 256 rows");

  // The tensor map of the row-major (stored_rows x stored_cols) bf16 matrix
  // this operand is read from (K-major: stored as (rows, K); MN-major: as
  // (K, rows)). False if libcuda refuses it.
  static bool make_map(CUtensorMap* map, const void* base, int stored_rows,
                       int stored_cols) {
    const cuuint64_t dims[2] = {(cuuint64_t)stored_cols, (cuuint64_t)stored_rows};
    const cuuint64_t strides[1] = {(cuuint64_t)stored_cols * 2};
    const cuuint32_t box[2] = {64, MN ? (cuuint32_t)GEMM_TILE_K : (cuuint32_t)ROWS};
    return make_tensor_map(map, base, 2, dims, strides, box);
  }

  // Load rows r0 .. r0 + ROWS - 1 of K slice k0 .. k0 + 63 into `dst`.
  __device__ __forceinline__ static void load(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int k0, int r0) {
    if constexpr (MN) {
#pragma unroll
      for (int i = 0; i < ROWS / 64; ++i) tma_load_2d(dst + i * CHUNK, map, bar, r0 + 64 * i, k0);
    } else {
      tma_load_2d(dst, map, bar, k0, r0);
    }
  }

  // Descriptor of the k-th 16-deep slice of the tile's rows r .. (r a
  // multiple of 64).
  __device__ __forceinline__ static uint64_t desc(const unsigned char* tile, int r, int k) {
    if constexpr (MN) return sw128_desc_mn(tile + (r / 64) * CHUNK + 2048 * k, CHUNK);
    else return sw128_desc(tile + r * 128 + 32 * k);
  }
};

template <bool AMN, bool BMN, int BN, int STAGES = GEMM_STAGES>
struct GemmTile {
  using A = GemmOperand<AMN, GEMM_TILE_M>;
  using B = GemmOperand<BMN, BN>;
  static constexpr int STAGE = A::BYTES + B::BYTES;
  static constexpr int RING = STAGES * STAGE;
  // 1024 bytes of slack to align the ring, then the ring and its barriers
  static constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;
};

// The block's dynamic shared memory, aligned to the 1024 bytes the swizzle needs.
__device__ __forceinline__ unsigned char* gemm_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int TA, int TB, int BN>
__device__ __forceinline__ void wgmma_tile_k16(float (&acc)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 256) wgmma_m64n256k16_ss<TA, TB>(acc, a, b);
  else wgmma_m64n128k16_ss<TA, TB>(acc, a, b);
}

// Accumulate the tile (rows m0.., columns n0..) over K slices kt0 .. kt1 - 1
// into `acc`. Returns false in the producer warpgroup's threads, which must
// then return; true in the consumers', whose `acc` then holds the sum (zero
// where kt0 == kt1). Every thread of the block calls it once.
template <bool AMN, bool BMN, int BN, int STAGES = GEMM_STAGES>
__device__ __forceinline__ bool gemm_mainloop(unsigned char* smem, const CUtensorMap* amap,
                                              const CUtensorMap* bmap, int m0, int n0,
                                              int kt0, int kt1, float (&acc)[BN / 2]) {
  using G = GemmTile<AMN, BMN, BN, STAGES>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::RING);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int n = kt1 - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every TMA load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], G::STAGE);
        unsigned char* st = smem + s * G::STAGE;
        G::A::load(st, amap, &full[s], (kt0 + i) * GEMM_TILE_K, m0);
        G::B::load(st + G::A::BYTES, bmap, &full[s], (kt0 + i) * GEMM_TILE_K, n0);
      }
    }
    return false;
  }
  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  setmaxnreg_inc<232>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* a = smem + s * G::STAGE;
    const unsigned char* b = a + G::A::BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < GEMM_TILE_K / 16; ++k)
      wgmma_tile_k16<AMN, BMN, BN>(acc, G::A::desc(a, 64 * wg, k), G::B::desc(b, 0, k));
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done
    fence_regs(acc);
    if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  return true;
}

// Both consumer warpgroups are done with the ring: from here the epilogue
// may write it as staging (generic stores after the async proxy's reads).
__device__ __forceinline__ void gemm_epilogue_begin() {
  named_sync(1, 256);
  fence_async_shared();
}

}  // namespace rsp
