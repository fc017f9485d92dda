// The fp32 forwards' building blocks: 3xTF32 products on wgmma .tf32.
//
// An fp32 operand x is split into a TF32 high part hi = cvt.rna.tf32(x) and
// the TF32 rounding of its remainder lo = tf32(x - hi) (x - hi is exact in
// fp32). A product is then three wgmma passes accumulated in fp32, the small
// ones first: lo.hi + hi.lo + hi.hi. The dropped lo.lo term and lo's own
// rounding are near 2^-22 of each product, so the sum keeps about fp32's
// accuracy where one TF32 pass keeps about three decimal digits. wgmma takes
// TF32 operands in 32-bit words; hi and lo are rounded to TF32 (their low 13
// bits zero), so nothing depends on what it does with the rest.
//
// .tf32 wgmma takes both shared-memory operands K-major only (the transpose
// bits exist for 16-bit types) in steps of K = 8: a 128-byte swizzle row is
// 32 fp32 values, and the k-th 8-deep slice of a tile starts 32 * k bytes
// into its row, as the k-th 16-deep bf16 slice does (hopper.cuh). Tiles
// here are written by the threads themselves (each split on its way from
// device memory to shared memory), so they are stored in the TMA's 128-byte
// swizzle by hand: the 16-byte unit u of row r sits at unit u ^ (r % 8).
//
// tf32_gemm_mainloop, shared by the fp32 kernels A (ln_mlp_residual_f32.cu)
// and B (ln_qkv_headmajor_f32.cu): a block of two warpgroups owns a
// 128 x 128 output tile of A . B^T (A: M x K, B: N x K, both row-major fp32,
// K-major) and walks K in 32-wide slices through two shared-memory buffers:
// each thread loads its share of the next slice into registers (rows past M
// or N read zeros) while the tensor cores run the current one, then splits
// and stores it into the other buffer.
#pragma once

#include "hopper.cuh"

namespace rsp {

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// hi and lo of x as wgmma .tf32 register operands
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));
}

// Store the hi and lo parts of four consecutive fp32 values 16 bytes each.
__device__ __forceinline__ void split_store4(unsigned char* hi, unsigned char* lo, float4 v) {
  const float4 h = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                               tf32_round(v.w));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) =
      make_float4(tf32_round(v.x - h.x), tf32_round(v.y - h.y), tf32_round(v.z - h.z),
                  tf32_round(v.w - h.w));
}

// Byte offset of the 16-byte unit u (of 8) of row r in a 128-byte-swizzled
// tile whose rows are 128 bytes (32 fp32).
__device__ __forceinline__ int sw128_off(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// The block's dynamic shared memory, aligned to the 1024 bytes the swizzle needs.
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// D (64 x 128, fp32 registers) += A (64 x 8, smem) * B (128 x 8, smem), tf32
// operands read as stored (both K-major: tf32 has no transposed form).
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 64) += A (64 x 8, registers: a[0] row g col t, a[1] row g + 8 col t,
// a[2] row g col t + 4, a[3] row g + 8 col t + 4 of the warp's 16 rows) * B
// (64 x 8, smem, K-major), tf32.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 80) += A (64 x 8, registers: a[0] row g col t, a[1] row g + 8 col t,
// a[2] row g col t + 4, a[3] row g + 8 col t + 4 of the warp's 16 rows) * B
// (80 x 8, smem, K-major), tf32.
__device__ __forceinline__ void wgmma_m64n80k8_tf32_rs(float (&d)[40], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

constexpr int TF32_TILE_M = 128;  // two warpgroups of 64 rows
constexpr int TF32_TILE_N = 128;
constexpr int TF32_TILE_K = 32;   // one 128-byte swizzle row of fp32
constexpr int TF32_THREADS = 256;
constexpr int TF32_TILE_BYTES = 128 * 128;  // 128 rows x 32 fp32: A or B, hi or lo
// two buffers of A hi, A lo, B hi, B lo, and the slack to align them
constexpr int TF32_GEMM_SMEM = 1024 + 2 * 4 * TF32_TILE_BYTES;

// Accumulate the tile (rows m0.., columns n0..) of A . B^T over all of K (a
// multiple of 32) into acc, in every thread of the block. Fragment order
// (per thread; wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32,
// g = lane / 4, t = lane % 4): acc[4 j + 2 half + e] is row
// m0 + 64 wg + 16 warp + g + 8 half, column n0 + 8 j + 2 t + e.
__device__ __forceinline__ void tf32_gemm_mainloop(unsigned char* smem, const float* __restrict__ a,
                                                   const float* __restrict__ b, int M, int N,
                                                   int K, int m0, int n0, float (&acc)[64]) {
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  float4 ra[4], rb[4];  // this thread's share of the next slice: 4 of its 1024 16-byte units
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + TF32_THREADS * q;
      const int r = idx / 8, u = idx % 8;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      ra[q] = m0 + r < M ? *reinterpret_cast<const float4*>(a + (size_t)(m0 + r) * K + k0 + 4 * u)
                         : z;
      rb[q] = n0 + r < N ? *reinterpret_cast<const float4*>(b + (size_t)(n0 + r) * K + k0 + 4 * u)
                         : z;
    }
  };
  auto store = [&](int buf) {
    unsigned char* s = smem + buf * 4 * TF32_TILE_BYTES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + TF32_THREADS * q;
      const int off = sw128_off(idx / 8, idx % 8);
      split_store4(s + off, s + TF32_TILE_BYTES + off, ra[q]);
      split_store4(s + 2 * TF32_TILE_BYTES + off, s + 3 * TF32_TILE_BYTES + off, rb[q]);
    }
  };
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int nk = K / TF32_TILE_K;
  load(0);
  store(0);
  fence_async_shared();
  __syncthreads();
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) load((i + 1) * TF32_TILE_K);  // in flight during this slice's products
    const unsigned char* s = smem + (i & 1) * 4 * TF32_TILE_BYTES;
    const unsigned char* ah = s + wg * 64 * 128;
    const unsigned char* al = ah + TF32_TILE_BYTES;
    const unsigned char* bh = s + 2 * TF32_TILE_BYTES;
    const unsigned char* bl = bh + TF32_TILE_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TF32_TILE_K / 8; ++k) {
      wgmma_m64n128k8_tf32_ss(acc, sw128_desc(al + 32 * k), sw128_desc(bh + 32 * k));
      wgmma_m64n128k8_tf32_ss(acc, sw128_desc(ah + 32 * k), sw128_desc(bl + 32 * k));
      wgmma_m64n128k8_tf32_ss(acc, sw128_desc(ah + 32 * k), sw128_desc(bh + 32 * k));
    }
    wgmma_commit();
    // the other buffer's last reader, slice i - 1, finished before the last barrier
    if (i + 1 < nk) store((i + 1) & 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_async_shared();
    __syncthreads();
  }
}

}  // namespace rsp
