// Split-f32 ("3xTF32") products on the tensor cores, and asynchronous tiles.
//
// Shared by max_corr.cu and warp_fwd.cu. Both are f32 matrix products with an
// epilogue. One TF32 product keeps 10 mantissa bits of each operand, which
// moves a correlation of unit-norm rows by ~1e-4 and changes which index wins
// a maximum. Here each f32 operand is split as x = hi + lo,
//     hi = tf32(x),  lo = tf32(x - hi),
// and a . b is accumulated in f32 as a_lo . b_hi + a_hi . b_lo + a_hi . b_hi,
// the two small products first. The dropped lo . lo term is ~2^-22 relative,
// so the result keeps about f32's accuracy at three tensor-core products per
// f32 product.
//
// Two forms of the product are here. mma.sync.aligned.m16n8k8.row.col.f32.
// tf32.tf32.f32 (warp_fwd.cu): a warp multiplies a 16 x 8 tile of A (row
// major, depth innermost) by an 8 x 8 tile of B from register fragments into
// a 16 x 8 f32 tile, and the operands are split when a fragment is loaded
// from shared memory, so a tile lies there once, as it came. And
// wgmma.mma_async m64n128k8 (max_corr.cu): four warps multiply 64 x 8 by
// 8 x 128 with both operands read from shared memory, depth innermost,
// 128-byte swizzled, so hi and lo are tiles of their own there, made once per
// value by the thread that copied it. On an H100 an mma.sync of this shape
// starts every 8 cycles on each of an SM's four tensor cores, half the rate
// wgmma reaches.
//
// The split and every map from a lane's fragment element to its row and
// column are __host__ __device__, so that a host-only harness, compiled by
// the CPU tests with g++, can hold them: without nvcc GFLA_HD is `inline`.
#pragma once

#include <cstdint>
#include <cstring>

#ifndef GFLA_HD
#ifdef __CUDACC__
#define GFLA_HD __host__ __device__ __forceinline__
#else
#define GFLA_HD inline
#endif
#endif

namespace gfla {

GFLA_HD uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  return u;
#endif
}

GFLA_HD float bits_f32(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// x rounded to TF32: 10 mantissa bits, nearest, ties away from zero. For
// finite x this is what cvt.rna.tf32.f32 gives; it is done on the bits (add
// half a unit of the kept part to the magnitude, clear the 13 low bits)
// because the card converts at a quarter of the rate it adds integers.
GFLA_HD float tf32_round(float x) {
  return bits_f32((f32_bits(x) + 0x1000u) & 0xffffe000u);
}

struct Tf32Pair {
  float hi, lo;
};

// x = hi + lo up to ~2^-22 |x|; x - hi is exact in f32.
GFLA_HD Tf32Pair tf32_split(float x) {
  const float hi = tf32_round(x);
  return Tf32Pair{hi, tf32_round(x - hi)};
}

// ---- fragment maps of one m16n8k8 product, lane 0..31 ----------------------
// A (16 rows x 8 deep): element e of 4. B (8 deep x 8 columns): element e of
// 2. C and D (16 rows x 8 columns): element e of 4.
GFLA_HD int mma_a_row(int lane, int e) { return (lane >> 2) + 8 * (e & 1); }
GFLA_HD int mma_a_depth(int lane, int e) { return (lane & 3) + 4 * (e >> 1); }
GFLA_HD int mma_b_depth(int lane, int e) { return (lane & 3) + 4 * e; }
GFLA_HD int mma_b_col(int lane) { return lane >> 2; }
GFLA_HD int mma_c_row(int lane, int e) { return (lane >> 2) + 8 * (e >> 1); }
GFLA_HD int mma_c_col(int lane, int e) { return 2 * (lane & 3) + (e & 1); }

// A CTA's output tile cut into a grid of warps, `warps_n` of them side by
// side, each owning tiles_m x tiles_n m16n8k8 fragments: warp w starts at row
// 16 tiles_m (w / warps_n) and column 8 tiles_n (w % warps_n).
struct WarpGrid {
  int warps_n, tiles_m, tiles_n;
};

GFLA_HD constexpr int grid_first_row(WarpGrid g, int warp) {
  return 16 * g.tiles_m * (warp / g.warps_n);
}

GFLA_HD constexpr int grid_first_col(WarpGrid g, int warp) {
  return 8 * g.tiles_n * (warp % g.warps_n);
}

// Row and column, within the CTA's tile, of accumulator element e (0..3) of
// fragment (mt, nt) of warp `warp`, lane `lane`.
GFLA_HD int grid_row(WarpGrid g, int warp, int lane, int mt, int e) {
  return grid_first_row(g, warp) + 16 * mt + mma_c_row(lane, e);
}

GFLA_HD int grid_col(WarpGrid g, int warp, int lane, int nt, int e) {
  return grid_first_col(g, warp) + 8 * nt + mma_c_col(lane, e);
}

// Floats per row of a shared-memory tile that is `depth` floats deep and is
// read as A or as n x depth B fragments: 4 more than a multiple of 32, so
// the 8 rows x 4 depths of one fragment load fall into 32 different banks,
// and a multiple of 4, so rows stay 16-byte aligned.
GFLA_HD constexpr int mma_row_stride(int depth) {
  return (depth + 31) / 32 * 32 + 4;
}

// The same for a depth x n tile (B stored with n innermost): 8 more than a
// multiple of 32, so 4 depths x 8 columns fall into 32 different banks.
GFLA_HD constexpr int mma_col_stride(int n) { return (n + 31) / 32 * 32 + 8; }

// Byte offset, within a tile whose rows are 128 bytes (32 floats of depth),
// of float `c` of row `row` under the 128-byte swizzle that the descriptor
// below names: the 16-byte chunk index is xor-ed with the row modulo 8. The
// tile must start on a 1024-byte boundary.
GFLA_HD int swizzle128(int row, int c) {
  return row * 128 + ((((c >> 2) ^ (row & 7)) << 4) | ((c & 3) << 2));
}

#ifdef __CUDACC__

// A split fragment element, as the two operand registers of the products.
__device__ __forceinline__ void tf32_split_bits(float x, uint32_t& hi,
                                                uint32_t& lo) {
  const Tf32Pair p = tf32_split(x);
  hi = f32_bits(p.hi);
  lo = f32_bits(p.lo);
}

// d += a . b, one TF32 product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes (or 4) from global to shared memory without passing registers;
// with `valid` false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are open.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- warpgroup products (wgmma) --------------------------------------------
// Four warps multiply a 64 x 8 tile of A by an 8 x 128 tile of B, both read
// from shared memory through descriptors, into 64 f32 accumulators a thread:
// warp w of the group holds rows 16 w .. 16 w + 15 and all 128 columns, as 16
// fragments side by side, each laid out like the C fragment above, so
// d[4 j + e] is element e of fragment column j.

// Descriptor of a tile laid out by swizzle128 (depth innermost, 8-row groups
// 1024 bytes apart).
// Adding 2 k to it moves 8 k floats on along the depth.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint64_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(tile)) & 0x3ffffu;
  return (addr >> 4) | (uint64_t{1} << 16) | (uint64_t{64} << 32) |
         (uint64_t{1} << 62);
}

// Writes to shared memory by ordinary stores become visible to wgmma, which
// reads through the asynchronous proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// The products write their accumulators while they run: no instruction that
// reads or writes d may move across this point (put it after wgmma_wait and
// before wgmma_fence).
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d = a . b + (keep ? d : 0): one m64n128k8 TF32 product, asynchronous.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(keep));
}

#endif  // __CUDACC__

}  // namespace gfla
