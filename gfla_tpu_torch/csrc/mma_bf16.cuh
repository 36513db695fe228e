// bf16 products on the tensor cores: mma.sync m16n8k16 with f32 accumulators.
//
// Shared by the bf16 instances of warp_fwd.cu and warp_bwd.cu
// (warp_fwd_bf16.cu, warp_bwd_bf16.cu). gfla_tpu's warp kernel, given a bf16
// source, rounds its operands to bf16 and accumulates every product in f32
// (gfla_tpu/ops/pallas_warp.py:183-200, 286, 308, 319). The bf16 kernels keep
// the f32 kernels' tiles: each value is rounded to bf16 where gfla_tpu's body
// rounds it and kept in a float that holds it exactly, and two such floats
// are packed into one 32-bit operand register as a fragment is loaded. One
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 then multiplies a 16 x
// 16 tile of A by a 16 x 8 tile of B, where the f32 kernels need six TF32
// products (two depth steps of three, mma_tf32x3.cuh).
//
// The rounding and every map from a lane's fragment element to its row and
// depth are __host__ __device__, so that a host-only harness, compiled by
// the CPU tests with g++, can hold them against torch's bfloat16 and a
// float64 product: without nvcc GFLA_HD is `inline`.
#pragma once

#include <cstdint>

#include "mma_tf32x3.cuh"

namespace gfla {

// x rounded to bf16, as bits: nearest, ties to even, done on the bits
// (subnormals included); NaN becomes the canonical 0x7fc0, as torch's
// conversion gives it; infinities stay.
GFLA_HD uint16_t bf16_bits(float x) {
  const uint32_t u = f32_bits(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

GFLA_HD float bf16_float(uint16_t b) {
  return bits_f32(static_cast<uint32_t>(b) << 16);
}

// x rounded to bf16, as the float that holds it exactly.
GFLA_HD float bf16_round(float x) { return bf16_float(bf16_bits(x)); }

// One operand register from two floats that hold bf16 values exactly: `lo`
// (the lower depth) in bits 0-15, `hi` in bits 16-31. Their low 16 bits are
// 0, so this only moves bits.
GFLA_HD uint32_t pack_bf16x2(float lo, float hi) {
  return (f32_bits(lo) >> 16) | (f32_bits(hi) & 0xffff0000u);
}

// ---- fragment maps of one m16n8k16 product, lane 0..31 ---------------------
// A (16 rows x 16 deep, row major): register r of 4 holds two elements, half
// h = 0 in its low bits. B (16 deep x 8 columns): register r of 2, half h.
// C and D (16 x 8, f32) are laid out as in m16n8k8: mma_c_row, mma_c_col.
GFLA_HD int mma16_a_row(int lane, int r) { return (lane >> 2) + 8 * (r & 1); }
GFLA_HD int mma16_a_depth(int lane, int r, int h) {
  return 2 * (lane & 3) + h + 8 * (r >> 1);
}
GFLA_HD int mma16_b_depth(int lane, int r, int h) {
  return 2 * (lane & 3) + h + 8 * r;
}
GFLA_HD int mma16_b_col(int lane) { return lane >> 2; }

// A value of an input tensor as a float: f32 as it is, bf16 (bits) widened.
GFLA_HD float to_float(float x) { return x; }
GFLA_HD float to_float(uint16_t b) { return bf16_float(b); }

#ifdef __CUDACC__

// Four consecutive values of an f32 or bf16 tensor as floats, from one 16-
// or 8-byte load: `at` is aligned to the load's size.
__device__ __forceinline__ float4 ldg4(const float* at) {
  return __ldg(reinterpret_cast<const float4*>(at));
}
__device__ __forceinline__ float4 ldg4(const uint16_t* at) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(at));
  return make_float4(bits_f32(v.x << 16), bits_f32(v.x & 0xffff0000u),
                     bits_f32(v.y << 16), bits_f32(v.y & 0xffff0000u));
}

// The same from shared memory.
__device__ __forceinline__ float4 lds4(const float* at) {
  return *reinterpret_cast<const float4*>(at);
}
__device__ __forceinline__ float4 lds4(const uint16_t* at) {
  const uint2 v = *reinterpret_cast<const uint2*>(at);
  return make_float4(bits_f32(v.x << 16), bits_f32(v.x & 0xffff0000u),
                     bits_f32(v.y << 16), bits_f32(v.y & 0xffff0000u));
}

// 8 bytes from global to shared memory without passing registers; with
// `valid` false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// d += a . b, one bf16 product with f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

#endif  // __CUDACC__

}  // namespace gfla
