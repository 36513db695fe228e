// bf16 products of the attention-math kernels' 128 x 128 tiles on the tensor
// cores: mma.sync m16n8k16 (mma_bf16.cuh) with f32 accumulators.
//
// Used by the bf16 instances of attn_math_fwd.cu and attn_math_bwd.cu
// (attn_math_fwd_bf16.cu, attn_math_bwd_bf16.cu) in place of the f32
// kernels' split-f32 wgmma walk (attn_math_steps.cuh), with the same tiles,
// stages and epilogue layout: a CTA of 8 warps, warp w holding tile rows
// 16 w .. 16 w + 15 and all 128 columns as 16 fragments side by side, so
// that sum[4 j + e] is the element at row grid_row(attn_grid(), warp, lane,
// 0, e) and column 8 j + mma_c_col(lane, e), as gemm_walk's epilogue gets it.
//
// A stage is 32 deep. Both operands go to shared memory depth innermost as
// bf16, rows 40 values (20 words) apart, so that the 8 rows x 4 words of a
// fragment load fall into 32 different banks and every fragment register
// is one 32-bit load. A (rows x depth) lies so in device memory; B lies so
// too ([column][depth], kBDepthRows false) or depth-major ([depth][column],
// kBDepthRows true: W1 as gfla_tpu lays it out, (k^2 2C) x D), and is then
// transposed as it is stored, a lane a depth row, so that the 16-bit stores
// of a warp hit 16 words. Each thread loads its part of the next stage into
// registers while the tensor cores work on this one, and stores it into the
// other of two buffers after. As in the f32 walk, every stage is multiplied
// from 0 and added to the item's sum on the FP32 cores (the tensor cores
// add by truncation), so a long depth sums in f32. Ragged rows, columns and
// depth are zero-filled by the loads. This is the simple form: 16-byte loads
// through registers, no cp.async, no ldmatrix, one CTA an SM.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "attn_math_steps.cuh"
#include "attn_math_tiles.cuh"
#include "mma_bf16.cuh"

namespace gfla {

constexpr int kBf16Ld = kAttnDepth + 8;               // bf16 a tile row
constexpr int kBf16TileElems = kAttnTile * kBf16Ld;

// Bytes of dynamic shared memory: two buffers of an A and a B tile.
GFLA_HD constexpr size_t bf16_gemm_smem_bytes() {
  return 4 * static_cast<size_t>(kBf16TileElems) * sizeof(uint16_t);
}

// One stage of an operand in device memory, bf16 as bits: element (r, c) is
// base[r * ld + c] where r < rows and c < cols, and 0 elsewhere. For A and a
// [column][depth] B, r is the row or column and c the depth; for a
// depth-major B, r is the depth and c the column.
struct Bf16Tile {
  const uint16_t* base;
  size_t ld;
  int rows, cols;
};

struct Bf16Stage {
  Bf16Tile a, b;
};

// Eight consecutive values from (r, c) of a tile, zero where outside. kVec:
// every row is 16-byte aligned and cols a multiple of 8.
template <bool kVec>
__device__ __forceinline__ uint4 bf16_load8(const Bf16Tile& t, int r, int c) {
  if (kVec) {
    return r < t.rows && c < t.cols
               ? __ldg(reinterpret_cast<const uint4*>(t.base + r * t.ld + c))
               : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint32_t lo = 0u, hi = 0u;
    if (r < t.rows && c + 2 * u < t.cols) {
      lo = __ldg(t.base + r * t.ld + c + 2 * u);
    }
    if (r < t.rows && c + 2 * u + 1 < t.cols) {
      hi = __ldg(t.base + r * t.ld + c + 2 * u + 1);
    }
    w[u] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Walk `steps` depth stages; stage s multiplies the tiles `tiles(s)` returns
// (a Bf16Stage). Every `per_item` stages complete an item, and
// `epilogue(item, sum)` gets its sums (gemm_walk's layout). Every thread of
// the CTA calls it; it ends with a barrier.
template <bool kVec, bool kBDepthRows, class Tiles, class Epilogue>
__device__ __forceinline__ void bf16_gemm_walk(uint16_t* smem, int steps,
                                               int per_item, Tiles tiles,
                                               Epilogue epilogue) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint16_t* a_buf[2] = {smem, smem + kBf16TileElems};
  uint16_t* b_buf[2] = {smem + 2 * kBf16TileElems,
                        smem + 3 * kBf16TileElems};
  // this thread's two loads of each operand: A (and a [column][depth] B)
  // row idx / 4, depth 8 (idx % 4); a depth-major B depth idx % 32, columns
  // 8 (idx / 32) ..
  uint4 ra[2], rb[2];
  auto fetch = [&](int step) {
    const Bf16Stage st = tiles(step);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      ra[j] = bf16_load8<kVec>(st.a, idx >> 2, 8 * (idx & 3));
      rb[j] = kBDepthRows ? bf16_load8<kVec>(st.b, idx & 31, 8 * (idx >> 5))
                          : bf16_load8<kVec>(st.b, idx >> 2, 8 * (idx & 3));
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      *reinterpret_cast<uint4*>(a_buf[buf] + (idx >> 2) * kBf16Ld +
                                8 * (idx & 3)) = ra[j];
      if (kBDepthRows) {
        const int d = idx & 31;
        uint16_t* to = b_buf[buf] + 8 * (idx >> 5) * kBf16Ld + d;
        const uint32_t w[4] = {rb[j].x, rb[j].y, rb[j].z, rb[j].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          to[(2 * u) * kBf16Ld] = static_cast<uint16_t>(w[u] & 0xffffu);
          to[(2 * u + 1) * kBf16Ld] = static_cast<uint16_t>(w[u] >> 16);
        }
      } else {
        *reinterpret_cast<uint4*>(b_buf[buf] + (idx >> 2) * kBf16Ld +
                                  8 * (idx & 3)) = rb[j];
      }
    }
  };

  float sum[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) sum[e] = 0.0f;
  if (steps > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  int chunk = 0;
  int item = 0;
  // this lane's A row (fragment register 0) and B column
  const int a_at = (16 * warp + mma16_a_row(lane, 0)) * kBf16Ld;
  const int b_at = mma16_b_col(lane) * kBf16Ld;
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) fetch(step + 1);  // in flight during the products
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    const uint16_t* as = a_buf[buf] + a_at;
    const uint16_t* bs = b_buf[buf] + b_at;
#pragma unroll
    for (int kk = 0; kk < kAttnDepth / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = *reinterpret_cast<const uint32_t*>(
            as + 8 * (r & 1) * kBf16Ld + 16 * kk + mma16_a_depth(lane, r, 0));
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t b[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          b[r] = *reinterpret_cast<const uint32_t*>(
              bs + 8 * j * kBf16Ld + 16 * kk + mma16_b_depth(lane, r, 0));
        }
        mma_bf16(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[4 * j + e] += acc[j][e];
    }
    if (++chunk == per_item) {
      epilogue(item++, sum);
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[e] = 0.0f;
      chunk = 0;
    }
    // the other buffer was last read one stage ago, before a barrier
    if (step + 1 < steps) put(buf ^ 1);
    __syncthreads();
  }
}

}  // namespace gfla
