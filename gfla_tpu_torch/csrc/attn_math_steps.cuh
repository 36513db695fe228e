// Device steps the attention-math kernels share (attn_math_fwd.cu,
// attn_math_bwd.cu): the split-f32 product of a 128 x 128 tile on wgmma, and
// the per-position softmax.
//
// The product. Both operands are row-major with the depth innermost, the
// layout wgmma takes for TF32: A (128 rows x depth), B (128 rows x depth),
// tile = A . B^T. A CTA of two warpgroups walks the depth in stages of 32
// floats (128-byte rows) through a ring of three stages, each A and B split
// into hi and lo tiles: cp.async brings each stage, 16 bytes a thread, into
// the 128-byte-swizzled layout wgmma reads, two stages ahead, and every
// thread splits the values it copied itself, once per value, while the
// tensor cores work on the stage before (max_corr.cu's ring). Each
// warpgroup multiplies its 64 rows by the 128 columns as m64n128k8 products,
// the two small products before the large one. The tensor cores add by
// truncation, so every stage starts from 0 and is added to the running sum
// on the FP32 cores. Ragged rows and depth are zero-filled by the copy.
// A CTA may walk several items (column tiles) against the same A; when A is
// at most 128 deep it then stays in shared memory, split once, and only B
// streams.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_math_tiles.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

// tools/kernel_split.py builds timing variants (each kernel file says which
// part a value leaves out); in the product, 1 leaves out the wgmma products,
// 2 the copies and splits of the stages.
#ifndef GFLA_SPLIT
#define GFLA_SPLIT 0
#endif

namespace gfla {

constexpr int kGemmStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kGemmTileBytes = kAttnTile * kAttnDepth * sizeof(float);
constexpr int kGemmAlign = 1024;  // of every tile, for the swizzle
constexpr int kGemmResidentStages = 4;  // of A, when it stays: D <= 128
// Bytes of dynamic shared memory: the ring holds hi and lo tiles of both
// operands a stage, or, with A resident, all of A's hi and lo tiles and a
// ring of B's.
GFLA_HD constexpr size_t gemm_smem_bytes(bool resident_a) {
  return (resident_a ? 2 * kGemmResidentStages + 2 * kGemmStages
                     : 4 * kGemmStages) *
             static_cast<size_t>(kGemmTileBytes) +
         kGemmAlign;
}

// One stage of an operand in device memory: element (r, c) is
// base[r * ld + c] where r < rows and c < cols, and 0 elsewhere.
struct GemmTile {
  const float* base;
  size_t ld;
  int rows, cols;
};

struct GemmStage {
  GemmTile a, b;
};

// Copy r of a tile that thread `tid` makes, the same for both operands:
// kPer floats from column cc of row `row` to byte `off` of the tile's
// shared-memory image. kVec: both operands' rows are 16-byte aligned and
// their column counts multiples of 4.
template <bool kVec>
struct GemmCopy {
  static constexpr int kPer = kVec ? 4 : 1;
  static constexpr int kAcross = kAttnDepth / kPer;
  static constexpr int kCount = kAttnTile * kAcross / kGemmThreads;
  int row, cc, off;
  __device__ __forceinline__ GemmCopy(int tid, int r) {
    const int idx = tid + r * kGemmThreads;
    row = idx / kAcross;
    cc = kPer * (idx % kAcross);
    off = swizzle128(row, cc);
  }
};

// Start this thread's copies of one tile into its hi image `to`.
template <bool kVec>
__device__ __forceinline__ void gemm_load_tile(unsigned char* to, GemmTile t) {
  if (GFLA_SPLIT == 2) return;
#pragma unroll 4
  for (int r = 0; r < GemmCopy<kVec>::kCount; ++r) {
    const GemmCopy<kVec> cp(threadIdx.x, r);
    const bool ok = cp.row < t.rows && cp.cc < t.cols;
    const float* from = ok ? t.base + cp.row * t.ld + cp.cc : t.base;
    if (kVec) {
      cp_async16(to + cp.off, from, ok);
    } else {
      cp_async4(to + cp.off, from, ok);
    }
  }
}

// Split what this thread copied into a tile: hi stays in place, lo goes to
// the tile behind it.
template <bool kVec>
__device__ __forceinline__ void gemm_split_tile(unsigned char* tile) {
  if (GFLA_SPLIT == 2) return;
#pragma unroll 4
  for (int r = 0; r < GemmCopy<kVec>::kCount; ++r) {
    const GemmCopy<kVec> cp(threadIdx.x, r);
    float* hi = reinterpret_cast<float*>(tile + cp.off);
    float* lo = reinterpret_cast<float*>(tile + kGemmTileBytes + cp.off);
    if (kVec) {
      const float4 v = *reinterpret_cast<const float4*>(hi);
      const Tf32Pair x = tf32_split(v.x);
      const Tf32Pair y = tf32_split(v.y);
      const Tf32Pair z = tf32_split(v.z);
      const Tf32Pair w = tf32_split(v.w);
      *reinterpret_cast<float4*>(hi) = make_float4(x.hi, y.hi, z.hi, w.hi);
      *reinterpret_cast<float4*>(lo) = make_float4(x.lo, y.lo, z.lo, w.lo);
    } else {
      const Tf32Pair x = tf32_split(*hi);
      *hi = x.hi;
      *lo = x.lo;
    }
  }
}

// The ring, on a 1024-byte boundary of the dynamic shared-memory window.
__device__ __forceinline__ unsigned char* gemm_ring(unsigned char* smem_raw) {
  return smem_raw + ((kGemmAlign - static_cast<uint32_t>(
                                       __cvta_generic_to_shared(smem_raw))) &
                     (kGemmAlign - 1));
}

// Walk `steps` depth stages; stage s multiplies the tiles `tiles(s)` returns
// (a GemmStage). Every `per_item` stages complete an item, and
// `epilogue(item, sum)` gets its sums while the products of the next
// item's first stage run: sum[4 j + e] is the tile element at row
// grid_row(attn_grid(), warp, lane, 0, e) and column 8 j + mma_c_col(lane,
// e). Every thread of the CTA calls it. kResidentA: A is the same for every
// item, at most kGemmResidentStages stages deep, and is copied and split
// once; only B then streams through the ring, which halves the copies and
// splits a stage.
template <bool kVec, bool kResidentA, class Tiles, class Epilogue>
__device__ __forceinline__ void gemm_walk(unsigned char* ring, int steps,
                                          int per_item, Tiles tiles,
                                          Epilogue epilogue) {
  constexpr int T = kGemmTileBytes;
  const int warp = threadIdx.x >> 5;
  const int group = warp >> 2;  // warpgroup: tile rows 64 group ..
  unsigned char* b_ring =
      kResidentA ? ring + 2 * kGemmResidentStages * T : ring;
  // the hi tiles of a ring slot; lo is the tile behind each
  auto a_tile = [&](int slot, int chunk) {
    return kResidentA ? ring + 2 * chunk * T : ring + 4 * slot * T;
  };
  auto b_tile = [&](int slot) {
    return kResidentA ? b_ring + 2 * slot * T : ring + 4 * slot * T + 2 * T;
  };
  if (kResidentA) {
    for (int j = 0; j < min(steps, per_item); ++j) {
      gemm_load_tile<kVec>(a_tile(0, j), tiles(j).a);
    }
  }
  // the copies run two stages ahead of the products; one commit per call,
  // empty past the end, so the group count stays in step
  int load_step = 0;
  int load_slot = 0;
  auto start_copies = [&]() {
    if (load_step < steps) {
      const GemmStage t = tiles(load_step);
      if (!kResidentA) gemm_load_tile<kVec>(a_tile(load_slot, 0), t.a);
      gemm_load_tile<kVec>(b_tile(load_slot), t.b);
      ++load_step;
      if (++load_slot == kGemmStages) load_slot = 0;
    }
    cp_async_commit();
  };
  auto split_slot = [&](int slot) {
    if (!kResidentA) gemm_split_tile<kVec>(a_tile(slot, 0));
    gemm_split_tile<kVec>(b_tile(slot));
  };
  start_copies();
  start_copies();
  cp_async_wait<1>();  // this thread's copies of stage 0 (and of A) are in
  if (kResidentA) {
    for (int j = 0; j < min(steps, per_item); ++j) {
      gemm_split_tile<kVec>(a_tile(0, j));
    }
  }
  if (steps > 0) split_slot(0);
  fence_proxy_async();
  __syncthreads();

  float acc[64];  // the stage's products
  float sum[64];  // the item's, so far
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    acc[e] = 0.0f;
    sum[e] = 0.0f;
  }
  int chunk = 0;
  int item = 0;
  int done = -1;  // an item whose sums wait for its epilogue
  int slot = 0;   // ring slot of `step`
  for (int step = 0; step < steps; ++step) {
    unsigned char* a_st = a_tile(slot, chunk);
    unsigned char* b_st = b_tile(slot);
    if (++slot == kGemmStages) slot = 0;
    if (GFLA_SPLIT != 1) {
      const uint64_t a_hi = wgmma_desc(a_st + group * (T / 2));
      const uint64_t a_lo = wgmma_desc(a_st + T + group * (T / 2));
      const uint64_t b_hi = wgmma_desc(b_st);
      const uint64_t b_lo = wgmma_desc(b_st + T);
      wgmma_fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kAttnDepth / 8; ++kk) {
        wgmma_tf32(acc, a_lo + 2 * kk, b_hi + 2 * kk, kk > 0);
        wgmma_tf32(acc, a_hi + 2 * kk, b_lo + 2 * kk, 1);
        wgmma_tf32(acc, a_hi + 2 * kk, b_hi + 2 * kk, 1);
      }
      wgmma_commit();
    }
    // while they run: split the next stage, then start the copies two
    // stages on, into the ring slot whose products ended before the last
    // barrier
    cp_async_wait<0>();  // this thread's copies of step + 1 are in
    if (step + 1 < steps) split_slot(slot);
    fence_proxy_async();
    start_copies();
    if (done >= 0) {  // the item before, while the products of this one run
      epilogue(done, sum);
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[e] = 0.0f;
      done = -1;
    }
    if (GFLA_SPLIT != 1) {
      wgmma_wait<0>();
      wgmma_fence_operand(acc);
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[e] += acc[e];
    } else {
      sum[0] += reinterpret_cast<const float*>(b_st)[threadIdx.x];
    }
    if (++chunk == per_item) {
      done = item++;
      chunk = 0;
    }
    __syncthreads();  // the split of step + 1 is everyone's; `b_st` is free
  }
  cp_async_wait<0>();  // only empty groups are left
  if (done >= 0) epilogue(done, sum);
}

// ---- per position: hidden layer and softmax ---------------------------------
// A CTA of kGemmThreads threads owns kAttnRowPos positions p0 .., of which
// the first n_valid exist. hid (kAttnRowPos x ld, ld >= D) gets the hidden
// layer LeakyReLU(hpre), zero past n_valid; att (kAttnRowPos x K2) the
// softmax over the K2 offsets of hid . W2 + b2, with W2 (D x K2) staged in
// w2s (K2 is odd at every odd k, so a warp reading a column of it meets no
// bank conflict; an even k only costs conflicts). hpre_row(t, d) gives hpre
// of position p0 + t. W2 and b2 are float, or bf16 as bits (T = uint16_t,
// the bf16 instances), when the hidden layer is rounded to bf16 before W2,
// where gfla_tpu's bf16 kernel body rounds it (pallas_attn.py:75, 178); the
// products and the softmax are f32 in both. Ends with a barrier.
template <class HpreRow, typename T>
__device__ __forceinline__ void rows_softmax(HpreRow hpre_row, int n_valid,
                                             const T* __restrict__ w2,
                                             const T* __restrict__ b2,
                                             float* hid, int ld, float* w2s,
                                             float* att, int K2, int D,
                                             float slope) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int e = tid; e < D * K2; e += kGemmThreads) w2s[e] = to_float(w2[e]);
  for (int e = tid; e < kAttnRowPos * D; e += kGemmThreads) {
    const int t = e / D;
    const int d = e - t * D;
    float h = 0.0f;
    if (t < n_valid) {
      h = hpre_row(t, d);
      h = h >= 0.0f ? h : h * slope;
    }
    hid[t * ld + d] = kBf16 ? bf16_round(h) : h;
  }
  __syncthreads();
  for (int e = tid; e < kAttnRowPos * K2; e += kGemmThreads) {
    const int t = e / K2;
    const int mm = e - t * K2;
    float s = 0.0f;
    for (int dd = 0; dd < D; ++dd) s = fmaf(hid[t * ld + dd], w2s[dd * K2 + mm], s);
    att[e] = s + to_float(b2[mm]);
  }
  __syncthreads();
  constexpr int kPerWarp = kAttnRowPos / (kGemmThreads / 32);
  for (int t = warp * kPerWarp; t < (warp + 1) * kPerWarp; ++t) {
    float* a = att + t * K2;
    float mx = -INFINITY;
    for (int mm = lane; mm < K2; mm += 32) mx = fmaxf(mx, a[mm]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    float s = 0.0f;
    for (int mm = lane; mm < K2; mm += 32) {
      const float v = expf(a[mm] - mx);
      a[mm] = v;
      s += v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int mm = lane; mm < K2; mm += 32) a[mm] = a[mm] / s;
  }
  __syncthreads();
}

// Four channels from c of row `row` of an (rows x C) tensor, zero past C.
// kVec: C is a multiple of 4 and the tensor 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ base,
                                        size_t row, int c, int C) {
  const float* at = base + row * C + c;
  if (kVec) {
    return c < C ? __ldg(reinterpret_cast<const float4*>(at))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(c < C ? __ldg(at) : 0.0f,
                     c + 1 < C ? __ldg(at + 1) : 0.0f,
                     c + 2 < C ? __ldg(at + 2) : 0.0f,
                     c + 3 < C ? __ldg(at + 3) : 0.0f);
}

// The same from a bf16 tensor (bits), widened; kVec: an 8-byte load.
template <bool kVec>
__device__ __forceinline__ float4 load4(const uint16_t* __restrict__ base,
                                        size_t row, int c, int C) {
  const uint16_t* at = base + row * C + c;
  if (kVec) {
    return c < C ? ldg4(at) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(c < C ? to_float(__ldg(at)) : 0.0f,
                     c + 1 < C ? to_float(__ldg(at + 1)) : 0.0f,
                     c + 2 < C ? to_float(__ldg(at + 2)) : 0.0f,
                     c + 3 < C ? to_float(__ldg(at + 3)) : 0.0f);
}

}  // namespace gfla
