// Merge rule of the streaming max-correlation (max_corr.cu).
//
// Shared by the CUDA kernels and by a host-only harness that the CPU tests
// compile with g++: without nvcc, GFLA_HD expands to plain `inline`.
//
// gfla_tpu's kernel (gfla_tpu/ops/pallas_corr.py:36-61) keeps the first index
// among equal maxima: jnp.argmax within a tile, a strict `>` across the
// sequential source tiles. Here partial results arrive from threads and CTAs
// that saw disjoint sets of source positions in no fixed order, so a partial
// (value, index) replaces the running one when its value is larger, or equal
// at a lower source index. Any merge order then gives the first index.
#pragma once

#ifndef GFLA_HD
#ifdef __CUDACC__
#define GFLA_HD __host__ __device__ __forceinline__
#else
#define GFLA_HD inline
#endif
#endif

namespace gfla {

// Source index of a running maximum that has seen no position yet; every
// real index is lower, so any finite value replaces it.
constexpr int kNoIndex = 0x7fffffff;

// Row (or column) of a 128-row tile that element r (0..7) of thread group g
// (0..15) covers in max_corr.cu: 4 rows at 4g, 4 at 64 + 4g, so a warp's
// float4 reads of shared memory are contiguous. Within a group, r orders the
// rows by index.
GFLA_HD int corr_tile_row(int g, int r) {
  return r < 4 ? 4 * g + r : 64 + 4 * g + (r - 4);
}

GFLA_HD bool corr_beats(float value, int index, float best, int best_index) {
  return value > best || (value == best && index < best_index);
}

}  // namespace gfla
