// Tile partition and merge rule of the streaming max-correlation
// (max_corr.cu).
//
// Shared by the CUDA kernels and by a host-only harness that the CPU tests
// compile with g++: without nvcc, GFLA_HD expands to plain `inline`.
//
// gfla_tpu's kernel (gfla_tpu/ops/pallas_corr.py:36-61) keeps the first index
// among equal maxima: jnp.argmax within a tile, a strict `>` across the
// sequential source tiles. Here a thread's correlations come out of
// tensor-core accumulator fragments, two neighbouring source rows at a time
// and eight rows apart between fragments, and partial results arrive from
// lanes, warps and CTAs that saw disjoint sets of source rows in no fixed
// order. So every fold, from the first, replaces the running (value, index)
// when the new value is larger, or equal at a lower source index
// (`corr_beats`). Any order then gives the first index.
#pragma once

#include "mma_tf32x3.cuh"

namespace gfla {

// Source index of a running maximum that has seen no position yet; every
// real index is lower, so any finite value replaces it.
constexpr int kNoIndex = 0x7fffffff;

// A CTA of 8 warps multiplies kCorrRows target rows (the tile's rows) by
// kCorrRows source rows (its columns): warp w holds target rows 16 w .. and
// all 128 source rows, as 16 fragments side by side (two warpgroups of four
// warps, each an m64n128 wgmma accumulator).
constexpr int kCorrRows = 128;
constexpr int kCorrWarps = 8;
GFLA_HD constexpr WarpGrid corr_grid() { return WarpGrid{1, 1, 16}; }

// Slot of a thread's running maxima that element e of fragment row mt
// folds into: one per target row the thread sees.
GFLA_HD int corr_slot(int mt, int e) { return 2 * mt + (e >> 1); }

GFLA_HD bool corr_beats(float value, int index, float best, int best_index) {
  return value > best || (value == best && index < best_index);
}

// Fold (value, index) into the running (best, best_index).
GFLA_HD void corr_fold(float value, int index, float& best, int& best_index) {
  if (corr_beats(value, index, best, best_index)) {
    best = value;
    best_index = index;
  }
}

// Number of source ranges that B x ceil(Nt / kCorrRows) target tiles are
// split into on a card of `sms` multiprocessors, one CTA each: as many as
// still fit the card at once, no more than there are source tiles, and none
// left without a tile.
GFLA_HD int corr_splits(int B, int Ns, int Nt, int sms) {
  const int n_tiles = (Ns + kCorrRows - 1) / kCorrRows;
  const long long ctas =
      static_cast<long long>(B) * ((Nt + kCorrRows - 1) / kCorrRows);
  long long splits = sms / ctas;
  if (splits > n_tiles) splits = n_tiles;
  if (splits < 1) splits = 1;
  const int per = static_cast<int>((n_tiles + splits - 1) / splits);
  return (n_tiles + per - 1) / per;
}

}  // namespace gfla
