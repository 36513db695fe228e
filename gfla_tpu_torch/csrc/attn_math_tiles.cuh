// Tile maps and launch plans of the attention-math kernels
// (attn_math_fwd.cu, attn_math_bwd.cu).
//
// Host- and device-side, so that a g++ harness of the CPU tests can check
// that each map covers its tile once: without nvcc GFLA_HD is `inline`.
//
// Both products run on the tensor cores in 128 x 128 tiles, depth walked in
// stages of 32 (attn_math_steps.cuh). Both multiply by W1 (k^2, 2C, D) as
// gfla_tpu lays it out: row (2 m + h) C + c multiplies channel c of offset m
// of the target blocks bt (h = 0) or of the source blocks bs (h = 1). So the
// forward's depth and the backward's product columns are walked as (offset
// m, half h, run of channels), and every run lies in one row of bt, bs, d_bt
// or d_bs.
#pragma once

#include "mma_tf32x3.cuh"

namespace gfla {

constexpr int kAttnTile = 128;      // product tile: rows and columns
constexpr int kAttnDepth = 32;      // depth a stage: 128-byte rows
constexpr int kAttnRowPos = 32;     // per-position kernels: positions a CTA
constexpr int kAttnSms = 132;       // the H100's SMs: one product CTA each

// A product CTA's 8 warps, two warpgroups of four: warp w holds tile rows
// 16 w .. 16 w + 15 and all 128 columns, 16 fragments side by side.
GFLA_HD constexpr WarpGrid attn_grid() { return WarpGrid{1, 1, 16}; }

// A run of channels c0 .. c0 + width - 1 of offset m of half h (0: bt, 1: bs).
struct OffsetRun {
  int m, h, c0;
};

// Run q of a walk over (m, h, c0) in runs of `width` channels: all runs of
// one (m, h) before the next, bt's before bs's within an offset, so W1 is
// read row after row.
GFLA_HD OffsetRun attn_run(int q, int C, int width) {
  const int per_half = (C + width - 1) / width;
  const int mh = q / per_half;
  return OffsetRun{mh >> 1, mh & 1, (q - mh * per_half) * width};
}

GFLA_HD int attn_runs(int k2, int C, int width) {
  return k2 * 2 * ((C + width - 1) / width);
}

// ---- forward: hpre = [bt || bs] . W1 over (positions) x (D) tiles ----------
// Its depth stages are runs of kAttnDepth channels. The grid is (position
// tiles x column tiles, splits): split z sums the stages [z * per_split,
// min(stages, (z + 1) * per_split)) into partial z, and the depth is split
// while the tiles alone would leave SMs idle.
struct AttnFwdPlan {
  int tiles, col_tiles, stages, per_split, splits;
};

GFLA_HD AttnFwdPlan attn_fwd_plan(int N, int C, int D, int k2) {
  AttnFwdPlan p;
  p.tiles = (N + kAttnTile - 1) / kAttnTile;
  p.col_tiles = (D + kAttnTile - 1) / kAttnTile;
  p.stages = attn_runs(k2, C, kAttnDepth);
  int splits = 1;
  while (p.tiles * p.col_tiles * splits < kAttnSms * 3 / 4 &&
         2 * splits <= p.stages) {
    splits *= 2;
  }
  p.per_split = (p.stages + splits - 1) / splits;
  p.splits = (p.stages + p.per_split - 1) / p.per_split;
  return p;
}

// ---- backward: d_[bt || bs] = d_hpre . W1^T -------------------------------
// A CTA's columns are an item: a run of kAttnTile channels of one (offset,
// half), so the item's columns are one row segment of d_bt or d_bs. The
// grid is (position tiles, splits): split y takes the items [y * per_cta,
// min(items, (y + 1) * per_cta)); the items are split while the position
// tiles alone would leave SMs idle.
GFLA_HD OffsetRun bwd_item(int item, int C) {
  return attn_run(item, C, kAttnTile);
}

struct AttnBwdPlan {
  int tiles, items, per_cta, splits;
};

GFLA_HD AttnBwdPlan attn_bwd_plan(int N, int C, int k2) {
  AttnBwdPlan p;
  p.tiles = (N + kAttnTile - 1) / kAttnTile;
  p.items = attn_runs(k2, C, kAttnTile);
  int splits = 1;
  while (p.tiles * splits < kAttnSms * 3 / 4 && 2 * splits <= p.items) {
    splits *= 2;
  }
  p.per_cta = (p.items + splits - 1) / splits;
  p.splits = (p.items + p.per_cta - 1) / p.per_cta;
  return p;
}

}  // namespace gfla
