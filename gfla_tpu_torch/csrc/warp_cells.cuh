// Footprint-cell form of the warp backward's per-position steps.
//
// All k^2 offsets of a position share its blend weights, and offset (i, j)
// blends the four clamped taps at footprint cells (i, j), (i, j+1), (i+1, j)
// and (i+1, j+1). So a sum over offsets of anything linear in the taps is a
// sum over the (k+1)^2 cells, each with a coefficient of at most four terms:
//  * <block_(i,j), g> is the blend of the cell dots <src[cell], g> (d_attn);
//  * the scatter of d_block into d_source adds, per cell, the blend-weighted
//    sum of the d_block vectors of the offsets that use the cell as a tap;
//  * d_flow is sum over cells of <src[cell], E[cell]>, E the same sum with
//    the weights' derivatives.
// Cells clamp onto the image as taps do, so two cells on one pixel each add
// their own share. Used by csrc/warp_bwd.cu and, compiled with g++, by a
// host-only harness of the CPU tests.
#pragma once

#include "warp_common.cuh"

namespace gfla {

// The tap role of a cell for an offset: cell (r, s) is the top-left tap (0)
// of offset (r, s), the top-right (1) of (r, s-1), the bottom-left (2) of
// (r-1, s) and the bottom-right (3) of (r-1, s-1).
GFLA_HD int role_row(int role, int r) { return r - (role >> 1); }
GFLA_HD int role_col(int role, int s) { return s - (role & 1); }

// True if the offset that holds cell (r, s) in `role` is one of rows
// [0, rows) x columns [0, k): a band of `rows` offset rows, in band-local
// cell rows.
GFLA_HD bool role_valid(int role, int r, int s, int rows, int k) {
  const int i = role_row(role, r);
  const int j = role_col(role, s);
  return i >= 0 && i < rows && j >= 0 && j < k;
}

// Coefficients of a tap in the blend (d) and in its derivatives with
// respect to wy (y) and wx (x).
struct TapCoef {
  float d, y, x;
};

GFLA_HD TapCoef tap_coef(int role, float wy, float wx) {
  switch (role) {
    case 0:
      return TapCoef{(1.0f - wy) * (1.0f - wx), -(1.0f - wx), -(1.0f - wy)};
    case 1: return TapCoef{(1.0f - wy) * wx, -wx, 1.0f - wy};
    case 2: return TapCoef{wy * (1.0f - wx), 1.0f - wx, -wy};
    default: return TapCoef{wy * wx, wx, wy};
  }
}

// <block_(i, j), g> from the position's cell dots cdot[r * k1 + s] =
// <src[cell (r, s)], g>.
GFLA_HD float cell_dattn(const float* cdot, int k1, const TapWeights& w,
                         int i, int j) {
  const float* c = cdot + i * k1 + j;
  return w.tl * c[0] + w.tr * c[1] + w.bl * c[k1] + w.br * c[k1 + 1];
}

// The forward's weight of cell (r, c), 0 <= r, c <= k, in
// (1/k^2) sum_m attn_m block_m: the blend weights of the offsets that use
// it as a tap times their attention weights att[i * k + j], summed in the
// order top-left, top-right, bottom-left, bottom-right (csrc/warp_fwd.cu).
GFLA_HD float cell_coef(const float* att, int k, const TapWeights& w, int r,
                        int c) {
  float f = 0.0f;
  if (r < k && c < k) f = fmaf(w.tl, att[r * k + c], f);
  if (r < k && c > 0) f = fmaf(w.tr, att[r * k + c - 1], f);
  if (r > 0 && c < k) f = fmaf(w.bl, att[(r - 1) * k + c], f);
  if (r > 0 && c > 0) f = fmaf(w.br, att[(r - 1) * k + c - 1], f);
  return f * (1.0f / static_cast<float>(k * k));
}

// In a band of one offset row and `cols` offsets (the wide per-position
// backward's, csrc/warp_bwd_tiles.cuh), the band-local offset column, and so
// the product fragment, that holds band-local cell (r, s), 0 <= r <= 1,
// 0 <= s <= cols, in `role`; -1 where no offset of the band does.
GFLA_HD int band_tap(int role, int r, int s, int cols) {
  return role_valid(role, r, s, 1, cols) ? role_col(role, s) : -1;
}

}  // namespace gfla
