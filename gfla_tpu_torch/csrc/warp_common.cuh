// Per-position index, clamp and bilinear code of the local-attention warp.
//
// Shared by the CUDA kernels (warp_fwd.cu, warp_bwd.cu) and by a host-only
// harness that the CPU tests compile with g++: without nvcc, GFLA_HD expands
// to plain `inline`.
//
// Semantics (gfla_tpu/ops/block_extract.py:40-72 and the padded-window
// formulation of gfla_tpu/ops/pallas_warp.py:103-134): output position (y, x)
// with flow (fx, fy) looks at the source point (y + fy, x + fx). Offset (i, j)
// of its k x k block blends the four taps at rows floor(y + fy) - k/2 + i + {0,1}
// and columns floor(x + fx) - k/2 + j + {0,1}, each clamped into the image,
// with the fractional weights wy = dy - floor(dy), wx = dx - floor(dx) that all
// k^2 offsets share.
#pragma once

#ifdef __CUDACC__
#define GFLA_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define GFLA_HD inline
#endif

namespace gfla {

struct Footprint {
  int y0;    // unclamped first footprint row: floor(y + fy) - k/2
  int x0;    // unclamped first footprint column: floor(x + fx) - k/2
  float wy;  // fractional row weight
  float wx;  // fractional column weight
};

GFLA_HD int clamp_index(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Footprint of output position (y, x) in an H x W image. The floor is
// saturated to a band just outside the image before the int conversion, so
// flows of any size stay defined; every tap of a saturated footprint clamps to
// the same edge row or column as it would unsaturated.
GFLA_HD Footprint footprint(float flow_x, float flow_y, int y, int x, int H,
                            int W, int k) {
  const int r = k / 2;
  const float dy = flow_y + static_cast<float>(y);
  const float dx = flow_x + static_cast<float>(x);
  const float fy = floorf(dy);
  const float fx = floorf(dx);
  const float ly = fminf(fmaxf(fy, -static_cast<float>(k + 2)),
                         static_cast<float>(H + k + 2));
  const float lx = fminf(fmaxf(fx, -static_cast<float>(k + 2)),
                         static_cast<float>(W + k + 2));
  Footprint f;
  f.y0 = static_cast<int>(ly) - r;
  f.x0 = static_cast<int>(lx) - r;
  f.wy = dy - fy;
  f.wx = dx - fx;
  return f;
}

// Clamped source row of footprint row i, 0 <= i <= k.
GFLA_HD int tap_row(const Footprint& f, int i, int H) {
  return clamp_index(f.y0 + i, 0, H - 1);
}

// Clamped source column of footprint column j, 0 <= j <= k.
GFLA_HD int tap_col(const Footprint& f, int j, int W) {
  return clamp_index(f.x0 + j, 0, W - 1);
}

// Pixel of footprint cell (i, j), 0 <= i, j <= k, of a position of batch
// element b, in the batch's (B*H*W) pixel order: what the tables of the
// kernels for k <= 9 hold, computed where it is needed (the wide instances
// keep nothing sized by k).
GFLA_HD int cell_pixel(const Footprint& f, int b, int i, int j, int H,
                       int W) {
  return (b * H + tap_row(f, i, H)) * W + tap_col(f, j, W);
}

// Blend weights of the four taps of an offset: top-left, top-right,
// bottom-left, bottom-right. A block value is their weighted sum; its
// cotangent goes back to the taps with the same weights (scattered into
// d_source at the clamped pixels, so edge bands fold onto the border as
// gfla_tpu's _fold_pad does) and to wy and wx, whose derivative with respect
// to the flow is 1 (floor is piecewise constant): csrc/warp_cells.cuh.
struct TapWeights {
  float tl, tr, bl, br;
};

GFLA_HD TapWeights tap_weights(float wy, float wx) {
  return TapWeights{(1.0f - wy) * (1.0f - wx), (1.0f - wy) * wx,
                    wy * (1.0f - wx), wy * wx};
}

}  // namespace gfla
