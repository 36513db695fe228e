// Tile maps and launch plans of the warp backward kernels (csrc/warp_bwd.cu).
//
// Host- and device-side, so that a g++ harness of the CPU tests can check
// that each map covers its tile once: without nvcc GFLA_HD is `inline`.
#pragma once

#include "mma_tf32x3.cuh"

namespace gfla {

constexpr int kPosRows = 64;      // per-position kernel: positions per CTA
constexpr int kW1Units = 128;     // dW1s kernel: hidden units per CTA
constexpr int kW1Chunk = 32;      // dW1s kernel: positions per stage
constexpr int kBwdTargetCtas = 264;  // two CTAs per SM of the H100's 132
constexpr int kWarpMaxK = 9;      // the widest block of the k <= 9 instances
constexpr int kWideCols = 8;      // wide instance: offsets of a band

// Both backward kernels have an instance compiled for each k of the live
// sites (3 and 5), one that takes k at run time for every other k in
// 1..kWarpMaxK, odd or even, and a wide one for every k above kWarpMaxK,
// in which nothing sized by k is held in registers or shared memory; the
// maps below name the tiles of the instance that a k runs on.
GFLA_HD constexpr bool warp_k_compiled(int k) { return k == 3 || k == 5; }
GFLA_HD constexpr bool warp_k_wide(int k) { return k > kWarpMaxK; }

struct OffsetChannel {
  int m, c;  // offset i * k + j, channel
};

// ---- per-position kernel: d_block = d_hpre . W1s^T ------------------------
// The product's columns come in tiles of (band, channel group): a band is
// pos_band_rows(k) offset rows, a group 8 channels, and fragment f of the
// tile (8 columns) is one offset of the band, its columns the 8 channels.
// So a lane's accumulators of one tile hold every offset of the band for
// its rows and channels. The compiled instances take all k rows in one band;
// the run-time instance one offset row a band, so that its accumulators are
// indexed by the column within the row alone, at most kWarpMaxK fragments.

GFLA_HD constexpr int pos_band_rows(int k) {
  return warp_k_compiled(k) ? k : 1;
}

GFLA_HD constexpr int pos_bands(int k) {
  return (k + pos_band_rows(k) - 1) / pos_band_rows(k);
}

// Fragments of `band` that hold an offset (the last band may be short).
GFLA_HD int pos_band_fragments(int k, int band) {
  const int rows = k - band * pos_band_rows(k);
  return (rows < pos_band_rows(k) ? rows : pos_band_rows(k)) * k;
}

// Offset and channel of column n of the tile (band, group): the W1s row
// m * C + c it multiplies.
GFLA_HD OffsetChannel pos_column(int k, int band, int group, int n) {
  return OffsetChannel{band * pos_band_rows(k) * k + (n >> 3),
                       8 * group + (n & 7)};
}

// The wide instance's bands: a run of up to kWideCols offsets of one offset
// row, so that the tile of a band is kWideCols fragments at any k. Band b
// is row b / wide_runs(k), run b % wide_runs(k).
GFLA_HD constexpr int wide_runs(int k) {
  return (k + kWideCols - 1) / kWideCols;
}

GFLA_HD constexpr int wide_bands(int k) { return k * wide_runs(k); }

struct WideBand {
  int i, j0, cols;  // offset row, first offset column, offsets
};

GFLA_HD WideBand wide_band(int k, int band) {
  const int i = band / wide_runs(k);
  const int j0 = (band - i * wide_runs(k)) * kWideCols;
  return WideBand{i, j0, k - j0 < kWideCols ? k - j0 : kWideCols};
}

// Offset and channel of column n of the wide tile (band, group): fragment
// n / 8 is offset (i, j0 + n / 8).
GFLA_HD OffsetChannel wide_column(int k, int band, int group, int n) {
  const WideBand b = wide_band(k, band);
  return OffsetChannel{b.i * k + b.j0 + (n >> 3), 8 * group + (n & 7)};
}

// The trade of an accumulator fragment with lane ^ 1 before the epilogue:
// a lane gives away the two elements the other lane keeps (trade_out), takes
// two back (trade_in), and then holds one row and four consecutive channels
// of the 16 x 8 fragment: row traded_row(lane), channels traded_col(lane)
// + 0..3.
GFLA_HD void trade_out(int lane, const float (&v)[4], float& s0, float& s1) {
  const bool odd = lane & 1;
  s0 = odd ? v[0] : v[2];
  s1 = odd ? v[1] : v[3];
}

GFLA_HD void trade_in(int lane, float (&v)[4], float r0, float r1) {
  if (lane & 1) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

GFLA_HD int traded_row(int lane) { return (lane >> 2) + 8 * (lane & 1); }
GFLA_HD int traded_col(int lane) { return 4 * ((lane & 3) >> 1); }

// The per-position grid: `tiles` x `splits` CTAs. Split y takes the
// (band, group) items [y * per_cta, min(items, (y + 1) * per_cta)); the
// groups are split while the position tiles alone would leave SMs idle.
struct PosPlan {
  int tiles, items, per_cta, splits;
};

GFLA_HD PosPlan pos_plan(int N, int C, int k) {
  PosPlan p;
  p.tiles = (N + kPosRows - 1) / kPosRows;
  p.items = (warp_k_wide(k) ? wide_bands(k) : pos_bands(k)) * ((C + 7) / 8);
  int splits = 1;
  while (p.tiles * splits < kBwdTargetCtas * 3 / 4 && 2 * splits <= p.items) {
    splits *= 2;
  }
  p.per_cta = (p.items + splits - 1) / splits;
  p.splits = (p.items + p.per_cta - 1) / p.per_cta;
  return p;
}

// ---- dW1s kernel: dW1s = blocks^T . d_hpre over positions -----------------
// A CTA's columns are w1_offsets(k) offsets x w1_channels(k) channels,
// offset-major, in w1_fragments(k) fragments; its rows kW1Units hidden
// units; its depth a range of positions. Up to 25 offsets a tile, and as
// many 4-channel groups as keep the tile within 100 columns (13 fragments,
// kW1MaxFragments, which the run-time and wide instances hold for every k;
// above 5 a tile is 25 offsets of 4 channels).

GFLA_HD constexpr int w1_offsets(int k) { return k * k < 25 ? k * k : 25; }

GFLA_HD constexpr int w1_channels(int k) {
  return 4 * (25 / w1_offsets(k) > 1 ? 25 / w1_offsets(k) : 1);
}

GFLA_HD constexpr int w1_fragments(int k) {
  return (w1_offsets(k) * w1_channels(k) + 7) / 8;
}

constexpr int kW1MaxFragments = 13;

GFLA_HD constexpr int w1_offset_tiles(int k) {
  return (k * k + w1_offsets(k) - 1) / w1_offsets(k);
}

// Offset and channel of column `col` of offset tile `ot`, channel tile `ct`
// (an offset past k^2 or a channel past C is padding).
GFLA_HD OffsetChannel w1_column(int k, int ot, int ct, int col) {
  const int mo = col / w1_channels(k);
  return OffsetChannel{ot * w1_offsets(k) + mo,
                       ct * w1_channels(k) + col - mo * w1_channels(k)};
}

// The dW1s grid: (w1_offset_tiles x ctiles, utiles, splits) CTAs; split z
// sums positions [z * span, min(N, (z + 1) * span)), span a multiple of
// kW1Chunk, into partial z; the splits bring the grid near kBwdTargetCtas.
struct W1Plan {
  int ctiles, utiles, span, splits;
};

GFLA_HD W1Plan w1_plan(int N, int C, int D, int k) {
  W1Plan p;
  p.ctiles = (C + w1_channels(k) - 1) / w1_channels(k);
  p.utiles = (D + kW1Units - 1) / kW1Units;
  const int chunks = (N + kW1Chunk - 1) / kW1Chunk;
  const int per_unit = w1_offset_tiles(k) * p.ctiles * p.utiles;
  int parts = (kBwdTargetCtas + per_unit / 2) / per_unit;
  parts = parts < 1 ? 1 : (parts > chunks ? chunks : parts);
  p.span = (chunks + parts - 1) / parts * kW1Chunk;
  p.splits = (N + p.span - 1) / p.span;
  return p;
}

}  // namespace gfla
