"""The split-f32 ("3xTF32") building block of the tensor-core kernels, on CPU.

csrc/mma_tf32x3.cuh, csrc/max_corr.cuh, csrc/warp_bwd_tiles.cuh and
csrc/attn_math_tiles.cuh keep the split of an f32 value into two TF32
values, every map from a lane's fragment element to its row and column, and
the tile maps and launch plans of the warp backward and the attention math
in `__host__ __device__` functions. They are compiled here with g++ into a
small harness:

- the fragment maps of one m16n8k8 product and the warp grids of
  csrc/max_corr.cu and csrc/warp_fwd.cu cover each tile element once, and
  the 128-byte swizzle of the wgmma tiles gives every float its own place;
- csrc/warp_bwd.cu's maps cover their tiles once: the offset-major columns
  of the d_block product (all offsets of a band x 8 channels a tile) and of
  the dW1s product, the trade that leaves a lane one row and four channels,
  the per-position kernel's split of (band, channel group) items and the
  dW1s kernel's split of the positions into ranges;
- the split is exact in its first part and leaves ~2^-22 of the value;
- csrc/attn_math_tiles.cuh's maps: the attention-math products' runs of
  channels take every W1 row once, their splits take every depth stage and
  every item once, and the wgmma accumulators cover the 128 x 128 tile;
- the split product, emulated with the kernel's arithmetic (tensor-core
  accumulation by truncation within a stage of 32 channels, stages added
  rounding to nearest), of unit-norm ReLU rows at C=256 and C=512 is within
  1e-6 of the float64 product, so well within the 1e-5 that decides an
  argmax, while one TF32 product is not: why the kernels multiply three
  times.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "gfla_tpu_torch" / "csrc"
CORR_ATOL = 1e-5  # chip_smoke.py's tolerance on cmax

HARNESS = r"""
#include <cmath>
#include "attn_math_tiles.cuh"
#include "max_corr.cuh"
#include "warp_bwd_tiles.cuh"
using namespace gfla;

// the tensor cores add into an f32 accumulator by truncation
static float add_rz(float acc, double term) {
  const double exact = static_cast<double>(acc) + term;
  float f = static_cast<float>(exact);
  if (std::fabs(static_cast<double>(f)) > std::fabs(exact)) {
    f = std::nextafterf(f, 0.0f);
  }
  return f;
}

extern "C" {
// which: 0 A (16 x 8), 1 B (8 deep x 8 columns), 2 C (16 x 8). Counts how
// often each element (row-major, 8 wide) is held by a (lane, element).
void fragment_cover(int which, int* count) {
  for (int lane = 0; lane < 32; ++lane) {
    for (int e = 0; e < (which == 1 ? 2 : 4); ++e) {
      int r, c;
      if (which == 0) { r = mma_a_row(lane, e); c = mma_a_depth(lane, e); }
      else if (which == 1) { r = mma_b_depth(lane, e); c = mma_b_col(lane); }
      else { r = mma_c_row(lane, e); c = mma_c_col(lane, e); }
      ++count[r * 8 + c];
    }
  }
}

// Counts how often each element of a (rows x cols) tile is an accumulator
// element of one of `warps` warps laid out as WarpGrid{warps_n, tm, tn}.
// Returns 1 if an element fell outside the tile.
int grid_cover(int warps, int warps_n, int tm, int tn, int rows, int cols,
               int* count) {
  const WarpGrid g{warps_n, tm, tn};
  int outside = 0;
  for (int warp = 0; warp < warps; ++warp) {
    for (int lane = 0; lane < 32; ++lane) {
      for (int mt = 0; mt < tm; ++mt) {
        for (int nt = 0; nt < tn; ++nt) {
          for (int e = 0; e < 4; ++e) {
            const int r = grid_row(g, warp, lane, mt, e);
            const int c = grid_col(g, warp, lane, nt, e);
            if (r < 0 || r >= rows || c < 0 || c >= cols) outside = 1;
            else ++count[r * cols + c];
          }
        }
      }
    }
  }
  return outside;
}

void corr_grid_shape(int* out) {
  const WarpGrid g = corr_grid();
  out[0] = g.warps_n; out[1] = g.tiles_m; out[2] = g.tiles_n;
  out[3] = kCorrWarps; out[4] = kCorrRows;
}

// Byte offset of every float of a (rows x 32) tile under swizzle128.
void swizzled(int rows, int* off) {
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < 32; ++c) off[r * 32 + c] = swizzle128(r, c);
  }
}

// Counts how often each (offset, channel) of W1s (k*k x C) is a column of
// the per-position product's tiles (the wide instance's above k = 9).
// Returns 1 if a column fell outside.
int pos_cover(int k, int C, int* count) {
  const bool wide = warp_k_wide(k);
  auto column = [&](int band, int group, int n) {
    return wide ? wide_column(k, band, group, n)
                : pos_column(k, band, group, n);
  };
  int outside = 0;
  for (int band = 0; band < (wide ? wide_bands(k) : pos_bands(k)); ++band) {
    const int frags = wide ? wide_band(k, band).cols
                           : pos_band_fragments(k, band);
    for (int group = 0; group < (C + 7) / 8; ++group) {
      for (int n = 0; n < 8 * frags; ++n) {
        const OffsetChannel oc = column(band, group, n);
        if (oc.c >= C) continue;  // zero-padded channels
        if (oc.m < 0 || oc.m >= k * k ||
            oc.m != column(band, group, n & ~7).m) {
          outside = 1;
        } else {
          ++count[oc.m * C + oc.c];
        }
      }
    }
  }
  return outside;
}

// The trade of a C fragment between lanes: returns how many traded
// elements are not where traded_row / traded_col say.
int trade_mismatches() {
  float v[32][4], s0[32], s1[32];
  for (int lane = 0; lane < 32; ++lane) {
    for (int e = 0; e < 4; ++e) {
      v[lane][e] = static_cast<float>(mma_c_row(lane, e) * 8 +
                                      mma_c_col(lane, e));
    }
    trade_out(lane, v[lane], s0[lane], s1[lane]);
  }
  int bad = 0;
  for (int lane = 0; lane < 32; ++lane) {
    trade_in(lane, v[lane], s0[lane ^ 1], s1[lane ^ 1]);
    for (int e = 0; e < 4; ++e) {
      bad += v[lane][e] != traded_row(lane) * 8 + traded_col(lane) + e;
    }
  }
  return bad;
}

// The same for the dW1s product's columns.
int w1_cover(int k, int C, int* count) {
  int outside = 0;
  const int ctiles = (C + w1_channels(k) - 1) / w1_channels(k);
  for (int ot = 0; ot < w1_offset_tiles(k); ++ot) {
    const int m_end = (ot + 1) * w1_offsets(k) < k * k
                          ? (ot + 1) * w1_offsets(k) : k * k;
    for (int ct = 0; ct < ctiles; ++ct) {
      for (int col = 0; col < 8 * w1_fragments(k); ++col) {
        const OffsetChannel oc = w1_column(k, ot, ct, col);
        if (oc.m >= m_end || oc.c >= C) continue;  // padding
        if (oc.m < ot * w1_offsets(k) || oc.c < ct * w1_channels(k)) {
          outside = 1;
        } else {
          ++count[oc.m * C + oc.c];
        }
      }
    }
  }
  return outside;
}

// Counts how often each position is in a dW1s range; info: span, splits,
// CTAs. Returns 1 if a range is empty.
int w1_ranges(int N, int C, int D, int k, int* count, int* info) {
  const W1Plan p = w1_plan(N, C, D, k);
  int empty = 0;
  for (int z = 0; z < p.splits; ++z) {
    const int hi = (z + 1) * p.span < N ? (z + 1) * p.span : N;
    if (hi <= z * p.span) empty = 1;
    for (int q = z * p.span; q < hi; ++q) ++count[q];
  }
  info[0] = p.span;
  info[1] = p.splits;
  info[2] = w1_offset_tiles(k) * p.ctiles * p.utiles * p.splits;
  return empty;
}

// Counts how often each (band, channel group) item is taken by a split of
// the per-position grid; info: items, splits, CTAs. Returns 1 if a split
// is empty.
int pos_items(int N, int C, int k, int* count, int* info) {
  const PosPlan p = pos_plan(N, C, k);
  int empty = 0;
  for (int y = 0; y < p.splits; ++y) {
    const int hi = (y + 1) * p.per_cta < p.items ? (y + 1) * p.per_cta
                                                 : p.items;
    if (hi <= y * p.per_cta) empty = 1;
    for (int it = y * p.per_cta; it < hi; ++it) ++count[it];
  }
  info[0] = p.items;
  info[1] = p.splits;
  info[2] = p.tiles * p.splits;
  return empty;
}

void attn_grid_shape(int* out) {
  const WarpGrid g = attn_grid();
  out[0] = g.warps_n; out[1] = g.tiles_m; out[2] = g.tiles_n;
  out[3] = kAttnTile;
}

// Counts how often each W1 row (2 m + h) C + c is in a run of `width`
// channels of attn_run's walk. Returns 1 if a run leaves its (m, h) or the
// walk reaches past k2.
int attn_runs_cover(int k2, int C, int width, int* count) {
  int outside = 0;
  for (int q = 0; q < attn_runs(k2, C, width); ++q) {
    const OffsetRun r = attn_run(q, C, width);
    if (r.m < 0 || r.m >= k2 || r.h < 0 || r.h > 1 || r.c0 % width != 0) {
      outside = 1;
      continue;
    }
    for (int c = r.c0; c < r.c0 + width && c < C; ++c) {
      ++count[(2 * r.m + r.h) * C + c];
    }
  }
  return outside;
}

// Counts how often each depth stage of the forward product is taken by a
// split, and each item of the backward product by a split; info: forward
// stages, splits, CTAs; backward items, splits, CTAs. Returns 1 if a split
// is empty.
int attn_plans(int N, int C, int D, int k2, int* fwd, int* bwd, int* info) {
  const AttnFwdPlan f = attn_fwd_plan(N, C, D, k2);
  int empty = 0;
  for (int z = 0; z < f.splits; ++z) {
    const int hi = (z + 1) * f.per_split < f.stages ? (z + 1) * f.per_split
                                                    : f.stages;
    if (hi <= z * f.per_split) empty = 1;
    for (int q = z * f.per_split; q < hi; ++q) ++fwd[q];
  }
  const AttnBwdPlan b = attn_bwd_plan(N, C, k2);
  for (int y = 0; y < b.splits; ++y) {
    const int hi = (y + 1) * b.per_cta < b.items ? (y + 1) * b.per_cta
                                                 : b.items;
    if (hi <= y * b.per_cta) empty = 1;
    for (int it = y * b.per_cta; it < hi; ++it) ++bwd[it];
  }
  info[0] = f.stages; info[1] = f.splits;
  info[2] = f.tiles * f.col_tiles * f.splits;
  info[3] = b.items; info[4] = b.splits; info[5] = b.tiles * b.splits;
  return empty;
}

void split(const float* x, int n, float* hi, float* lo) {
  for (int i = 0; i < n; ++i) {
    const Tf32Pair p = tf32_split(x[i]);
    hi[i] = p.hi;
    lo[i] = p.lo;
  }
}

// out3[r] = <a_r, b_r> as the kernels compute it: operands split, per 8
// channels the products a_lo b_hi, a_hi b_lo, a_hi b_hi added in that order
// into an accumulator that truncates, which starts from 0 every 32 channels
// and is then added to the sum rounding to nearest. out1[r]: the same with
// a_hi b_hi alone, one TF32 product.
void dots(const float* a, const float* b, int rows, int C, float* out3,
          float* out1) {
  for (int r = 0; r < rows; ++r) {
    float sum3 = 0.0f, sum1 = 0.0f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      float acc3 = 0.0f, acc1 = 0.0f;
      for (int k0 = c0; k0 < c0 + 32 && k0 < C; k0 += 8) {
        double lh = 0.0, hl = 0.0, hh = 0.0;
        for (int k = k0; k < k0 + 8 && k < C; ++k) {
          const Tf32Pair x = tf32_split(a[r * C + k]);
          const Tf32Pair y = tf32_split(b[r * C + k]);
          lh += static_cast<double>(x.lo) * y.hi;
          hl += static_cast<double>(x.hi) * y.lo;
          hh += static_cast<double>(x.hi) * y.hi;
        }
        acc3 = add_rz(add_rz(add_rz(acc3, lh), hl), hh);
        acc1 = add_rz(acc1, hh);
      }
      sum3 += acc3;
      sum1 += acc1;
    }
    out3[r] = sum3;
    out1[r] = sum1;
  }
}
}
"""


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("mma_tf32x3") / "libmma.so"
    src = out.with_suffix(".cpp")
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fragment_cover.argtypes = [i, p]
    lib.grid_cover.argtypes = [i, i, i, i, i, i, p]
    lib.grid_cover.restype = i
    lib.corr_grid_shape.argtypes = [p]
    lib.swizzled.argtypes = [i, p]
    lib.split.argtypes = [p, i, p, p]
    lib.pos_cover.argtypes = [i, i, p]
    lib.pos_cover.restype = i
    lib.trade_mismatches.restype = i
    lib.w1_cover.argtypes = [i, i, p]
    lib.w1_cover.restype = i
    lib.w1_ranges.argtypes = [i, i, i, i, p, p]
    lib.w1_ranges.restype = i
    lib.pos_items.argtypes = [i, i, i, p, p]
    lib.pos_items.restype = i
    lib.dots.argtypes = [p, p, i, i, p, p]
    lib.attn_grid_shape.argtypes = [p]
    lib.attn_runs_cover.argtypes = [i, i, i, p]
    lib.attn_runs_cover.restype = i
    lib.attn_plans.argtypes = [i, i, i, i, p, p, p]
    lib.attn_plans.restype = i
    return lib


@pytest.mark.parametrize("which,rows", [(0, 16), (1, 8), (2, 16)],
                         ids=["A", "B", "C"])
def test_fragment_maps_cover_each_element_once(harness, which, rows):
    count = np.zeros(16 * 8, np.int32)
    harness.fragment_cover(which, _ptr(count))
    assert (count[:rows * 8] == 1).all() and (count[rows * 8:] == 0).all()


@pytest.mark.parametrize("nt", [1, 2, 4, 8])
def test_warp_fwd_grid_covers_its_tile_once(harness, nt):
    """csrc/warp_fwd.cu: 8 warps as WarpGrid{4, 2, NT} over 64 positions x
    32 NT hidden units, for every NT the launcher picks."""
    rows, cols = 64, 32 * nt
    count = np.zeros(rows * cols, np.int32)
    assert harness.grid_cover(8, 4, 2, nt, rows, cols, _ptr(count)) == 0
    assert (count == 1).all()


def test_max_corr_grid_covers_its_tile_once(harness):
    shape = np.zeros(5, np.int32)
    harness.corr_grid_shape(_ptr(shape))
    warps_n, tm, tn, warps, rows = (int(v) for v in shape)
    count = np.zeros(rows * rows, np.int32)
    assert harness.grid_cover(warps, warps_n, tm, tn, rows, rows,
                              _ptr(count)) == 0
    assert (count == 1).all()


def test_swizzle_permutes_16_byte_chunks_within_each_row(harness):
    """The layout csrc/max_corr.cu copies its tiles into and names in its
    wgmma descriptors: every float of a 128 x 32 tile has its own place, a
    16-byte chunk stays whole and in its 128-byte row, and the same chunk of
    8 consecutive rows falls into 8 different 16-byte columns."""
    rows = 128
    off = np.empty(rows * 32, np.int32)
    harness.swizzled(rows, _ptr(off))
    assert sorted(off.tolist()) == list(range(0, rows * 128, 4))
    off = off.reshape(rows, 8, 4)
    assert (off[:, :, 1:] - off[:, :, :1] == [4, 8, 12]).all()
    assert (off[:, :, 0] // 128 == np.arange(rows)[:, None]).all()
    columns = off[:, :, 0] % 128 // 16                      # (rows, 8)
    for r0 in range(0, rows, 8):
        for chunk in range(8):
            assert sorted(columns[r0:r0 + 8, chunk]) == list(range(8))


def test_split_is_exact_in_hi_and_leaves_2_to_minus_22(harness):
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096)),
        [0.0, 1.0, -1.0, 1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-10,
         1 + 3 * 2.0**-11]]).astype(np.float32)
    hi, lo = np.empty_like(x), np.empty_like(x)
    harness.split(_ptr(x), x.size, _ptr(hi), _ptr(lo))
    # both parts are TF32 values: the 13 low mantissa bits are 0
    assert (hi.view(np.uint32) & 0x1FFF == 0).all()
    assert (lo.view(np.uint32) & 0x1FFF == 0).all()
    # hi is x to 11 significant bits, ties away from zero
    assert (np.abs(x - hi) <= np.abs(x) * 2.0**-11).all()
    ties = dict(zip(x[4096:].tolist(), hi[4096:].tolist()))
    assert ties[1 + 2.0**-11] == 1 + 2.0**-10
    assert ties[-(1 + 2.0**-11)] == -(1 + 2.0**-10)
    assert ties[1 + 3 * 2.0**-11] == 1 + 2.0**-9
    assert ties[1 + 2.0**-10] == 1 + 2.0**-10 and ties[0.0] == 0.0
    # what the two parts leave of x (x - hi is exact in f32)
    left = x.astype(np.float64) - hi.astype(np.float64) - lo
    assert (np.abs(left) <= np.abs(x) * 2.0**-22).all()


@pytest.mark.parametrize("C", [256, 512])
def test_split_product_keeps_f32_where_one_tf32_product_does_not(harness, C):
    """Unit-norm ReLU rows, as the correctness loss feeds max-correlation at
    relu3_1 (C=256) and relu4_1 (C=512)."""
    rng = np.random.RandomState(C)
    rows = 4096

    def unit(x):
        x = np.maximum(x, 0.0)
        return (x / np.sqrt((x * x).sum(-1, keepdims=True))).astype(
            np.float32)

    a, b = unit(rng.randn(rows, C)), unit(rng.randn(rows, C))
    b[::2] = a[::2]  # and rows against themselves: products near 1
    exact = (a.astype(np.float64) * b).sum(-1)
    out3, out1 = np.empty(rows, np.float32), np.empty(rows, np.float32)
    harness.dots(_ptr(a), _ptr(b), rows, C, _ptr(out3), _ptr(out1))
    err3 = np.abs(out3 - exact).max()
    err1 = np.abs(out1 - exact).max()
    assert err3 <= 1e-6 < CORR_ATOL < err1, (err3, err1)
    # equal rows give bitwise equal products, so exact ties stay ties
    a[1] = a[3]
    b[1] = b[3]
    harness.dots(_ptr(a), _ptr(b), rows, C, _ptr(out3), _ptr(out1))
    assert out3[1] == out3[3]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 16])
@pytest.mark.parametrize("C", [21, 128])
def test_warp_bwd_product_columns_cover_w1s_once(harness, k, C):
    """csrc/warp_bwd.cu: the d_block product's offset-major tiles (every
    fragment one offset of the band, 8 channels; above k = 9 the wide
    instance's runs of up to 8 offsets of a row) and the dW1s product's
    columns each take every (offset, channel) of W1s once."""
    for cover in (harness.pos_cover, harness.w1_cover):
        count = np.zeros(k * k * C, np.int32)
        assert cover(k, C, _ptr(count)) == 0
        assert (count == 1).all()


def test_warp_bwd_trade_leaves_one_row_and_four_channels_a_lane(harness):
    assert harness.trade_mismatches() == 0


SITES = [  # N, C, D, k: the two live sites, a 64x64 input's, ragged, and
    # the run-time instance's k at the k=5 site
    (8 * 64 * 64, 128, 128, 5), (8 * 32 * 32, 256, 128, 3),
    (2 * 16 * 16, 128, 128, 5), (2 * 12 * 10, 21, 42, 3),
    (2 * 16 * 12, 22, 40, 7), (1000, 36, 200, 1),
    (8 * 64 * 64, 128, 128, 4), (8 * 64 * 64, 128, 128, 9),
    # the wide instances' k at the pose sites and past Market's width
    (8 * 64 * 64, 128, 128, 11), (8 * 32 * 32, 256, 128, 13),
    (8 * 32 * 16, 128, 128, 17)]


@pytest.mark.parametrize("N,C,D,k", SITES)
def test_warp_bwd_splits_cover_their_work_once(harness, N, C, D, k):
    """The dW1s kernel's position ranges tile [0, N) once, in whole 32-
    position stages; the per-position kernel's splits take each (band,
    channel group) once; both grids fill the card at the live sites."""
    count = np.zeros(N, np.int32)
    info = np.zeros(3, np.int32)
    assert harness.w1_ranges(N, C, D, k, _ptr(count), _ptr(info)) == 0
    assert (count == 1).all() and info[0] % 32 == 0
    w1_ctas = info[2]
    items = 7 * 7 * 128  # more than any case has
    count = np.zeros(items, np.int32)
    assert harness.pos_items(N, C, k, _ptr(count), _ptr(info)) == 0
    assert (count[:info[0]] == 1).all() and (count[info[0]:] == 0).all()
    if N >= 8 * 32 * 32:
        assert w1_ctas >= 132 and info[2] >= 132


def test_attn_math_grid_covers_its_tile_once(harness):
    """csrc/attn_math_steps.cuh: the two warpgroups' wgmma accumulators of
    a product CTA (8 warps, each 16 rows x 16 fragments) cover its
    128 x 128 tile once."""
    shape = np.zeros(4, np.int32)
    harness.attn_grid_shape(_ptr(shape))
    warps_n, tm, tn, tile = (int(v) for v in shape)
    count = np.zeros(tile * tile, np.int32)
    assert harness.grid_cover(8, warps_n, tm, tn, tile, tile,
                              _ptr(count)) == 0
    assert (count == 1).all()


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("C", [21, 128, 256])
@pytest.mark.parametrize("width", [32, 128], ids=["fwd-depth", "bwd-items"])
def test_attn_math_runs_cover_w1_once(harness, k, C, width):
    """The forward's depth stages (runs of 32 channels) and the backward
    product's items (runs of 128) each take every row (2 m + h) C + c of
    W1 (k^2, 2C, D) once, every run inside one (offset, half)."""
    count = np.zeros(2 * k * k * C, np.int32)
    assert harness.attn_runs_cover(k * k, C, width, _ptr(count)) == 0
    assert (count == 1).all()


ATTN_SITES = [  # N, C, D, k: the two live sites, ragged, wide D, one tile
    (8 * 64 * 64, 128, 128, 5), (8 * 32 * 32, 256, 128, 3),
    (1000, 21, 42, 3), (150, 64, 256, 3), (40, 36, 64, 1)]


@pytest.mark.parametrize("N,C,D,k", ATTN_SITES)
def test_attn_math_splits_cover_their_work_once(harness, N, C, D, k):
    """The forward product's depth splits take each stage once and the
    backward product's splits each item once, none empty; at the live
    sites both grids give at least 3/4 of the H100's 132 SMs a CTA."""
    fwd = np.zeros(2 * k * k * ((C + 31) // 32), np.int32)
    bwd = np.zeros(2 * k * k * ((C + 127) // 128), np.int32)
    info = np.zeros(6, np.int32)
    assert harness.attn_plans(N, C, D, k * k, _ptr(fwd), _ptr(bwd),
                              _ptr(info)) == 0
    assert info[0] == fwd.size and info[3] == bwd.size
    assert (fwd == 1).all() and (bwd == 1).all()
    if N >= 8 * 32 * 32:
        assert info[2] >= 99 and info[5] >= 99
