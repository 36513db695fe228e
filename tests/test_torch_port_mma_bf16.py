"""The bf16 building block of the warp kernels' bf16 instances, on the CPU.

csrc/mma_bf16.cuh keeps the rounding to bf16, the packing of two bf16 values
into an operand register and the fragment maps of one mma.sync m16n8k16
product in `__host__ __device__` functions. They are compiled here with g++
into a small harness:

- the rounding (nearest, ties to even, on the bits) gives torch's
  `.bfloat16()` bits for normal numbers, exact ties either way, subnormals,
  the largest finite values (which round to inf), zeros and infinities, and
  a NaN for a NaN;
- the fragment maps of A (16 x 16) and B (16 x 8) cover each element once;
- a warp's product, emulated lane by lane from the PTX ISA's description of
  the m16n8k16 .bf16 fragments (written out in the harness, apart from the
  header), over the three ways the kernels load their operands (A rows with
  the depth innermost and B with the columns innermost, as warp_fwd.cu; B
  with the depth innermost, as the per-position backward; both with the
  depth outermost, as the dW1s kernel), equals the float64 product of the
  bf16-rounded operands within f32 accumulation (1e-6 relative), and is off
  the f32 operands' product by the bf16 rounding.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

CSRC = Path(__file__).resolve().parents[1] / "gfla_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdint>
#include "mma_bf16.cuh"
using namespace gfla;

// One m16n8k16 product of a warp, from the PTX ISA's fragment layout for
// .bf16 (groupID = lane >> 2, threadID_in_group = lane % 4): A element i of
// 8 (register i / 2, half i % 2) lies at row groupID (+8 for i in 2,3,6,7),
// column 2 threadID_in_group + (i & 1) (+8 for i >= 4); B element i of 4 at
// row 2 threadID_in_group + (i & 1) (+8 for i >= 2), column groupID; C
// element i of 4 at row groupID (+8 for i >= 2), column 2 threadID_in_group
// + (i & 1). d += a . b, summed in double and added in f32.
static void emulate_mma(const uint32_t (*a)[4], const uint32_t (*b)[2],
                        float (*d)[4]) {
  double A[16][16], B[16][8];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 8; ++i) {
      const uint32_t reg = a[lane][i / 2];
      const uint16_t half = (i & 1) ? reg >> 16 : reg & 0xffffu;
      const int row = g + ((i == 2 || i == 3 || i == 6 || i == 7) ? 8 : 0);
      const int col = 2 * t + (i & 1) + (i >= 4 ? 8 : 0);
      A[row][col] = bf16_float(half);
    }
    for (int i = 0; i < 4; ++i) {
      const uint32_t reg = b[lane][i / 2];
      const uint16_t half = (i & 1) ? reg >> 16 : reg & 0xffffu;
      B[2 * t + (i & 1) + (i >= 2 ? 8 : 0)][g] = bf16_float(half);
    }
  }
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 4; ++i) {
      const int row = g + (i >= 2 ? 8 : 0), col = 2 * t + (i & 1);
      double s = 0.0;
      for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
      d[lane][i] += static_cast<float>(s);
    }
  }
}

extern "C" {
void round_bits(const float* x, int n, uint16_t* out) {
  for (int i = 0; i < n; ++i) out[i] = bf16_bits(x[i]);
}

// which: 0 A (16 x 16), 1 B (16 deep x 8). Counts how often each element
// (row-major) is held by a (lane, register, half).
void fragment_cover(int which, int* count) {
  for (int lane = 0; lane < 32; ++lane) {
    for (int r = 0; r < (which ? 2 : 4); ++r) {
      for (int h = 0; h < 2; ++h) {
        if (which == 0) {
          ++count[mma16_a_row(lane, r) * 16 + mma16_a_depth(lane, r, h)];
        } else {
          ++count[mma16_b_depth(lane, r, h) * 8 + mma16_b_col(lane)];
        }
      }
    }
  }
}

// out (16 x 8) = A (16 x K) . B (K x 8), one warp, K a multiple of 16, the
// operands rounded to bf16 as the kernels round them and held in floats.
// layout 0: A[row][k], B[k][col] (warp_fwd.cu); 1: A[row][k], B[col][k]
// (the per-position backward); 2: A[k][row], B[k][col] (the dW1s kernel).
void walk(int layout, int K, const float* A, const float* B, float* out) {
  float a_st[16 * 512], b_st[8 * 512];
  for (int i = 0; i < 16 * K; ++i) a_st[i] = bf16_round(A[i]);
  for (int i = 0; i < 8 * K; ++i) b_st[i] = bf16_round(B[i]);
  auto at_a = [&](int row, int k) {
    return layout == 2 ? a_st[k * 16 + row] : a_st[row * K + k];
  };
  auto at_b = [&](int k, int col) {
    return layout == 1 ? b_st[col * K + k] : b_st[k * 8 + col];
  };
  float d[32][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[32][4], b[32][2];
    for (int lane = 0; lane < 32; ++lane) {
      for (int r = 0; r < 4; ++r) {
        const int row = mma16_a_row(lane, r);
        a[lane][r] = pack_bf16x2(at_a(row, k0 + mma16_a_depth(lane, r, 0)),
                                 at_a(row, k0 + mma16_a_depth(lane, r, 1)));
      }
      for (int r = 0; r < 2; ++r) {
        const int col = mma16_b_col(lane);
        b[lane][r] = pack_bf16x2(at_b(k0 + mma16_b_depth(lane, r, 0), col),
                                 at_b(k0 + mma16_b_depth(lane, r, 1), col));
      }
    }
    emulate_mma(a, b, d);
  }
  for (int lane = 0; lane < 32; ++lane) {
    for (int e = 0; e < 4; ++e) {
      out[mma_c_row(lane, e) * 8 + mma_c_col(lane, e)] = d[lane][e];
    }
  }
}
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("mma_bf16") / "libmma_bf16.so"
    src = out.with_suffix(".cpp")
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.round_bits.argtypes = [p, i, p]
    lib.fragment_cover.argtypes = [i, p]
    lib.walk.argtypes = [i, i, p, p, p]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bits(f32):
    """The bit patterns of float32 values, as int32."""
    return np.asarray(f32, np.float32).view(np.int32)


def _values():
    rng = np.random.RandomState(0)
    bits = [
        0x3f808000,  # 1 + 2^-8: a tie, kept part even -> down
        0x3f818000,  # 1 + 3 2^-8: a tie, kept part odd -> up
        0xbf818000,  # negative tie, up in magnitude
        0x3f808001, 0x3f807fff,  # just above / below a tie
        0x00000001, 0x00008000, 0x00018000, 0x007fffff, 0x807fffff,
        0x00400000,  # subnormals, ties among them
        0x7f7fffff, 0xff7fffff,  # the largest finite -> inf
        0x7f7f7fff,  # the largest that stays finite
        0x00000000, 0x80000000, 0x7f800000, 0xff800000,  # zeros, infinities
    ]
    special = np.array(bits, np.uint32).view(np.float32)
    scaled = (rng.randn(2000) * np.exp(rng.uniform(-30, 30, 2000))).astype(
        np.float32)
    return np.concatenate([special, scaled, rng.randn(500).astype(
        np.float32)])


def test_rounding_is_torchs(harness):
    x = _values()
    got = np.zeros(len(x), np.uint16)
    harness.round_bits(_ptr(x), len(x), _ptr(got))
    want = torch.from_numpy(x).bfloat16().view(torch.int16).numpy().view(
        np.uint16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sign", [1, -1])
def test_nan_stays_nan(harness, sign):
    x = np.array([sign * np.nan, np.float32(np.uint32(0x7f800001).view(
        np.float32))], np.float32)
    got = np.zeros(2, np.uint16)
    harness.round_bits(_ptr(x), 2, _ptr(got))
    back = (got.astype(np.uint32) << 16).view(np.float32)
    assert np.isnan(back).all()
    assert torch.from_numpy(x).bfloat16().isnan().all()


@pytest.mark.parametrize("which,shape", [(0, (16, 16)), (1, (16, 8))],
                         ids=["A", "B"])
def test_fragment_maps_cover_once(harness, which, shape):
    count = np.zeros(shape, np.int32)
    harness.fragment_cover(which, _ptr(count))
    np.testing.assert_array_equal(count, np.ones(shape, np.int32))


@pytest.mark.parametrize("layout", [0, 1, 2],
                         ids=["fwd", "bwd-pos", "bwd-dw1s"])
@pytest.mark.parametrize("K", [16, 128, 512])
def test_warp_product_is_the_bf16_product(harness, layout, K):
    rng = np.random.RandomState(layout * 1000 + K)
    A = rng.randn(16, K).astype(np.float32)
    B = rng.randn(K, 8).astype(np.float32)
    a_in = np.ascontiguousarray(A.T if layout == 2 else A)
    b_in = np.ascontiguousarray(B.T if layout == 1 else B)
    out = np.zeros((16, 8), np.float32)
    harness.walk(layout, K, _ptr(a_in), _ptr(b_in), _ptr(out))
    a16 = torch.from_numpy(A).bfloat16().double().numpy()
    b16 = torch.from_numpy(B).bfloat16().double().numpy()
    want = a16 @ b16
    scale = np.abs(a16) @ np.abs(b16)
    assert np.abs(out - want).max() <= 1e-6 * scale.max()
    # and the rounding to bf16 happened: the f32 operands' product differs
    exact = A.astype(np.float64) @ B.astype(np.float64)
    assert np.abs(out - exact).max() > 1e-4 * scale.max()
