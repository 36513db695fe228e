"""The port's ops against gfla_tpu's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages in f32.
Tolerances: 1e-5 abs where both sides run the same gathers and sums in f32
(block extraction, heatmaps); 2e-5 abs/rel for the attention warp, whose
3200-term dense layer and softmax sum in a different order in torch, XLA and
the Pallas interpreter.

The CUDA kernel itself runs only on the card (chip_smoke.py). Here its
index, clamp and bilinear code, csrc/warp_common.cuh, is compiled with g++
into a small shared library and checked against gfla_tpu's padded-window
prep (`_prep`, gfla_tpu/ops/pallas_warp.py:103-134) and block extraction.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.ops.block_extract import block_extract as jax_block_extract
from gfla_tpu.ops.block_extract import extract_patches as jax_extract_patches
from gfla_tpu.ops.local_attn import local_attn_warp as jax_local_attn_warp
from gfla_tpu.ops.pallas_warp import _prep, local_attn_warp_fused
from gfla_tpu_torch.ops import warp
from gfla_tpu_torch.ops.block_extract import block_extract, extract_patches
from gfla_tpu_torch.ops.local_attn import local_attn_warp, target_stream

ATOL = RTOL = 2e-5
CSRC = Path(__file__).resolve().parents[1] / "gfla_tpu_torch" / "csrc"


def _inputs(b=2, h=16, w=16, c=8, k=3, d=16, seed=0, flow_scale=1.5):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        source=rng.randn(b, h, w, c).astype(f32),
        target=rng.randn(b, h, w, c).astype(f32),
        flow=(rng.randn(b, h, w, 2) * flow_scale).astype(f32),
        w1=(rng.randn(k * k, 2 * c, d) * 0.1).astype(f32),
        b1=(rng.randn(d) * 0.1).astype(f32),
        w2=(rng.randn(d, k * k) * 0.1).astype(f32),
        b2=(rng.randn(k * k) * 0.1).astype(f32),
    )


def _jax(a):
    return {n: jnp.asarray(v) for n, v in a.items()}


def _torch(a):
    return {n: torch.from_numpy(v) for n, v in a.items()}


def _port(a, k, **kw):
    t = _torch(a)
    return local_attn_warp(t["source"], t["target"], t["flow"], k, t["w1"],
                           t["b1"], t["w2"], t["b2"], **kw)


WARP_CASES = [  # k, c, d, flow scale, seed
    pytest.param(3, 8, 16, 1.5, 0, id="k3"),
    pytest.param(5, 8, 16, 1.5, 1, id="k5"),
    pytest.param(3, 8, 16, 60.0, 2, id="k3-far-flow"),  # |flow| to ~2.5 H+
]


@pytest.mark.parametrize("k,c,d,scale,seed", WARP_CASES)
def test_warp_matches_xla_composition(k, c, d, scale, seed):
    a = _inputs(c=c, k=k, d=d, seed=seed, flow_scale=scale)
    j = _jax(a)
    want = jax_local_attn_warp(j["source"], j["target"], j["flow"], k,
                               j["w1"], j["b1"], j["w2"], j["b2"],
                               use_pallas=False)
    np.testing.assert_allclose(_port(a, k).numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,c,d,scale,seed", WARP_CASES)
def test_warp_matches_pallas_kernel_interpreted(k, c, d, scale, seed):
    a = _inputs(c=c, k=k, d=d, seed=seed, flow_scale=scale)
    j = _jax(a)
    want = local_attn_warp_fused(j["source"], j["target"], j["flow"], k,
                                 j["w1"], j["b1"], j["w2"], j["b2"],
                                 interpret=True)
    np.testing.assert_allclose(_port(a, k).numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_warp_return_attn_matches_jax():
    a = _inputs(k=5, seed=3)
    j = _jax(a)
    attn_j, out_j = jax_local_attn_warp(
        j["source"], j["target"], j["flow"], 5, j["w1"], j["b1"], j["w2"],
        j["b2"], return_attn=True, use_pallas=False)
    attn, out = _port(a, 5, return_attn=True)
    assert attn.shape == (2, 16, 16, 25)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)


def test_plain_warp_equals_composite_and_target_stream_is_a_conv():
    """On the CPU the dispatcher runs the kernel's plain twin behind the
    target-stream conv; it equals the full composite of the reference
    formulation (concat [target || source] blocks, dense, softmax, sum)."""
    a = _inputs(k=3, seed=4)
    t = _torch(a)
    fused = _port(a, 3)
    composite = _port(a, 3, activation=torch.nn.SELU())  # no kernel: composite
    assert not torch.allclose(fused, composite)  # the activation matters
    composite_leaky = _port(a, 3, return_attn=True)[1]
    torch.testing.assert_close(fused, composite_leaky, rtol=RTOL, atol=ATOL)
    hbt = target_stream(t["target"], t["w1"], t["b1"], 3)
    blocks = extract_patches(t["target"], 3).reshape(2, 256, 9 * 8)
    want = blocks @ t["w1"][:, :8, :].reshape(9 * 8, 16) + t["b1"]
    torch.testing.assert_close(hbt, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,scale", [(3, 1.5), (5, 2.0), (4, 40.0)])
def test_block_extract_matches_jax(k, scale):
    rng = np.random.RandomState(k)
    src = rng.randn(2, 9, 11, 5).astype(np.float32)
    flow = (rng.randn(2, 9, 11, 2) * scale).astype(np.float32)
    want = jax_block_extract(jnp.asarray(src), jnp.asarray(flow), k)
    got = block_extract(torch.from_numpy(src), torch.from_numpy(flow), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want_p = jax_extract_patches(jnp.asarray(src), k)
    got_p = extract_patches(torch.from_numpy(src), k)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_warp_fwd_plain_on_cpu_without_launch():
    """A CPU tensor runs the plain version and leaves the launch count."""
    a = _inputs(k=3, seed=5)
    t = _torch(a)
    hbt = target_stream(t["target"], t["w1"], t["b1"], 3)
    w1s = t["w1"][:, 8:, :].reshape(72, 16)
    before = warp.launches
    out = warp.warp_fwd(t["source"], t["flow"], hbt, w1s, t["w2"], t["b2"], 3)
    assert warp.launches == before
    torch.testing.assert_close(out, warp.warp_fwd_plain(
        t["source"], t["flow"], hbt, w1s, t["w2"], t["b2"], 3))


# ---------------------------------------------------------------------------
# csrc/warp_common.cuh on the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "warp_common.cuh"
extern "C" {
// rows/cols: (N, k+1) clamped footprint taps; wy/wx: (N,) weights
void footprints(const float* flow, int B, int H, int W, int k, int* rows,
                int* cols, float* wy, float* wx) {
  for (int p = 0; p < B * H * W; ++p) {
    const int y = (p / W) % H, x = p % W;
    const gfla::Footprint f =
        gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    for (int i = 0; i <= k; ++i) {
      rows[p * (k + 1) + i] = gfla::tap_row(f, i, H);
      cols[p * (k + 1) + i] = gfla::tap_col(f, i, W);
    }
    wy[p] = f.wy;
    wx[p] = f.wx;
  }
}
// out: (N, k*k, C) bilinear blocks
void blocks(const float* src, const float* flow, int B, int H, int W, int C,
            int k, float* out) {
  for (int p = 0; p < B * H * W; ++p) {
    const int b = p / (H * W), y = (p / W) % H, x = p % W;
    const gfla::Footprint f =
        gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    const gfla::TapWeights w = gfla::tap_weights(f.wy, f.wx);
    const float* img = src + (size_t)b * H * W * C;
    for (int m = 0; m < k * k; ++m) {
      const int r0 = gfla::tap_row(f, m / k, H);
      const int r1 = gfla::tap_row(f, m / k + 1, H);
      const int c0 = gfla::tap_col(f, m % k, W);
      const int c1 = gfla::tap_col(f, m % k + 1, W);
      for (int c = 0; c < C; ++c)
        out[(p * k * k + m) * C + c] =
            w.tl * img[(r0 * W + c0) * C + c] +
            w.tr * img[(r0 * W + c1) * C + c] +
            w.bl * img[(r1 * W + c0) * C + c] +
            w.br * img[(r1 * W + c1) * C + c];
    }
  }
}
}
"""


@pytest.fixture(scope="module")
def header_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("warp_common") / "libwarp_common.so"
    src = out.with_suffix(".cpp")
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.footprints.argtypes = [p, i, i, i, i, p, p, p, p]
    lib.blocks.argtypes = [p, p, i, i, i, i, i, p]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("k,scale", [(3, 1.5), (5, 3.0), (5, 40.0), (7, 9.0)])
def test_header_taps_match_pallas_prep(header_lib, k, scale):
    """Clamping each tap into the unpadded image reproduces the Pallas
    kernel's edge-padded source and clipped window start, for flows far off
    the image too."""
    B, H, W = 2, 9, 13
    rng = np.random.RandomState(k)
    flow = (rng.randn(B, H, W, 2) * scale).astype(np.float32)
    N = B * H * W
    rows = np.zeros((N, k + 1), np.int32)
    cols = np.zeros((N, k + 1), np.int32)
    wy = np.zeros(N, np.float32)
    wx = np.zeros(N, np.float32)
    header_lib.footprints(_ptr(flow), B, H, W, k, _ptr(rows), _ptr(cols),
                          _ptr(wy), _ptr(wx))
    src = jnp.zeros((B, H, W, 1), jnp.float32)
    _, by, bx, wy_j, wx_j = _prep(src, jnp.asarray(flow), k)
    offs = np.arange(k + 1)
    # padded row by + i holds image row clamp(by + i - P, 0, H - 1), P = k
    want_rows = np.clip(np.asarray(by).reshape(N, 1) + offs - k, 0, H - 1)
    want_cols = np.clip(np.asarray(bx).reshape(N, 1) + offs - k, 0, W - 1)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(cols, want_cols)
    np.testing.assert_array_equal(wy, np.asarray(wy_j).reshape(N))
    np.testing.assert_array_equal(wx, np.asarray(wx_j).reshape(N))


@pytest.mark.parametrize("k,scale", [(3, 2.0), (5, 30.0)])
def test_header_blocks_match_block_extract(header_lib, k, scale):
    B, H, W, C = 2, 8, 10, 3
    rng = np.random.RandomState(10 + k)
    src = rng.randn(B, H, W, C).astype(np.float32)
    flow = (rng.randn(B, H, W, 2) * scale).astype(np.float32)
    out = np.zeros((B * H * W, k * k, C), np.float32)
    header_lib.blocks(_ptr(src), _ptr(flow), B, H, W, C, k, _ptr(out))
    want = jax_block_extract(jnp.asarray(src), jnp.asarray(flow), k)
    np.testing.assert_allclose(out.reshape(B, H, W, k * k, C),
                               np.asarray(want), atol=1e-5)
