"""The warp backward's footprint-cell steps and its saved hpre, on the CPU.

csrc/warp_bwd.cu's per-position kernel starts from the forward's
pre-activation hidden layer hpre (stored by csrc/warp_fwd.cu) instead of
recomputing it, and works on the (k+1)^2 footprint cells of each position
instead of its k^2 blended blocks (csrc/warp_cells.cuh). Here a g++ harness
runs the cell form of d_attn, the blend of the cell dots <src[cell], g>,
over every position: it must give (1/k^2) <block, g> within 1e-5 x its
largest |value| (f32 sums in another order), at odd and even k up to 9 (an
even block's footprint starts one further up and left) and at k = 10, 11
and 16, where the wide instances take over, also at far-off flows (scale
40) that clamp whole footprints onto the border, where cells share a pixel.
The wide forward's steps run there too: the footprint pixels computed
where they are used (`cell_pixel`, which the wide kernels read in place of
the narrow ones' tables) and the weighted sum over the cells with each
cell's weight made from the attention weights (`cell_coef`), against the
plain twin's output at k = 10, 11 and 16.
The cell pre-sum into d_source and d_flow is held against gfla_tpu's
`_core_bwd` in tests/test_torch_port_warp_bwd.py.

The plain backward given a saved hpre equals the one that recomputes it
(bitwise: the same torch ops), and `WarpFunction` saves hpre in place of
hidden_bt, its gradients held against `jax.vjp` of `attn_warp_core`.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.ops.pallas_warp import attn_warp_core
from gfla_tpu_torch.ops import warp
from gfla_tpu_torch.ops.block_extract import block_extract
from gfla_tpu_torch.ops.local_attn import target_stream

CSRC = Path(__file__).resolve().parents[1] / "gfla_tpu_torch" / "csrc"
GRAD_REL = 1e-4
DATTN_REL = 1e-5

HARNESS = r"""
#include <vector>
#include "warp_cells.cuh"
using namespace gfla;
extern "C" {
// d_attn (B*H*W, k*k) = (1/k^2) <block, g> from each position's cell dots
void cell_dattn_all(const float* src, const float* flow, const float* g,
                    int B, int H, int W, int C, int k, float* dattn) {
  const int k1 = k + 1;
  std::vector<float> cdot(k1 * k1);  // (k + 1)^2 cells
  for (int p = 0; p < B * H * W; ++p) {
    const int b = p / (H * W), y = (p / W) % H, x = p % W;
    const Footprint f = footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    for (int r = 0; r < k1; ++r) {
      for (int s = 0; s < k1; ++s) {
        const float* px = src + ((size_t)(b * H + tap_row(f, r, H)) * W +
                                 tap_col(f, s, W)) * C;
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc += px[c] * g[(size_t)p * C + c];
        cdot[r * k1 + s] = acc;
      }
    }
    const TapWeights w = tap_weights(f.wy, f.wx);
    for (int m = 0; m < k * k; ++m) {
      dattn[(size_t)p * k * k + m] =
          cell_dattn(cdot.data(), k1, w, m / k, m % k) / (float)(k * k);
    }
  }
}

// The wide forward's output from the attention weights att (B*H*W, k*k):
// out = sum over the (k+1)^2 cells of cell_coef x src[cell_pixel].
void wide_out(const float* src, const float* flow, const float* att, int B,
              int H, int W, int C, int k, float* out) {
  for (int p = 0; p < B * H * W; ++p) {
    const int b = p / (H * W), y = (p / W) % H, x = p % W;
    const Footprint f = footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    const TapWeights w = tap_weights(f.wy, f.wx);
    for (int r = 0; r <= k; ++r) {
      for (int s = 0; s <= k; ++s) {
        const float coef = cell_coef(att + (size_t)p * k * k, k, w, r, s);
        const float* px = src + (size_t)cell_pixel(f, b, r, s, H, W) * C;
        for (int c = 0; c < C; ++c) out[(size_t)p * C + c] += coef * px[c];
      }
    }
  }
}

// cell_pixel of every footprint cell of every position: (B*H*W, k+1, k+1)
void cell_pixels(const float* flow, int B, int H, int W, int k, int* pix) {
  for (int p = 0; p < B * H * W; ++p) {
    const int b = p / (H * W), y = (p / W) % H, x = p % W;
    const Footprint f = footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    for (int r = 0; r <= k; ++r) {
      for (int s = 0; s <= k; ++s) {
        pix[((size_t)p * (k + 1) + r) * (k + 1) + s] =
            cell_pixel(f, b, r, s, H, W);
      }
    }
  }
}
}
"""


def _inputs(k, c=8, d=16, b=2, h=16, w=16, flow_scale=1.5, seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    src = rng.randn(b, h, w, c).astype(f32)
    tgt = rng.randn(b, h, w, c).astype(f32)
    flow = (rng.randn(b, h, w, 2) * flow_scale).astype(f32)
    w1 = torch.from_numpy((rng.randn(k * k, 2 * c, d) * 0.2).astype(f32))
    b1 = torch.from_numpy((rng.randn(d) * 0.1).astype(f32))
    hbt = target_stream(torch.from_numpy(tgt), w1, b1, k)
    w1s = w1[:, c:, :].reshape(k * k * c, d).contiguous()
    w2 = torch.from_numpy((rng.randn(d, k * k) * 0.3).astype(f32))
    b2 = torch.from_numpy((rng.randn(k * k) * 0.1).astype(f32))
    g = rng.randn(b, h, w, c).astype(f32)
    return (torch.from_numpy(src), torch.from_numpy(flow), hbt, w1s, w2,
            b2), torch.from_numpy(g)


def _core_vjp(args, g, k):
    """gfla_tpu's custom VJP of the warp core, Pallas kernels interpreted:
    the cotangents of (source, flow, hidden_bt, w1s, w2, b2)."""
    def core(*xs):
        return attn_warp_core(*xs, k, 0.1, True)

    _, vjp = jax.vjp(core, *(jnp.asarray(t.detach().numpy()) for t in args))
    return [np.asarray(x) for x in vjp(jnp.asarray(g.numpy()))]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("warp_cells") / "libwarp_cells.so"
    src = out.with_suffix(".cpp")
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cell_dattn_all.argtypes = [p, p, p] + [i] * 5 + [p]
    lib.wide_out.argtypes = [p, p, p] + [i] * 5 + [p]
    lib.cell_pixels.argtypes = [p] + [i] * 4 + [p]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


CASES = [  # k, flow scale; even k reach one row and column further up-left
    pytest.param(3, 1.5, id="k3"),
    pytest.param(5, 1.5, id="k5"),
    pytest.param(7, 1.5, id="k7"),
    pytest.param(3, 40.0, id="k3-far-flow"),
    pytest.param(5, 40.0, id="k5-far-flow"),
    pytest.param(7, 40.0, id="k7-far-flow"),
    pytest.param(2, 1.5, id="k2"),
    pytest.param(4, 1.5, id="k4"),
    pytest.param(9, 1.5, id="k9"),
    pytest.param(2, 40.0, id="k2-far-flow"),
    pytest.param(4, 40.0, id="k4-far-flow"),
    pytest.param(9, 40.0, id="k9-far-flow"),
    pytest.param(10, 1.5, id="k10"),
    pytest.param(11, 1.5, id="k11"),
    pytest.param(16, 1.5, id="k16"),
    pytest.param(11, 40.0, id="k11-far-flow"),
    pytest.param(16, 40.0, id="k16-far-flow"),
]
WIDE_CASES = CASES[-5:]  # the wide instances' k


@pytest.mark.parametrize("k,scale", CASES)
def test_cell_dattn_matches_block_dots(harness, k, scale):
    args, g = _inputs(k, flow_scale=scale, seed=k + int(scale))
    src, flow = args[0], args[1]
    B, H, W, C = src.shape
    blocks = block_extract(src, flow, k).reshape(B * H * W, k * k, C)
    want = (torch.einsum("nkc,nc->nk", blocks.double(),
                         g.reshape(-1, C).double()) / (k * k)).numpy()
    got = np.zeros((B * H * W, k * k), np.float32)
    harness.cell_dattn_all(_ptr(src.numpy()), _ptr(flow.numpy()),
                           _ptr(g.numpy()), B, H, W, C, k, _ptr(got))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DATTN_REL * np.abs(want).max())


@pytest.mark.parametrize("k,scale", WIDE_CASES)
def test_wide_forward_cells_match_plain_twin(harness, k, scale):
    """The wide forward's weighted sum over the footprint cells, from the
    plain twin's attention weights, is its output (1e-5 x max: f32 sums in
    another order), and each cell's pixel is the one block_extract reads."""
    from gfla_tpu_torch.ops.block_extract import patch_index

    args, _ = _inputs(k, flow_scale=scale, seed=60 + k + int(scale))
    src, flow, hbt, w1s, w2, b2 = args
    B, H, W, C = src.shape
    blocks = block_extract(src, flow, k).reshape(B, H * W, k * k * C)
    hidden = torch.nn.functional.leaky_relu(blocks @ w1s + hbt, 0.1)
    att = torch.softmax(hidden @ w2 + b2, dim=-1).reshape(B * H * W, k * k)
    want = warp.warp_fwd_plain(*args, k).reshape(B * H * W, C).numpy()
    got = np.zeros((B * H * W, C), np.float32)
    harness.wide_out(_ptr(src.numpy()), _ptr(flow.numpy()),
                     _ptr(np.ascontiguousarray(att.numpy())), B, H, W, C, k,
                     _ptr(got))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DATTN_REL * np.abs(want).max())
    flat = patch_index(flow, H, W, k)[0] + (torch.arange(B) * H * W)[
        :, None, None, None, None]
    pix = np.zeros((B * H * W, k + 1, k + 1), np.int32)
    harness.cell_pixels(_ptr(flow.numpy()), B, H, W, k, _ptr(pix))
    np.testing.assert_array_equal(pix.reshape(flat.shape), flat.numpy())


@pytest.mark.parametrize("k,scale", [(3, 1.5), (5, 40.0)], ids=["k3", "k5-far"])
def test_plain_bwd_from_saved_hpre(k, scale):
    """From the forward's hpre the plain backward is the recomputing one,
    and gfla_tpu's `_core_bwd`."""
    args, g = _inputs(k, flow_scale=scale, seed=40 + k)
    out, hpre = warp.warp_fwd_plain(*args, k, with_hpre=True)
    torch.testing.assert_close(out, warp.warp_fwd_plain(*args, k),
                               rtol=0, atol=0)
    assert tuple(hpre.shape) == (args[0].shape[0] * 16 * 16, 16)
    from_hpre = warp.warp_bwd_plain(*args, g, k, hpre=hpre)
    recomputed = warp.warp_bwd_plain(*args, g, k)
    without_hbt = warp.warp_bwd_plain(args[0], args[1], None, *args[3:], g, k,
                                      hpre=hpre)
    for a, b, c in zip(from_hpre, recomputed, without_hbt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    want = _core_vjp(args, g, k)
    for name, got, w in zip(("source", "flow", "hidden_bt", "w1s", "w2",
                             "b2"), from_hpre, want):
        np.testing.assert_allclose(got.reshape(w.shape).numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


def test_warp_function_saves_hpre_not_hidden_bt():
    k = 5
    args, g = _inputs(k, seed=50)
    leaves = [t.clone().requires_grad_() for t in args]
    out = warp.warp_fwd(*leaves, k)
    saved = out.grad_fn.saved_tensors
    hpre = warp.warp_fwd_plain(*args, k, with_hpre=True)[1]
    assert any(t.shape == hpre.shape and torch.equal(t, hpre) for t in saved)
    assert not any(t.shape == args[2].shape and torch.equal(t, args[2])
                   for t in saved)
    out.backward(g)
    want = _core_vjp(args, g, k)
    for name, leaf, w in zip(("source", "flow", "hidden_bt", "w1s", "w2",
                              "b2"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)
