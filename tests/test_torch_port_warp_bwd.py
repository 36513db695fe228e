"""The warp's backward against gfla_tpu's custom VJP, on the CPU.

`WarpFunction` (forward `warp_fwd`, backward `warp_bwd`) runs its plain twins
here; its gradients for all seven inputs of `local_attn_warp` are held
against `jax.vjp` of gfla_tpu's `local_attn_warp_fused` with the Pallas
kernels interpreted, under a random (non-symmetric) cotangent. Tolerance:
1e-4 x the largest |gradient| of each input (f32; the sums run in other
orders in torch, XLA and the Pallas interpreter; at most 1.1e-6 observed).

The CUDA kernels run only on the card (chip_smoke.py); the per-position
kernel's scatter into d_source and its d_flow, pre-summed over each
position's (k+1)^2 footprint cells in bands of offset rows
(csrc/warp_cells.cuh, csrc/warp_common.cuh), are compiled here with g++ and
fed the block cotangents of the plain backward: they must equal what
gfla_tpu's `_core_bwd` returns, with the kernel's bands and with others,
and at far-off flows (scale 40) that clamp cells onto one pixel. The wide
instances' bands (k = 10, 11 and 16: runs of up to 8 offsets of one row,
csrc/warp_bwd_tiles.cuh's `wide_band`, each cell's offsets by
csrc/warp_cells.cuh's `band_tap`) are held against the plain twin's
`block_extract_bwd`, since gfla_tpu's kernel is not its own function above
k = 8 (tests/test_torch_port_kernel_sizes.py).
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

from gfla_tpu.ops.pallas_warp import attn_warp_core, local_attn_warp_fused
from gfla_tpu_torch.ops import warp
from gfla_tpu_torch.ops.local_attn import local_attn_warp, target_stream

CSRC = Path(__file__).resolve().parents[1] / "gfla_tpu_torch" / "csrc"
GRAD_REL = 1e-4
NAMES = ("source", "target", "flow", "w1", "b1", "w2", "b2")


def _inputs(k, c=8, d=16, b=2, h=16, w=16, flow_scale=1.5, seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        source=rng.randn(b, h, w, c).astype(f32),
        target=rng.randn(b, h, w, c).astype(f32),
        flow=(rng.randn(b, h, w, 2) * flow_scale).astype(f32),
        w1=(rng.randn(k * k, 2 * c, d) * 0.2).astype(f32),
        b1=(rng.randn(d) * 0.1).astype(f32),
        w2=(rng.randn(d, k * k) * 0.3).astype(f32),
        b2=(rng.randn(k * k) * 0.1).astype(f32),
    ), rng.randn(b, h, w, c).astype(f32)


CASES = [  # k, flow scale, seed
    pytest.param(3, 1.5, 0, id="k3"),
    pytest.param(5, 1.5, 1, id="k5"),
    pytest.param(3, 40.0, 2, id="k3-far-flow"),
    pytest.param(5, 40.0, 3, id="k5-far-flow"),
]


@pytest.mark.parametrize("k,scale,seed", CASES)
def test_warp_grads_match_pallas_vjp(k, scale, seed):
    a, g = _inputs(k, flow_scale=scale, seed=seed)

    def f(source, target, flow, w1, b1, w2, b2):
        return local_attn_warp_fused(source, target, flow, k, w1, b1, w2, b2,
                                     interpret=True)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in NAMES))
    want = vjp(jnp.asarray(g))

    t = {n: torch.from_numpy(a[n]).requires_grad_() for n in NAMES}
    before = (warp.launches, warp.bwd_pos_launches, warp.bwd_w1_launches)
    out = local_attn_warp(t["source"], t["target"], t["flow"], k, t["w1"],
                          t["b1"], t["w2"], t["b2"])
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    assert (warp.launches, warp.bwd_pos_launches,
            warp.bwd_w1_launches) == before  # CPU: plain twins, no launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)
    for name, w in zip(NAMES, want):
        got = t[name].grad.numpy()
        w = np.asarray(w)
        scale_ = np.abs(w).max()
        assert scale_ > 0, name
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_REL * scale_,
                                   err_msg=name)


def test_warp_function_gradcheck_f64():
    """Analytic backward against finite differences, with flow fractions in
    [0.3, 0.7] so that no perturbation crosses a floor."""
    rng = np.random.RandomState(7)
    k, B, H, W, C, D = 3, 1, 4, 5, 2, 3
    flow = (rng.randint(-2, 3, (B, H, W, 2))
            + rng.uniform(0.3, 0.7, (B, H, W, 2)))
    args = [rng.randn(B, H, W, C), flow, rng.randn(B, H * W, D),
            rng.randn(k * k * C, D) * 0.5, rng.randn(D, k * k) * 0.5,
            rng.randn(k * k) * 0.1]
    args = [torch.from_numpy(np.asarray(x, np.float64)).requires_grad_()
            for x in args]
    assert torch.autograd.gradcheck(
        lambda *x: warp.WarpFunction.apply(*x, k, 0.1), args, eps=1e-6,
        atol=1e-6)


def test_warp_fwd_needs_no_grad_for_plain_serving():
    """Without grad the call bypasses the Function (no graph is built)."""
    a, _ = _inputs(3)
    t = {n: torch.from_numpy(a[n]) for n in NAMES}
    hbt = target_stream(t["target"], t["w1"], t["b1"], 3)
    w1s = t["w1"][:, 8:, :].reshape(9 * 8, 16)
    with torch.no_grad():
        out = warp.warp_fwd(t["source"].requires_grad_(), t["flow"], hbt,
                            w1s, t["w2"], t["b2"], 3)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# g++ harness of the backward's footprint-cell code (csrc/warp_cells.cuh)
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "warp_bwd_tiles.cuh"
#include "warp_cells.cuh"
using namespace gfla;
extern "C" {
// The same in the wide instance's bands: runs of up to kWideCols offsets of
// one offset row, each over its 2 x (cols + 1) cells.
void scatter_wide(const float* src, const float* flow, const float* db,
                  int B, int H, int W, int C, int k, float* dsrc,
                  float* dflow) {
  const int k2 = k * k;
  for (int p = 0; p < B * H * W; ++p) {
    const int b = p / (H * W), y = (p / W) % H, x = p % W;
    const Footprint f = footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    TapCoef coef[4];
    for (int role = 0; role < 4; ++role) coef[role] = tap_coef(role, f.wy, f.wx);
    float sy = 0.0f, sx = 0.0f;
    for (int band = 0; band < wide_bands(k); ++band) {
      const WideBand wb = wide_band(k, band);
      for (int r = 0; r <= 1; ++r) {
        for (int s = 0; s <= wb.cols; ++s) {
          const size_t pix = cell_pixel(f, b, wb.i + r, wb.j0 + s, H, W);
          for (int c = 0; c < C; ++c) {
            float vd = 0.0f, vy = 0.0f, vx = 0.0f;
            for (int role = 0; role < 4; ++role) {
              const int nt = band_tap(role, r, s, wb.cols);
              if (nt < 0) continue;
              const int m = wb.i * k + wb.j0 + nt;
              const float v = db[((size_t)p * k2 + m) * C + c];
              vd += coef[role].d * v;
              vy += coef[role].y * v;
              vx += coef[role].x * v;
            }
            dsrc[pix * C + c] += vd;
            sy += src[pix * C + c] * vy;
            sx += src[pix * C + c] * vx;
          }
        }
      }
    }
    dflow[2 * p] = sx;
    dflow[2 * p + 1] = sy;
  }
}

// d_blocks (B*H*W, k*k, C) -> d_source (+=) and d_flow (x, y): per band of
// `band_rows` offset rows, each of its cells gets the tap-weighted sum of
// the d_block values of the offsets that use it.
void scatter(const float* src, const float* flow, const float* db, int B,
             int H, int W, int C, int k, int band_rows, float* dsrc,
             float* dflow) {
  const int k2 = k * k;
  for (int p = 0; p < B * H * W; ++p) {
    const int b = p / (H * W), y = (p / W) % H, x = p % W;
    const Footprint f = footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, k);
    TapCoef coef[4];
    for (int role = 0; role < 4; ++role) coef[role] = tap_coef(role, f.wy, f.wx);
    float sy = 0.0f, sx = 0.0f;
    for (int i0 = 0; i0 < k; i0 += band_rows) {
      const int rows = k - i0 < band_rows ? k - i0 : band_rows;
      for (int r = 0; r <= rows; ++r) {
        for (int s = 0; s <= k; ++s) {
          const size_t pix = (size_t)(b * H + tap_row(f, i0 + r, H)) * W +
                             tap_col(f, s, W);
          for (int c = 0; c < C; ++c) {
            float vd = 0.0f, vy = 0.0f, vx = 0.0f;
            for (int role = 0; role < 4; ++role) {
              if (!role_valid(role, r, s, rows, k)) continue;
              const int m = (i0 + role_row(role, r)) * k + role_col(role, s);
              const float v = db[((size_t)p * k2 + m) * C + c];
              vd += coef[role].d * v;
              vy += coef[role].y * v;
              vx += coef[role].x * v;
            }
            dsrc[pix * C + c] += vd;
            sy += src[pix * C + c] * vy;
            sx += src[pix * C + c] * vx;
          }
        }
      }
    }
    dflow[2 * p] = sx;
    dflow[2 * p + 1] = sy;
  }
}
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("warp_bwd_common") / "libwarp_bwd.so"
    src = out.with_suffix(".cpp")
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scatter.argtypes = [p, p, p] + [i] * 6 + [p, p]
    lib.scatter_wide.argtypes = [p, p, p] + [i] * 5 + [p, p]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


SCATTER_CASES = [  # k, flow scale, seed, offset rows per band
    pytest.param(3, 1.5, 0, 3, id="k3"),
    pytest.param(5, 1.5, 1, 5, id="k5"),
    pytest.param(3, 40.0, 2, 3, id="k3-far-flow"),
    pytest.param(5, 40.0, 3, 5, id="k5-far-flow"),
    pytest.param(7, 1.5, 4, 3, id="k7-bands"),  # bands of 3 offset rows
    pytest.param(5, 40.0, 5, 2, id="k5-far-flow-bands"),
    pytest.param(7, 40.0, 6, 3, id="k7-far-flow-bands"),
    # the run-time instance's bands of one offset row, odd and even k (up
    # to 8: at 9 gfla_tpu's kernel leaves its function, as
    # tests/test_torch_port_kernel_sizes.py shows)
    pytest.param(4, 1.5, 7, 1, id="k4-rows"),
    pytest.param(8, 40.0, 8, 1, id="k8-far-flow-rows"),
    pytest.param(2, 40.0, 9, 1, id="k2-far-flow-rows"),
]


@pytest.mark.parametrize("k,scale,seed,band_rows", SCATTER_CASES)
def test_header_scatter_and_dflow_match_core_bwd(harness, k, scale, seed,
                                                 band_rows):
    a, g = _inputs(k, flow_scale=scale, seed=10 + seed)
    B, H, W, C = a["source"].shape
    t = {n: torch.from_numpy(a[n]) for n in NAMES}
    hbt = target_stream(t["target"], t["w1"], t["b1"], k)
    w1s = t["w1"][:, C:, :].reshape(k * k * C, -1).contiguous()
    d_blocks = warp.warp_bwd_pos_plain(t["source"], t["flow"], hbt, w1s,
                                       t["w2"], t["b2"], torch.from_numpy(g),
                                       k)[5]
    db = np.ascontiguousarray(d_blocks.numpy())
    dsrc = np.zeros_like(a["source"])
    dflow = np.zeros_like(a["flow"])
    harness.scatter(_ptr(a["source"]), _ptr(a["flow"]), _ptr(db), B, H, W, C,
                    k, band_rows, _ptr(dsrc), _ptr(dflow))

    def core(source, flow):
        return attn_warp_core(source, flow, jnp.asarray(hbt.numpy()),
                              jnp.asarray(w1s.numpy()), jnp.asarray(a["w2"]),
                              jnp.asarray(a["b2"]), k, 0.1, True)

    _, vjp = jax.vjp(core, jnp.asarray(a["source"]), jnp.asarray(a["flow"]))
    want_src, want_flow = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(dsrc, want_src, rtol=0,
                               atol=GRAD_REL * np.abs(want_src).max())
    np.testing.assert_allclose(dflow, want_flow, rtol=0,
                               atol=GRAD_REL * np.abs(want_flow).max())


@pytest.mark.parametrize("k,scale,seed", [
    pytest.param(10, 1.5, 0, id="k10"),
    pytest.param(11, 1.5, 1, id="k11"),
    pytest.param(16, 1.5, 2, id="k16"),
    pytest.param(11, 40.0, 3, id="k11-far-flow"),
    pytest.param(16, 40.0, 4, id="k16-far-flow"),
])
def test_header_wide_scatter_and_dflow_match_plain_twin(harness, k, scale,
                                                         seed):
    """The wide bands' pre-summed scatter into d_source and their d_flow,
    from the plain backward's block cotangents, against the plain twin's
    transpose of block_extract (f32 sums in another order: 1e-5 x max)."""
    a, g = _inputs(k, flow_scale=scale, seed=30 + seed)
    B, H, W, C = a["source"].shape
    t = {n: torch.from_numpy(a[n]) for n in NAMES}
    hbt = target_stream(t["target"], t["w1"], t["b1"], k)
    w1s = t["w1"][:, C:, :].reshape(k * k * C, -1).contiguous()
    d_blocks = warp.warp_bwd_pos_plain(t["source"], t["flow"], hbt, w1s,
                                       t["w2"], t["b2"], torch.from_numpy(g),
                                       k)[5]
    want_src, want_flow = (x.numpy() for x in warp.block_extract_bwd(
        t["source"], t["flow"], d_blocks, k))
    db = np.ascontiguousarray(d_blocks.numpy())
    dsrc = np.zeros_like(a["source"])
    dflow = np.zeros_like(a["flow"])
    harness.scatter_wide(_ptr(a["source"]), _ptr(a["flow"]), _ptr(db), B, H,
                         W, C, k, _ptr(dsrc), _ptr(dflow))
    np.testing.assert_allclose(dsrc, want_src, rtol=0,
                               atol=1e-5 * np.abs(want_src).max())
    np.testing.assert_allclose(dflow, want_flow, rtol=0,
                               atol=1e-5 * np.abs(want_flow).max())
