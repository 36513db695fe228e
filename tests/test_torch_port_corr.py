"""The max-correlation of the correctness loss against gfla_tpu, on the CPU.

`max_corr_plain` (the plain twin of csrc/max_corr.cu) is held against
gfla_tpu's Pallas kernel `max_corr_pallas` run in interpret mode, at ragged
shapes and with duplicated and zero rows, where ties must go to the first
index: cmax within 1e-5 (f32; sums in other orders), argmax equal. The
correctness loss with GFLA_PALLAS_CORR=1 in both packages, on the same
feature maps, agrees in value and in its gradients to 1e-5 x the largest
|value|. The kernel's merge rule and its partition of the source rows over
threads and CTAs (csrc/max_corr.cuh) are compiled here with g++: the emulated
kernel must give numpy's first argmax at exact ties.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.losses import PerceptualCorrectness as JaxCorrectness
from gfla_tpu.ops.pallas_corr import max_corr_pallas
from gfla_tpu_torch.losses import PerceptualCorrectness
from gfla_tpu_torch.ops import max_corr

CSRC = Path(__file__).resolve().parents[1] / "gfla_tpu_torch" / "csrc"
ATOL = 1e-5


def _features(B, Ns, Nt, C, ties, seed):
    """Unit-norm ReLU features; with `ties`, source rows repeated at several
    positions, zero rows in both, and target rows that copy source rows."""
    rng = np.random.RandomState(seed)
    s = np.maximum(rng.randn(B, Ns, C), 0.0)
    t = np.maximum(rng.randn(B, Nt, C), 0.0)
    if ties:
        s[:, 5::9] = s[:, 2:3]
        s[:, 7::31] = 0.0
        t[:, ::3] = s[:, 2:3]
        t[:, 1::5] = 0.0
        t[:, 4::11] = s[:, 40:41]
    s = s / (np.sqrt((s * s).sum(-1, keepdims=True)) + 1e-8)
    t = t / (np.sqrt((t * t).sum(-1, keepdims=True)) + 1e-8)
    return s.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("B,Ns,Nt,C,ties,chunk", [
    pytest.param(2, 300, 77, 5, False, 2048, id="ragged"),
    pytest.param(1, 1100, 130, 40, False, 256, id="several-tiles-and-chunks"),
    pytest.param(2, 700, 50, 16, True, 128, id="duplicated-and-zero-rows"),
])
def test_max_corr_plain_matches_pallas(B, Ns, Nt, C, ties, chunk):
    s, t = _features(B, Ns, Nt, C, ties, Ns + Nt)
    want_max, want_idx = max_corr_pallas(jnp.asarray(s), jnp.asarray(t),
                                         interpret=True)
    before = max_corr.launches
    got_max, got_idx = max_corr.max_corr_plain(torch.from_numpy(s),
                                               torch.from_numpy(t), chunk)
    np.testing.assert_allclose(got_max.numpy(), np.asarray(want_max),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_idx.dtype == torch.int64
    # the dispatching wrapper takes the plain twin for CPU tensors
    got = max_corr.max_corr(torch.from_numpy(s), torch.from_numpy(t))
    assert max_corr.launches == before
    np.testing.assert_array_equal(got[1].numpy(), got_idx.numpy())
    if ties:
        idx = got_idx.numpy()
        copies = (t == s[:, 2:3]).all(-1)   # of source row 2, repeated later
        zeros = (t == 0).all(-1)            # equal to every source row
        assert copies.any() and zeros.any()
        assert (idx[copies] == 2).all() and (idx[zeros] == 0).all()


def test_max_corr_refuses_devices_without_a_kernel():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        max_corr.max_corr(x, x)


def test_correctness_loss_with_corr_kernel_matches_jax(monkeypatch):
    """GFLA_PALLAS_CORR=1 in both packages, on the same feature maps (ReLU,
    with zero and duplicated rows), flows at the feature size and
    nearest-resized: the loss and its gradients to the flows and to both
    feature maps."""
    monkeypatch.setenv("GFLA_PALLAS_CORR", "1")
    rng = np.random.RandomState(3)
    feats = {}
    for name, (h, c) in (("relu3_1", (8, 16)), ("relu4_1", (4, 32))):
        f = np.maximum(rng.randn(2, 2, h, h, c), 0.0).astype(np.float32)
        f[:, :, :, :2] = 1.0   # white side bands: duplicated rows
        f[:, :, 1, 3] = 0.0    # zero rows
        feats[name] = f
    flows = [(rng.randn(2, 4, 4, 2) * 1.5).astype(np.float32),
             (rng.randn(2, 4, 4, 2) * 1.5).astype(np.float32)]

    def jax_loss(flows, t_feats, s_feats):
        return JaxCorrectness(None)(None, None, flows, [2, 3],
                                    target_feats=t_feats,
                                    source_feats=s_feats)

    import jax

    jt = {k: jnp.asarray(v[0]) for k, v in feats.items()}
    js = {k: jnp.asarray(v[1]) for k, v in feats.items()}
    want, (gf, gt, gs) = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        [jnp.asarray(f) for f in flows], jt, js)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 3, 1, 2))).requires_grad_()

    ft = [nchw(f) for f in flows]
    tt = {k: nchw(v[0]) for k, v in feats.items()}
    st = {k: nchw(v[1]) for k, v in feats.items()}
    got = PerceptualCorrectness(None)(None, None, ft, [2, 3],
                                      target_feats=tt, source_feats=st)
    got.backward()
    assert abs(got.item() - float(want)) <= ATOL * abs(float(want))
    pairs = [(a, b) for a, b in zip(ft, gf)]
    pairs += [(tt[k], gt[k]) for k in feats] + [(st[k], gs[k]) for k in feats]
    for port, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            port.grad.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
            atol=ATOL * np.abs(ref).max())


# ---------------------------------------------------------------------------
# g++ harness of the kernel's merge (csrc/max_corr.cuh)
# ---------------------------------------------------------------------------

HARNESS = r"""
#include <cmath>
#include "max_corr.cuh"
extern "C" {
// The kernel's partition and merges over a precomputed correlation
// corr (Ns x Nt): per split of `per` 128-row source tiles, 16 column groups
// keep a running (max, argmax) with a strict > in index order, merge by the
// xor-shuffle tree, then the splits merge in order.
void emulate(const float* corr, int Ns, int Nt, int per, float* cmax,
             int* amax) {
  const int n_tiles = (Ns + 127) / 128;
  for (int j = 0; j < Nt; ++j) {
    float out_v = -INFINITY;
    int out_i = gfla::kNoIndex;
    for (int t0 = 0; t0 < n_tiles; t0 += per) {
      float best[16];
      int best_i[16];
      for (int g = 0; g < 16; ++g) {
        best[g] = -INFINITY;
        best_i[g] = gfla::kNoIndex;
        for (int tile = t0; tile < t0 + per && tile < n_tiles; ++tile) {
          for (int q = 0; q < 8; ++q) {
            const int i = tile * 128 + gfla::corr_tile_row(g, q);
            if (i >= Ns) continue;
            const float v = corr[(size_t)i * Nt + j];
            if (v > best[g]) { best[g] = v; best_i[g] = i; }
          }
        }
      }
      for (int off = 8; off > 0; off >>= 1) {
        float nv[16];
        int ni[16];
        for (int g = 0; g < 16; ++g) {
          const int o = g ^ off;
          nv[g] = best[g];
          ni[g] = best_i[g];
          if (gfla::corr_beats(best[o], best_i[o], best[g], best_i[g])) {
            nv[g] = best[o];
            ni[g] = best_i[o];
          }
        }
        for (int g = 0; g < 16; ++g) { best[g] = nv[g]; best_i[g] = ni[g]; }
      }
      if (gfla::corr_beats(best[0], best_i[0], out_v, out_i)) {
        out_v = best[0];
        out_i = best_i[0];
      }
    }
    cmax[j] = out_v;
    amax[j] = out_i;
  }
}
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("max_corr_merge") / "libmax_corr.so"
    src = out.with_suffix(".cpp")
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emulate.argtypes = [p, i, i, i, p, p]
    return lib


@pytest.mark.parametrize("Ns,Nt,levels,per", [
    (1000, 64, 3, 1),    # many exact ties, one tile per split
    (1000, 64, 3, 3),    # ... three tiles per split, ragged last split
    (777, 40, 1000, 8),  # fewer ties, one split
    (129, 7, 2, 1),      # a last tile of one row
])
def test_header_merge_gives_the_first_argmax(harness, Ns, Nt, levels, per):
    rng = np.random.RandomState(Ns + levels)
    corr = rng.randint(0, levels, (Ns, Nt)).astype(np.float32)
    corr[:, 0] = 0.0  # a column of equal values: index 0
    cmax = np.empty(Nt, np.float32)
    amax = np.empty(Nt, np.int32)
    harness.emulate(corr.ctypes.data_as(ctypes.c_void_p), Ns, Nt, per,
                    cmax.ctypes.data_as(ctypes.c_void_p),
                    amax.ctypes.data_as(ctypes.c_void_p))
    np.testing.assert_array_equal(cmax, corr.max(0))
    np.testing.assert_array_equal(amax, corr.argmax(0))
    assert amax[0] == 0
