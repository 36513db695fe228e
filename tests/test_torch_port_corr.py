"""The max-correlation of the correctness loss against gfla_tpu, on the CPU.

`max_corr_plain` (the plain twin of csrc/max_corr.cu) is held against
gfla_tpu's Pallas kernel `max_corr_pallas` run in interpret mode, at ragged
shapes and with duplicated and zero rows, where ties must go to the first
index: cmax within 1e-5 (f32; sums in other orders), argmax equal. The
correctness loss with GFLA_PALLAS_CORR=1 in both packages, on the same
feature maps, agrees in value and in its gradients to 1e-5 x the largest
|value|. The kernel's merge rule, its partition of a tile over the
accumulator fragments of its threads and of the source rows over CTAs
(csrc/max_corr.cuh, csrc/mma_tf32x3.cuh) are compiled here with g++: the
emulated kernel must fold every pair once and give numpy's first argmax at
exact ties.
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
#include <algorithm>
#include <cmath>
#include <vector>
#include "max_corr.cuh"
using namespace gfla;
extern "C" {
// The kernel's partition and merges over a precomputed correlation
// corr (Ns x Nt). Per tile of kCorrRows target rows and per split of `per`
// source tiles, the CTA's 256 threads fold their accumulator elements in
// fragment order into one running (max, argmax) slot per target row they
// see, skipping source rows past Ns; the four lanes of a quad merge by
// xor-shuffle, the warps that share target rows (none in a grid one warp
// wide) in order, then the splits in order.
// seen (Ns x Nt) counts how often each pair was folded.
void emulate(const float* corr, int Ns, int Nt, int per, float* cmax,
             int* amax, int* seen) {
  const WarpGrid g = corr_grid();
  const int threads = 32 * kCorrWarps;
  const int slots = 2 * g.tiles_m;  // target rows a thread sees
  const int n_tiles = (Ns + kCorrRows - 1) / kCorrRows;
  const int n_splits = (n_tiles + per - 1) / per;
  for (int j0 = 0; j0 < Nt; j0 += kCorrRows) {
    std::vector<float> part_v(n_splits * kCorrRows);
    std::vector<int> part_i(n_splits * kCorrRows);
    for (int sp = 0; sp < n_splits; ++sp) {
      std::vector<float> best(threads * slots, -INFINITY);
      std::vector<int> best_i(threads * slots, kNoIndex);
      for (int tid = 0; tid < threads; ++tid) {
        const int warp = tid / 32, lane = tid % 32;
        const int end = std::min(n_tiles, (sp + 1) * per);
        for (int tile = sp * per; tile < end; ++tile) {
          for (int mt = 0; mt < g.tiles_m; ++mt) {
            for (int nt = 0; nt < g.tiles_n; ++nt) {
              for (int e = 0; e < 4; ++e) {
                const int i =
                    tile * kCorrRows + grid_col(g, warp, lane, nt, e);
                const int j = j0 + grid_row(g, warp, lane, mt, e);
                if (i >= Ns) continue;
                float v = 0.0f;  // rows past Nt multiply zero-filled rows
                if (j < Nt) {
                  v = corr[(size_t)i * Nt + j];
                  ++seen[(size_t)i * Nt + j];
                }
                const int r = tid * slots + corr_slot(mt, e);
                corr_fold(v, i, best[r], best_i[r]);
              }
            }
          }
        }
      }
      for (int off = 1; off <= 2; off <<= 1) {
        std::vector<float> nv(best);
        std::vector<int> ni(best_i);
        for (int tid = 0; tid < threads; ++tid) {
          for (int r = 0; r < slots; ++r) {
            corr_fold(best[(tid ^ off) * slots + r],
                      best_i[(tid ^ off) * slots + r], nv[tid * slots + r],
                      ni[tid * slots + r]);
          }
        }
        best = nv;
        best_i = ni;
      }
      std::vector<float> red_v(g.warps_n * kCorrRows);
      std::vector<int> red_i(g.warps_n * kCorrRows);
      for (int tid = 0; tid < threads; tid += 4) {
        const int warp = tid / 32, lane = tid % 32;
        for (int r = 0; r < slots; ++r) {
          const int row = grid_row(g, warp, lane, r >> 1, 2 * (r & 1));
          red_v[(warp % g.warps_n) * kCorrRows + row] = best[tid * slots + r];
          red_i[(warp % g.warps_n) * kCorrRows + row] =
              best_i[tid * slots + r];
        }
      }
      for (int row = 0; row < kCorrRows; ++row) {
        float v = red_v[row];
        int i = red_i[row];
        for (int w = 1; w < g.warps_n; ++w) {
          corr_fold(red_v[w * kCorrRows + row], red_i[w * kCorrRows + row], v,
                    i);
        }
        part_v[sp * kCorrRows + row] = v;
        part_i[sp * kCorrRows + row] = i;
      }
    }
    for (int row = 0; row < kCorrRows && j0 + row < Nt; ++row) {
      float v = -INFINITY;
      int i = kNoIndex;
      for (int sp = 0; sp < n_splits; ++sp) {
        corr_fold(part_v[sp * kCorrRows + row], part_i[sp * kCorrRows + row],
                  v, i);
      }
      cmax[j0 + row] = v;
      amax[j0 + row] = i;
    }
  }
}

int splits(int B, int Ns, int Nt, int sms) {
  return corr_splits(B, Ns, Nt, sms);
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
    lib.emulate.argtypes = [p, i, i, i, p, p, p]
    lib.splits.argtypes = [i, i, i, i]
    lib.splits.restype = i
    return lib


@pytest.mark.parametrize("Ns,Nt,levels,per", [
    (1000, 64, 3, 1),    # many exact ties, one tile per split
    (1000, 64, 3, 3),    # ... three tiles per split, ragged last split
    (777, 40, 1000, 8),  # fewer ties, one split
    (129, 7, 2, 1),      # a last tile of one row
    (300, 200, 2, 2),    # two target tiles, the second ragged
])
def test_header_merge_gives_the_first_argmax(harness, Ns, Nt, levels, per):
    rng = np.random.RandomState(Ns + levels)
    corr = rng.randint(0, levels, (Ns, Nt)).astype(np.float32)
    corr[:, 0] = 0.0  # a column of equal values: index 0
    cmax = np.empty(Nt, np.float32)
    amax = np.empty(Nt, np.int32)
    seen = np.zeros((Ns, Nt), np.int32)
    harness.emulate(corr.ctypes.data_as(ctypes.c_void_p), Ns, Nt, per,
                    cmax.ctypes.data_as(ctypes.c_void_p),
                    amax.ctypes.data_as(ctypes.c_void_p),
                    seen.ctypes.data_as(ctypes.c_void_p))
    # the fragments of the ragged tiles cover every pair once
    assert (seen == 1).all()
    np.testing.assert_array_equal(cmax, corr.max(0))
    np.testing.assert_array_equal(amax, corr.argmax(0))
    assert amax[0] == 0


@pytest.mark.parametrize("B,Ns,Nt,sms,want", [
    (8, 4096, 4096, 132, 1),  # relu3_1: 256 target tiles fill the card
    (8, 1024, 1024, 132, 2),  # relu4_1: 64 target tiles, 128 CTAs
    (3, 1000, 777, 132, 4),   # 21 target tiles, 8 source tiles in pairs
    (1, 100, 100, 132, 1),    # one source tile cannot be split
])
def test_header_source_split_fills_the_card_once(harness, B, Ns, Nt, sms,
                                                 want):
    got = harness.splits(B, Ns, Nt, sms)
    assert got == want
    n_tiles = -(-Ns // 128)
    per = -(-n_tiles // got)
    assert (got - 1) * per < n_tiles       # no split without a tile
    assert got * B * -(-Nt // 128) <= max(sms, B * -(-Nt // 128))
