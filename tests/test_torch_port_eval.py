"""The port trainer's held-out evaluation, visuals and both CLIs at their
defaults, on the CPU.

- `compare_ssim`, `compare_psnr` and `compare_l1` equal gfla_tpu's within
  1e-6 on random and on equal images (both are float64 numpy and scipy;
  the same arithmetic);
- `evaluate_held_out` gives train.py's numbers for the same images;
- the held-out indices are train.py's (train.py:133-137) for three
  (n, batchSize, seed), and none when the dataset has fewer than two
  batches;
- `tensor2im` and `flow2color` are bitwise gfla_tpu's;
- `python -m gfla_tpu_torch.train` and `python -m gfla_tpu_torch.test` at
  the default `--dataset_mode` (fashion) on a small tree: the trainer holds
  out a batch, evaluates it, writes its logs, visuals and a profiler trace;
  the serving CLI writes `_vis.jpg` files.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_trees import write_tree

from gfla_tpu.metrics import reconstruction as jax_metrics
from gfla_tpu.utils.images import flow2color as jax_flow2color
from gfla_tpu.utils.images import tensor2im as jax_tensor2im
from gfla_tpu_torch.metrics import reconstruction
from gfla_tpu_torch.train.evaluate import (
    current_visuals,
    evaluate_held_out,
    holdout_indices,
)
from gfla_tpu_torch.utils.images import flow2color, tensor2im

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape)
    if kind == "equal":
        return a, a.copy()
    return a, np.clip(a + rng.randn(*shape) * 0.1, 0, 1)


@pytest.mark.parametrize("metric", ["compare_ssim", "compare_psnr",
                                    "compare_l1"])
@pytest.mark.parametrize("kind,shape", [
    ("random", (80, 60, 3)), ("equal", (80, 60, 3)), ("random", (40, 30, 3))],
    ids=["random", "equal", "uncropped"])
def test_metrics_match_gfla_tpu(metric, kind, shape):
    a, b = _images(kind, shape)
    got = getattr(reconstruction, metric)(a, b)
    want = getattr(jax_metrics, metric)(a, b)
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= 1e-6


class _Task:
    def __init__(self, out):
        self.out = out

    def test_step(self, *args):
        return self.out


def test_evaluate_held_out_matches_train_py():
    from train import evaluate_held_out as jax_evaluate

    rng = np.random.RandomState(2)
    gt = rng.rand(3, 64, 52, 3).astype(np.float32) * 2.2 - 1.1
    gen = gt + rng.randn(*gt.shape).astype(np.float32) * 0.2
    want = jax_evaluate(_Task((gen, [], [])), None, {"P2": gt})
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)
    got = evaluate_held_out(_Task((nchw(gen), [], [])), {"P2": nchw(gt)})
    assert set(got) == {"ssim", "psnr", "l1"}
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-6, name
    assert evaluate_held_out(_Task(([], [])), {"P2": nchw(gt)}) == {}


@pytest.mark.parametrize("n,batch,seed", [(100, 8, 0), (37, 8, 4),
                                          (16, 8, 11), (15, 8, 0)])
def test_holdout_indices_match_train_py(n, batch, seed):
    want = None  # train.py:133-137
    if n >= 2 * batch:
        want = np.sort(np.random.RandomState(seed + 9973).choice(
            n, size=batch, replace=False))
    got = holdout_indices(n, batch, seed)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels,scale", [(3, 1.3), (1, 1.0), (3, 0.5)],
                         ids=["rgb-clipped", "grey", "rgb"])
def test_tensor2im_is_gfla_tpus(channels, scale):
    x = (np.random.RandomState(channels).rand(2, 9, 7, channels) * 2 - 1
         ).astype(np.float32) * scale
    got = tensor2im(torch.from_numpy(x).permute(0, 3, 1, 2), 1)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jax_tensor2im(x, 1))


@pytest.mark.parametrize("scale", [3.0, 0.0], ids=["random", "zero"])
def test_flow2color_is_gfla_tpus(scale):
    flow = np.random.RandomState(5).randn(2, 12, 10, 2).astype(
        np.float32) * scale
    np.testing.assert_array_equal(flow2color(flow, 1),
                                  jax_flow2color(flow, 1))


def test_current_visuals_name_each_view():
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.rand(*s).astype(np.float32))
    batch = {"P1": t(2, 3, 16, 12), "P2": t(2, 3, 16, 12),
             "BP2": t(2, 18, 16, 12)}
    task = _Task((t(2, 3, 16, 12), [t(2, 2, 4, 3), t(2, 2, 8, 6)],
                  [t(2, 1, 4, 3), t(2, 1, 8, 6)]))
    vis = current_visuals(task, batch)
    assert list(vis) == ["input_P1", "input_BP2", "img_gen", "input_P2",
                         "flow_field0", "mask0", "flow_field1", "mask1"]
    assert vis["input_BP2"].shape == (16, 12, 3)
    assert vis["flow_field1"].shape == (8, 6, 3)
    assert all(v.dtype == torch.uint8 for v in vis.values())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("tree") / "fashion", "fasion",
                      pairs=8)


def _cli(module, tmp_path, *args):
    """A CLI at the default --dataset_mode on the CPU, in a subprocess with
    two OpenMP threads, as the other test workers load every core."""
    return subprocess.run(
        [sys.executable, "-m", module, "--gpu_ids=-1", "--load_size=64",
         "--batchSize=2", f"--checkpoints_dir={tmp_path / 'ckpt'}",
         "--name=disk", *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))


def test_train_cli_evaluates_and_writes_visuals_at_defaults(tmp_path, tree):
    proc = _cli("gfla_tpu_torch.train", tmp_path, f"--dataroot={tree}",
                "--max_iters=3", "--eval_iters_freq=1", "--display_freq=1",
                "--profile_iters=1", "--print_freq=1")
    assert proc.returncode == 0, proc.stderr
    held = np.sort(np.random.RandomState(9973).choice(8, 2, replace=False))
    assert f"held out 2 samples for eval (indices {held.tolist()})" \
        in proc.stdout
    assert "dataset [fashion] created: 8 samples, 3 iters/epoch" \
        in proc.stdout
    run = tmp_path / "ckpt" / "disk"
    evals = (run / "eval_log.txt").read_text().splitlines()
    assert [line.split(")")[0] for line in evals] == [
        f"(epoch: {i // 3}, iters: {i}" for i in (1, 2, 3)]
    for line in evals:
        fields = line.split(") ")[1].split()
        values = dict(zip(fields[::2], map(float, fields[1::2])))
        assert list(values) == ["ssim:", "psnr:", "l1:"]
        assert all(np.isfinite(v) for v in values.values())
    assert len((run / "loss_log.txt").read_text().splitlines()) == 4
    images = sorted(p.name for p in (run / "web" / "images").iterdir())
    assert len(images) == 3 * 8 and images[0] == "iter00000001_flow_field0.png"
    with Image.open(run / "web" / "images" / "iter00000003_img_gen.png") as im:
        assert im.size == (64, 64) and im.mode == "RGB"
    assert "iter00000003_input_P1.png" in (run / "web" / "index.html"
                                           ).read_text()
    assert (run / "profile" / "trace_3.json").stat().st_size > 0
    assert (run / "3_net_G.pth").exists()


def test_test_cli_writes_vis_jpegs_at_defaults(tmp_path, tree):
    proc = _cli("gfla_tpu_torch.test", tmp_path, f"--dataroot={tree}",
                f"--results_dir={tmp_path / 'results'}")
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / "results" / "disk"
    names = sorted(p.name for p in out.iterdir())
    assert names and all(n.startswith("test") and n.endswith("_vis.jpg")
                         for n in names)
    with Image.open(out / names[0]) as im:
        assert im.size == (64, 64) and im.format == "JPEG"


def test_learning_curve_evaluates_the_untrained_generator_first(tmp_path,
                                                                tree):
    from gfla_tpu_torch.tools import learning_curve

    assert learning_curve.main([
        "--gpu_ids=-1", f"--dataroot={tree}", "--load_size=64",
        "--batchSize=2", "--max_iters=1", "--eval_iters_freq=1",
        "--nThreads=0", f"--checkpoints_dir={tmp_path}", "--name=lc"]) == 0
    lines = (tmp_path / "lc" / "eval_log.txt").read_text().splitlines()
    assert [line.split(")")[0] for line in lines] == [
        "(epoch: 0, iters: 0", "(epoch: 0, iters: 1"]
