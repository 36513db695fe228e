"""The port's serving and training CLIs and device rules, on the CPU.

`python -m gfla_tpu_torch.test` runs in a subprocess, as a user runs it, and
must write the `{src}_2_{tgt}_vis.jpg` files that the metrics CLI reads,
without importing JAX or gfla_tpu's host-data stack (pandas, cv2): the card's
machine has none of them. `python -m gfla_tpu_torch.train` takes two steps,
writes the original's checkpoint files and resumes from them, importing no
image library either; its options parse as gfla_tpu's do.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "pandas", "cv2", "gfla_tpu")


def _env():
    """The child's environment: the repo on the path, and two OpenMP
    threads, since the test workers already load every core."""
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")


def _run(tmp_path, *args):
    """`python -m gfla_tpu_torch.test` on the CPU; -X importtime lists every
    module the run imports on stderr."""
    return subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "gfla_tpu_torch.test",
         "--gpu_ids=-1", "--model=pose", "--dataset_mode=synthetic",
         "--load_size=64", "--batchSize=2",
         f"--results_dir={tmp_path / 'results'}",
         f"--checkpoints_dir={tmp_path / 'ckpt'}", "--name=smoke", *args],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)


def _imported(stderr):
    names = [line.rsplit("|", 1)[-1].strip() for line in stderr.splitlines()
             if line.startswith("import time:")]
    return {n.split(".")[0] for n in names}


def test_cli_writes_vis_files_without_jax(tmp_path):
    proc = _run(tmp_path, "--max_dataset_size=3", "--save_input")
    assert proc.returncode == 0, proc.stderr
    assert "no checkpoint found; using random init" in proc.stdout
    assert "gfla_tpu_torch" in _imported(proc.stderr)
    assert not _imported(proc.stderr) & set(FORBIDDEN)
    out = tmp_path / "results" / "smoke"
    names = sorted(p.name for p in out.iterdir())
    assert [n for n in names if n.endswith("_vis.jpg")] == [
        f"syn_{i}_a_2_syn_{i}_b_vis.jpg" for i in range(3)]
    assert len(names) == 3 * 4  # vis, ref, gt and all panels
    assert (tmp_path / "ckpt" / "smoke" / "test_opt.txt").exists()


def test_cli_serves_bfloat16(tmp_path):
    """--compute_dtype=bfloat16 serves through the bf16 generator and
    writes the same files."""
    proc = _run(tmp_path, "--max_dataset_size=2", "--compute_dtype=bfloat16")
    assert proc.returncode == 0, proc.stderr
    assert not _imported(proc.stderr) & set(FORBIDDEN)
    names = sorted(p.name for p in (tmp_path / "results" / "smoke").iterdir())
    assert names == [f"syn_{i}_a_2_syn_{i}_b_vis.jpg" for i in range(2)]


def test_gpu_ids_select_cpu_or_raise(monkeypatch):
    from gfla_tpu_torch.runtime import select_device

    assert select_device("-1") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_device("0")
    with pytest.raises(NotImplementedError):
        select_device("0,1")


def test_pose_task_asks_for_cuda_without_falling_back(monkeypatch):
    from gfla_tpu_torch.tasks.pose import PoseTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = SimpleNamespace(image_nc=3, structure_nc=18, layers=3,
                          attn_layer=[2, 3], kernel_size={"2": 5, "3": 3},
                          use_spect_g=False, compute_dtype="float32",
                          gpu_ids="0")
    with pytest.raises(RuntimeError, match="--gpu_ids=-1"):
        PoseTask(opt)


def test_warp_refuses_devices_without_a_kernel():
    from gfla_tpu_torch.ops import warp

    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        warp.warp_fwd(x, x[..., :2], x.reshape(1, 16, 8), x.reshape(16, 8),
                      x.reshape(8, 16)[:, :9], x[0, 0, 0, :9], 3)


TRAIN_FORBIDDEN = FORBIDDEN + ("PIL", "imageio")


def _train(tmp_path, *args):
    """`python -m gfla_tpu_torch.train` on the CPU, two samples a batch."""
    return subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "gfla_tpu_torch.train",
         "--gpu_ids=-1", "--model=pose", "--dataset_mode=synthetic",
         "--load_size=64", "--batchSize=2", "--max_dataset_size=4",
         "--print_freq=1", f"--checkpoints_dir={tmp_path / 'ckpt'}",
         "--name=smoke", *args],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)


def _loss_lines(stdout):
    """{iteration: {loss name: value}} from the trainer's loss lines."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("(epoch:"):
            head, tail = line.split(") ", 1)
            step = int(head.split("iters: ")[1].split(",")[0])
            fields = tail.split()
            out[step] = {k.rstrip(":"): float(v)
                         for k, v in zip(fields[::2], fields[1::2])}
    return out


def test_train_cli_takes_bfloat16_steps_on_a_tree(tmp_path):
    """Two --compute_dtype=bfloat16 steps from a DeepFashion-layout tree:
    finite losses, a finite held-out evaluation, and f32 checkpoints."""
    from torch_port_trees import write_tree

    from gfla_tpu_torch.tasks.pose import PoseTask

    tree = write_tree(tmp_path / "fashion", "fasion", pairs=8)
    proc = _train(tmp_path, "--dataset_mode=fashion", f"--dataroot={tree}",
                  "--max_iters=2", "--compute_dtype=bfloat16",
                  "--eval_iters_freq=2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    logs = _loss_lines("\n".join(x for x in lines if "ssim:" not in x))
    assert sorted(logs) == [1, 2]
    for step in logs.values():
        assert sorted(step) == sorted(PoseTask.loss_names + ["total_G"])
        assert all(np.isfinite(v) for v in step.values())
    evals = _loss_lines("\n".join(x for x in lines if "ssim:" in x))
    assert sorted(evals) == [2] and sorted(evals[2]) == ["l1", "psnr", "ssim"]
    assert all(np.isfinite(v) for v in evals[2].values())
    sd = torch.load(tmp_path / "ckpt" / "smoke" / "2_net_G.pth",
                    weights_only=True)
    assert {v.dtype for v in sd.values()} == {torch.float32}


def test_train_cli_takes_steps_writes_checkpoints_and_resumes(tmp_path):
    from gfla_tpu_torch.tasks.pose import PoseTask

    proc = _train(tmp_path, "--max_iters=2")
    assert proc.returncode == 0, proc.stderr
    assert not _imported(proc.stderr) & set(TRAIN_FORBIDDEN)
    logs = _loss_lines(proc.stdout)
    assert sorted(logs) == [1, 2]
    for step in logs.values():
        assert sorted(step) == sorted(PoseTask.loss_names + ["total_G"])
        assert all(np.isfinite(v) for v in step.values())
    ckpt = tmp_path / "ckpt" / "smoke"
    assert {"2_net_G.pth", "2_net_D.pth", "latest_net_G.pth",
            "latest_net_D.pth", "train_opt.txt"} <= {
                p.name for p in ckpt.iterdir()}
    d = torch.load(ckpt / "2_net_D.pth", weights_only=True)
    assert d["block0.model.1.weight_u"].shape == (32,)

    proc = _train(tmp_path, "--max_iters=3", "--continue_train")
    assert proc.returncode == 0, proc.stderr
    assert "resumed from iteration 2" in proc.stdout
    assert sorted(_loss_lines(proc.stdout)) == [3]
    assert (ckpt / "3_net_G.pth").exists()


POSE_TRAIN_FLAGS = [
    "--model=pose", "--dataset_mode=synthetic", "--name=exp",
    "--load_size=64", "--batchSize=2", "--lr=2e-4", "--gan_mode=hinge",
    "--kernel_size=2=5,3=3", "--attn_layer=2,3", "--lambda_style=250",
    "--lambda_correct=4", "--ratio_g2d=0.2", "--no_spect_d",
    "--continue_train", "--niter=7", "--niter_decay=3", "--lr_policy=step",
    "--print_freq=5", "--save_latest_freq=3", "--save_iters_freq=6",
    "--max_iters=9", "--gpu_ids=-1", "--seed=4",
]


@pytest.mark.parametrize("flags", [
    ["--model=pose", "--dataset_mode=synthetic"], POSE_TRAIN_FLAGS],
    ids=["defaults", "pose-flags"])
def test_train_options_parse_like_gfla_tpu(monkeypatch, tmp_path, flags):
    from gfla_tpu.options.options import TrainOptions as JaxTrainOptions
    from gfla_tpu_torch.options import TrainOptions

    flags = [*flags, f"--checkpoints_dir={tmp_path}"]
    monkeypatch.setattr(sys, "argv", ["train.py", *flags])
    want = vars(JaxTrainOptions().parse(save=False))
    got = vars(TrainOptions().parse(flags, save=False))
    assert got == want


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr
