"""gfla_tpu flags that the port used to parse and drop, on the CPU.

- `--remat` recomputes the pose generator's forward in the backward, as
  gfla_tpu wraps it in jax.checkpoint (tasks/pose.py:201-205): one pose step
  at 32x32 (ngf 16, img_f 64) gives the losses, the gradients of G and D and
  the stored spectral-norm u of the step without it, each within 1e-6 x its
  largest |value| (the same f32 sums, in the order the recomputation takes).
- gfla_tpu's parallelism flags: `--spatial` above 1 (the data x spatial
  mode) makes the training CLI raise NotImplementedError naming the flag
  and its ROADMAP item, before any data or network is built; the training
  CLI trains one step with `--mesh_devices=2` on two CPU ranks and with
  `--distributed` in a torchrun world of one; the serving CLI takes all
  three, serves on one device and says so.
- `--model=poseflownet --compute_dtype=bfloat16` trains in float32, as
  gfla_tpu's poseflownet task does: its step equals the float32 step.
"""

import argparse
import copy
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.poseflownet import PoseFlowNetTask

REPO = Path(__file__).resolve().parents[1]
H = W = 32
REL = 1e-6


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: these steps run beside the other test workers
    on the same cores, where torch's default of one thread a core
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opt(model="pose", **over):
    opt = argparse.Namespace(
        model=model, dataset_mode="synthetic", phase="train", isTrain=True,
        batchSize=2, load_size=H, old_size=(H, W), structure_nc=18,
        image_nc=3, layers=3, attn_layer=[2, 3], ngf=16, img_f=64,
        kernel_size={"2": 5, "3": 3}, use_spect_g=False, no_spect_d=False,
        lr=1e-4, lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
        iters_per_epoch=10, gan_mode="lsgan", ratio_g2d=0.1,
        lambda_rec=5.0, lambda_g=2.0, lambda_correct=5.0, lambda_style=500.0,
        lambda_content=0.5, lambda_regularization=0.0025,
        compute_dtype="float32", seed=0, gpu_ids="-1", remat=False)
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _batch(seed):
    rng = np.random.RandomState(seed)
    kp = torch.from_numpy(rng.rand(2, 2, 18, 2).astype(np.float32) * (H - 1))
    images = torch.from_numpy((rng.rand(2, 2, 3, H, W) * 2 - 1).astype(
        np.float32))
    batch = {"P1": images[0], "P2": images[1],
             "BP1": encode_heatmaps(kp[0], H, W).permute(0, 3, 1, 2),
             "BP2": encode_heatmaps(kp[1], H, W).permute(0, 3, 1, 2)}
    return {k: v.contiguous(memory_format=torch.channels_last)
            for k, v in batch.items()}


def _close(got, want, what):
    tol = REL * max(want.abs().max().item(), 1e-30)
    assert (got - want).abs().max().item() <= tol, what


@pytest.mark.parametrize("spect", [False, True], ids=["plain", "spect_g"])
def test_remat_keeps_the_pose_step(spect):
    base = PoseTask(_opt(use_spect_g=spect))
    remat = copy.deepcopy(base)
    remat.opt = _opt(use_spect_g=spect, remat=True)
    batch = _batch(3)
    calls = []
    forward = remat.net_g.forward
    remat.net_g.forward = lambda *a: calls.append(1) or forward(*a)
    want = base.train_step(batch)
    got = remat.train_step(batch)
    assert len(calls) == 2  # the forward, and its recomputation
    for name in want:
        _close(got[name], want[name], name)
    for net_a, net_b in ((remat.net_g, base.net_g), (remat.net_d, base.net_d)):
        for (name, a), b in zip(net_a.named_parameters(),
                                net_b.parameters()):
            _close(a.grad, b.grad, f"d {name}")
            _close(a.detach(), b.detach(), name)
    buffers = dict(base.net_g.named_buffers())
    for name, u in remat.net_g.named_buffers():
        _close(u, buffers[name], name)
    assert any(n.endswith("weight_u") for n in buffers) == spect


CLI_TIMEOUT = 240  # s: the two-rank training run takes 14-15 s alone on
                  # an 8-core host, 90-152 s beside seven 8-thread loads


def _cli(module, *args, env=None):
    """The CLI in a session of its own, killed with any ranks it started if
    it outlives CLI_TIMEOUT."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--gpu_ids=-1", "--model=pose",
         "--dataset_mode=synthetic", "--load_size=64", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                 PYTHONUNBUFFERED="1", **(env or {})))
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{module} {' '.join(args)} still running after "
                    f"{CLI_TIMEOUT} s; its output ends:\n{out[-2000:]}\n"
                    f"{err[-3000:]}")
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _torchrun_world_of_one():
    """torchrun's variables for one process on this host."""
    from gfla_tpu_torch.parallel import free_port

    return dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()))


@pytest.mark.parametrize("module", ["gfla_tpu_torch.train",
                                    "gfla_tpu_torch.test"])
@pytest.mark.parametrize("flag", ["--mesh_devices=2", "--spatial=2",
                                  "--distributed"])
def test_parallel_flags_are_refused(tmp_path, module, flag):
    train = module == "gfla_tpu_torch.train"
    proc = _cli(module, flag, f"--checkpoints_dir={tmp_path}",
                f"--results_dir={tmp_path}", "--name=flags", "--nThreads=0",
                *(["--load_size=32", "--batchSize=2", "--max_iters=1"] if train
                  else ["--max_dataset_size=1"]),
                env=_torchrun_world_of_one() if flag == "--distributed"
                else None)
    if train and flag == "--spatial=2":  # the one refusal left
        assert proc.returncode != 0
        assert "NotImplementedError" in proc.stderr
        assert flag in proc.stderr and "queue 1, item 2" in proc.stderr
        assert "dataset [" not in proc.stdout
        return
    assert proc.returncode == 0, proc.stderr[-3000:]
    if train:
        assert proc.stdout.count("training finished at iteration 1") == 1
        assert (tmp_path / "flags" / "1_net_G.pth").exists()
        ranks = "data parallel: 2 ranks on ['cpu', 'cpu'], 1 rows each"
        assert (ranks in proc.stdout) == (flag == "--mesh_devices=2")
    else:
        assert "serving runs on one device" in proc.stdout
        assert [p.name for p in (tmp_path / "flags").glob("*_vis.jpg")] \
            == ["syn_0_a_2_syn_0_b_vis.jpg"]


def test_poseflownet_bfloat16_trains_in_float32():
    f32 = PoseFlowNetTask(_opt("poseflownet", lambda_correct=20.0,
                               lambda_regularization=0.01))
    bf16 = PoseFlowNetTask(_opt("poseflownet", lambda_correct=20.0,
                                lambda_regularization=0.01,
                                compute_dtype="bfloat16"))
    for a, b in zip(bf16.net_g.state_dict().values(),
                    f32.net_g.state_dict().values()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    batch = _batch(5)
    want = f32.train_step(batch)
    got = bf16.train_step(batch)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for a, b in zip(bf16.net_g.parameters(), f32.net_g.parameters()):
        assert torch.equal(a, b)
