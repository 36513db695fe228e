"""The port's file-backed dance and face data against gfla_tpu's, on the CPU.

A dance tree (iPER layout, 72x56 frames, skeleton JSONs with missing
joints, joints past the frame's edge and frames with no person) and a face
tree (FaceForensics layout, 60x80 frames, a size other than --load_size=64)
are written here through chip_smoke.py's writer with the CPU's encoder
(PIL). Each sample of the port's DanceDataset and FaceDataset, after the
port's `prepare_batch` on the CPU (PIL's decode, then the same code the
card runs), is held against gfla_tpu's dataset sample followed by
gfla_tpu's train.py prepare:
- the frames and the reference within 1e-5 abs, the rule
  test_torch_port_data.py holds the pose images to (the native pass's
  arithmetic is reproduced; its blend's fused products part the two by
  ~4e-7);
- the heatmaps (dance's device encode) within 1e-6 abs;
- every other structure channel (the drawn limbs, face's curves, Canny
  background, distance maps and part labels) bitwise;
- the test cursor (frame_idx, change_seq, the padding at a sequence's end),
  the paths and dance's normalised joints exactly.
The cases: dance iper and fashion in training (augmentation on, the device
encode and --no_device_encode), dance at test time, face in training with
and without --no_canny_edge and --no_dist_map, and face at test time.
Also: the loader's batches, and the streaming test on the CPU through both
CLIs (`--use_mask` is tests/test_torch_port_use_mask.py's).
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gfla_tpu.data import collate as jax_collate
from gfla_tpu.data.animation_data import DanceDataset as JaxDance
from gfla_tpu.data.animation_data import FaceDataset as JaxFace
from gfla_tpu.parallel import make_mesh
from gfla_tpu_torch.data import collate, make_loader
from gfla_tpu_torch.data.animation_data import DanceDataset, FaceDataset
from gfla_tpu_torch.tasks.animation import prepare_batch
from train import prepare_batch as jax_prepare_batch

REPO = Path(__file__).resolve().parent.parent
IMAGE_ATOL = 1e-5
HEATMAP_ATOL = 1e-6
LOAD = 64
SEQS, FRAMES = 3, 7  # 7 frames: the test chunks of 3 pad each sequence


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("video")
    out = {}
    for kind, (H, W), seed in (("dance", (72, 56), 3), ("face", (60, 80), 4)):
        root = str(base / kind)
        chip_smoke.write_video_tree(root, kind, H, W, seed, "cpu",
                                    seqs=SEQS, frames=FRAMES)
        out[kind] = root
    return out


def _opt(root, phase, **over):
    opt = argparse.Namespace(
        dataroot=root, phase=phase, isTrain=phase == "train",
        load_size=LOAD, n_frames_total=4, max_frames_per_gpu=2, max_t_step=2,
        n_frames_pre_load_test=3, start_frame=0, seed=7, use_mask=False,
        angle=None, shift=None, scale=None, old_size=None,
        sub_dataset="iper", no_device_encode=False, no_canny_edge=False,
        no_dist_map=False)
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


CASES = {  # kind, phase, options
    "dance-iper-train": ("dance", "train", {}),
    "dance-iper-host-maps": ("dance", "train", dict(no_device_encode=True)),
    "dance-fashion-train": ("dance", "train", dict(sub_dataset="fashion")),
    "dance-fashion-host-maps": ("dance", "train",
                                dict(sub_dataset="fashion",
                                     no_device_encode=True)),
    "dance-test": ("dance", "test", {}),
    "face-train": ("face", "train", {}),
    "face-no-canny": ("face", "train", dict(no_canny_edge=True)),
    "face-no-dist-map": ("face", "train", dict(no_dist_map=True)),
    "face-test": ("face", "test", {}),
}


def _bitwise(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), (
        f"{what}: {np.count_nonzero(got != want)} values differ")


@pytest.mark.parametrize("case", list(CASES))
def test_samples_after_prepare_match_gfla_tpu(trees, case):
    kind, phase, over = CASES[case]
    is_train = phase == "train"
    jax_cls, cls = {"dance": (JaxDance, DanceDataset),
                    "face": (JaxFace, FaceDataset)}[kind]
    want_opt = jax_cls.apply_defaults(_opt(trees[kind], phase, **over),
                                      is_train)
    got_opt = cls.apply_defaults(_opt(trees[kind], phase, **over), is_train)
    assert vars(got_opt) == vars(want_opt)
    want_ds, got_ds = jax_cls(want_opt), cls(got_opt)
    n = SEQS if is_train else SEQS * 3  # 7 frames -> 9 -> 3 chunks of 3
    assert len(got_ds) == len(want_ds) == n
    mesh = make_mesh(1)
    moved = False
    for i in range(n):
        want = jax_collate([want_ds[i]])
        raw = got_ds[i]
        got = prepare_batch(collate([raw]), torch.device("cpu"), got_opt)
        want_dev = {k: np.asarray(v) for k, v in
                    jax_prepare_batch(want, want_opt, mesh).items()}
        what = f"{case} sample {i}"
        assert raw["gen_paths"] == want["gen_paths"][0], what
        if not is_train:
            assert raw["frame_idx"] == want["frame_idx"][0], what
            assert raw["change_seq"] == want["change_seq"][0], what
        moved |= not np.array_equal(raw["P_all_inv"][0], np.eye(2, 3))
        for key in ("P_all", "ref_image"):
            img = got[key].movedim(-3, -1).numpy()
            np.testing.assert_allclose(img, want_dev[key], rtol=0,
                                       atol=IMAGE_ATOL,
                                       err_msg=f"{what} {key}")
        for key in ("BP_all", "ref_skeleton"):
            maps = got[key].movedim(-3, -1).numpy()
            ref = want_dev[key]
            assert maps.shape == ref.shape, (what, key, maps.shape)
            if kind == "dance":
                np.testing.assert_allclose(
                    maps[..., :17], ref[..., :17], rtol=0, atol=HEATMAP_ATOL,
                    err_msg=f"{what} {key} heatmaps")
                _bitwise(maps[..., 17:], ref[..., 17:], f"{what} {key} limbs")
            else:
                _bitwise(maps, ref, f"{what} {key}")
        for key in ("gen_kps_clean", "gen_kps_noise"):
            if key in want_dev:
                _bitwise(got[key].numpy(), want_dev[key], f"{what} {key}")
    if kind == "face" and not over:
        # the last sample's Canny background joined its curves
        assert (got["BP_all"][0, :, 0].numpy() > 0).sum() \
            > (raw["edges"] > 0).sum()
    assert moved == (is_train and kind == "dance")


def test_loader_keeps_bytes_and_the_test_order(trees):
    opt = FaceDataset.apply_defaults(argparse.Namespace(
        **vars(_opt(trees["face"], "test")), batchSize=1,
        serial_batches=True, nThreads=0), False)
    batches = list(make_loader(FaceDataset(opt), opt, train=False))
    assert len(batches) == SEQS * 3
    first = batches[0]
    assert isinstance(first["P_all"][0], list) and len(first["P_all"][0]) == 3
    assert first["P_all"][0][0].dtype == np.uint8
    assert first["P_all_inv"].shape == (1, 3, 2, 3)
    assert first["dist"].shape == (1, 3, LOAD, LOAD, 14)
    assert [b["frame_idx"][0] for b in batches[:4]] == [3, 6, 9, 3]
    assert [b["change_seq"][0] for b in batches[:4]] == [False, False, True,
                                                         False]
    # the padded chunk repeats the sequence's last frame
    padded = batches[2]["gen_paths"][0]
    assert padded[1:] == [padded[0]] * 2


SMALL = ["--gpu_ids=-1", "--load_size=64",
         "--max_frames_per_gpu=3", "--n_frames_total=3",
         "--n_frames_pre_load_test=3", "--seed=3"]


def _cli(module, tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *SMALL, *args], cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))


@pytest.mark.parametrize("kind", ["dance", "face"])
def test_clis_train_and_stream_from_disk(trees, tmp_path, kind):
    """Two training iterations from the tree through the training CLI
    (finite losses, a checkpoint), then the serving CLI over the test
    sequences: gfla_tpu's file names, one ref_ref a sequence (the carry
    reset at each sequence's first chunk) and an mp4 of as many frames as
    were written, stitched by cv2 at each change_seq."""
    import cv2

    ckpt = tmp_path / "ckpt"
    dv = "--frames_D_V=3" if kind == "face" else "--frames_D_V=5"
    extra = ["--max_frames_per_gpu=5", "--n_frames_total=5"] \
        if kind == "dance" else []
    proc = _cli("gfla_tpu_torch.train", tmp_path, f"--model={kind}",
                f"--dataset_mode={kind}", f"--dataroot={trees[kind]}",
                "--batchSize=1", "--max_iters=2", "--print_freq=1",
                "--nThreads=0", dv, *extra, f"--checkpoints_dir={ckpt}",
                "--name=disk")
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [line for line in proc.stdout.splitlines()
              if line.startswith("(epoch:")]
    assert len(losses) == 2 and "nan" not in " ".join(losses).lower()
    for net in ("G", "D", "D_V"):
        assert (ckpt / "disk" / f"2_net_{net}.pth").exists(), net

    res = tmp_path / "res"
    proc = _cli("gfla_tpu_torch.test", tmp_path, f"--model={kind}",
                f"--dataset_mode={kind}", f"--dataroot={trees[kind]}",
                "--nThreads=0", f"--checkpoints_dir={ckpt}", "--name=disk",
                f"--results_dir={res}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    frames = sorted(Path(trees[kind]).glob(
        ("test_256/train_A" if kind == "dance" else "test_data") + "/*/*"))
    seqs = sorted({p.parent.name for p in frames})
    for seq in seqs:
        out = res / "disk" / seq
        names = sorted(p.name for p in out.iterdir())
        want = sorted([f"frame_{t:05d}_{s}.png" for t in range(FRAMES)
                       for s in ("vis", "gt")] + ["ref_ref.png"])
        assert names == want, (seq, names)
        video = cv2.VideoCapture(str(out) + "_gt_vis_.mp4")
        count = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
        video.release()
        assert count == FRAMES, (seq, count)
    assert f"wrote {SEQS * 9} frames" in proc.stdout


@pytest.mark.parametrize("kind,flags", [
    ("dance", ["--sub_dataset=fashion", "--no_device_encode",
               "--test_list=x.txt", "--use_kp"]),
    ("face", ["--no_canny_edge", "--no_dist_map",
              "--total_test_frames=30"])], ids=["dance", "face"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_dataset_options_parse_like_gfla_tpu(monkeypatch, tmp_path, kind,
                                             flags, mode):
    """The datasets' own flags arrive through their modify_options, and
    apply_defaults sets what gfla_tpu's sets, in both CLIs."""
    from gfla_tpu.options.options import TestOptions as JaxTestOptions
    from gfla_tpu.options.options import TrainOptions as JaxTrainOptions
    from gfla_tpu_torch.options import TestOptions, TrainOptions

    args = [f"--model={kind}", f"--dataset_mode={kind}", "--load_size=128",
            *flags, f"--checkpoints_dir={tmp_path}"]
    monkeypatch.setattr(sys, "argv", [f"{mode}.py", *args])
    jax_cls, port_cls = ((JaxTrainOptions, TrainOptions) if mode == "train"
                         else (JaxTestOptions, TestOptions))
    want = vars(jax_cls().parse(save=False))
    got = vars(port_cls().parse(args, save=False))
    assert got == want
    assert got["structure_nc"] == (20 if kind == "dance" else 16)


def test_learning_curve_takes_the_face_tree(trees, tmp_path):
    """tools/learning_curve.py with --model=face: the untrained generator's
    held-out evaluation, then the trainer's, on a held-out sequence."""
    from gfla_tpu_torch.tools import learning_curve

    assert learning_curve.main([
        "--model=face", "--gpu_ids=-1", f"--dataroot={trees['face']}",
        "--load_size=64", "--batchSize=1", "--n_frames_total=3",
        "--max_frames_per_gpu=3", "--frames_D_V=3", "--max_iters=1",
        "--eval_iters_freq=1", "--nThreads=0",
        f"--checkpoints_dir={tmp_path}", "--name=lc"]) == 0
    lines = (tmp_path / "lc" / "eval_log.txt").read_text().splitlines()
    assert [line.split(")")[0] for line in lines] == [
        "(epoch: 0, iters: 0", "(epoch: 0, iters: 1"]
