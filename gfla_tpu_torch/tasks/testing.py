"""Test-time runners (counterpart of gfla_tpu/tasks/testing.py:34-103 and
gfla_tpu/tasks/shapenet.py:142-177): the pose head writes
`{src}_2_{tgt}_vis.jpg` per sample, plus the ref, gt and all panels with
--save_input or in the val phase; the ShapeNet head serves each test source
at every view of its azimuth sweep and writes `{src}_2_{target}_vis.jpg`
for each; the animation heads stream chunks, the last frame carried into the
next, and write `{frame}_vis` and `{frame}_gt` per frame, `ref_ref` per
sequence and the sequence's mp4. JPEGs go through data/image_io: nvJPEG from
the card's memory on CUDA, PIL on the CPU; PNGs (`--write_ext=png`, the
animation heads' default) through its own writer on the host."""

from __future__ import annotations

import os

import torch

from gfla_tpu_torch.data.image_io import write_jpeg, write_png
from gfla_tpu_torch.utils.images import tensor2im
from gfla_tpu_torch.utils.video import write2video


def run_test_pose(task, opt, loader) -> int:
    out_dir = os.path.join(opt.results_dir, opt.name)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for batch in loader:
        dev = task.prepare_batch(batch)
        img_gen, _, _ = task.test_step(dev)
        for i in range(img_gen.shape[0]):
            # name = splitext(splitext(src)[0] + '_2_' + tgt)[0] + '_vis.jpg'
            # (pose_model.py:108-110, base_model.py:224-237 of the original)
            src = os.path.splitext(batch["P1_path"][i])[0]
            base = os.path.join(out_dir, os.path.splitext(
                f"{src}_2_{batch['P2_path'][i]}")[0])
            gen = tensor2im(img_gen, i)
            write_jpeg(f"{base}_vis.jpg", gen)
            if getattr(opt, "save_input", False) or opt.phase == "val":
                ref, gt = tensor2im(dev["P1"], i), tensor2im(dev["P2"], i)
                write_jpeg(f"{base}_ref.jpg", ref)
                write_jpeg(f"{base}_gt.jpg", gt)
                write_jpeg(f"{base}_all.jpg", torch.cat([ref, gen, gt], 1))
            n += 1
        if n >= opt.max_dataset_size:
            break
    print(f"wrote {n} results to {out_dir}")
    return n


def run_test_shapenet(task, opt, loader) -> int:
    """Each prepared test batch carries its sources' sweeps, P2 (B, V, 3, H,
    W), BP2 (B, V, 2) and P2_path[b][v]: view v of the whole batch is one
    forward. Stops after the batch that reaches --max_dataset_size images,
    as gfla_tpu does."""
    out_dir = os.path.join(opt.results_dir, opt.name)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for batch in loader:
        dev = task.prepare_batch(batch)
        for j in range(dev["BP2"].shape[1]):
            view = {"P1": dev["P1"], "BP1": dev["BP1"],
                    "BP2": dev["BP2"][:, j], "P2": dev["P2"][:, j]}
            img = task.test_step(view)[0]
            for i in range(img.shape[0]):
                target = batch["P2_path"][i][j]
                write_jpeg(os.path.join(
                    out_dir, f"{batch['P1_path'][i]}_2_{target}_vis.jpg"),
                    tensor2im(img, i))
                n += 1
        if n >= opt.max_dataset_size:
            break
    print(f"wrote {n} results to {out_dir}")
    return n


def _write(path: str, image: torch.Tensor) -> None:
    """uint8 (H, W, 3) as a JPEG or a PNG, by the path's extension."""
    if path.lower().endswith((".jpg", ".jpeg")):
        write_jpeg(path, image)
    elif path.lower().endswith(".png"):
        write_png(path, image)
    else:
        raise ValueError(f"--write_ext: the port writes jpg or png, not "
                         f"{os.path.splitext(path)[1]!r}")


def run_test_animation(task, opt, loader) -> int:
    """Chunk after chunk of each test sequence, the last frame and skeleton
    carried into the next chunk and reset at a sequence's first chunk, as
    gfla_tpu's run_test_animation; files under
    `results_dir/name/{sequence}/`, and at a sequence's last chunk
    (`change_seq`) its gt and vis frames stitched into an mp4
    (utils/video.py, which says so where cv2 is missing)."""
    ext = getattr(opt, "write_ext", "png")
    base_dir = os.path.join(opt.results_dir, opt.name)
    carry = None
    n = 0
    for batch in loader:
        dev = task.prepare_batch(batch)
        frame_idx = batch.get("frame_idx", [0])[0]
        start = getattr(opt, "start_frame", 0)
        preload = getattr(opt, "n_frames_pre_load_test",
                          dev["BP_all"].shape[1])
        first_chunk = frame_idx == start + preload
        if first_chunk:
            carry = None
        gen, carry = task.test_step(dev, *(carry or (None, None)))
        paths = batch["gen_paths"][0]  # batchSize 1 at test time
        seq = os.path.basename(os.path.dirname(paths[0])) or "seq"
        results_dir = os.path.join(base_dir, seq)
        if first_chunk:
            _write(os.path.join(results_dir, f"ref_ref.{ext}"),
                   tensor2im(dev["ref_image"]))
        for t in range(gen.shape[1]):
            name = os.path.splitext(os.path.basename(paths[t]))[0]
            _write(os.path.join(results_dir, f"{name}_vis.{ext}"),
                   tensor2im(gen[:, t]))
            if "P_all" in dev:
                _write(os.path.join(results_dir, f"{name}_gt.{ext}"),
                       tensor2im(dev["P_all"][:, t]))
            n += 1
        if batch.get("change_seq", [False])[0]:
            write2video(results_dir, ["gt", "vis"], ext)
    print(f"wrote {n} frames under {base_dir}")
    return n
