"""Test-time runners (counterpart of gfla_tpu/tasks/testing.py:34-65 and
gfla_tpu/tasks/shapenet.py:142-177): the pose head writes
`{src}_2_{tgt}_vis.jpg` per sample, plus the ref, gt and all panels with
--save_input or in the val phase; the ShapeNet head serves each test source
at every view of its azimuth sweep and writes `{src}_2_{target}_vis.jpg`
for each. Both encode through data/image_io: nvJPEG from the card's memory
on CUDA, PIL on the CPU."""

from __future__ import annotations

import os

import torch

from gfla_tpu_torch.data.image_io import write_jpeg
from gfla_tpu_torch.utils.images import tensor2im


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
