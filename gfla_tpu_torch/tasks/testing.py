"""Test-time runner of the pose head (counterpart of
gfla_tpu/tasks/testing.py:34-65): writes `{src}_2_{tgt}_vis.jpg` per sample,
plus the ref, gt and all panels with --save_input or in the val phase,
through data/image_io's encoder: nvJPEG from the card's memory on CUDA, PIL
on the CPU."""

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
