"""Test-time runner of the pose head (counterpart of
gfla_tpu/tasks/testing.py:34-65): writes `{src}_2_{tgt}_vis.jpg` per sample,
plus ref/gt/all panels with --save_input or in the val phase."""

from __future__ import annotations

import os

import numpy as np


def tensor2im(x, index: int = 0) -> np.ndarray:
    """(B,3,H,W) tensor in [-1, 1] -> uint8 (H, W, 3)."""
    arr = x[index].detach().float().permute(1, 2, 0).cpu().numpy()
    return ((np.clip(arr, -1.0, 1.0) + 1.0) / 2.0 * 255.0).astype(np.uint8)


def _save(path: str, img: np.ndarray):
    import imageio  # only the writer needs an image library

    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, img)


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
            base = os.path.splitext(f"{src}_2_{batch['P2_path'][i]}")[0]
            _save(os.path.join(out_dir, f"{base}_vis.jpg"),
                  tensor2im(img_gen, i))
            if getattr(opt, "save_input", False) or opt.phase == "val":
                ref, gt = tensor2im(dev["P1"], i), tensor2im(dev["P2"], i)
                _save(os.path.join(out_dir, f"{base}_ref.jpg"), ref)
                _save(os.path.join(out_dir, f"{base}_gt.jpg"), gt)
                _save(os.path.join(out_dir, f"{base}_all.jpg"),
                      np.concatenate([ref, tensor2im(img_gen, i), gt], 1))
            n += 1
        if n >= opt.max_dataset_size:
            break
    print(f"wrote {n} results to {out_dir}")
    return n
