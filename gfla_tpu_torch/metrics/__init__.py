"""Offline metrics of the port (gfla_tpu/metrics): FID, LPIPS (plain and
masked) and the reconstruction metrics, on the card unless told the CPU;
`python -m gfla_tpu_torch.metrics` is the CLI."""

import os

from gfla_tpu_torch.metrics.fid import FID, calculate_frechet_distance
from gfla_tpu_torch.metrics.lpips import LPIPS
from gfla_tpu_torch.metrics.reconstruction import (
    ReconstructionMetrics,
    compare_l1,
    compare_mae,
    compare_psnr,
    compare_ssim,
    get_image_list,
)

__all__ = [
    "FID",
    "LPIPS",
    "ReconstructionMetrics",
    "calculate_frechet_distance",
    "compare_l1",
    "compare_mae",
    "compare_psnr",
    "compare_ssim",
    "get_image_list",
    "preprocess_path_for_deform_task",
]


def preprocess_path_for_deform_task(gt_path: str, distorted_path: str):
    """Pair generated files back to their GT by the `{src}_2_{tgt}_vis`
    naming: each generated image's GT is `{tgt}.jpg` in gt_path; a missing
    one is reported and its image left out."""
    distorted_image_list = sorted(get_image_list(distorted_path))
    gt_list, distorted_list = [], []
    for distorted_image in distorted_image_list:
        image = os.path.basename(distorted_image)
        image = image.split("_2_")[-1]
        image = image.split("_vis")[0] + ".jpg"
        gt_image = os.path.join(gt_path, image)
        if not os.path.isfile(gt_image):
            print(f"missing GT: {gt_image}")
            continue
        gt_list.append(gt_image)
        distorted_list.append(distorted_image)
    return gt_list, distorted_list
