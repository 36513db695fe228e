"""The trainer's held-out evaluation and visuals (counterpart of gfla_tpu's
train.py:64-111, :126-142 and :202-266). In the data x spatial mode each
rank of rank 0's spatial group runs the generator on its row band (an
animation clip's frames too), and the outputs and inputs are gathered
whole (`parallel.whole`) before they are scored or drawn; keypoint's
group holds its batch whole."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gfla_tpu_torch import parallel
from gfla_tpu_torch.utils.images import flow2color, tensor2im

HOLDOUT_SEED = 9973


def holdout_indices(n: int, batch_size: int,
                    seed: int) -> Optional[np.ndarray]:
    """The batch of samples training never sees, as gfla_tpu's train.py
    draws it; None when the dataset has fewer than two batches."""
    if n < 2 * batch_size:
        return None
    rng = np.random.RandomState(seed + HOLDOUT_SEED)
    return np.sort(rng.choice(n, size=batch_size, replace=False))


def _unit(images: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) in [-1, 1] -> float (B, H, W, 3) in [0, 1] on the host."""
    arr = images.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return np.clip((arr + 1.0) / 2.0, 0.0, 1.0)


def _centre(x: np.ndarray, T: int) -> np.ndarray:
    """The T frames at the middle of (B, T', C)."""
    return x[:, (x.shape[1] - T) // 2:][:, :T]


def evaluate_held_out(task, batch) -> Dict[str, float]:
    """Mean SSIM, PSNR and L1 of the generator's eval-mode output against
    P2 over a prepared batch, or for an animation clip over its B * T frames
    against P_all's; {} for a task that generates no image (poseflownet).
    For the keypoint head: kp_mse, the mean squared error of the denoised
    window (its centre T frames) against gt_data, and kp_mse_identity, the
    raw input's centre T frames against it, the floor a denoiser must
    beat."""
    # imported here: the metrics bring scipy, which a run that never
    # evaluates (a rank of a short data-parallel run) need not load
    from gfla_tpu_torch.metrics.reconstruction import (
        compare_l1,
        compare_psnr,
        compare_ssim,
    )

    out = parallel.whole(task.test_step(batch))
    batch = parallel.whole(batch)
    if "gt_data" in batch and "input_data" in batch:
        gt = batch["gt_data"].cpu().numpy()
        T = gt.shape[1]
        out_c = _centre(out.cpu().numpy(), T)
        inp_c = _centre(batch["input_data"].cpu().numpy(), T)
        return {"kp_mse": float(np.mean((out_c - gt) ** 2)),
                "kp_mse_identity": float(np.mean((inp_c - gt) ** 2))}
    if "P_all" in batch:  # (B, T, 3, H, W) frames
        T = out[0].shape[1]
        gen, gt = (_unit(x.flatten(0, 1))
                   for x in (out[0], batch["P_all"][:, :T]))
    elif len(out) != 3:
        return {}
    else:
        gen, gt = _unit(out[0]), _unit(batch["P2"])
    return {name: float(np.mean([fn(gen[i], gt[i]) for i in range(len(gen))]))
            for name, fn in (("ssim", compare_ssim), ("psnr", compare_psnr),
                             ("l1", compare_l1))}


def current_visuals(task, batch) -> Dict[str, torch.Tensor]:
    """The first sample's uint8 (H, W, 3) visuals: P1, BP2 (its heatmaps'
    maximum; not for ShapeNet's viewpoint labels), the generated image, P2,
    and per attention level the flow's colours and the occlusion mask; for
    an animation clip, its last generated frame, as gfla_tpu shows; none
    for the keypoint head."""
    if "input_data" in batch:
        return {}
    if "P_all" in batch:
        return {"img_gen": tensor2im(parallel.whole(
            task.test_step(batch)[0][:, -1]))}
    out = parallel.whole(task.test_step(batch))
    batch = parallel.whole(batch)
    visuals = {"input_P1": tensor2im(batch["P1"])}
    if batch["BP2"].dim() == 4:
        visuals["input_BP2"] = tensor2im(
            batch["BP2"][:1].amax(1, keepdim=True) * 2.0 - 1.0)
    if len(out) == 3:
        visuals["img_gen"] = tensor2im(out[0])
    visuals["input_P2"] = tensor2im(batch["P2"])
    flows, masks = out[-2:]
    for j, (flow, mask) in enumerate(zip(flows, masks)):
        visuals[f"flow_field{j}"] = torch.from_numpy(flow2color(
            flow[0].float().permute(1, 2, 0).cpu().numpy()))
        visuals[f"mask{j}"] = tensor2im(mask * 2.0 - 1.0)
    return visuals
