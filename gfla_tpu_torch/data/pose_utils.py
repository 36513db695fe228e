"""Keypoints of the pose datasets: the annotation strings, their mapping
onto the loaded image (numpy twins of gfla_tpu/data/pose_utils.py:28-80)
and Gaussian heatmaps on the device (torch twin of :102-123)."""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

MISSING_VALUE = -1


def load_pose_cords_from_strings(y_str: str, x_str: str) -> np.ndarray:
    """The annotation CSV's keypoint strings -> (K, 2) array of (y, x)."""
    y = json.loads(y_str)
    x = json.loads(x_str)
    return np.stack([np.asarray(y), np.asarray(x)], axis=1)


def transform_cords(cords: np.ndarray, img_size: Tuple[int, int],
                    old_size: Optional[Tuple[int, int]] = None,
                    affine_matrix: Optional[np.ndarray] = None) -> np.ndarray:
    """Rescale (y, x) keypoints from old_size to img_size and apply the
    forward 3x3 affine, truncating to int as gfla_tpu does; joints at
    MISSING_VALUE stay there."""
    old_size = img_size if old_size is None else old_size
    out = np.full_like(cords, MISSING_VALUE, dtype=np.float32)
    for i, point in enumerate(cords.astype(float)):
        if point[0] == MISSING_VALUE or point[1] == MISSING_VALUE:
            continue
        y = point[0] / old_size[0] * img_size[0]
        x = point[1] / old_size[1] * img_size[1]
        if affine_matrix is not None:
            p = affine_matrix @ np.array([x, y, 1.0])
            y, x = int(p[1]), int(p[0])
        else:
            y, x = int(y), int(x)
        out[i] = (y, x)
    return out


def encode_heatmaps(cords: torch.Tensor, height: int, width: int,
                    sigma: float = 6.0,
                    missing_value: float = MISSING_VALUE) -> torch.Tensor:
    """cords (..., K, 2) as (y, x), `missing_value` for absent joints ->
    heatmaps (..., H, W, K) on cords' device; absent joints give zero maps."""
    y = cords[..., 0]
    x = cords[..., 1]
    yy = torch.arange(height, dtype=torch.float32, device=cords.device)
    xx = torch.arange(width, dtype=torch.float32, device=cords.device)
    dy2 = (yy[:, None] - y[..., None, :]) ** 2      # (..., H, K)
    dx2 = (xx[:, None] - x[..., None, :]) ** 2      # (..., W, K)
    maps = torch.exp(-(dy2[..., :, None, :] + dx2[..., None, :, :])
                     / (2.0 * sigma**2))            # (..., H, W, K)
    present = (y != missing_value) & (x != missing_value)
    return maps * present[..., None, None, :]
