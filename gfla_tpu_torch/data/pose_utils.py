"""Gaussian keypoint heatmaps on the device (torch twin of
gfla_tpu/data/pose_utils.py:102-123)."""

from __future__ import annotations

import torch

MISSING_VALUE = -1


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
