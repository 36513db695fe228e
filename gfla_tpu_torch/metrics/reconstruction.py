"""Reconstruction metrics of the held-out evaluation: SSIM with the uniform
51x51 window, PSNR and L1 (numpy and scipy copy of
gfla_tpu/metrics/reconstruction.py:21-80, itself skimage's
structural_similarity arithmetic). Images are float (H, W[, C]) in
[0, data_range]."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def _ssim_channel(x, y, data_range, win_size=51):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    npts = win_size**2
    cov_norm = npts / (npts - 1)  # sample covariance, as skimage's default

    ux, uy = uniform_filter(x, win_size), uniform_filter(y, win_size)
    uxx = uniform_filter(x * x, win_size)
    uyy = uniform_filter(y * y, win_size)
    uxy = uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    num = (2 * ux * uy + C1) * (2 * vxy + C2)
    den = (ux**2 + uy**2 + C1) * (vx + vy + C2)
    s = num / den

    # crop the filter's edge effects, as skimage does
    pad = (win_size - 1) // 2
    if pad > 0 and s.shape[0] > 2 * pad and s.shape[1] > 2 * pad:
        s = s[pad:-pad, pad:-pad]
    return s.mean()


def compare_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
                 win_size: int = 51) -> float:
    """Mean SSIM over channels of (H, W, C) images, or of one (H, W)."""
    if a.ndim == 3:
        return float(np.mean([
            _ssim_channel(a[..., c], b[..., c], data_range, win_size)
            for c in range(a.shape[-1])]))
    return float(_ssim_channel(a, b, data_range, win_size))


def compare_psnr(a: np.ndarray, b: np.ndarray,
                 data_range: float = 1.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))


def compare_l1(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))
