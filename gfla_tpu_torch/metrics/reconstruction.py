"""Reconstruction metrics: SSIM, ssim_256, PSNR, L1 and MAE (numpy and
scipy copy of gfla_tpu/metrics/reconstruction.py, itself skimage's
structural_similarity arithmetic). Images are float (H, W[, C]) in
[0, data_range]. The trainer's held-out evaluation calls `compare_ssim`,
`compare_psnr` and `compare_l1` with their defaults; the metrics CLI reads
folders through `ReconstructionMetrics.calculate_from_disk`."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
from scipy.ndimage import gaussian_filter, uniform_filter

from gfla_tpu_torch.data.image_io import read_images
from gfla_tpu_torch.runtime import select_device

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
CHUNK = 64  # images decoded at a time by ReconstructionMetrics


def _ssim_channel(x, y, data_range, win_size=51, gaussian_weights=False,
                  sigma=1.5, use_sample_covariance=True):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    if gaussian_weights:
        # skimage truncates at 3.5 sigma
        def filt(im):
            return gaussian_filter(im, sigma, truncate=3.5)
        pad = int(3.5 * sigma + 0.5)
        npts = (2 * pad + 1) ** 2
    else:
        def filt(im):
            return uniform_filter(im, win_size)
        pad = (win_size - 1) // 2
        npts = win_size**2
    cov_norm = npts / (npts - 1) if use_sample_covariance else 1.0

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    num = (2 * ux * uy + C1) * (2 * vxy + C2)
    den = (ux**2 + uy**2 + C1) * (vx + vy + C2)
    s = num / den

    # crop the filter's edge effects, as skimage does
    if pad > 0 and s.shape[0] > 2 * pad and s.shape[1] > 2 * pad:
        s = s[pad:-pad, pad:-pad]
    return s.mean()


def compare_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
                 win_size: int = 51, multichannel: bool = True,
                 gaussian_weights: bool = False, sigma: float = 1.5,
                 use_sample_covariance: bool = True) -> float:
    """Mean SSIM over channels of (H, W, C) images, or of one (H, W); the
    uniform win_size window with the sample covariance by default, or
    skimage's Gaussian window (sigma, truncated at 3.5 sigma)."""
    args = (data_range, win_size, gaussian_weights, sigma,
            use_sample_covariance)
    if multichannel and a.ndim == 3:
        return float(np.mean([_ssim_channel(a[..., c], b[..., c], *args)
                              for c in range(a.shape[-1])]))
    return float(_ssim_channel(a, b, *args))


def compare_psnr(a: np.ndarray, b: np.ndarray,
                 data_range: float = 1.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))


def compare_l1(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def compare_mae(a: np.ndarray, b: np.ndarray) -> float:
    """The original's 'mae': sum |a - b| / sum (|a| + |b|)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return float(np.sum(np.abs(a - b))
                 / (np.sum(np.abs(a) + np.abs(b)) + 1e-12))


def get_image_list(source) -> List[str]:
    """A list as given; a directory's image files (by extension, in the
    directory's order); a .txt file's lines; else the one path."""
    if isinstance(source, (list, tuple)):
        return list(source)
    if os.path.isdir(source):
        return [os.path.join(source, f) for f in os.listdir(source)
                if f.lower().endswith(IMG_EXTS)]
    if source.endswith(".txt"):
        with open(source) as f:
            return [line.strip() for line in f if line.strip()]
    return [source]


class ReconstructionMetrics:
    """The metrics over folders (gfla_tpu/metrics/reconstruction.py:100-145):
    the images decode on `device` (the first card unless given; nvJPEG
    there) with the channels they were stored with, CHUNK at a time, and
    the arithmetic is numpy on the host."""

    def __init__(self, data_range: float = 1.0, win_size: int = 51,
                 device=None):
        self.data_range = data_range
        self.win_size = win_size
        self.device = select_device("0") if device is None \
            else torch.device(device)

    def _read(self, paths) -> List[np.ndarray]:
        return [img.cpu().numpy().astype(np.float32) / 255.0
                for img in read_images(paths, self.device, "stored")]

    def calculate_from_disk(self, inputs, gts, save_path=None,
                            sort: bool = True) -> Dict[str, List[float]]:
        input_list = get_image_list(inputs)
        gt_list = get_image_list(gts)
        if sort:
            input_list, gt_list = sorted(input_list), sorted(gt_list)
        n = min(len(input_list), len(gt_list))
        psnr, ssim, ssim_256, mae, l1 = [], [], [], [], []
        for s in range(0, n, CHUNK):
            stop = min(s + CHUNK, n)
            for img_pred, img_gt in zip(self._read(input_list[s:stop]),
                                        self._read(gt_list[s:stop])):
                psnr.append(compare_psnr(img_gt, img_pred, self.data_range))
                ssim.append(compare_ssim(img_gt, img_pred, self.data_range,
                                         self.win_size))
                mae.append(compare_mae(img_gt, img_pred))
                l1.append(compare_l1(img_gt, img_pred))
                g256, p256 = img_gt * 255.0, img_pred * 255.0
                ssim_256.append(compare_ssim(
                    g256, p256, data_range=p256.max() - p256.min(),
                    gaussian_weights=True, sigma=1.5,
                    use_sample_covariance=False))
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            np.savez(os.path.join(save_path, "metrics.npz"), psnr=psnr,
                     ssim=ssim, ssim_256=ssim_256, mae=mae, l1=l1)
        out = {}
        for name, values in (("psnr", psnr), ("ssim", ssim),
                             ("ssim_256", ssim_256), ("mae", mae),
                             ("l1", l1)):
            out[name] = [round(float(np.mean(values)), 6)]
            out[f"{name}_variance"] = [round(float(np.var(values)), 6)]
        return out
