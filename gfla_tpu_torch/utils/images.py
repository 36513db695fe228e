"""Tensor to image, and flow colours (counterpart of gfla_tpu/utils/images.py,
the reference's util/util.py).

tensor2im: a [-1, 1] float tensor -> uint8 (H, W, 3) on its device, with
gfla_tpu's arithmetic. flow2color: the Middlebury colour wheel, in numpy
exactly as gfla_tpu computes it.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor2im(x: torch.Tensor, index: int = 0) -> torch.Tensor:
    """(B, C, H, W) or (C, H, W) in [-1, 1], C = 1 or 3 -> uint8 (H, W, 3)
    on x's device."""
    if x.dim() == 4:
        x = x[index]
    arr = x.detach().float().permute(1, 2, 0)
    arr = ((arr.clamp(-1.0, 1.0) + 1.0) / 2.0 * 255.0).to(torch.uint8)
    if arr.shape[-1] == 1:
        arr = arr.expand(-1, -1, 3)
    return arr.contiguous()


def _make_color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow2color(flow, index: int = 0) -> np.ndarray:
    """(B, H, W, 2) or (H, W, 2) flow, (x, y), as numpy -> uint8 colour
    wheel image (H, W, 3)."""
    f = np.asarray(flow)
    if f.ndim == 4:
        f = f[index]
    u, v = f[..., 0], f[..., 1]
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(rad.max(), 1e-8)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    frac = fk - k0
    img = np.zeros(f.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - frac) * col0 + frac * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255.0 * col)
    return img
