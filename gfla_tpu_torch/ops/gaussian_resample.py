"""Gaussian-kernel flow warping (resample2d) in plain torch (NHWC).

Counterpart of gfla_tpu/ops/gaussian_resample.py:46-92 (the original's
resample2d_kernel.cu:62-93): output (y, x) with flow (fx, fy) blends the
k x k taps around (y + fy, x + fx), each weighted by a product of per-axis
Gaussians exp(-d^2 / (2 sigma^2)) of its distance from the sample point,
and divides by the weight sum. For offsets o in {-f*dil} and {(f+1)*dil},
f < k/2, the per-axis distance is |o - frac|. Tap indices clamp to the
image edge; a zero weight sum divides by 1e-8 instead (SAFE_DIV).
Autograd gives the scatter-add source gradient and the quotient-rule flow
gradient through the fractional parts.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _tap_offsets(kernel_size: int, dilation: int, device) -> torch.Tensor:
    f = torch.arange(kernel_size // 2, device=device)
    return torch.sort(torch.cat([-f * dilation, (f + 1) * dilation])).values


def gaussian_resample(source, flow, kernel_size: int = 2, dilation: int = 1,
                      sigma: float = 5.0, row0: int = 0):
    """Warp `source` (B,H,W,C) by `flow` (B,Hf,W,2), channel 0 = x, with a
    Gaussian kernel. Returns (B,Hf,W,C). The flow's rows are the source's
    rows from `row0` (a row band's, over the whole source); by default
    Hf = H from row 0."""
    B, H, W, C = source.shape
    Hf = flow.shape[1]
    k = kernel_size
    offs = _tap_offsets(k, dilation, source.device)               # (k,)
    ys = torch.arange(row0, row0 + Hf, device=flow.device, dtype=flow.dtype)
    xs = torch.arange(W, device=flow.device, dtype=flow.dtype)
    yf = flow[..., 1] + ys[None, :, None]
    xf = flow[..., 0] + xs[None, None, :]
    fy = torch.floor(yf)
    fx = torch.floor(xf)
    beta = yf - fy                                               # (B,H,W)
    alpha = xf - fx
    offf = offs.to(flow.dtype)
    dy = (offf - beta[..., None]).abs()                          # (B,H,W,k)
    dx = (offf - alpha[..., None]).abs()
    inv2s2 = 1.0 / (2.0 * sigma * sigma + _EPS)
    wy = torch.exp(-dy * dy * inv2s2)
    wx = torch.exp(-dx * dx * inv2s2)
    iy = (fy.long()[..., None] + offs).clamp(0, H - 1)
    ix = (fx.long()[..., None] + offs).clamp(0, W - 1)
    flat = (iy[..., :, None] * W + ix[..., None, :]).reshape(B, -1, 1)
    taps = torch.gather(source.reshape(B, H * W, C), 1,
                        flat.expand(-1, -1, C)).reshape(B, Hf, W, k, k, C)
    w2d = wy[..., :, None] * wx[..., None, :]                    # (B,H,W,k,k)
    val = (w2d[..., None] * taps).sum((3, 4))
    total = w2d.sum((3, 4))[..., None]
    return val / torch.where(total == 0.0, torch.full_like(total, _EPS),
                             total)
