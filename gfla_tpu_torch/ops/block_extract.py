"""Flow-guided k x k block extraction in plain torch (NHWC).

Counterpart of gfla_tpu/ops/block_extract.py:40-72,155-217: every flow cell
(y, x) takes the k x k neighbourhood of `source` around (y + flow_y,
x + flow_x), each tap bilinear between edge-clamped integer reads. All k^2
offsets share the same fractional weights, so one (k+1) x (k+1) integer
footprint per cell feeds every offset. Taps clamp to the image edge, which is
why `grid_sample` (zero or border padding per sample point) is not used.
Flow is (B, H, W, 2) with channel 0 = x; `source` is at flow resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patch_index(flow, H: int, W: int, kernel_size: int):
    """Pixel index iy * W + ix of each edge-clamped (k+1)x(k+1) footprint tap
    of an H x W source, (B,Hf,Wf,k+1,k+1), and the fractional weights wy, wx
    (B,Hf,Wf) that all k^2 offsets share."""
    k = kernel_size
    r = k // 2
    Hf, Wf = flow.shape[1:3]
    ys = torch.arange(Hf, device=flow.device, dtype=flow.dtype)
    xs = torch.arange(Wf, device=flow.device, dtype=flow.dtype)
    dy = flow[..., 1] + ys[None, :, None]
    dx = flow[..., 0] + xs[None, None, :]
    fy = torch.floor(dy)
    fx = torch.floor(dx)
    offs = torch.arange(k + 1, device=flow.device) - r
    iy = (fy.long()[..., None] + offs).clamp(0, H - 1)      # (B,Hf,Wf,k+1)
    ix = (fx.long()[..., None] + offs).clamp(0, W - 1)
    return iy[..., :, None] * W + ix[..., None, :], dy - fy, dx - fx


def _patch_gather(source, flow, kernel_size: int):
    """Edge-clamped (k+1)x(k+1) integer footprints and fractional weights.
    Returns patch (B,H,W,k+1,k+1,C), wy and wx (B,H,W)."""
    B, H, W, C = source.shape
    k = kernel_size
    flat, wy, wx = patch_index(flow, H, W, k)
    patch = torch.gather(source.reshape(B, H * W, C), 1,
                         flat.reshape(B, -1, 1).expand(-1, -1, C))
    return patch.reshape(B, *flat.shape[1:3], k + 1, k + 1, C), wy, wx


def block_extract(source, flow, kernel_size: int):
    """(B,H,W,C) source, (B,H,W,2) flow -> (B,H,W,k*k,C) blocks; offset index
    i*k + j samples source at (y + flow_y + i - k//2, x + flow_x + j - k//2)."""
    k = kernel_size
    patch, wy, wx = _patch_gather(source, flow, k)
    wy = wy[..., None, None, None]
    wx = wx[..., None, None, None]
    block = ((1.0 - wy) * (1.0 - wx) * patch[:, :, :, :k, :k]
             + (1.0 - wy) * wx * patch[:, :, :, :k, 1:]
             + wy * (1.0 - wx) * patch[:, :, :, 1:, :k]
             + wy * wx * patch[:, :, :, 1:, 1:])
    B, H, W = block.shape[:3]
    return block.reshape(B, H, W, k * k, -1)


def extract_patches(x, kernel_size: int):
    """Zero-flow blocks: edge-padded k x k patches by pad and shift, no gather.
    (B,H,W,C) -> (B,H,W,k*k,C)."""
    k = kernel_size
    r = k // 2
    B, H, W, C = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (r, k - 1 - r, r, k - 1 - r),
               mode="replicate").permute(0, 2, 3, 1)
    return torch.stack([xp[:, i:i + H, j:j + W, :]
                        for i in range(k) for j in range(k)], dim=3)
