"""Local-attention coefficients as spatial tiles: a pure layout transform.

Counterpart of gfla_tpu/ops/attn_reshape.py (the reference's CUDA op
`LocalAttnReshape`): a per-position k^2-vector of attention coefficients
(B, H, W, k^2) becomes k x k tiles (B, k*H, k*W, 1) laid out as the block
extractor's tiles, out[y, x] = in[y // k, x // k, (y % k) * k + x % k].
A reshape and a transpose, no kernel; the warp never materialises it.
"""

from __future__ import annotations

import torch


def local_attn_reshape(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, H, W, k^2) -> (B, k*H, k*W, 1); channel i*k + j goes to tile
    position (i, j)."""
    k = kernel_size
    B, H, W, K2 = x.shape
    if K2 != k * k:
        raise ValueError(f"local_attn_reshape: channel dim {K2} != k^2 = "
                         f"{k * k}")
    t = x.reshape(B, H, W, k, k).permute(0, 1, 3, 2, 4)
    return t.reshape(B, H * k, W * k, 1)


def local_attn_reshape_inverse(tiles: torch.Tensor,
                               kernel_size: int) -> torch.Tensor:
    """(B, k*H, k*W, 1) -> (B, H, W, k^2), the exact inverse."""
    k = kernel_size
    B, kH, kW, _ = tiles.shape
    H, W = kH // k, kW // k
    t = tiles.reshape(B, H, k, W, k).permute(0, 1, 3, 2, 4)
    return t.reshape(B, H, W, k * k)
