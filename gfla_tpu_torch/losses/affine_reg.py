"""Flow-field affine regularisation (counterpart of
gfla_tpu/losses/affine_reg.py; the original's external_function.py:12-77).

For every k x k patch of the flow-displaced coordinate grid, the squared
residual of its best-fit affine transform, ||K v||^2 with
K = A (A^T A)^-1 A^T - I, averaged over patches and summed over the x and y
grids. Flows are NCHW, (B, 2, H, W) with channel 0 = x.

Over row bands (the data x spatial mode) a band's flow is its rows of the
whole flow: its grid counts rows from its first global row, takes the
k - 1 rows below it from the next band, anchors the patches at its own
rows (the last band loses the image's bottom k - 1, as the valid patches
do), and its residual sum is summed over the bands and divided by the
whole image's patch count.

The residuals and their sums are in at least f32, as gfla_tpu's einsum
with `preferred_element_type=float32` and its f32 mean: a bf16 flow's
patches are widened before the projection, and over bands the f32 band
sums are summed over the group.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Sequence

import numpy as np
import torch

from gfla_tpu_torch import parallel


@lru_cache(maxsize=8)
def _residual_projector(kz: int) -> np.ndarray:
    """K = A(A^T A)^-1 A^T - I, (k^2, k^2), float32."""
    temp = np.arange(kz)
    A = np.ones([kz * kz, 3], dtype=np.float64)
    A[:, 0] = np.repeat(temp, kz)
    A[:, 1] = np.tile(temp, kz)
    k = A @ np.linalg.inv(A.T @ A) @ A.T - np.identity(kz * kz)
    return k.astype(np.float32)


def _patches(grid, kz: int):
    """(B, H, W) -> (B, H-k+1, W-k+1, k^2) valid patches by slicing."""
    B, H, W = grid.shape
    Ho, Wo = H - kz + 1, W - kz + 1
    return torch.stack([grid[:, i:i + Ho, j:j + Wo]
                        for i in range(kz) for j in range(kz)], dim=-1)


class AffineRegularizationLoss:
    """Single-resolution affine regularisation of one flow field."""

    def __init__(self, kz: int):
        self.kz = kz
        self.projector = torch.from_numpy(_residual_projector(kz))

    def __call__(self, flow):
        B, _, H, W = flow.shape
        kz = self.kz
        b = parallel.bands()
        row0 = 0 if b is None else b.first_row(H)
        xs = torch.arange(W, device=flow.device, dtype=flow.dtype)
        ys = torch.arange(row0, row0 + H, device=flow.device,
                          dtype=flow.dtype)
        acc = torch.promote_types(flow.dtype, torch.float32)
        proj = self.projector.to(flow.device, acc)
        loss = 0.0
        for g in (flow[:, 0] + xs[None, None, :], flow[:, 1] + ys[None, :, None]):
            if b is None:
                r = _patches(g, kz).to(acc) @ proj.t()
                loss = loss + (r * r).sum(-1).mean()
                continue
            patches = _patches(parallel.pad_rows(g, 0, kz - 1, dim=1), kz)
            if b.bottom:
                patches = patches[:, :H - kz + 1]
            r = patches.to(acc) @ proj.t()
            count = B * (H * b.size - kz + 1) * (W - kz + 1)
            loss = loss + parallel.band_sum((r * r).sum()) / count
        return loss


class MultiAffineRegularizationLoss:
    """flow_fields[i] (coarse to fine) pairs with kz_dic's keys sorted
    descending."""

    def __init__(self, kz_dic: Dict[int, int]):
        self.layers = sorted(kz_dic, reverse=True)
        self.methods = {key: AffineRegularizationLoss(kz_dic[key])
                        for key in kz_dic}

    def __call__(self, flow_fields: Sequence[torch.Tensor]):
        loss = 0.0
        for i, flow in enumerate(flow_fields):
            loss = loss + self.methods[self.layers[i]](flow)
        return loss
