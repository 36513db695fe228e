"""The datasets' image passes on tensors. `resize_like_pil` is the ShapeNet
dataset's PIL resize. `affine_resize_normalize`, for the pose datasets, is
an inverse affine warp, bilinear resize and [-1, 1] normalization in one
batched function (torch twin of
gfla_tpu's native pass, native/gfla_host.cc:27-68 through
gfla_tpu/data/native.py:59-89, which gfla_tpu takes wherever its native
library builds). It is data preparation, not a TPU kernel: on the card it
runs on the device right after the decode, in plain torch ops.

The native pass maps output pixel (x, y) through the 2x3 inverse matrix
(output-scale units) and scales by (W0/dw, H0/dh), with no half-pixel
offset; an output pixel whose top-left tap lies beyond one pixel outside the
image is the fill colour, and each tap outside the image reads the fill.
gfla_tpu's build (-O3 -march=native) fuses the first product of each mapped
coordinate into its sum: `fma(m0, x, m1 * y) + m2`. The port computes that
fused sum exactly (the product of two float32 is exact in float64, rounded
once): a float32 sum of rounded products moves a tap's weight by an ulp of
the coordinate, which the blend turns into more than 1e-5 of the output.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

FILL = (128.0, 128.0, 128.0)


def _fused(m0, x, m1y):
    """float32 fma(m0, x, m1y): one rounding of the exact m0 * x + m1y."""
    return (m0.double() * x.double() + m1y.double()).float()


def affine_resize_normalize(src: torch.Tensor, out_hw: Tuple[int, int],
                            inverse: Optional[torch.Tensor] = None,
                            fill=FILL) -> torch.Tensor:
    """uint8 (B, H0, W0, 3) -> float32 (B, dh, dw, 3) in [-1, 1] on src's
    device. `inverse` is (B, 2, 3) or (B, 6), float32: each image's output
    pixel -> input map in output-scale units (affine.inverse_affine_matrix);
    None is the identity, a plain resize."""
    if src.dtype != torch.uint8 or src.dim() != 4 or src.shape[-1] != 3:
        raise ValueError(f"affine_resize_normalize: want uint8 (B, H, W, 3), "
                         f"got {src.dtype} {tuple(src.shape)}")
    B, sh, sw, _ = src.shape
    dh, dw = out_hw
    dev = src.device
    f32 = dict(dtype=torch.float32, device=dev)
    if inverse is None:
        inverse = torch.tensor([1, 0, 0, 0, 1, 0], **f32).expand(B, 6)
    m = inverse.to(**f32).reshape(B, 6, 1, 1).unbind(1)
    sx = torch.tensor(sw, **f32) / dw
    sy = torch.tensor(sh, **f32) / dh
    x = torch.arange(dw, **f32).view(1, 1, dw)
    y = torch.arange(dh, **f32).view(1, dh, 1)
    fx = (_fused(m[0], x, m[1] * y) + m[2]) * sx      # (B, dh, dw)
    fy = (_fused(m[3], x, m[4] * y) + m[5]) * sy
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    ax, ay = (fx - x0f)[..., None], (fy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    fill = torch.tensor(fill, **f32)
    flat = src.reshape(B * sh * sw, 3)
    base = (torch.arange(B, device=dev) * (sh * sw)).view(B, 1, 1)

    def tap(yy, xx):
        inside = (xx >= 0) & (yy >= 0) & (xx < sw) & (yy < sh)
        idx = base + yy.clamp(0, sh - 1) * sw + xx.clamp(0, sw - 1)
        return torch.where(inside[..., None], flat[idx].float(), fill)

    out = ((1 - ay) * ((1 - ax) * tap(y0, x0) + ax * tap(y0, x0 + 1))
           + ay * ((1 - ax) * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1)))
    whole = (x0 < -1) | (y0 < -1) | (x0 >= sw) | (y0 >= sh)
    out = torch.where(whole[..., None], fill, out)
    return out / 127.5 - 1.0


def resample_images(images, out_hw: Tuple[int, int],
                    inverse: torch.Tensor) -> torch.Tensor:
    """A list of decoded uint8 (H0, W0, 3) tensors on one device and their
    (N, 2, 3) inverse matrices -> float32 (N, dh, dw, 3): one
    `affine_resize_normalize` for each input size (one for a dataset whose
    images share a size)."""
    sizes = sorted({tuple(img.shape) for img in images})
    if len(sizes) == 1:
        return affine_resize_normalize(torch.stack(images), out_hw, inverse)
    out = torch.empty((len(images), *out_hw, 3), dtype=torch.float32,
                      device=inverse.device)
    for size in sizes:
        idx = [i for i, img in enumerate(images) if tuple(img.shape) == size]
        out[idx] = affine_resize_normalize(
            torch.stack([images[i] for i in idx]), out_hw, inverse[idx])
    return out


PIL_BITS = 22  # Pillow's fixed-point precision for 8-bit images


@lru_cache(maxsize=16)
def _pil_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's bilinear resampling weights along one axis
    (libImaging/Resample.c, precompute_coeffs and normalize_coeffs_8bpc):
    output pixel i reads the inputs in [xmin, xmax) around the centre
    (i + 0.5) * scale with a triangle widened by the scale when it shrinks,
    normalised, and rounded to integers of PIL_BITS fraction bits. Returned
    as a dense (out_size, in_size) float64 matrix of those integers; the
    arithmetic below keeps Pillow's order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support is 1
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = [max(0.0, 1.0 - abs((x - center + 0.5) * ss))
             for x in range(xmin, xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in zip(range(xmin, xmax), k):
            out[i, x] = int(0.5 + (w / ww if ww else w) * (1 << PIL_BITS))
    return out


def _pil_pass(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """One of Pillow's two passes over the uint8 values in float64 `x`
    (N, H, W, 3), along `dim` (2: the rows' pixels, 1: the columns'): each
    output is (sum of weight * value + 2^(PIL_BITS-1)) >> PIL_BITS, clipped
    to [0, 255]. The sums are integers below 2^53, so float64 holds them
    exactly."""
    w = torch.from_numpy(_pil_bilinear_weights(x.shape[dim], size)).to(
        x.device)
    eq = "nhwc,ow->nhoc" if dim == 2 else "nhwc,oh->nowc"
    acc = torch.einsum(eq, x, w)
    return torch.floor((acc + 2.0 ** (PIL_BITS - 1)) / 2.0 ** PIL_BITS
                       ).clamp_(0, 255)


def resize_like_pil(images: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 (..., size, size, 3) in [-1, 1] on
    the images' device: PIL's `resize((size, size), BILINEAR)` of each
    image (gfla_tpu/data/shapenet_data.py:76-81), then / 127.5 - 1. As
    Pillow does, the rows are resampled first and rounded to uint8, then the
    columns, in Pillow's fixed-point arithmetic, so the pixels are PIL's. At
    the stored size PIL copies, and so does this."""
    if images.dtype != torch.uint8 or images.shape[-1] != 3:
        raise ValueError(f"resize_like_pil: want uint8 (..., H, W, 3), got "
                         f"{images.dtype} {tuple(images.shape)}")
    lead, (h, w) = images.shape[:-3], images.shape[-3:-1]
    x = images.reshape(-1, h, w, 3)
    if (h, w) != (size, size):
        x = x.double()
        if w != size:
            x = _pil_pass(x, 2, size)
        if h != size:
            x = _pil_pass(x, 1, size)
    return (x.float() / 127.5 - 1.0).reshape(*lead, size, size, 3)
