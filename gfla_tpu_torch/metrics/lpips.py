"""LPIPS (net-lin, AlexNet) perceptual distance, plain and masked (NCHW):
the arithmetic of gfla_tpu/metrics/lpips.py:40-118.

AlexNet's five conv layers (conv0 11x11 stride 4 pad 2, then 3x3 stride-2
max pools after conv0 and conv1), each ReLU output a tap; each tap
normalised over channels as x / (sqrt(sum x^2) + 1e-10), the squared
difference weighted per channel by the learned linear weights, averaged
over the positions and summed over the taps. The inputs are images in
[-1, 1], shifted and scaled by LPIPS's constants first.

The masked variant (Market-1501's mask-LPIPS) weights each tap's positions
by the body mask resized to the tap as gfla_tpu resizes it:
`jax.image.resize(..., "bilinear")`, which is a triangle filter widened by
the scale when it shrinks (antialiased), normalised per output; not
`F.interpolate`'s bilinear. `jax_resize_weights` writes those weights as
one matrix per axis.

Weights come from `$GFLA_ASSETS_DIR/lpips_alex.npz` (default
`<repo>/assets`; keys `conv{i}_kernel` (kh, kw, cin, cout), `conv{i}_bias`,
`lin{i}`), the file scripts/convert_lpips_weights.py writes. Without it the
five linear weights are gfla_tpu's exactly (|N(0, 1)| / sqrt(c) from
`np.random.RandomState(7 + i)`), and the convs a seeded random AlexNet
(N(0, 2 / fan_in) kernels, zero biases): gfla_tpu's come from a JAX key
that torch cannot reproduce, so tests carry them across with
`convert.lpips_state_dict`. Scores from the fallback are stamped
FALLBACK-WEIGHTS.
"""

from __future__ import annotations

import math
import os
import warnings
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfla_tpu_torch.data.image_io import read_images
from gfla_tpu_torch.metrics.inception import assets_dir
from gfla_tpu_torch.metrics.reconstruction import get_image_list
from gfla_tpu_torch.runtime import select_device, tf32_off

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# (out channels, kernel, stride, padding) of each conv
ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
            (256, 3, 1, 1)]
FALLBACK_SEED = 64


class AlexNetFeatures(nn.Module):
    """forward(x (B, 3, H, W)) -> the five ReLU taps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (cout, k, s, p) in enumerate(ALEX_CFG):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, s, p))
            cin = cout

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i in range(len(ALEX_CFG)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPSNet(nn.Module):
    """AlexNet's features and the five linear weights (buffers lin0..4)."""

    def __init__(self):
        super().__init__()
        self.features = AlexNetFeatures()
        for i, (c, *_) in enumerate(ALEX_CFG):
            self.register_buffer(f"lin{i}", torch.zeros(c))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def lins(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin{i}") for i in range(len(ALEX_CFG))]


@lru_cache(maxsize=32)
def jax_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of jax.image.resize's "bilinear"
    along one axis (jax/_src/image/scale.py, compute_weight_mat, antialias
    on), in its float32 arithmetic: output i samples at
    (i + 0.5) * in / out - 0.5 with a triangle widened by in / out when that
    exceeds 1, the weights normalised; an output whose sample lies outside
    the input gets none. The sample positions are float32, so their
    rounding (up to 2^-17 of the position) moves the weights; float64
    positions would leave the mask ~2e-6 off jax's."""
    f32 = np.float32
    if in_size == out_size:
        return np.eye(in_size, dtype=f32)
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None, :]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0)).astype(f32)


def resize_mask(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, 1, H, W) float -> (B, 1, h, w): jax.image.resize(mask, ...,
    "bilinear") of gfla_tpu's masked LPIPS."""
    H, W = mask.shape[-2:]
    wy = torch.from_numpy(jax_resize_weights(H, size[0])).to(mask)
    wx = torch.from_numpy(jax_resize_weights(W, size[1])).to(mask)
    return torch.einsum("bchw,yh,xw->bcyx", mask, wy, wx)


def _norm(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


def lpips_distance(net: LPIPSNet, x: torch.Tensor, y: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, y (B, 3, H, W) in [-1, 1], mask (B, 1, H, W) or None -> (B,)."""
    fx = net.features((x - net.shift) / net.scale)
    fy = net.features((y - net.shift) / net.scale)
    total = 0.0
    for tap_x, tap_y, lin in zip(fx, fy, net.lins()):
        d = (_norm(tap_x) - _norm(tap_y)) ** 2
        val = torch.einsum("bchw,c->bhw", d, lin)
        if mask is not None:
            m = resize_mask(mask, val.shape[1:])[:, 0]
            val = (val * m).sum((1, 2)) / (m.sum((1, 2)) + 1e-8)
        else:
            val = val.mean((1, 2))
        total = total + val
    return total


def npz_key(key: str) -> Tuple[str, bool]:
    """The port's state-dict key -> (npz key of gfla_tpu's layout, whether
    it is a conv kernel): `features.conv0.weight` -> `conv0_kernel`."""
    if key.startswith("features."):
        name, leaf = key[len("features."):].split(".")
        return f"{name}_{'kernel' if leaf == 'weight' else 'bias'}", \
            leaf == "weight"
    return key, False


def state_dict_from_flat(flat: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """gfla_tpu-layout arrays (conv{i}_kernel, conv{i}_bias, lin{i}) -> the
    LPIPSNet state dict; conv kernels (kh, kw, cin, cout) -> (cout, cin,
    kh, kw)."""
    sd = {}
    for key in LPIPSNet().state_dict():
        name, kernel = npz_key(key)
        value = np.asarray(flat[name], np.float32)
        if kernel:
            value = value.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


def fallback_lins() -> List[np.ndarray]:
    """gfla_tpu's fallback linear weights, bit for bit."""
    return [np.abs(np.random.RandomState(7 + i).randn(c).astype(np.float32))
            / np.sqrt(c) for i, (c, *_) in enumerate(ALEX_CFG)]


def load_lpips_params(path: str = None) -> Tuple[LPIPSNet, bool]:
    """(network in eval mode on the CPU, whether real weights were read)."""
    path = path or os.path.join(assets_dir(), "lpips_alex.npz")
    net = LPIPSNet()
    if os.path.exists(path):
        with np.load(path) as data:
            net.load_state_dict(state_dict_from_flat(dict(data)))
        return net.eval(), True
    gen = torch.Generator().manual_seed(FALLBACK_SEED)
    with torch.no_grad():
        for conv in net.features.children():
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * math.sqrt(2.0 / fan_in))
            conv.bias.zero_()
        for lin, value in zip(net.lins(), fallback_lins()):
            lin.copy_(torch.from_numpy(value))
    return net.eval(), False


def _unit(images: Sequence[torch.Tensor]) -> torch.Tensor:
    """uint8 (H, W, 3) images -> float (B, 3, H, W) in [-1, 1], as gfla_tpu's
    loader: x / 127.5 - 1 in float32."""
    return (torch.stack(images).float() / 127.5 - 1.0).permute(0, 3, 1, 2)


class LPIPS:
    """gfla_tpu's LPIPS class (lpips.py:121-181) on `device`: the first
    card unless given, f32 with TF32 off."""

    def __init__(self, batch_size: int = 32, allow_fallback: bool = False,
                 device=None):
        self.batch_size = batch_size
        self.device = select_device("0") if device is None \
            else torch.device(device)
        net, self.has_weights = load_lpips_params()
        self.net = net.to(self.device)
        self.fallback = not self.has_weights
        if self.fallback:
            msg = ("lpips_alex.npz asset missing — LPIPS would use "
                   "deterministic random features; values not comparable to "
                   "published ones.")
            if not allow_fallback:
                raise RuntimeError(
                    msg + " Pass --allow_fallback_weights (CLI) or "
                    "allow_fallback=True to proceed anyway; outputs will "
                    "be stamped FALLBACK-WEIGHTS.")
            warnings.warn(msg)

    @torch.no_grad()
    def distance(self, gen: Sequence[torch.Tensor],
                 gt: Sequence[torch.Tensor],
                 masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 (H, W, 3) images on the device, masks (B, H, W) or None ->
        (B,) distances."""
        if masks is not None:
            masks = masks.to(self.device, torch.float32)[:, None]
        with tf32_off():
            return lpips_distance(self.net, _unit(gen), _unit(gt), masks)

    def calculate_from_disk(self, generated_path, gt_path,
                            masks: Optional[List[np.ndarray]] = None,
                            sort: bool = True, verbose: bool = True) -> float:
        gen = get_image_list(generated_path)
        gt = get_image_list(gt_path)
        if sort:
            gen, gt = sorted(gen), sorted(gt)
        dists = []
        bs = self.batch_size
        for s in range(0, len(gen), bs):
            m = None if masks is None else torch.from_numpy(
                np.stack(masks[s:s + bs]).astype(np.float32))
            dists.append(self.distance(
                read_images(gen[s:s + bs], self.device),
                read_images(gt[s:s + bs], self.device), m).cpu().numpy())
        value = float(np.mean(np.concatenate(dists)))
        if verbose:
            print(f"LPIPS: {value:.4f}")
        return value
