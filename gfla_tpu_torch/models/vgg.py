"""Frozen VGG19 feature extractor for the perceptual losses (NCHW).

Counterpart of gfla_tpu/models/vgg.py (the original's
external_function.py:323-444): returns every relu1_1 ... relu5_4 activation.
Inputs are used as given, [-1, 1] images with no ImageNet normalisation, as
in the original. Parameters are frozen; gradients flow to the input.

Weights come from `assets/vgg19_features.npz` when it exists (keys
`{conv}_kernel` (kh, kw, cin, cout) and `{conv}_bias`, the file gfla_tpu
reads). Without it the network is a seeded random one, with a loud warning:
training runs end to end, but the losses are not comparable with the
original's. gfla_tpu's own fallback comes from a JAX key that torch cannot
reproduce, so tests carry its parameters across with
`gfla_tpu_torch.convert.vgg19_state_dict`.

Over row bands (the data x spatial mode) its 3x3 convs take their halo
rows from the neighbouring bands (`nn.norms.Conv2d`) and its 2x2 max pools
stay inside the band, whose first row is even at every level.

The network runs in its parameters' type, the input cast to it, as
gfla_tpu's `vgg19_features` does (models/vgg.py:97-104): a task that
computes in bfloat16 casts the frozen parameters once at set-up.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfla_tpu_torch.nn.norms import Conv2d

# (name, out_channels); 'M' = 2x2 max pool
CFG = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
]

ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets", "vgg19_features.npz")


class VGG19(nn.Module):
    """forward(x (B,3,H,W)) -> {relu1_1: ..., ..., relu5_4: ...}."""

    def __init__(self):
        super().__init__()
        cin = 3
        for item in CFG:
            if item != "M":
                name, ch = item
                setattr(self, name, Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.requires_grad_(False)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = x.to(self.conv1_1.weight.dtype).contiguous(
            memory_format=torch.channels_last)
        feats = {}
        for item in CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            name, _ = item
            x = F.relu(getattr(self, name)(x))
            feats["relu" + name[4:]] = x
        return feats


def load_vgg19(path: str = ASSET_PATH, seed: int = 190219) -> VGG19:
    """The frozen VGG19 from `path`, or a seeded random one (N(0, 1/fan_in)
    kernels, zero biases) with a warning when the file is absent."""
    vgg = VGG19()
    if os.path.exists(path):
        data = np.load(path)
        sd = {}
        for item in CFG:
            if item != "M":
                name, _ = item
                sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                    data[f"{name}_kernel"].transpose(3, 2, 0, 1)))
                sd[f"{name}.bias"] = torch.from_numpy(data[f"{name}_bias"])
        vgg.load_state_dict(sd, strict=True)
        return vgg.eval()
    print("=" * 70, file=sys.stderr)
    print("WARNING: assets/vgg19_features.npz missing — perceptual losses "
          "use a\nDETERMINISTIC RANDOM VGG19. Training runs end-to-end but "
          "quality is NOT\ncomparable to the reference. Run "
          "scripts/convert_vgg_weights.py once.", file=sys.stderr)
    print("=" * 70, file=sys.stderr)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in vgg.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
                m.bias.zero_()
    return vgg.eval()
