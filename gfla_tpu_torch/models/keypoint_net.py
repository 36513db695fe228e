"""The Motion Extraction Net, a temporal 1-D keypoint denoiser (counterpart
of gfla_tpu/models/keypoint_net.py; the original's KPInputNet2D and
KPInput2DGenerator, generator.py:320-382, and its norms,
base_function.py:892-934).

A dilated stack of VALID temporal convolutions with a per-sample layer
norm, conditioned through ADALN on a global feature pooled from three
stride-2 convolutions, denoises COCO-17 2-D pose sequences into Human3.6M-17
ones. The receptive field is 3^layers frames (81 at layers=4): T input
frames give T - 80 outputs.

Layout: (B, 2K, T), torch's NCT; gfla_tpu's is (B, T, 2K), and the task
transposes at its edge. The modules and parameters are named as the
original GFLA's state dict names them (`kp_input.expand_conv`,
`kp_input.layers_ln.{j}.mlp_gamma`, ...), so an original
`latest_net_G.pth` loads with strict=True. The convolutions run on
torch.nn.functional.conv1d (cuDNN on the card): gfla_tpu computes them
with nn.Conv, outside any Pallas kernel.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over all but the batch dimension, the
    variance biased."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class LayerNormAll(nn.Module):
    """Per-sample layer norm over (C, T), then a per-channel affine, (C, 1)
    (the original's LayerNorm1d, base_function.py:892-907)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, 1))
        self.bias = nn.Parameter(torch.zeros(features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        return _layer_norm(x, self.eps) * self.weight + self.bias


class ADALN1d(nn.Module):
    """Adaptive layer norm: a parameter-free norm over (C, T), then
    (1 + gamma) * y + beta per channel from the global feature through
    `mlp_shared` (Linear, ReLU), `mlp_gamma` and `mlp_beta`
    (base_function.py:910-934)."""

    def __init__(self, norm_nc: int, feature_nc: int, hidden_nc: int = 128,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.mlp_shared = nn.Sequential(nn.Linear(feature_nc, hidden_nc),
                                        nn.ReLU())
        self.mlp_gamma = nn.Linear(hidden_nc, norm_nc)
        self.mlp_beta = nn.Linear(hidden_nc, norm_nc)

    def forward(self, x: torch.Tensor, feature: torch.Tensor) -> torch.Tensor:
        h = self.mlp_shared(feature)
        gamma = self.mlp_gamma(h)[:, :, None]
        beta = self.mlp_beta(h)[:, :, None]
        return _layer_norm(x, self.eps) * (1.0 + gamma) + beta


def feature_length(t: int, k: int) -> int:
    """The global feature's length after the three stride-2 VALID convs."""
    for _ in range(3):
        t = (t - k) // 2 + 1
    return t


class KPInputNet2D(nn.Module):
    def __init__(self, keypoint_nc: int = 17, channels: int = 256,
                 layers: int = 4, dropout: float = 0.15,
                 kernel_size: int = 3):
        super().__init__()
        k, C, K2 = kernel_size, channels, 2 * keypoint_nc
        self.kernel_size, self.layers = k, layers
        self.expand_conv = nn.Conv1d(K2, C, k, bias=False)
        self.expand_ln = LayerNormAll(C)
        self.expand_drop = nn.Dropout(dropout)
        convs, norms = [], []
        dilation = k
        for _ in range(layers - 1):
            convs += [nn.Conv1d(C, C, k, dilation=dilation, bias=False),
                      nn.Conv1d(C, C, 1, bias=False)]
            norms += [ADALN1d(C, C), ADALN1d(C, C)]
            dilation *= k
        self.layers_conv = nn.ModuleList(convs)
        self.layers_ln = nn.ModuleList(norms)
        # after expand_drop: named_modules() lists the 7 dropouts in the
        # order forward calls them, which is how masks are matched to them
        self.layers_drop = nn.ModuleList(
            nn.Dropout(dropout) for _ in range(2 * (layers - 1)))
        self.shrink = nn.Conv1d(C, K2, 1)
        self.feature_conv_1 = nn.Conv1d(K2, C, k, stride=2, bias=False)
        self.feature_conv_2 = nn.Conv1d(C, C, k, stride=2, bias=False)
        self.feature_conv_3 = nn.Conv1d(C, C, k, stride=2, bias=False)

    def forward(self, kp: torch.Tensor) -> torch.Tensor:
        """kp: (B, 2K, T) -> (B, 2K, T - (3^layers - 1))."""
        k = self.kernel_size
        # The three stride-2 VALID convs consume frames: T < 15 at k=3
        # leaves an empty feature, whose mean is NaN. Refuse it.
        if feature_length(kp.shape[2], k) < 1:
            raise ValueError(
                f"KPInputNet2D: input length T={kp.shape[2]} too short for "
                f"the 3 stride-2 feature convs (k={k}); need T >= 15 for k=3")
        lrelu = lambda v: F.leaky_relu(v, 0.1)  # noqa: E731
        f = lrelu(self.feature_conv_1(kp))
        f = lrelu(self.feature_conv_2(f))
        f = lrelu(self.feature_conv_3(f))
        feature = f.mean(dim=2)  # (B, C)

        x = self.expand_drop(lrelu(self.expand_ln(self.expand_conv(kp))))
        dilation = k
        for i in range(self.layers - 1):
            pad = (k - 1) * dilation // 2
            res = x[:, :, pad:x.shape[2] - pad]
            h = self.layers_conv[2 * i](x)
            h = self.layers_drop[2 * i](
                lrelu(self.layers_ln[2 * i](h, feature)))
            h = self.layers_conv[2 * i + 1](h)
            h = self.layers_drop[2 * i + 1](
                lrelu(self.layers_ln[2 * i + 1](h, feature)))
            x = res + h
            dilation *= k
        return self.shrink(x)


class KPInput2DGenerator(nn.Module):
    """The registry's `kpinput2d` (generator.py:320-328)."""

    def __init__(self, structure_nc: int = 17, channels: int = 256,
                 layers: int = 4):
        super().__init__()
        self.kp_input = KPInputNet2D(keypoint_nc=structure_nc,
                                     channels=channels, layers=layers)

    def forward(self, input_2d: torch.Tensor) -> torch.Tensor:
        return self.kp_input(input_2d)


def init_kp_weights(module: nn.Module, generator: torch.Generator,
                    gain: float = 0.02) -> nn.Module:
    """gfla_tpu's init of this net: orthogonal(gain) conv weights (flax
    draws it over the (k * in, out) view of the kernel, torch over (out,
    in * k): the same distribution, other draws) and zero conv biases;
    Linear weights lecun-normal, truncated at two standard deviations, as
    flax's Dense default, and zero biases; the norms' ones and zeros."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv1d):
                nn.init.orthogonal_(m.weight, gain=gain, generator=generator)
            elif isinstance(m, nn.Linear):
                # flax's truncated_normal: the standard deviation of the
                # truncated draw is 0.87962566 of the untruncated one's
                std = math.sqrt(1.0 / m.in_features) / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
    return module
