"""Activation, normalisation and convolution factories (NCHW).

Counterpart of gfla_tpu/nn/norms.py:24-163 on the serving path, in the
original GFLA's module layout (base_function.py:175-208) so that its
checkpoints load by key. gfla_tpu's zero-padded `Conv2d` is plain
`nn.Conv2d`; its reflect padding is a separate `nn.ReflectionPad2d` in the
blocks that use it, as in the original, which keeps the key indices.
Spectral norm, Conv3d and CoordConv are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


def get_activation(name: str) -> nn.Module:
    """Activation factory (reference base_function.py:196-208)."""
    if name == "ReLU":
        return nn.ReLU()
    if name == "SELU":
        return nn.SELU()
    if name == "LeakyReLU":
        return nn.LeakyReLU(0.1)
    if name == "PReLU":
        raise NotImplementedError(
            "activation [PReLU] has learnable slopes and is not implemented")
    raise NotImplementedError(f"activation [{name}] is not found")


class InstanceNorm(nn.InstanceNorm2d):
    """InstanceNorm2d(affine=True): eps 1e-5, biased variance, no running
    stats. Written out so that `channels_last` input stays `channels_last`
    (torch's fused instance norm returns NCHW-contiguous memory)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, affine=True,
                         track_running_stats=False)

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def norm_layer(norm_type: str, num_features: int) -> nn.Module:
    """'instance' or 'batch'; 'none' is handled by callers (no layer)."""
    if norm_type == "instance":
        return InstanceNorm(num_features)
    if norm_type == "batch":
        return nn.BatchNorm2d(num_features, eps=1e-5, momentum=0.1)
    raise NotImplementedError(f"normalization layer [{norm_type}] not found")


def ConvTranspose2x(in_nc: int, out_nc: int) -> nn.ConvTranspose2d:
    """Exact 2x upsampling: ConvTranspose2d(k=3, s=2, p=1, output_padding=1)."""
    return nn.ConvTranspose2d(in_nc, out_nc, 3, stride=2, padding=1,
                              output_padding=1)


def init_weights(module: nn.Module, generator: torch.Generator,
                 gain: float = 0.02) -> nn.Module:
    """The original's default init (base_network.py:29-53, 'orthogonal'):
    orthogonal(gain) conv weights and zero biases. Norm layers keep their
    ones and zeros, as in gfla_tpu."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.orthogonal_(m.weight, gain=gain, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module
