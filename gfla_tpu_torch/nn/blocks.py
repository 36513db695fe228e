"""Pre-activation building blocks (NCHW), in the original GFLA's module layout.

Counterpart of gfla_tpu/nn/blocks.py:27-286. Each block keeps the
original's `nn.Sequential` indices (base_function.py:334-391,508-556,650-691)
so its checkpoints load with strict key matching: with a norm layer,
`model.0` norm, `model.2` conv, `model.3` norm, `model.5` conv; without,
`model.1` and `model.3`; a learnable shortcut is `shortcut.0`
(`shortcut.1` behind ResBlockEncoder's average pool). With `use_spect` every
conv is spectral-normed (keys `weight_orig`, `weight_u`, `weight_v`); the
generator's blocks leave `update_stats` to the module's train/eval mode.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gfla_tpu_torch.nn.norms import (
    ConvTranspose2x,
    ReflectionPad2d,
    SpectralNormed,
    conv2d,
    conv3d,
    get_activation,
    norm_layer,
)


def _pre_act(norm_type, activation, in_nc, conv1, mid_nc, conv2):
    """[norm, act, conv1, norm, act, conv2], the norm slots dropped for
    norm_type 'none'."""
    act = get_activation(activation)
    if norm_type == "none":
        return nn.Sequential(act, conv1, act, conv2)
    return nn.Sequential(norm_layer(norm_type, in_nc), act, conv1,
                         norm_layer(norm_type, mid_nc), act, conv2)


class EncoderBlock(nn.Module):
    """norm, act, conv 4x4 s2 -> norm, act, conv 3x3 s1 (H -> H/2)."""

    def __init__(self, input_nc: int, output_nc: int, norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False):
        super().__init__()
        self.model = _pre_act(
            norm_type, activation, input_nc,
            conv2d(input_nc, output_nc, 4, 2, 1, use_spect), output_nc,
            conv2d(output_nc, output_nc, 3, 1, 1, use_spect))

    def forward(self, x):
        return self.model(x)


class ResBlock(nn.Module):
    """Pre-activation residual block; the shortcut is a learnable 1x1 conv
    when input_nc != output_nc or `learnable_shortcut`."""

    def __init__(self, input_nc: int, output_nc: Optional[int] = None,
                 hidden_nc: Optional[int] = None, norm_type: str = "batch",
                 activation: str = "ReLU", learnable_shortcut: bool = False,
                 use_spect: bool = False):
        super().__init__()
        output_nc = output_nc or input_nc
        hidden_nc = hidden_nc or input_nc
        self.model = _pre_act(
            norm_type, activation, input_nc,
            conv2d(input_nc, hidden_nc, 3, 1, 1, use_spect), hidden_nc,
            conv2d(hidden_nc, output_nc, 3, 1, 1, use_spect))
        self.learnable_shortcut = learnable_shortcut or input_nc != output_nc
        if self.learnable_shortcut:
            self.shortcut = nn.Sequential(
                conv2d(input_nc, output_nc, 1, 1, 0, use_spect))

    def forward(self, x):
        s = self.shortcut(x) if self.learnable_shortcut else x
        return self.model(x) + s


class ResBlockEncoder(nn.Module):
    """Residual 2x downsampling (the discriminator's block): main [norm,]
    act, conv 3x3 s1 -> [norm,] act, conv 4x4 s2; shortcut avg-pool 2 ->
    conv 1x1. `update_stats` goes to the spectral-norm convs."""

    def __init__(self, input_nc: int, output_nc: int,
                 hidden_nc: Optional[int] = None, norm_type: str = "none",
                 activation: str = "LeakyReLU", use_spect: bool = True):
        super().__init__()
        hidden_nc = hidden_nc or input_nc
        self.model = _pre_act(
            norm_type, activation, input_nc,
            conv2d(input_nc, hidden_nc, 3, 1, 1, use_spect), hidden_nc,
            conv2d(hidden_nc, output_nc, 4, 2, 1, use_spect))
        self.shortcut = nn.Sequential(
            nn.AvgPool2d(2, 2), conv2d(input_nc, output_nc, 1, 1, 0, use_spect))

    def forward(self, x, update_stats=None):
        return (_run(self.model, x, update_stats)
                + _run(self.shortcut, x, update_stats))


class AvgPool3d(nn.AvgPool3d):
    """nn.AvgPool3d computed in at least float32 and rounded once to the
    input's type: what cuDNN-free CUDA does for a bf16 input (float sums,
    one rounding), on every device; torch's CPU pool takes no bf16. Over
    row bands the temporal discriminator's unpadded stride-2 pool needs no
    neighbour's rows: each band holds an even number of them
    (options.spatial_levels)."""

    def forward(self, x):
        acc = torch.promote_types(x.dtype, torch.float32)
        return super().forward(x.to(acc)).to(x.dtype)


class ResBlock3DEncoder(nn.Module):
    """The temporal discriminator's 3-D residual block on NCDHW input
    (gfla_tpu/nn/blocks.py:212-238, the original's base_function.py:43-67,
    which gfla_tpu runs without a norm whatever `norm_type` says): main
    act, conv 3^3 p1 -> act, conv (3,4,4) s(1,2,2) p(0,1,1); shortcut
    avg-pool (3,2,2) s(1,2,2), unpadded -> conv 1^3. Time shrinks by 2 and
    space halves. Keys `model.1`, `model.3`, `shortcut.1`."""

    def __init__(self, input_nc: int, output_nc: int,
                 hidden_nc: Optional[int] = None,
                 activation: str = "LeakyReLU", use_spect: bool = True):
        super().__init__()
        hidden_nc = hidden_nc or input_nc
        self.model = _pre_act(
            "none", activation, input_nc,
            conv3d(input_nc, hidden_nc, 3, 1, 1, use_spect), hidden_nc,
            conv3d(hidden_nc, output_nc, (3, 4, 4), (1, 2, 2), (0, 1, 1),
                   use_spect))
        self.shortcut = nn.Sequential(
            AvgPool3d((3, 2, 2), (1, 2, 2)),
            conv3d(input_nc, output_nc, 1, 1, 0, use_spect))

    def forward(self, x, update_stats=None):
        return (_run(self.model, x, update_stats)
                + _run(self.shortcut, x, update_stats))


def _run(seq, x, update_stats):
    for layer in seq:
        x = (layer(x, update_stats) if isinstance(layer, SpectralNormed)
             else layer(x))
    return x


class ResBlocks(nn.Module):
    """`num_blocks` ResBlocks in `model` (base_function.py:393-418)."""

    def __init__(self, num_blocks: int, input_nc: int,
                 output_nc: Optional[int] = None,
                 hidden_nc: Optional[int] = None, norm_type: str = "batch",
                 activation: str = "ReLU", learnable_shortcut: bool = False,
                 use_spect: bool = False):
        super().__init__()
        hidden_nc = hidden_nc or input_nc
        output_nc = output_nc or input_nc
        kw = dict(norm_type=norm_type, activation=activation,
                  learnable_shortcut=learnable_shortcut, use_spect=use_spect)
        if num_blocks == 1:
            blocks = [ResBlock(input_nc, output_nc, hidden_nc, **kw)]
        else:
            blocks = [ResBlock(input_nc, hidden_nc, hidden_nc, **kw)]
            blocks += [ResBlock(hidden_nc, hidden_nc, hidden_nc, **kw)
                       for _ in range(num_blocks - 2)]
            blocks += [ResBlock(hidden_nc, output_nc, hidden_nc, **kw)]
        self.model = nn.Sequential(*blocks)

    def forward(self, x):
        return self.model(x)


class ResBlockDecoder(nn.Module):
    """Residual 2x upsampling: main norm, act, conv 3x3 -> norm, act, convT;
    shortcut convT."""

    def __init__(self, input_nc: int, output_nc: int,
                 hidden_nc: Optional[int] = None, norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False):
        super().__init__()
        hidden_nc = hidden_nc or input_nc
        self.model = _pre_act(
            norm_type, activation, input_nc,
            conv2d(input_nc, hidden_nc, 3, 1, 1, use_spect), hidden_nc,
            ConvTranspose2x(hidden_nc, output_nc, use_spect))
        self.shortcut = nn.Sequential(
            ConvTranspose2x(input_nc, output_nc, use_spect))

    def forward(self, x):
        return self.model(x) + self.shortcut(x)


class Jump(nn.Module):
    """Skip adapter: [norm,] act, reflect pad, conv. `conv1` is registered
    both as an attribute and inside `model`, so the state dict carries it
    under both names, as the original's does."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int = 3,
                 norm_type: str = "none", activation: str = "ReLU",
                 use_spect: bool = False):
        super().__init__()
        self.conv1 = conv2d(input_nc, output_nc, kernel_size, 1, 0, use_spect)
        layers = [get_activation(activation),
                  ReflectionPad2d(kernel_size // 2), self.conv1]
        if norm_type != "none":
            layers.insert(0, norm_layer(norm_type, input_nc))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class Output(Jump):
    """Output head: Jump followed by tanh."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int = 3,
                 norm_type: str = "none", activation: str = "ReLU",
                 use_spect: bool = False):
        super().__init__(input_nc, output_nc, kernel_size, norm_type,
                         activation, use_spect)
        self.model.append(nn.Tanh())
