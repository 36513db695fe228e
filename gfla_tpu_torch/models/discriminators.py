"""Discriminators (NCHW), in the original GFLA's module layout.

Counterpart of gfla_tpu/models/discriminators.py:26-146 (the original's
discriminator.py:10-140). Each ends in a conv to a logit map, with no
sigmoid (they pair with the lsgan and hinge losses); the residual and
temporal ones end in a 1x1 conv spectral-normed whatever `use_spect` says,
as in both.

* ResDiscriminator: a stack of ResBlockEncoders. Keys: `block0`,
  `encoder{i}`, `conv`.
* TemporalDiscriminator: a clip (B, T, C, H, W) through two
  ResBlock3DEncoders (`block0`, `block1`; time shrinks by 2 and space halves
  in each), the remaining time folded into channels, then ResBlockEncoders
  (`encoder{i}`) and `conv`. The fold is gfla_tpu's, t * C + c
  (discriminators.py:88-91), not the original's c * T + t: the keys are the
  original's, but `encoder0`'s input channels are in gfla_tpu's order, so
  gfla_tpu's parameters load as they are (convert.py).
* PatchDiscriminator: the 70x70 PatchGAN, registered as `patch` (no task
  uses it, as in gfla_tpu): 4x4 convs without bias, stride 2 then 1,
  LeakyReLU between, in
  `model` (keys `model.0`, `model.2`, ...; with `use_coord` each conv
  takes the coordinate channels first, keys `model.{i}.conv.*`).
"""

from __future__ import annotations

from torch import nn

from gfla_tpu_torch.nn.blocks import ResBlock3DEncoder, ResBlockEncoder
from gfla_tpu_torch.nn.norms import (
    SpectralConv2d,
    SpectralNormed,
    add_coords,
    get_activation,
)


def _mult(i: int, ndf: int, img_f: int) -> int:
    return min(2**i, img_f // ndf)


class ResDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, img_f: int = 1024,
                 layers: int = 6, norm_type: str = "none",
                 activation: str = "LeakyReLU", use_spect: bool = True):
        super().__init__()
        self.layers = layers
        self.nonlinearity = get_activation(activation)
        kw = dict(norm_type=norm_type, activation=activation,
                  use_spect=use_spect)
        self.block0 = ResBlockEncoder(input_nc, ndf, ndf, **kw)
        mult = 1
        for i in range(layers - 1):
            mult_prev = mult
            mult = _mult(i + 1, ndf, img_f)
            setattr(self, f"encoder{i}",
                    ResBlockEncoder(ndf * mult_prev, ndf * mult,
                                    ndf * mult_prev, **kw))
        self.conv = SpectralConv2d(ndf * mult, 1, 1)

    def forward(self, x, update_stats=None):
        """x (B,3,H,W) -> logits (B,1,H/2^layers,W/2^layers). With
        `update_stats` (None: `self.training`) every spectral-norm conv
        stores its power-iteration state."""
        out = self.block0(x, update_stats)
        for i in range(self.layers - 1):
            out = getattr(self, f"encoder{i}")(out, update_stats)
        return self.conv(self.nonlinearity(out), update_stats)


class TemporalDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, input_length: int = 6,
                 ndf: int = 64, img_f: int = 1024, layers: int = 6,
                 activation: str = "LeakyReLU", use_spect: bool = True):
        super().__init__()
        self.layers = layers
        self.nonlinearity = get_activation(activation)
        kw = dict(activation=activation, use_spect=use_spect)
        self.block0 = ResBlock3DEncoder(input_nc, ndf, ndf, **kw)
        self.block1 = ResBlock3DEncoder(ndf, 2 * ndf, ndf, **kw)
        mult = 2 * (input_length - 4)
        for i in range(layers - 2):
            mult_prev = mult
            mult = _mult(i + 2, ndf, img_f)
            setattr(self, f"encoder{i}",
                    ResBlockEncoder(ndf * mult_prev, ndf * mult,
                                    ndf * mult_prev, norm_type="none", **kw))
        self.conv = SpectralConv2d(ndf * mult, 1, 1)

    def forward(self, x, update_stats=None):
        """x (B, T, C, H, W) -> logits (B, 1, H/2^layers, W/2^layers);
        `update_stats` as ResDiscriminator's."""
        out = self.block0(x.transpose(1, 2), update_stats)  # NCDHW
        out = self.block1(out, update_stats)
        B, C, T, H, W = out.shape
        out = out.transpose(1, 2).reshape(B, T * C, H, W)  # t * C + c
        for i in range(self.layers - 2):
            out = getattr(self, f"encoder{i}")(out, update_stats)
        return self.conv(self.nonlinearity(out), update_stats)


class CoordConv(nn.Module):
    """The coordinate channels (`add_coords`), then `conv` (the original's
    CoordConv, base_function.py:315-332)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x, update_stats=None):
        x = add_coords(x)
        if isinstance(self.conv, SpectralNormed):
            return self.conv(x, update_stats)
        return self.conv(x)


class PatchDiscriminator(nn.Module):
    """gfla_tpu/models/discriminators.py:109-146 (the original's
    discriminator.py:50-98): `layers` stride-2 convs (ndf * min(2^i,
    img_f / ndf) channels), a stride-1 conv at the last width, and a
    stride-1 conv to one channel; 4x4 kernels, zero padding 1, no bias,
    spectral-normed with `use_spect`."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, img_f: int = 512,
                 layers: int = 3, activation: str = "LeakyReLU",
                 use_spect: bool = True, use_coord: bool = False):
        super().__init__()

        def conv(cin, cout, stride):
            cin += 2 * use_coord
            c = (SpectralConv2d(cin, cout, 4, stride, 1, bias=False)
                 if use_spect else
                 nn.Conv2d(cin, cout, 4, stride, 1, bias=False))
            return CoordConv(c) if use_coord else c

        seq = [conv(input_nc, ndf, 2), get_activation(activation)]
        mult = 1
        for i in range(1, layers):
            mult_prev, mult = mult, _mult(i, ndf, img_f)
            seq += [conv(ndf * mult_prev, ndf * mult, 2),
                    get_activation(activation)]
        seq += [conv(ndf * mult, ndf * mult, 1), get_activation(activation),
                conv(ndf * mult, 1, 1)]
        self.model = nn.Sequential(*seq)

    def forward(self, x, update_stats=None):
        """x (B, C, H, W) -> logits (B, 1, H', W'); `update_stats` as
        ResDiscriminator's."""
        for layer in self.model:
            x = (layer(x, update_stats)
                 if isinstance(layer, (SpectralNormed, CoordConv))
                 else layer(x))
        return x
