"""Discriminator (NCHW), in the original GFLA's module layout.

Counterpart of gfla_tpu/models/discriminators.py:26-58 (the original's
discriminator.py:10-47): a stack of ResBlockEncoders and a final 1x1 conv to
a logit map, with no sigmoid (it pairs with the lsgan and hinge losses).
The final conv is spectral-normed whatever `use_spect` says, as in both.
Keys: `block0`, `encoder{i}`, `conv`.
"""

from __future__ import annotations

from torch import nn

from gfla_tpu_torch.nn.blocks import ResBlockEncoder
from gfla_tpu_torch.nn.norms import SpectralConv2d, get_activation


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
