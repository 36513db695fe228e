"""Pre-activation building blocks (NCHW), in the original GFLA's module layout.

Counterpart of gfla_tpu/nn/blocks.py:27-175,241-286. Each block keeps the
original's `nn.Sequential` indices (base_function.py:334-391,508-531,650-691)
so its checkpoints load with strict key matching: with a norm layer,
`model.0` norm, `model.2` conv, `model.3` norm, `model.5` conv; without,
`model.1` and `model.3`; a learnable shortcut is `shortcut.0`.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from gfla_tpu_torch.nn.norms import ConvTranspose2x, get_activation, norm_layer


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
                 activation: str = "ReLU"):
        super().__init__()
        self.model = _pre_act(
            norm_type, activation, input_nc,
            nn.Conv2d(input_nc, output_nc, 4, 2, 1), output_nc,
            nn.Conv2d(output_nc, output_nc, 3, 1, 1))

    def forward(self, x):
        return self.model(x)


class ResBlock(nn.Module):
    """Pre-activation residual block; the shortcut is a learnable 1x1 conv
    when input_nc != output_nc or `learnable_shortcut`."""

    def __init__(self, input_nc: int, output_nc: Optional[int] = None,
                 hidden_nc: Optional[int] = None, norm_type: str = "batch",
                 activation: str = "ReLU", learnable_shortcut: bool = False):
        super().__init__()
        output_nc = output_nc or input_nc
        hidden_nc = hidden_nc or input_nc
        self.model = _pre_act(
            norm_type, activation, input_nc,
            nn.Conv2d(input_nc, hidden_nc, 3, 1, 1), hidden_nc,
            nn.Conv2d(hidden_nc, output_nc, 3, 1, 1))
        self.learnable_shortcut = learnable_shortcut or input_nc != output_nc
        if self.learnable_shortcut:
            self.shortcut = nn.Sequential(
                nn.Conv2d(input_nc, output_nc, 1, 1, 0))

    def forward(self, x):
        s = self.shortcut(x) if self.learnable_shortcut else x
        return self.model(x) + s


class ResBlocks(nn.Module):
    """`num_blocks` ResBlocks in `model` (base_function.py:393-418)."""

    def __init__(self, num_blocks: int, input_nc: int,
                 output_nc: Optional[int] = None,
                 hidden_nc: Optional[int] = None, norm_type: str = "batch",
                 activation: str = "ReLU", learnable_shortcut: bool = False):
        super().__init__()
        hidden_nc = hidden_nc or input_nc
        output_nc = output_nc or input_nc
        kw = dict(norm_type=norm_type, activation=activation,
                  learnable_shortcut=learnable_shortcut)
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
                 activation: str = "ReLU"):
        super().__init__()
        hidden_nc = hidden_nc or input_nc
        self.model = _pre_act(
            norm_type, activation, input_nc,
            nn.Conv2d(input_nc, hidden_nc, 3, 1, 1), hidden_nc,
            ConvTranspose2x(hidden_nc, output_nc))
        self.shortcut = nn.Sequential(ConvTranspose2x(input_nc, output_nc))

    def forward(self, x):
        return self.model(x) + self.shortcut(x)


class Jump(nn.Module):
    """Skip adapter: [norm,] act, reflect pad, conv. `conv1` is registered
    both as an attribute and inside `model`, so the state dict carries it
    under both names, as the original's does."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int = 3,
                 norm_type: str = "none", activation: str = "ReLU"):
        super().__init__()
        self.conv1 = nn.Conv2d(input_nc, output_nc, kernel_size, 1, 0)
        layers = [get_activation(activation),
                  nn.ReflectionPad2d(kernel_size // 2), self.conv1]
        if norm_type != "none":
            layers.insert(0, norm_layer(norm_type, input_nc))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class Output(Jump):
    """Output head: Jump followed by tanh."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int = 3,
                 norm_type: str = "none", activation: str = "ReLU"):
        super().__init__(input_nc, output_nc, kernel_size, norm_type,
                         activation)
        self.model.append(nn.Tanh())
