"""Activation, normalisation and convolution factories (NCHW).

Counterpart of gfla_tpu/nn/norms.py:24-163, in the original GFLA's module
layout (base_function.py:175-208) so that its checkpoints load by key.
gfla_tpu's zero-padded `Conv2d` is plain `nn.Conv2d`, or `SpectralConv2d`
with `use_spect` (and `ConvTranspose2x` likewise); its reflect padding is a
separate `nn.ReflectionPad2d` in the blocks that use it, as in the original,
which keeps the key indices. gfla_tpu's `Conv3d` (the temporal
discriminator's, NDHWC there, NCDHW here) is `nn.Conv3d` or `SpectralConv3d`
(`conv3d`); `add_coords` is its CoordConv input.

Over row bands (the data x spatial mode, `gfla_tpu_torch.parallel.bands`)
the convolutions, the transposed 2x convolution, the reflection pad and the
instance norm take their input's band and return their output's: a
zero-padded conv takes its halo rows from the neighbouring bands first
(`band_conv2d`: p rows above the band and kh - s - p below), the transposed
conv the one row below (`band_conv_transpose2x`), the pad its rows
(`ReflectionPad2d`), and the norm sums its statistics over the bands. A
module built here is `nn.Conv2d`, `nn.ConvTranspose2d` or
`nn.ReflectionPad2d` without bands, bit for bit, with the same keys. The
temporal discriminator's 3-D convolutions take their rows (NCDHW's dim 3)
by the same rule (`band_conv3d`), and `add_coords` appends the band's rows
of the whole image's coordinates.

Under a bf16 compute dtype (`train.precision.cast_call`) these modules run
on bf16 copies of their parameters and buffers: InstanceNorm's reductions
then accumulate in f32 and round to bf16, as gfla_tpu's jnp reductions do
(over row bands too: `band_var_mean` sums the f32 partials over the bands
before it rounds),
and the spectral norm's power iteration runs on the bf16 weight and u; the
u it stores is kept in f32 by `cast_call`, as gfla_tpu's `to_f32` keeps it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gfla_tpu_torch import parallel


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
        if parallel.bands() is None:
            var, mean = torch.var_mean(x, dim=(2, 3), correction=0,
                                       keepdim=True)
        else:  # the band sums, then the squares about the global mean
            var, mean = band_var_mean(x)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def band_var_mean(x):
    """(biased variance, mean) over each (sample, channel)'s whole image
    from this row band, as gfla_tpu's `jnp.var` and `jnp.mean` reduce: a
    bf16 `x` is widened to f32, the mean and the squares about that f32
    mean summed in f32 (each band's partial sum, then the sum over the
    bands, before any rounding, as GSPMD all-reduces the f32 partials),
    and each statistic rounded once to `x`'s type."""
    acc = torch.promote_types(x.dtype, torch.float32)
    n = x.shape[2] * x.shape[3] * parallel.bands().size
    wide = x.to(acc)
    mean = parallel.band_sum(wide.sum((2, 3), keepdim=True)) / n
    var = parallel.band_sum(((wide - mean) ** 2).sum((2, 3),
                                                     keepdim=True)) / n
    return var.to(x.dtype), mean.to(x.dtype)


def norm_layer(norm_type: str, num_features: int) -> nn.Module:
    """'instance' or 'batch'; 'none' is handled by callers (no layer)."""
    if norm_type == "instance":
        return InstanceNorm(num_features)
    if norm_type == "batch":
        return nn.BatchNorm2d(num_features, eps=1e-5, momentum=0.1)
    raise NotImplementedError(f"normalization layer [{norm_type}] not found")


def band_conv2d(x, w, b, stride: int, padding: int):
    """F.conv2d(x, w, b, stride, padding) on a row band: output row o reads
    input rows o * s - p ... o * s - p + kh - 1, so the band takes p rows
    from the band above and kh - s - p from the band below (zeros at the
    image's edges, as the zero padding), and pads only its columns."""
    kh = w.shape[2]
    x = parallel.pad_rows(x, padding, max(0, kh - stride - padding))
    return F.conv2d(x, w, b, stride, (0, padding))


def band_conv_transpose2x(x, w, b):
    """ConvTranspose2x on a row band (rows r0 ... r0 + h - 1 -> 2 r0 ...
    2 r0 + 2h - 1): output row 2m reads input row m, 2m + 1 rows m and
    m + 1, so the band takes one row from below (zeros under the image)."""
    h = x.shape[2]
    y = F.conv_transpose2d(parallel.pad_rows(x, 0, 1), w, b, stride=2,
                           padding=1, output_padding=1)
    return y[:, :, :2 * h]


def band_conv3d(x, w, b, stride, padding):
    """F.conv3d(x, w, b, stride, padding) on a row band of NCDHW `x` (rows
    on dim 3), by `band_conv2d`'s rule: p_h rows from the band above and
    kh - s_h - p_h from the band below (zeros at the image's edges), the
    time and column axes padded as they are. The temporal discriminator's
    3^3 conv (padding 1) and its (3,4,4) stride (1,2,2) conv (padding
    (0,1,1)) each take one row from either side."""
    kh, (sd, sh, sw), (pd, ph, pw) = w.shape[3], stride, padding
    x = parallel.pad_rows(x, ph, max(0, kh - sh - ph), dim=3)
    return F.conv3d(x, w, b, (sd, sh, sw), (pd, 0, pw))


class Conv2d(nn.Conv2d):
    """nn.Conv2d that also takes a row band (`band_conv2d`) when it pads;
    an unpadded conv (1x1, or after its own pad) runs as it is."""

    def forward(self, x):
        if parallel.bands() is None or not self.padding[0]:
            return super().forward(x)
        return band_conv2d(x, self.weight, self.bias, self.stride[0],
                           self.padding[0])


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2x's nn.ConvTranspose2d, which also takes a row band
    (`band_conv_transpose2x`)."""

    def forward(self, x, output_size=None):
        if parallel.bands() is None:
            return super().forward(x, output_size)
        return band_conv_transpose2x(x, self.weight, self.bias)


class ReflectionPad2d(nn.ReflectionPad2d):
    """nn.ReflectionPad2d that also takes a row band: its columns
    reflected, its rows from the neighbouring bands, reflected at the
    image's top and bottom only."""

    def forward(self, x):
        if parallel.bands() is None:
            return super().forward(x)
        left, right, top, bottom = self.padding
        x = F.pad(x, (left, right, 0, 0), mode="reflect")
        return parallel.pad_rows(x, top, bottom, "reflect")


def _l2_normalize(x, eps: float = 1e-12):
    """flax's `_l2_normalize`: x * rsqrt(sum x^2 + eps)."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormed(nn.Module):
    """A conv whose kernel is divided by its largest singular value, with
    flax's `SpectralNorm` semantics (gfla_tpu/nn/norms.py:79-163), not
    torch's `spectral_norm`:

    * every call runs one power-iteration step from the stored u, whether or
      not it stores the result; u and v carry no gradient, sigma does;
    * vectors are normalised as x * rsqrt(sum x^2 + 1e-12);
    * u is stored only with `update_stats`; None means `self.training`.

    The state dict has the original GFLA's keys, `weight_orig`, `bias`,
    `weight_u` (cout,) and `weight_v` (fan_in,), so its checkpoints load.
    flax matricises the kernel as (kh*kw*cin, cout) and this module as
    (cout, fan_in): a permutation and a transpose, which leave u, sigma and
    the normalised kernel unchanged. The u buffer is replaced, never
    written in place, since an earlier call may have saved it for backward.
    Subclasses give the weight's shape, its (cout, fan_in) view and the
    convolution.
    """

    def __init__(self, weight_shape, out_nc: int, bias: bool = True,
                 eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(out_nc)) if bias else None
        fan_in = math.prod(weight_shape) // out_nc
        bound = 1 / math.sqrt(fan_in)
        nn.init.uniform_(self.weight_orig, -bound, bound)
        self.register_buffer("weight_u", _l2_normalize(torch.randn(out_nc)))
        self.register_buffer("weight_v", torch.zeros(fan_in))

    def matrix(self, w):
        raise NotImplementedError

    def conv(self, x, w):
        raise NotImplementedError

    def normalized_weight(self, update_stats=None):
        if update_stats is None:
            update_stats = self.training
        w = self.weight_orig
        wm = self.matrix(w)                              # (cout, fan_in)
        with torch.no_grad():
            v = _l2_normalize(wm.t() @ self.weight_u, self.eps)
        wv = wm @ v
        u = _l2_normalize(wv.detach(), self.eps)
        sigma = torch.dot(u, wv)
        if update_stats:
            self.weight_u = u
            self.weight_v = v
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x, update_stats=None):
        return self.conv(x, self.normalized_weight(update_stats))


class SpectralConv2d(SpectralNormed):
    """Spectral-norm Conv2d; weight (cout, cin, k, k)."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 eps: float = 1e-12):
        super().__init__((out_nc, in_nc, kernel_size, kernel_size), out_nc,
                         bias, eps)
        self.stride, self.padding = stride, padding

    def matrix(self, w):
        return w.reshape(w.shape[0], -1)

    def conv(self, x, w):
        if parallel.bands() is not None and self.padding:
            return band_conv2d(x, w, self.bias, self.stride, self.padding)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class SpectralConvTranspose2x(SpectralNormed):
    """Spectral-norm ConvTranspose2x; weight (cin, cout, 3, 3), normalised
    over cout as torch's `spectral_norm` does for a transposed conv."""

    def __init__(self, in_nc: int, out_nc: int, eps: float = 1e-12):
        super().__init__((in_nc, out_nc, 3, 3), out_nc, True, eps)

    def matrix(self, w):
        return w.transpose(0, 1).reshape(w.shape[1], -1)

    def conv(self, x, w):
        if parallel.bands() is not None:
            return band_conv_transpose2x(x, w, self.bias)
        return F.conv_transpose2d(x, w, self.bias, stride=2, padding=1,
                                  output_padding=1)


class SpectralConv3d(SpectralNormed):
    """Spectral-norm Conv3d; weight (cout, cin, kd, kh, kw), NCDHW input,
    torch-style (symmetric) padding."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, eps: float = 1e-12):
        ks = _triple(kernel_size)
        super().__init__((out_nc, in_nc, *ks), out_nc, bias, eps)
        self.stride, self.padding = _triple(stride), _triple(padding)

    def matrix(self, w):
        return w.reshape(w.shape[0], -1)

    def conv(self, x, w):
        if parallel.bands() is not None and self.padding[1]:
            return band_conv3d(x, w, self.bias, self.stride, self.padding)
        return F.conv3d(x, w, self.bias, self.stride, self.padding)


class Conv3d(nn.Conv3d):
    """nn.Conv3d that also takes a row band (`band_conv3d`) when it pads
    its rows; an unpadded one (the shortcut's 1^3) runs as it is."""

    def forward(self, x):
        if parallel.bands() is None or not self.padding[1]:
            return super().forward(x)
        return band_conv3d(x, self.weight, self.bias, self.stride,
                           self.padding)


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def conv3d(in_nc: int, out_nc: int, kernel_size, stride=1, padding=0,
           use_spect: bool = False) -> nn.Module:
    """Conv3d, or SpectralConv3d with `use_spect` (gfla_tpu's Conv3d)."""
    if use_spect:
        return SpectralConv3d(in_nc, out_nc, kernel_size, stride, padding)
    return Conv3d(in_nc, out_nc, kernel_size, stride, padding)


def add_coords(x: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """(B, C, H, W) -> (B, C + 2 [+ 1], H, W): the coordinates in [-1, 1]
    appended, first the one that runs along H, then along W, then with
    `with_r` their radius (gfla_tpu/nn/norms.py:192-206, which keeps the
    original AddCoords' orientation: its 'xx' channel is normalised over
    H). Over row bands the H coordinate is the band's rows of the whole
    image's, `linspace(-1, 1, S * H)`."""
    B, _, H, W = x.shape
    b = parallel.bands()
    rows = H if b is None else H * b.size
    hh, ww = (torch.linspace(-1.0, 1.0, n, dtype=x.dtype, device=x.device)
              for n in (rows, W))
    if b is not None:
        hh = hh[b.first_row(H):b.first_row(H) + H]
    hh_ch = hh[None, None, :, None].expand(B, 1, H, W)
    ww_ch = ww[None, None, None, :].expand(B, 1, H, W)
    chans = [x, hh_ch, ww_ch]
    if with_r:
        chans.append(torch.sqrt(hh_ch**2 + ww_ch**2))
    return torch.cat(chans, dim=1)


def conv2d(in_nc: int, out_nc: int, kernel_size: int, stride: int = 1,
           padding: int = 0, use_spect: bool = False) -> nn.Module:
    """Conv2d, or SpectralConv2d with `use_spect` (gfla_tpu's Conv2d)."""
    if use_spect:
        return SpectralConv2d(in_nc, out_nc, kernel_size, stride, padding)
    return Conv2d(in_nc, out_nc, kernel_size, stride, padding)


def ConvTranspose2x(in_nc: int, out_nc: int,
                    use_spect: bool = False) -> nn.Module:
    """Exact 2x upsampling: ConvTranspose2d(k=3, s=2, p=1, output_padding=1),
    or SpectralConvTranspose2x with `use_spect`."""
    if use_spect:
        return SpectralConvTranspose2x(in_nc, out_nc)
    return ConvTranspose2d(in_nc, out_nc, 3, stride=2, padding=1,
                           output_padding=1)


def init_weights(module: nn.Module, generator: torch.Generator,
                 gain: float = 0.02) -> nn.Module:
    """The original's default init (base_network.py:29-53, 'orthogonal'):
    orthogonal(gain) conv weights and zero biases; spectral-norm convs also
    draw a fresh unit u. Norm layers keep their ones and zeros, as in
    gfla_tpu."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d)):
                nn.init.orthogonal_(m.weight, gain=gain, generator=generator)
            elif isinstance(m, SpectralNormed):
                nn.init.orthogonal_(m.weight_orig, gain=gain,
                                    generator=generator)
                m.weight_u = _l2_normalize(torch.randn(
                    m.weight_u.shape, generator=generator)).to(m.weight_u)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
    return module


def recompute_keeping_u(module: nn.Module, fn, *args):
    """`fn(*args)` under torch.utils.checkpoint (its activations recomputed
    in the backward), the recomputation seeing every parameter and buffer
    of `module`'s modules as the forward saw them: the spectral-norm u the
    forward started from, and under a bf16 compute dtype the bf16 copies
    `train.precision.cast_call` had swapped in, though the call that swapped
    them has returned by the backward. It leaves each as it found it, so u
    advances once per forward, as in gfla_tpu's jax.checkpoint, which
    recomputes inside the cast (the values and gradients are those of the
    call without it).

    Over row bands the recomputation issues the forward's halo exchanges
    and band sums again, inside the backward, and every rank of a spatial
    group must issue them in the same order or the group hangs. Each rank
    has the same graph, so the backward reaches the region at the same
    point everywhere; the checkpoint's early stop (it raises once the last
    tensor the backward needs is recomputed) is turned off, so that the
    recomputation runs the whole forward on every rank, each collective
    of it once, whatever a band's graph saves."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    slots = [(store, name) for m in module.modules()
             for store in (m._parameters, m._buffers) for name in store]
    before = [store[name] for store, name in slots]
    runs = []

    def run(*args):
        after = [store[name] for store, name in slots]
        for (store, name), t in zip(slots, before):
            store[name] = t
        try:
            return fn(*args)
        finally:  # also when the recomputation stops early, by raising
            if runs:  # the recomputation in the backward
                for (store, name), t in zip(slots, after):
                    store[name] = t
            runs.append(1)

    with set_checkpoint_early_stop(parallel.bands() is None):
        return checkpoint(run, *args, use_reentrant=False)
