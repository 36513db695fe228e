"""Inception-v3 pool3 features for FID (NCHW): the graph of
gfla_tpu/metrics/inception.py:38-178, which is torchvision's inception_v3
up to the 2048-wide global pool, with gfla_tpu's own choices kept:

- each ConvBN is a bias-free conv, BatchNorm in inference mode with eps
  1e-3, and ReLU; the factorised 1x7, 7x1, 1x3 and 3x1 convs keep their
  (ph, pw) padding;
- the 3x3 stride-1 average pools inside the Mixed blocks divide by 9,
  the zero padding included (`count_include_pad=True`, gfla_tpu's `_pool`,
  not pytorch-fid's FIDInceptionA-E, which leave the padding out);
- the max pools are 3x3 stride 2 with no padding;
- the input is an image in [0, 1], mapped to 2x - 1; the output is the
  spatial mean of Mixed_7c, (B, 2048).

Weights come from `$GFLA_ASSETS_DIR/inception_v3.npz` (default
`<repo>/assets`), the file scripts/convert_inception_weights.py writes in
gfla_tpu's layout (`params/<Module>/<branch>/conv/kernel` (kh, kw, cin,
cout), `.../bn/scale|bias`, `batch_stats/.../bn/mean|var`); keys the file
lacks keep their initial values, as in gfla_tpu. Without the file the
network is a seeded random one (N(0, 2 / fan_in) kernels, BatchNorm the
identity), and every score from it is stamped FALLBACK-WEIGHTS.
gfla_tpu's fallback comes from a JAX key that torch cannot reproduce, so
tests carry its parameters across with `convert.inception_state_dict`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FALLBACK_SEED = 299


def assets_dir() -> str:
    """$GFLA_ASSETS_DIR, else the repo's assets/, read at call time."""
    return os.environ.get("GFLA_ASSETS_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "assets"))


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max3(x):
    return F.max_pool2d(x, 3, 2)


class MixedA(nn.Module):
    """Inception A (35x35)."""

    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg3(x))], 1)


class MixedB(nn.Module):
    """Reduction A (35 -> 17)."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3(x)], 1)


class MixedC(nn.Module):
    """Inception B (17x17), 7x1 and 1x7 factorised."""

    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg3(x))], 1)


class MixedD(nn.Module):
    """Reduction B (17 -> 8)."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max3(x)], 1)


class MixedE(nn.Module):
    """Inception C (8x8), branched 1x3 and 3x1."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg3(x))], 1)


class InceptionV3Features(nn.Module):
    """forward(x (B, 3, H, W) in [0, 1], H, W >= 75) -> (B, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = MixedA(192, 32)
        self.Mixed_5c = MixedA(256, 64)
        self.Mixed_5d = MixedA(288, 64)
        self.Mixed_6a = MixedB(288)
        self.Mixed_6b = MixedC(768, 128)
        self.Mixed_6c = MixedC(768, 160)
        self.Mixed_6d = MixedC(768, 160)
        self.Mixed_6e = MixedC(768, 192)
        self.Mixed_7a = MixedD(768)
        self.Mixed_7b = MixedE(1280)
        self.Mixed_7c = MixedE(2048)
        self.requires_grad_(False)

    def forward(self, x):
        x = 2 * x - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max3(x)))
        x = _max3(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean((2, 3))


# the port's key suffix -> (gfla_tpu collection, gfla_tpu leaf path)
_FLAX_LEAF = {
    "conv.weight": ("params", "conv/kernel"),
    "bn.weight": ("params", "bn/scale"),
    "bn.bias": ("params", "bn/bias"),
    "bn.running_mean": ("batch_stats", "bn/mean"),
    "bn.running_var": ("batch_stats", "bn/var"),
}


def flax_key(key: str) -> Tuple[str, str]:
    """The port's state-dict key -> (npz key of gfla_tpu's layout, the
    leaf's kind): `Mixed_5b.branch1x1.conv.weight` ->
    `params/Mixed_5b/branch1x1/conv/kernel`. Raises KeyError for a key
    gfla_tpu has no counterpart of (BatchNorm's num_batches_tracked)."""
    parts = key.split(".")
    suffix = ".".join(parts[-2:])
    collection, leaf = _FLAX_LEAF[suffix]
    return f"{collection}/{'/'.join(parts[:-2])}/{leaf}", suffix


def state_dict_from_flat(flat: Dict[str, np.ndarray],
                         keys) -> Dict[str, torch.Tensor]:
    """gfla_tpu-layout arrays keyed as `flax_key` names them -> the port's
    state dict for those of `keys` that `flat` holds; conv kernels (kh, kw,
    cin, cout) -> (cout, cin, kh, kw)."""
    sd = {}
    for key in keys:
        try:
            npz_key, suffix = flax_key(key)
        except KeyError:
            continue
        if npz_key not in flat:
            continue
        value = np.asarray(flat[npz_key], np.float32)
        if suffix == "conv.weight":
            value = value.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


def _fallback(net: nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * math.sqrt(2.0 / fan_in))


def load_inception_params(path: str = None
                          ) -> Tuple[InceptionV3Features, bool]:
    """(network in eval mode on the CPU, whether real weights were read):
    from `path` (default `assets_dir()/inception_v3.npz`) when it exists,
    else the seeded fallback."""
    path = path or os.path.join(assets_dir(), "inception_v3.npz")
    net = InceptionV3Features()
    _fallback(net, FALLBACK_SEED)
    if not os.path.exists(path):
        return net.eval(), False
    with np.load(path) as data:
        sd = state_dict_from_flat(dict(data), net.state_dict().keys())
    net.load_state_dict(sd, strict=False)
    return net.eval(), True
