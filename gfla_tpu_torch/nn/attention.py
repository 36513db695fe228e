"""ExtractorAttn: learned local attention over flow-displaced source blocks.

Counterpart of gfla_tpu/nn/attention.py. Parameters keep the original's
layout (base_function.py:790-818): `fully_connect_layer.0` is the stride-k
Conv2d(2C -> D, k) over [target || source] tiles and `fully_connect_layer.2`
the 1x1 Conv2d(D -> k*k). The forward maps them to gfla_tpu's dense layout,
w1 (k*k, 2C, D) and w2 (D, k*k) (gfla_tpu/convert/torch_mapping.py:51-61), and
calls `ops.local_attn.local_attn_warp` on NHWC views of the channels_last
activations.
"""

from __future__ import annotations

from torch import nn

from gfla_tpu_torch.nn.norms import get_activation
from gfla_tpu_torch.ops.local_attn import local_attn_warp


class ExtractorAttn(nn.Module):
    def __init__(self, feature_nc: int, kernel_size: int = 4,
                 activation: str = "LeakyReLU", hidden_nc: int = 128):
        super().__init__()
        self.kernel_size = kernel_size
        k = kernel_size
        self.fully_connect_layer = nn.Sequential(
            nn.Conv2d(2 * feature_nc, hidden_nc, k, stride=k),
            get_activation(activation),
            nn.Conv2d(hidden_nc, k * k, 1),
            nn.Softmax(dim=1),
        )

    def dense_weights(self):
        """(w1 (k², 2C, D), b1, w2 (D, k²), b2) in gfla_tpu's layout."""
        conv1, _, conv2, _ = self.fully_connect_layer
        d, c2, k, _ = conv1.weight.shape
        w1 = conv1.weight.permute(2, 3, 1, 0).reshape(k * k, c2, d)
        w2 = conv2.weight[:, :, 0, 0].t().contiguous()
        return w1, conv1.bias, w2, conv2.bias

    def forward(self, source, target, flow, return_attn: bool = False):
        """source/target (B,C,H,W), flow (B,2,H,W) (x, y). Returns (B,C,H,W),
        or (attn (B,k²,H,W), out) with `return_attn`."""
        w1, b1, w2, b2 = self.dense_weights()
        nhwc = [t.permute(0, 2, 3, 1).contiguous()
                for t in (source, target, flow)]
        res = local_attn_warp(*nhwc, self.kernel_size, w1, b1, w2, b2,
                              activation=self.fully_connect_layer[1],
                              return_attn=return_attn)
        if return_attn:
            attn, out = res
            return attn.permute(0, 3, 1, 2), out.permute(0, 3, 1, 2)
        return res.permute(0, 3, 1, 2)
