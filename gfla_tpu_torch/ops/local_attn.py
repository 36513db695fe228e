"""Local-attention warp: the ExtractorAttn computation as one op (NHWC).

Counterpart of gfla_tpu/ops/local_attn.py. Weight layout contract as there:
w1 (k*k, 2C, D) with offset index i*k + j and channels [target || source];
w2 (D, k*k).

Dispatch follows gfla_tpu's `GFLA_ATTN_PALLAS` (ops/local_attn.py:88-142),
read when called:
- `auto` (the default) or `warp`: with `return_attn=False` and a LeakyReLU
  (or ReLU) activation the target stream is a k x k convolution over the
  edge-padded target (as in gfla_tpu's `local_attn_warp_fused`) and the
  source stream goes to `warp.warp_fwd`, which launches the CUDA kernel on a
  CUDA tensor and runs its plain twin on a CPU tensor. gfla_tpu's `auto`
  takes the warp kernel on its accelerator and the composition on the CPU;
  the port takes the warp route on both, since its CPU twin is plain torch.
  The warp kernels take every k >= 1, odd or even, as gfla_tpu's Pallas
  warp does (from k = 10 on their wide instances), and so does the plain
  twin on a CPU tensor: no kernel size sends the route to the composite.
- `1`: the blocks are gathered in plain torch (`block_extract`,
  `extract_patches`) and the attention math goes to
  `attn_math.attn_math`, the math-fused kernel, for any LeakyReLU or ReLU
  (the kernel takes the slope). gfla_tpu fuses only the default
  LeakyReLU(0.1) and sends other slopes to its composition; the port keeps
  them on the kernel, which computes them. Gradients to source, target and
  flow go through autograd over the gather.
- `0`: the plain composite, any activation, any device.
`return_attn=True`, the visualisation hook, runs the composite under every
setting, as gfla_tpu does. An activation that no kernel computes runs the
composite on the CPU and raises on CUDA unless `0` asks for the composite:
the kernel routes never give way silently.

In bfloat16 (`--compute_dtype=bfloat16`) the warp route runs the warp
kernels' bf16 instances and `1` the attention-math kernels' bf16 instances
(csrc/attn_math_{fwd,bwd}_bf16.cu); on the CPU their plain twins round where
they do. The composite sums in f32, as gfla_tpu's does.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from gfla_tpu_torch.ops import acc_dtype, attn_math, warp
from gfla_tpu_torch.ops.block_extract import block_extract, extract_patches


def _leaky_slope(activation):
    """Negative slope if `activation` is one the kernel computes, else None."""
    if activation is None:
        return 0.1
    if isinstance(activation, nn.LeakyReLU):
        return float(activation.negative_slope)
    if isinstance(activation, nn.ReLU):
        return 0.0
    return None


def target_stream(target, w1, b1, kernel_size: int):
    """hidden_bt = conv(edge_pad(target), W1[:, :C]) + b1 -> (B, H*W, D): the
    conv in the target's type, then b1 added in f32, in gfla_tpu's order
    (pallas_warp.py:515-522)."""
    B, H, W, C = target.shape
    k = kernel_size
    r = k // 2
    D = w1.shape[-1]
    acc = acc_dtype(target.dtype)
    w_bt = w1[:, :C, :].reshape(k, k, C, D).permute(3, 2, 0, 1)  # (D,C,k,k)
    padded = F.pad(target.permute(0, 3, 1, 2), (r, k - 1 - r, r, k - 1 - r),
                   mode="replicate")
    hidden = F.conv2d(padded, w_bt.to(target.dtype)).to(acc) \
        + b1.to(acc)[:, None, None]                               # (B,D,H,W)
    return hidden.permute(0, 2, 3, 1).reshape(B, H * W, D).contiguous()


def _composite(source, target, flow, k, w1, b1, w2, b2, activation,
               return_attn):
    """gfla_tpu's XLA composition (ops/local_attn.py:122-171) in torch: the
    products of the inputs' values summed in `acc_dtype` of their type, the
    attention weights in the source's type for the weighted sum."""
    acc = acc_dtype(source.dtype)
    block_source = block_extract(source, flow, k)            # (B,H,W,k²,C)
    block_target = extract_patches(target, k)
    cat = torch.cat([block_target, block_source], dim=-1)
    hidden = activation(torch.einsum("bhwkc,kcd->bhwd", cat.to(acc),
                                     w1.to(acc)) + b1.to(acc))
    attn = torch.softmax(torch.einsum("bhwd,dk->bhwk", hidden,
                                      w2.to(acc)) + b2.to(acc), dim=-1)
    out = (torch.einsum("bhwk,bhwkc->bhwc", attn.to(source.dtype).to(acc),
                        block_source.to(acc)) / float(k * k)).to(source.dtype)
    return (attn, out) if return_attn else out


def local_attn_warp(source, target, flow, kernel_size: int, w1, b1, w2, b2,
                    activation=None, return_attn: bool = False):
    """source/target (B,H,W,C), flow (B,H,W,2) (x, y). Returns (B,H,W,C), or
    (attn (B,H,W,k*k), out) with `return_attn`. `activation` is an
    nn.Module or callable; None means LeakyReLU(0.1)."""
    k = kernel_size
    route = os.environ.get("GFLA_ATTN_PALLAS", "auto")
    slope = _leaky_slope(activation)
    act = activation or nn.LeakyReLU(0.1)
    if slope is None and source.is_cuda and route != "0":
        raise NotImplementedError(
            f"local_attn_warp: the CUDA kernels compute LeakyReLU/ReLU only, "
            f"got {activation!r}; GFLA_ATTN_PALLAS=0 selects the composite")
    if route == "0" or return_attn or slope is None:
        return _composite(source, target, flow, k, w1, b1, w2, b2, act,
                          return_attn)
    B, H, W, C = source.shape
    if route == "1":
        bs = block_extract(source, flow, k).reshape(-1, k * k, C)
        bt = extract_patches(target, k).reshape(-1, k * k, C)
        out = attn_math.attn_math(bs, bt, w1, b1, w2, b2, slope)
        return out.reshape(B, H, W, C)
    D = w1.shape[-1]
    hidden_bt = target_stream(target, w1, b1, k)
    w1s = w1[:, C:, :].reshape(k * k * C, D)
    return warp.warp_fwd(source, flow, hidden_bt, w1s, w2, b2, k, slope)
