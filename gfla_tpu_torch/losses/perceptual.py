"""VGG-based perceptual losses: content/style and sampling correctness.

Counterpart of gfla_tpu/losses/perceptual.py:35-308 (the original's
external_function.py:121-319), on the port's NCHW feature maps. Left out
until the face and dance heads need them: `_bilinear_warp`
(`use_bilinear_sampling`) and the `mask` and `frames` branches of the
correctness loss.

Under a bf16 compute dtype the VGG features are bf16, and the losses sum as
gfla_tpu's `_acc` does (perceptual.py:29-47, 263-266): the L1 differences
and the Gram products in f32, and the correctness loss promotes its
features to f32 before the normalisation, the max-correlation and the
resampling, so `GFLA_PALLAS_CORR=1` still hands the kernel f32.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch

from gfla_tpu_torch.ops import acc_dtype
from gfla_tpu_torch.ops.gaussian_resample import gaussian_resample
from gfla_tpu_torch.ops.max_corr import max_corr, max_corr_plain

_EPS = 1e-8

# VGG layer per attention level index (external_function.py:228)
CORRECTNESS_LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1"]
CONTENT_LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]
STYLE_LAYERS = ["relu2_2", "relu3_4", "relu4_4", "relu5_2"]


def l1_loss(a, b):
    dt = torch.promote_types(acc_dtype(a.dtype), acc_dtype(b.dtype))
    return (a.to(dt) - b.to(dt)).abs().mean()


def gram_matrix(x):
    """(B, C, H, W) -> (B, C, C), normalised by h*w*c; the products of x's
    values summed in `acc_dtype`."""
    B, C, H, W = x.shape
    f = x.reshape(B, C, H * W).to(acc_dtype(x.dtype))
    return f @ f.transpose(1, 2) / (H * W * C)


def vgg_content_style_loss(vgg, x, y, weights: Sequence[float] = (1.0,) * 5,
                           fx=None, fy=None):
    """(content, style) between images x and y in [-1, 1]; precomputed
    feature dicts `fx`/`fy` save VGG forwards."""
    fx = fx if fx is not None else vgg(x)
    fy = fy if fy is not None else vgg(y)
    content = 0.0
    for w, name in zip(weights, CONTENT_LAYERS):
        content = content + w * l1_loss(fx[name], fy[name])
    style = 0.0
    for name in STYLE_LAYERS:
        style = style + l1_loss(gram_matrix(fx[name]), gram_matrix(fy[name]))
    return content, style


def _max_corr_fwd(source_norm, target_norm, chunk: int):
    """(cmax, argmax) as gfla_tpu chooses (perceptual.py:66-81), deciding
    when called: with GFLA_PALLAS_CORR=1 and inputs that compute in float32
    the max-correlation kernel (`ops.max_corr.max_corr`), else the chunked
    scan (`max_corr_plain`)."""
    if (os.environ.get("GFLA_PALLAS_CORR", "0") == "1"
            and torch.promote_types(source_norm.dtype, torch.float32)
            == torch.float32):
        return max_corr(source_norm.float().contiguous(),
                        target_norm.float().contiguous())
    return max_corr_plain(source_norm, target_norm, chunk)


class MaxCorrelation(torch.autograd.Function):
    """max over source positions of <s_i, t_j>, without the (Ns x Nt)
    correlation: the kernel or an O(chunk * Nt) scan (`_max_corr_fwd`).
    Backward: d cmax_j / d s_i is nonzero only at i = argmax_j, so it is one
    gather (grad target) and one scatter-add (grad source), as gfla_tpu's
    custom VJP (perceptual.py:144-155)."""

    @staticmethod
    def forward(ctx, source_norm, target_norm, chunk: int = 2048):
        cmax, amax = _max_corr_fwd(source_norm, target_norm, chunk)
        ctx.save_for_backward(source_norm, target_norm, amax)
        return cmax

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        source_norm, target_norm, amax = ctx.saved_tensors
        idx = amax[..., None].expand(-1, -1, source_norm.shape[-1])
        s_at = torch.gather(source_norm, 1, idx)                 # (B,Nt,C)
        dt = g[..., None] * s_at
        ds = torch.zeros_like(source_norm).scatter_add_(
            1, idx, g[..., None] * target_norm)
        return ds, dt, None


def _safe_norm(x, dim: int):
    """L2 norm with a zero gradient at exactly-zero vectors (ReLU features,
    a warp fully off the image) instead of NaN."""
    return torch.sqrt(torch.clamp((x * x).sum(dim), min=1e-30))


def _nearest_resize(x, H: int, W: int):
    """torch F.interpolate(mode='nearest') on NCHW: source index
    floor(dst * in / out), as gfla_tpu's `_nearest_resize`."""
    h, w = x.shape[2:]
    iy = torch.floor(torch.arange(H, device=x.device) * (h / H)).long()
    ix = torch.floor(torch.arange(W, device=x.device) * (w / W)).long()
    return x[:, :, iy][:, :, :, ix]


class PerceptualCorrectness:
    """Sampling-correctness loss: for each flow field (coarse to fine) and
    its VGG layer, warp the source features with the Gaussian resampler
    (k=4, dil=1, sigma=2), take the cosine similarity with the target
    features against the per-position max correlation over all source
    positions, and penalise exp(-cs / (cmax + eps))."""

    def __init__(self, vgg, layers: Sequence[str] = tuple(CORRECTNESS_LAYERS)):
        self.vgg = vgg
        self.layers = list(layers)

    def __call__(self, target, source, flow_list, used_layers,
                 target_feats=None, source_feats=None):
        used = sorted(used_layers, reverse=True)
        t_feats = target_feats if target_feats is not None else \
            self.vgg(target)
        s_feats = source_feats if source_feats is not None else \
            self.vgg(source)
        loss = 0.0
        for i, flow in enumerate(flow_list):
            name = self.layers[used[i]]
            loss = loss + self.layer_loss(t_feats[name], s_feats[name], flow)
        return loss

    @staticmethod
    def layer_loss(target_vgg, source_vgg, flow):
        """Features (B,C,H,W), flow (B,2,h,w) in feature pixels; the
        features are promoted to `acc_dtype` first."""
        target_vgg = target_vgg.to(acc_dtype(target_vgg.dtype))
        source_vgg = source_vgg.to(acc_dtype(source_vgg.dtype))
        B, C, H, W = target_vgg.shape
        if flow.shape[2:] != (H, W):
            flow = _nearest_resize(flow, H, W)
        t = target_vgg.permute(0, 2, 3, 1).reshape(B, H * W, C)
        s_nhwc = source_vgg.permute(0, 2, 3, 1)
        s = s_nhwc.reshape(B, H * W, C)
        s_norm = s / (_safe_norm(s, 2)[..., None] + _EPS)
        t_norm = t / (_safe_norm(t, 2)[..., None] + _EPS)
        cmax = MaxCorrelation.apply(s_norm, t_norm)              # (B, N)
        sampled = gaussian_resample(s_nhwc, flow.permute(0, 2, 3, 1), 4, 1,
                                    2.0).reshape(B, H * W, C)
        num = (sampled * t).sum(2)
        den = torch.clamp(_safe_norm(sampled, 2) * _safe_norm(t, 2), min=1e-8)
        loss_map = torch.exp(-(num / den) / (cmax + _EPS))
        return loss_map.mean() - math.exp(-1.0)
