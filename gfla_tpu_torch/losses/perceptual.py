"""VGG-based perceptual losses: content/style and sampling correctness.

Counterpart of gfla_tpu/losses/perceptual.py:35-308 (the original's
external_function.py:121-319), on the port's NCHW feature maps, with the
correctness loss's branches for the animation heads: `frames` (a batch of
B * T frames in (b, t) order, reduced per frame and summed over frames),
`mask` (a per-position weight) and `use_bilinear_sampling` (a plain
zero-padded bilinear warp, `_bilinear_warp`, in place of the Gaussian
resampler).

Under a bf16 compute dtype the VGG features are bf16, and the losses sum as
gfla_tpu's `_acc` does (perceptual.py:29-47, 263-266): the L1 differences
and the Gram products in f32, and the correctness loss promotes its
features to f32 before the normalisation, the max-correlation and the
resampling, so `GFLA_PALLAS_CORR=1` still hands the kernel f32.

Over row bands (the data x spatial mode, `gfla_tpu_torch.parallel.bands`)
each loss is the whole image's: an L1 mean and the correctness map's mean
are band sums over the global count (`parallel.band_mean`), a Gram matrix
sums its band products over the bands (every band then holds it whole, so
the style L1 is a plain mean), and the correctness loss gathers the source
features whole, as gfla_tpu gathers a replicated operand, and compares the
band's target rows with the source sampled at their global positions.
The animation heads' per-frame form takes each frame's mean over the batch
and the whole image as a band reduction (`parallel.band_mean` over a
dimension), and the masked form gfla_tpu's ratio of global sums
(`_global_ratio`). Only the bilinear form (`use_bilinear_sampling`, which
no head reaches) has no band form: its warp reads the source's rows at
the band's own positions, and it refuses bands.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch

from gfla_tpu_torch import parallel
from gfla_tpu_torch.ops import acc_dtype
from gfla_tpu_torch.ops.gaussian_resample import gaussian_resample
from gfla_tpu_torch.ops.max_corr import max_corr, max_corr_plain

_EPS = 1e-8

# VGG layer per attention level index (external_function.py:228)
CORRECTNESS_LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1"]
CONTENT_LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]
STYLE_LAYERS = ["relu2_2", "relu3_4", "relu4_4", "relu5_2"]


def _abs_diff(a, b):
    dt = torch.promote_types(acc_dtype(a.dtype), acc_dtype(b.dtype))
    return (a.to(dt) - b.to(dt)).abs()


def l1_loss(a, b):
    """mean |a - b| over the whole image (over bands, `band_mean`)."""
    return parallel.band_mean(_abs_diff(a, b))


def gram_matrix(x):
    """(B, C, H, W) -> (B, C, C), normalised by h*w*c; the products of x's
    values summed in `acc_dtype`; over bands the band products summed over
    the bands, normalised by the whole image's h*w*c."""
    B, C, H, W = x.shape
    f = x.reshape(B, C, H * W).to(acc_dtype(x.dtype))
    b = parallel.bands()
    if b is None:
        return f @ f.transpose(1, 2) / (H * W * C)
    return parallel.band_sum(f @ f.transpose(1, 2)) / (H * b.size * W * C)


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
        style = style + _abs_diff(gram_matrix(fx[name]),
                                  gram_matrix(fy[name])).mean()
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


def _global_ratio(num, den):
    """num / (den + eps) of the global batch, from this rank's numerator
    and denominator (sums over its rows of its batch): the denominator
    (mask sums, which carry no gradient) is summed over every rank; over
    row bands the numerator is summed over the spatial group
    (`parallel.band_sum`, so that each rank holds its data index's and
    takes `band_mean`'s gradient convention); and the ratio is scaled by
    the number of data indices, so that the mean over the ranks, of the
    gradients as of the logged values, is gfla_tpu's ratio of global sums.
    Without a process group it is num / (den + eps)."""
    if not parallel.active():
        return num / (den + _EPS)
    den = parallel.allreduce_sum_(den.detach().clone())
    return parallel.data_world().size * (parallel.band_sum(num)
                                         / (den + _EPS))


def _nearest_resize(x, H: int, W: int):
    """torch F.interpolate(mode='nearest') on NCHW: source index
    floor(dst * in / out), as gfla_tpu's `_nearest_resize`; over bands
    from the band's global rows to its source band's (the bands of both
    sizes cover the same image rows)."""
    h, w = x.shape[2:]
    b = parallel.bands()
    if b is None:
        iy = torch.floor(torch.arange(H, device=x.device) * (h / H)).long()
    else:
        rows = torch.arange(b.first_row(H), b.first_row(H) + H,
                            device=x.device)
        iy = torch.floor(rows * (h / H)).long() - b.first_row(h)
    ix = torch.floor(torch.arange(W, device=x.device) * (w / W)).long()
    return x[:, :, iy][:, :, :, ix]


def _bilinear_warp(source, flow):
    """source (B, H, W, C) sampled at each position plus flow (B, H, W, 2)
    (x, y), bilinearly, zero outside the image (gfla_tpu's
    `_bilinear_warp`, perceptual.py:181-214: the original's grid_sample
    with align_corners=True on a grid normalised by size - 1 and a flow
    scaled by 2 / size, which moves flow * (size - 1) / size pixels)."""
    B, H, W, C = source.shape
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    dy = flow[..., 1] * ((H - 1) / H) + ys[None, :, None]
    dx = flow[..., 0] * ((W - 1) / W) + xs[None, None, :]
    fy, fx = torch.floor(dy), torch.floor(dx)
    wy, wx = (dy - fy)[..., None], (dx - fx)[..., None]
    iy0, ix0 = fy.long(), fx.long()
    src = source.reshape(B, H * W, C)

    def tap(iy, ix):
        inb = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)).to(source.dtype)
        flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        vals = torch.gather(src, 1, flat.reshape(B, H * W, 1).expand(
            -1, -1, C)).reshape(B, H, W, C)
        return vals * inb[..., None]

    return ((1 - wy) * (1 - wx) * tap(iy0, ix0)
            + (1 - wy) * wx * tap(iy0, ix0 + 1)
            + wy * (1 - wx) * tap(iy0 + 1, ix0)
            + wy * wx * tap(iy0 + 1, ix0 + 1))


class PerceptualCorrectness:
    """Sampling-correctness loss: for each flow field (coarse to fine) and
    its VGG layer, warp the source features with the Gaussian resampler
    (k=4, dil=1, sigma=2), take the cosine similarity with the target
    features against the per-position max correlation over all source
    positions, and penalise exp(-cs / (cmax + eps))."""

    def __init__(self, vgg, layers: Sequence[str] = tuple(CORRECTNESS_LAYERS)):
        self.vgg = vgg
        self.layers = list(layers)

    def __call__(self, target, source, flow_list, used_layers, mask=None,
                 use_bilinear_sampling: bool = False, target_feats=None,
                 source_feats=None, frames: int | None = None):
        """`mask` (B, 1, H, W) weights the positions; with `frames=T` the
        batch is B * T frames in (b, t) order, and the loss is the sum over
        frames of each frame's loss (gfla_tpu's per-frame loop on a folded
        batch)."""
        used = sorted(used_layers, reverse=True)
        t_feats = target_feats if target_feats is not None else \
            self.vgg(target)
        s_feats = source_feats if source_feats is not None else \
            self.vgg(source)
        loss = 0.0
        for i, flow in enumerate(flow_list):
            name = self.layers[used[i]]
            loss = loss + self.layer_loss(t_feats[name], s_feats[name], flow,
                                          mask, use_bilinear_sampling, frames)
        return loss

    @staticmethod
    def layer_loss(target_vgg, source_vgg, flow, mask=None,
                   use_bilinear_sampling: bool = False,
                   frames: int | None = None):
        """Features (B,C,H,W), flow (B,2,h,w) in feature pixels; the
        features are promoted to `acc_dtype` first. With a `mask`, in a
        data-parallel run, the loss is a collective (its mask sums are
        summed over the ranks, `_global_ratio`): every rank must call it
        in the same order, so a caller on rank 0 alone would hang the
        world."""
        b = parallel.bands()
        if b is not None and use_bilinear_sampling:
            raise NotImplementedError(
                "the correctness loss's bilinear sampling has no row-band "
                "form: its warp would read the gathered source at the "
                "band's own rows, not at their global positions")
        target_vgg = target_vgg.to(acc_dtype(target_vgg.dtype))
        source_vgg = parallel.gather_rows(
            source_vgg.to(acc_dtype(source_vgg.dtype)))
        B, C, H, W = target_vgg.shape
        if flow.shape[2:] != (H, W):
            flow = _nearest_resize(flow, H, W)
        t = target_vgg.permute(0, 2, 3, 1).reshape(B, H * W, C)
        s_nhwc = source_vgg.permute(0, 2, 3, 1)
        s = s_nhwc.reshape(B, -1, C)
        s_norm = s / (_safe_norm(s, 2)[..., None] + _EPS)
        t_norm = t / (_safe_norm(t, 2)[..., None] + _EPS)
        cmax = MaxCorrelation.apply(s_norm, t_norm)              # (B, N)
        row0 = 0 if b is None else b.first_row(H)
        warp = _bilinear_warp if use_bilinear_sampling else \
            lambda s, f: gaussian_resample(s, f, 4, 1, 2.0, row0)
        sampled = warp(s_nhwc, flow.permute(0, 2, 3, 1)).reshape(B, H * W, C)
        num = (sampled * t).sum(2)
        den = torch.clamp(_safe_norm(sampled, 2) * _safe_norm(t, 2), min=1e-8)
        loss_map = torch.exp(-(num / den) / (cmax + _EPS))      # (B, N)
        e1 = math.exp(-1.0)
        if mask is None:
            if frames is None:
                return parallel.band_mean(loss_map) - e1
            lm = loss_map.reshape(-1, frames, H * W)
            return (parallel.band_mean(lm, (0, 2)) - e1).sum()
        m = mask if mask.shape[2:] == (H, W) else _nearest_resize(mask, H, W)
        m = m.reshape(B, H * W)
        loss_map = loss_map - e1
        if frames is None:
            return _global_ratio((m * loss_map).sum(), m.sum())
        lm = loss_map.reshape(-1, frames, H * W)
        mm = m.reshape(-1, frames, H * W)
        return _global_ratio((mm * lm).sum(dim=(0, 2)),
                             mm.sum(dim=(0, 2))).sum()
