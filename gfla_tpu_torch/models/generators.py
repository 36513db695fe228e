"""Pose-transfer generator (NCHW, channels_last activations).

Counterpart of gfla_tpu/models/generators.py:44-284 with the original GFLA's
module tree (generator.py:13-242), so an original `latest_net_G.pth` loads
with strict key matching:

* PoseSourceNet encodes the source image into a feature pyramid, returned
  coarsest first with the raw input last.
* PoseFlowNet (fixed ngf=32, img_f=256, encoder_layer=5) is a U-Net over
  [source, source pose, target pose] that emits a flow (x, y, in feature
  pixels) and a sigmoid mask at each attention level, coarse to fine.
* PoseTargetNet encodes the target pose and decodes it, fusing at each
  attention level: out = out * (1 - mask) + attn(source_feat, out, flow) * mask.
* PoseFlowNetGenerator is the stage-1 flow pretraining head: a PoseFlowNet
  alone, under the name `flow_net`, so its checkpoint keys are those of
  PoseGenerator.flow_net (the two-stage protocol).

The ShapeNet novel-view heads (gfla_tpu/models/generators.py:676-878, the
original's generator.py:590-773) take a viewpoint code, a (B, 21, 1, 1)
one-hot of azimuth and elevation, in place of the pose heatmaps:

* ShapeNetFlowNet encodes the source image alone and fuses the code
  difference, source - target, tiled over the bottleneck, through one
  ResBlock (`cat`, input bottleneck + 21 channels, a 1x1 shortcut);
* ShapeNetTargetNet grows the target from the target code tiled to 8x8
  through two ResBlockDecoders (8 -> 16 -> 32) instead of an encoder, then
  decodes as PoseTargetNet does;
* ShapeNetGenerator and ShapeNetFlowNetGenerator are PoseGenerator and
  PoseFlowNetGenerator over those two nets.

With `use_spect` (`--use_spect_g`) every block conv is spectral-normed, as in
gfla_tpu: not the flow and mask heads, not the attention. Each spectral conv
stores its power iteration in train mode and not in eval mode.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from gfla_tpu_torch.nn.attention import ExtractorAttn
from gfla_tpu_torch.nn.blocks import (
    EncoderBlock,
    Jump,
    Output,
    ResBlockDecoder,
    ResBlocks,
)


def _mult(i: int, ngf: int, img_f: int) -> int:
    return min(2**i, img_f // ngf)


class PoseSourceNet(nn.Module):
    def __init__(self, input_nc: int = 3, ngf: int = 64, img_f: int = 1024,
                 layers: int = 6, norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False):
        super().__init__()
        self.layers = layers
        kw = dict(norm_type=norm_type, activation=activation,
                  use_spect=use_spect)
        self.block0 = EncoderBlock(input_nc, ngf, **kw)
        for i in range(layers - 1):
            setattr(self, f"encoder{i}",
                    EncoderBlock(ngf * _mult(i, ngf, img_f),
                                 ngf * _mult(i + 1, ngf, img_f), **kw))

    def forward(self, source):
        feats = [source]
        out = self.block0(source)
        feats.append(out)
        for i in range(self.layers - 1):
            out = getattr(self, f"encoder{i}")(out)
            feats.append(out)
        return list(reversed(feats))


class PoseFlowNet(nn.Module):
    def __init__(self, image_nc: int = 3, structure_nc: int = 18,
                 ngf: int = 32, img_f: int = 256, encoder_layer: int = 5,
                 attn_layer: Sequence[int] = (1, 2), norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False,
                 input_nc: int | None = None):
        super().__init__()
        self.encoder_layer = encoder_layer
        self.decoder_layer = encoder_layer - min(attn_layer)
        self.attn_layer = tuple(attn_layer)
        kw = dict(norm_type=norm_type, activation=activation,
                  use_spect=use_spect)
        self.block0 = EncoderBlock(input_nc or 2 * structure_nc + image_nc,
                                   ngf, **kw)
        for i in range(encoder_layer - 1):
            setattr(self, f"encoder{i}",
                    EncoderBlock(ngf * _mult(i, ngf, img_f),
                                 ngf * _mult(i + 1, ngf, img_f), **kw))
        nc_prev = ngf * _mult(encoder_layer - 1, ngf, img_f)
        for i in range(self.decoder_layer):
            nc = ngf * _mult(encoder_layer - i - 2, ngf, img_f)
            setattr(self, f"decoder{i}",
                    ResBlockDecoder(nc_prev, nc, nc, **kw))
            setattr(self, f"jump{i}",
                    Jump(nc, nc, 3, norm_type="none", activation=activation,
                         use_spect=use_spect))
            if encoder_layer - i - 1 in self.attn_layer:
                setattr(self, f"output{i}", nn.Conv2d(nc, 2, 3, 1, 1))
                setattr(self, f"mask{i}", nn.Sequential(
                    nn.Conv2d(nc, 1, 3, 1, 1), nn.Sigmoid()))
            nc_prev = nc

    def forward(self, source, source_b, target_b):
        return self.decode(*self.encode(
            torch.cat([source, source_b, target_b], dim=1)))

    def encode(self, x):
        """(the bottleneck, every level's output, finest first)."""
        out = self.block0(x)
        result = [out]
        for i in range(self.encoder_layer - 1):
            out = getattr(self, f"encoder{i}")(out)
            result.append(out)
        return out, result

    def decode(self, out, result):
        """(flows, masks) at the attention levels, coarse to fine."""
        flows, masks = [], []
        for i in range(self.decoder_layer):
            out = getattr(self, f"decoder{i}")(out)
            out = out + getattr(self, f"jump{i}")(
                result[self.encoder_layer - i - 2])
            if self.encoder_layer - i - 1 in self.attn_layer:
                flows.append(getattr(self, f"output{i}")(out))
                masks.append(getattr(self, f"mask{i}")(out))
        return flows, masks


class _TargetDecoder(nn.Module):
    """The target decoder both target nets share: `layers` upsampling levels
    from the coarsest feature, each first blending at an attention level
    (out * (1 - mask) + attn(source_feat, out, flow) * mask), then the
    output head. A subclass builds its input stage, then calls
    `_add_decoder`, and says in `encode` how the target code reaches the
    coarsest level."""

    def _add_decoder(self, output_nc, ngf, img_f, layers, num_blocks,
                     activation, attn_layer, extractor_kz, **kw):
        self.layers = layers
        self.attn_layer = tuple(attn_layer)
        nc_prev = ngf * _mult(layers - 1, ngf, img_f)
        for i in range(layers):
            nc = ngf * _mult(layers - i - 2, ngf, img_f) \
                if i != layers - 1 else ngf
            up = ResBlockDecoder(nc_prev, nc, None, activation=activation,
                                 **kw)
            if num_blocks > 1:
                up = nn.Sequential(
                    ResBlocks(num_blocks - 1, nc_prev,
                              activation=activation, **kw), up)
            else:
                up = nn.Sequential(up)
            setattr(self, f"decoder{i}", up)
            if layers - i in self.attn_layer:
                setattr(self, f"attn{i}",
                        ExtractorAttn(nc_prev,
                                      extractor_kz[str(layers - i)],
                                      activation))
            nc_prev = nc
        self.outconv = Output(ngf, output_nc, 3, norm_type="none",
                              activation=activation,
                              use_spect=kw["use_spect"])

    def forward(self, target_b, source_feature, flow_fields, masks,
                return_hooks: bool = False):
        out = self.encode(target_b)
        hooks = {"target": [], "source": [], "attn": [], "mask": []}
        counter = 0
        for i in range(self.layers):
            if self.layers - i in self.attn_layer:
                attn_mod = getattr(self, f"attn{i}")
                if return_hooks:
                    attn_w, out_attn = attn_mod(
                        source_feature[i], out, flow_fields[counter],
                        return_attn=True)
                else:
                    out_attn = attn_mod(source_feature[i], out,
                                        flow_fields[counter])
                mask = masks[counter]
                out = out * (1 - mask) + out_attn * mask
                if return_hooks:
                    hooks["target"].append(out)
                    hooks["source"].append(source_feature[i])
                    hooks["attn"].append(attn_w)
                    hooks["mask"].append(mask)
                counter += 1
            out = getattr(self, f"decoder{i}")(out)
        img = self.outconv(out)
        return (img, hooks) if return_hooks else img


class PoseTargetNet(_TargetDecoder):
    """Encodes the target pose heatmaps with `layers` EncoderBlocks."""

    def __init__(self, structure_nc: int = 18, output_nc: int = 3,
                 ngf: int = 64, img_f: int = 1024, layers: int = 6,
                 num_blocks: int = 2, norm_type: str = "batch",
                 activation: str = "ReLU", attn_layer: Sequence[int] = (1, 2),
                 extractor_kz: Dict[str, int] = None,
                 use_spect: bool = False):
        super().__init__()
        kw = dict(norm_type=norm_type, use_spect=use_spect)
        self.block0 = EncoderBlock(structure_nc, ngf, activation=activation,
                                   **kw)
        for i in range(layers - 1):
            setattr(self, f"encoder{i}",
                    EncoderBlock(ngf * _mult(i, ngf, img_f),
                                 ngf * _mult(i + 1, ngf, img_f),
                                 activation=activation, **kw))
        self._add_decoder(output_nc, ngf, img_f, layers, num_blocks,
                          activation, attn_layer, extractor_kz, **kw)

    def encode(self, target_b):
        out = self.block0(target_b)
        for i in range(self.layers - 1):
            out = getattr(self, f"encoder{i}")(out)
        return out


class ShapeNetTargetNet(_TargetDecoder):
    """Grows the target from its viewpoint code (B, structure_nc, 1, 1)
    tiled to 8x8, through two ResBlockDecoders (8 -> 16 -> 32), whose
    hidden width is their input's (gfla_tpu/models/generators.py:745-805)."""

    def __init__(self, structure_nc: int = 18, output_nc: int = 3,
                 ngf: int = 64, img_f: int = 1024, layers: int = 6,
                 num_blocks: int = 2, norm_type: str = "batch",
                 activation: str = "ReLU", attn_layer: Sequence[int] = (1, 2),
                 extractor_kz: Dict[str, int] = None,
                 use_spect: bool = False):
        super().__init__()
        kw = dict(norm_type=norm_type, use_spect=use_spect)
        self.block0 = ResBlockDecoder(structure_nc, ngf, None,
                                      activation=activation, **kw)
        self.block1 = ResBlockDecoder(ngf, ngf * _mult(layers - 1, ngf, img_f),
                                      None, activation=activation, **kw)
        self._add_decoder(output_nc, ngf, img_f, layers, num_blocks,
                          activation, attn_layer, extractor_kz, **kw)

    def encode(self, target_b):
        seed = target_b.expand(-1, -1, 8, 8).contiguous(
            memory_format=torch.channels_last)
        return self.block1(self.block0(seed))


class ShapeNetFlowNet(PoseFlowNet):
    """PoseFlowNet over the source image alone; the viewpoint code
    difference (source_b - target_b), tiled over the bottleneck and
    concatenated to it, is fused by one ResBlock before the decoder
    (gfla_tpu/models/generators.py:676-742)."""

    def __init__(self, image_nc: int = 3, structure_nc: int = 18,
                 ngf: int = 32, img_f: int = 256, encoder_layer: int = 5,
                 attn_layer: Sequence[int] = (1, 2), norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False):
        super().__init__(image_nc, structure_nc, ngf, img_f, encoder_layer,
                         attn_layer, norm_type, activation, use_spect,
                         input_nc=image_nc)
        nc = ngf * _mult(encoder_layer - 1, ngf, img_f)
        self.cat = ResBlocks(1, nc + structure_nc, nc, None,
                             norm_type=norm_type, activation=activation,
                             use_spect=use_spect)

    def forward(self, source, source_b, target_b):
        out, result = self.encode(source)
        code = (source_b - target_b).expand(-1, -1, *out.shape[2:])
        out = self.cat(torch.cat([out, code], dim=1).contiguous(
            memory_format=torch.channels_last))
        return self.decode(out, result)


class PoseGenerator(nn.Module):
    """Source encoder + flow U-Net + target decoder. Inputs and outputs are
    NCHW; inputs are moved to channels_last so every activation, and the
    NHWC view the warp kernel reads, stays channels_last."""

    TargetNet, FlowNet = PoseTargetNet, PoseFlowNet

    def __init__(self, image_nc: int = 3, structure_nc: int = 18,
                 output_nc: int = 3, ngf: int = 64, img_f: int = 1024,
                 layers: int = 6, num_blocks: int = 2,
                 norm_type: str = "batch", activation: str = "ReLU",
                 attn_layer: Sequence[int] = (1, 2),
                 extractor_kz: Dict[str, int] = None,
                 use_spect: bool = False):
        super().__init__()
        kw = dict(norm_type=norm_type, activation=activation,
                  use_spect=use_spect)
        self.source = PoseSourceNet(image_nc, ngf, img_f, layers, **kw)
        self.target = self.TargetNet(structure_nc, output_nc, ngf, img_f,
                                     layers, num_blocks,
                                     attn_layer=attn_layer,
                                     extractor_kz=extractor_kz, **kw)
        self.flow_net = self.FlowNet(image_nc, structure_nc, ngf=32,
                                     img_f=256, encoder_layer=5,
                                     attn_layer=attn_layer, **kw)

    def forward(self, source, source_b, target_b, return_hooks: bool = False):
        source, source_b, target_b = (
            t.contiguous(memory_format=torch.channels_last)
            for t in (source, source_b, target_b))
        feature_list = self.source(source)
        flow_fields, masks = self.flow_net(source, source_b, target_b)
        out = self.target(target_b, feature_list, flow_fields, masks,
                          return_hooks=return_hooks)
        if return_hooks:
            img, hooks = out
            return img, flow_fields, masks, hooks
        return out, flow_fields, masks


class PoseFlowNetGenerator(nn.Module):
    """Stage-1 flow pretraining head (gfla_tpu/models/generators.py:287-310,
    the original's generator.py:244-259): returns (flows, masks), coarse to
    fine."""

    FlowNet = PoseFlowNet

    def __init__(self, image_nc: int = 3, structure_nc: int = 18,
                 ngf: int = 32, img_f: int = 256, encoder_layer: int = 5,
                 attn_layer: Sequence[int] = (1, 2), norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False):
        super().__init__()
        self.flow_net = self.FlowNet(image_nc, structure_nc, ngf, img_f,
                                     encoder_layer, attn_layer,
                                     norm_type=norm_type,
                                     activation=activation,
                                     use_spect=use_spect)

    def forward(self, source, source_b, target_b):
        source, source_b, target_b = (
            t.contiguous(memory_format=torch.channels_last)
            for t in (source, source_b, target_b))
        return self.flow_net(source, source_b, target_b)


class ShapeNetGenerator(PoseGenerator):
    """Novel-view synthesis generator (gfla_tpu/models/generators.py:
    808-853): PoseSourceNet, ShapeNetFlowNet, ShapeNetTargetNet; source_b
    and target_b are (B, structure_nc, 1, 1) viewpoint codes."""

    TargetNet, FlowNet = ShapeNetTargetNet, ShapeNetFlowNet


class ShapeNetFlowNetGenerator(PoseFlowNetGenerator):
    """Stage-1 flow pretraining head for ShapeNet (gfla_tpu/models/
    generators.py:856-878): its keys are ShapeNetGenerator.flow_net's."""

    FlowNet = ShapeNetFlowNet
