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

The recurrent animation heads (gfla_tpu/models/generators.py:317-675, the
original's generator.py:264-585) generate a chunk of frames (B, T, C, H, W)
one frame at a time, each frame's output the next frame's previous image:

* FaceTargetNet is PoseTargetNet with two attention streams a level: the
  previous frame's features (`attn_p{i}`) and the reference image's
  (`attn_r{i}`), each blended under its own mask, the two blends summed;
* FaceFlowNet is PoseFlowNet over [skeleton, previous image, previous
  skeleton, reference image, reference skeleton] with two streams: 4-channel
  flow and 2-channel mask heads split into (previous, reference);
* FaceGenerator: per frame, the previous image encoded (`source_previous`),
  FaceFlowNet, FaceTargetNet; the reference image is encoded once a chunk
  (`source_reference`);
* DanceGenerator: the same with two PoseFlowNets (instance norm and
  LeakyReLU whatever G uses): `flow_net_previous` per frame, and
  `flow_net_reference`, which reads only the reference pair and the frame's
  skeleton, once a chunk over all its frames folded into the batch (B * T,
  in (b, t) order), as gfla_tpu hoists it out of the recurrence.
The frame loop is gfla_tpu's unrolled recurrence (`_scan_frames` with
use_scan=False), the same function as its scan. With `remat` each frame runs
under torch.utils.checkpoint (gfla_tpu's `nn.remat` of the frame step), u
advancing once a frame all the same.

With `use_spect` (`--use_spect_g`) every block conv is spectral-normed, as in
gfla_tpu: not the flow and mask heads, not the attention. Each spectral conv
stores its power iteration in train mode and not in eval mode: in a chunk,
the per-frame nets' u advances once a frame, the reference nets' once a
chunk, as gfla_tpu carries u through its scan.
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
from gfla_tpu_torch.nn.norms import recompute_keeping_u


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
    """`streams` flow fields and masks at each attention level: 1 here, 2
    (previous, reference) in FaceFlowNet, whose heads emit 2 * streams and
    streams channels, split in that order."""

    streams = 1

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
                setattr(self, f"output{i}",
                        nn.Conv2d(nc, 2 * self.streams, 3, 1, 1))
                setattr(self, f"mask{i}", nn.Sequential(
                    nn.Conv2d(nc, self.streams, 3, 1, 1), nn.Sigmoid()))
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
        """(flows, masks) at the attention levels, coarse to fine, each
        level's streams in turn."""
        flows, masks = [], []
        for i in range(self.decoder_layer):
            out = getattr(self, f"decoder{i}")(out)
            out = out + getattr(self, f"jump{i}")(
                result[self.encoder_layer - i - 2])
            if self.encoder_layer - i - 1 in self.attn_layer:
                flows.extend(getattr(self, f"output{i}")(out).split(2, 1))
                masks.extend(getattr(self, f"mask{i}")(out).split(1, 1))
        return flows, masks


class _TargetDecoder(nn.Module):
    """The target decoder the target nets share: `layers` upsampling levels
    from the coarsest feature, each first blending at an attention level
    (out * (1 - mask) + attn(source_feat, out, flow) * mask), then the
    output head. A subclass builds its input stage, then calls
    `_add_decoder`, and says in `encode` how the target code reaches the
    coarsest level. `streams` names the attention modules of a level:
    `attn{i}` here, `attn_p{i}` and `attn_r{i}` in FaceTargetNet."""

    streams = ("",)

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
                for stream in self.streams:
                    setattr(self, f"attn{stream}{i}",
                            ExtractorAttn(nc_prev,
                                          extractor_kz[str(layers - i)],
                                          activation))
            nc_prev = nc
        self.outconv = Output(ngf, output_nc, 3, norm_type="none",
                              activation=activation,
                              use_spect=kw["use_spect"])

    def decode(self, out, blend):
        """The decoder from the coarsest feature `out`; `blend(i, level,
        out)` fuses attention level `level` (0 the coarsest) at decoder
        level i."""
        level = 0
        for i in range(self.layers):
            if self.layers - i in self.attn_layer:
                out = blend(i, level, out)
                level += 1
            out = getattr(self, f"decoder{i}")(out)
        return self.outconv(out)

    def forward(self, target_b, source_feature, flow_fields, masks,
                return_hooks: bool = False):
        hooks = {"target": [], "source": [], "attn": [], "mask": []}

        def blend(i, level, out):
            attn_mod = getattr(self, f"attn{i}")
            if return_hooks:
                attn_w, out_attn = attn_mod(
                    source_feature[i], out, flow_fields[level],
                    return_attn=True)
            else:
                out_attn = attn_mod(source_feature[i], out,
                                    flow_fields[level])
            mask = masks[level]
            out = out * (1 - mask) + out_attn * mask
            if return_hooks:
                hooks["target"].append(out)
                hooks["source"].append(source_feature[i])
                hooks["attn"].append(attn_w)
                hooks["mask"].append(mask)
            return out

        img = self.decode(self.encode(target_b), blend)
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


# ---------------------------------------------------------------------------
# the recurrent animation heads
# ---------------------------------------------------------------------------

def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


class FaceTargetNet(PoseTargetNet):
    """PoseTargetNet with a previous and a reference attention stream at
    each level (gfla_tpu/models/generators.py:378-443)."""

    streams = ("_p", "_r")

    def forward(self, bp, prev_features, ref_features, flow_fields, masks):
        """flow_fields/masks: [previous, reference] per level, coarse to
        fine."""

        def blend(i, level, out):
            fused = []
            for s, (stream, feats) in enumerate(
                    (("_p", prev_features), ("_r", ref_features))):
                flow, mask = flow_fields[2 * level + s], masks[2 * level + s]
                attn = getattr(self, f"attn{stream}{i}")(feats[i], out, flow)
                fused.append(out * (1 - mask) + attn * mask)
            return fused[0] + fused[1]

        return self.decode(self.encode(bp), blend)


class FaceFlowNet(PoseFlowNet):
    """One flow U-Net over cat(bp, p_prev, bp_prev, p_ref, bp_ref) for both
    streams (gfla_tpu/models/generators.py:446-503)."""

    streams = 2

    def __init__(self, image_nc: int = 3, structure_nc: int = 16,
                 ngf: int = 32, img_f: int = 256, encoder_layer: int = 5,
                 attn_layer: Sequence[int] = (1, 2), norm_type: str = "batch",
                 activation: str = "ReLU", use_spect: bool = False):
        super().__init__(image_nc, structure_nc, ngf, img_f, encoder_layer,
                         attn_layer, norm_type, activation, use_spect,
                         input_nc=3 * structure_nc + 2 * image_nc)

    def forward(self, bp, p_prev, bp_prev, p_ref, bp_ref):
        return self.decode(*self.encode(
            torch.cat([bp, p_prev, bp_prev, p_ref, bp_ref], dim=1)))


class _AnimationGenerator(nn.Module):
    """The source nets, the target net and the frame recurrence that
    FaceGenerator and DanceGenerator share; a subclass adds its flow nets
    and its `frame_step`. Inputs: bp_frames (B, T, structure_nc, H, W), the
    reference image and skeleton (B, C, H, W), and the previous image and
    skeleton the chunk starts from (the reference pair if None). Returns
    (frames (B, T, 3, H, W), flows and masks [previous, reference per level
    x (B, T, c, h, w)], the previous image of each frame (B, T, 3, H, W))."""

    def __init__(self, image_nc: int = 3, structure_nc: int = 16,
                 output_nc: int = 3, ngf: int = 64, img_f: int = 1024,
                 layers: int = 6, num_blocks: int = 2,
                 norm_type: str = "batch", activation: str = "ReLU",
                 attn_layer: Sequence[int] = (1, 2),
                 extractor_kz: Dict[str, int] = None,
                 use_spect: bool = False):
        super().__init__()
        kw = dict(norm_type=norm_type, activation=activation,
                  use_spect=use_spect)
        self.source_previous = PoseSourceNet(image_nc, ngf, img_f, layers,
                                             **kw)
        self.source_reference = PoseSourceNet(image_nc, ngf, img_f, layers,
                                              **kw)
        self.target = FaceTargetNet(structure_nc, output_nc, ngf, img_f,
                                    layers, num_blocks,
                                    attn_layer=attn_layer,
                                    extractor_kz=extractor_kz, **kw)

    def forward(self, bp_frames, p_reference, bp_reference, p_previous=None,
                bp_previous=None, remat: bool = False):
        p_ref, bp_ref = _channels_last(p_reference), \
            _channels_last(bp_reference)
        p_prev = p_ref if p_previous is None else _channels_last(p_previous)
        bp_prev = bp_ref if bp_previous is None \
            else _channels_last(bp_previous)
        ref_features = self.source_reference(p_ref)
        frame_step, per_frame = self.chunk_setup(bp_frames, p_ref, bp_ref,
                                                 ref_features)
        gen, flows, masks, prev = [], [], [], []
        for t in range(bp_frames.shape[1]):
            bp = _channels_last(bp_frames[:, t])
            args = (p_prev, bp_prev, bp, *(x[:, t] for x in per_frame))
            if remat:
                img, f, m = recompute_keeping_u(self, frame_step, *args)
            else:
                img, f, m = frame_step(*args)
            gen.append(img)
            flows.append(f)
            masks.append(m)
            prev.append(p_prev)
            p_prev, bp_prev = img, bp

        def stack(per_t):
            return [torch.stack([fr[j] for fr in per_t], dim=1)
                    for j in range(len(per_t[0]))]

        return (torch.stack(gen, dim=1), stack(flows), stack(masks),
                torch.stack(prev, dim=1))

    def chunk_setup(self, bp_frames, p_ref, bp_ref, ref_features):
        """(frame_step(p_prev, bp_prev, bp, *x_t) -> (img, flows, masks),
        the (B, T, ...) tensors whose frame t is x_t)."""
        raise NotImplementedError


class FaceGenerator(_AnimationGenerator):
    """gfla_tpu/models/generators.py:506-573 (the original's
    generator.py:388-426)."""

    def __init__(self, image_nc: int = 3, structure_nc: int = 16,
                 output_nc: int = 3, ngf: int = 64, img_f: int = 1024,
                 layers: int = 6, num_blocks: int = 2,
                 norm_type: str = "batch", activation: str = "ReLU",
                 attn_layer: Sequence[int] = (1, 2),
                 extractor_kz: Dict[str, int] = None,
                 use_spect: bool = False):
        super().__init__(image_nc, structure_nc, output_nc, ngf, img_f,
                         layers, num_blocks, norm_type, activation,
                         attn_layer, extractor_kz, use_spect)
        self.flow_net = FaceFlowNet(image_nc, structure_nc, ngf=32,
                                    img_f=256, encoder_layer=5,
                                    attn_layer=attn_layer,
                                    norm_type=norm_type,
                                    activation=activation,
                                    use_spect=use_spect)

    def chunk_setup(self, bp_frames, p_ref, bp_ref, ref_features):
        def frame_step(p_prev, bp_prev, bp):
            prev_features = self.source_previous(p_prev)
            flows, masks = self.flow_net(bp, p_prev, bp_prev, p_ref, bp_ref)
            img = self.target(bp, prev_features, ref_features, flows, masks)
            return img, flows, masks

        return frame_step, ()


class DanceGenerator(_AnimationGenerator):
    """gfla_tpu/models/generators.py:576-675 (the original's
    generator.py:264-316): two PoseFlowNets, their flows and masks
    interleaved [previous, reference] per level into FaceTargetNet."""

    def __init__(self, image_nc: int = 3, structure_nc: int = 18,
                 output_nc: int = 3, ngf: int = 64, img_f: int = 1024,
                 layers: int = 6, num_blocks: int = 2,
                 norm_type: str = "batch", activation: str = "ReLU",
                 attn_layer: Sequence[int] = (1, 2),
                 extractor_kz: Dict[str, int] = None,
                 use_spect: bool = False):
        super().__init__(image_nc, structure_nc, output_nc, ngf, img_f,
                         layers, num_blocks, norm_type, activation,
                         attn_layer, extractor_kz, use_spect)
        flow_kw = dict(ngf=32, img_f=256, encoder_layer=5,
                       attn_layer=attn_layer, norm_type="instance",
                       activation="LeakyReLU", use_spect=use_spect)
        self.flow_net_previous = PoseFlowNet(image_nc, structure_nc,
                                             **flow_kw)
        self.flow_net_reference = PoseFlowNet(image_nc, structure_nc,
                                              **flow_kw)

    def chunk_setup(self, bp_frames, p_ref, bp_ref, ref_features):
        B, T = bp_frames.shape[:2]

        def rep(a):  # (B, ...) -> (B * T, ...), each sample T times
            return _channels_last(a.repeat_interleave(T, dim=0))

        flows_r, masks_r = self.flow_net_reference(
            rep(p_ref), rep(bp_ref),
            _channels_last(bp_frames.reshape(B * T, *bp_frames.shape[2:])))
        per_frame = [a.reshape(B, T, *a.shape[1:])
                     for a in (*flows_r, *masks_r)]
        levels = len(flows_r)

        def frame_step(p_prev, bp_prev, bp, *refs):
            prev_features = self.source_previous(p_prev)
            flows_p, masks_p = self.flow_net_previous(p_prev, bp_prev, bp)
            flows, masks = [], []
            for j in range(levels):
                flows += [flows_p[j], refs[j]]
                masks += [masks_p[j], refs[levels + j]]
            img = self.target(bp, prev_features, ref_features, flows, masks)
            return img, flows, masks

        return frame_step, per_frame
