"""gfla_tpu parameters -> the port's state dicts.

The exact inverse of gfla_tpu.convert.torch_mapping's converters
(torch_mapping.py:40-214,253-329): each function takes gfla_tpu's variable
trees, as nested dicts of numpy arrays, and returns a state dict keyed like
the original GFLA's checkpoints, which loads into the port's module with
`strict=True`:

* `pose_generator_state_dict`: the instance-norm pose generator
  (`latest_net_G.pth`, PoseGenerator), spectral-normed or not;
* `poseflownet_state_dict`: the stage-1 flow generator
  (PoseFlowNetGenerator), whose keys are the pose generator's `flow_net.*`;
* `shapenet_generator_state_dict` and `shapenetflow_state_dict`: the ShapeNet
  novel-view generator and its stage-1 flow head, likewise (gfla_tpu's
  `cat` ResBlocks -> `flow_net.cat.model.0`; the target's 8x8-seed
  ResBlockDecoders -> `target.block0`, `target.block1`);
* `face_generator_state_dict` and `dance_generator_state_dict`: the
  recurrent animation generators (`source_previous`, `source_reference`,
  `target` with `attn_p{i}` and `attn_r{i}`, and `flow_net`, or
  `flow_net_previous` and `flow_net_reference`), spectral-normed or not;
* `kp_generator_state_dict`: the keypoint head's KPInput2DGenerator
  (`kp_input.*`): a flax Conv kernel (k, I, O) -> (O, I, k), a Dense
  kernel (I, O) -> (O, I), and the LayerNormAll scale and bias (C,) ->
  (C, 1), the original's LayerNorm1d shape;
* `res_discriminator_state_dict`: the spectral-norm ResDiscriminator
  (`latest_net_D.pth`), its power-iteration u carried across;
* `temporal_discriminator_state_dict`: the spectral-norm
  TemporalDiscriminator (`latest_net_D_V.pth` of the dance head), its 3-D
  kernels (kd, kh, kw, I, O) -> (O, I, kd, kh, kw), u carried across, and
  `encoder0`'s input channels left in gfla_tpu's t * C + c order, which the
  port's fold keeps;
* `vgg19_state_dict`: the VGG19 of the perceptual losses (the port's VGG19
  module keys, `conv1_1.weight` ...);
* `inception_state_dict` and `lpips_state_dict`: the metric networks
  (metrics/inception.py's InceptionV3Features from gfla_tpu's
  `{'params', 'batch_stats'}`, metrics/lpips.py's LPIPSNet from its AlexNet
  variables and five linear weights), through the same key maps that read
  the npz files of gfla_tpu's layout.

* conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw), and likewise in 3-D
* transposed-conv kernel (kh, kw, I, O), spatially flipped -> weight
  (I, O, kh, kw), flipped back
* InstanceNorm_0 {scale, bias} -> {weight, bias}
* attention w1 (k*k, 2C, D) -> (D, 2C, k, k); w2 (D, k*k) -> (k*k, D, 1, 1)
* Jump/Output `conv1` also under its Sequential alias `model.2`
* spectral-norm conv: kernel -> `weight_orig`; flax's stored u (1, cout) ->
  `weight_u` (cout,); `weight_v` (fan_in,), which flax does not store, is
  the normalised W^T u the next power-iteration step starts from (a
  transposed conv's W is its (cout, cin*kh*kw) view)
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _l2n(x):
    return x / np.sqrt((x * x).sum() + 1e-12)


def _spectral(key, w, wm, u, sd):
    """Spectral-norm keys of weight `w`, matricised (cout, fan_in) as `wm`."""
    sd[f"{key}.weight_orig"] = _t(w)
    sd[f"{key}.weight_u"] = _t(u)
    sd[f"{key}.weight_v"] = _t(_l2n(wm.T @ u))


def _u(stats, name):
    return np.asarray(stats["SpectralNorm_0"][f"{name}/kernel/u"]).reshape(-1)


def _sub(stats, name):
    return stats[name] if stats else None


def _conv(tree, key, sd, stats=None):
    conv = tree["Conv_0"]
    kernel = np.asarray(conv["kernel"])
    n = kernel.ndim
    w = kernel.transpose(n - 1, n - 2, *range(n - 2))
    if stats:
        _spectral(key, w, w.reshape(w.shape[0], -1), _u(stats, "Conv_0"), sd)
    else:
        sd[f"{key}.weight"] = _t(w)
    if "bias" in conv:
        sd[f"{key}.bias"] = _t(conv["bias"])


def _conv_transpose(tree, key, sd, stats=None):
    conv = tree["ConvTranspose_0"]
    w = np.asarray(conv["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if stats:
        wm = w.transpose(1, 0, 2, 3).reshape(w.shape[1], -1)
        _spectral(key, w, wm, _u(stats, "ConvTranspose_0"), sd)
    else:
        sd[f"{key}.weight"] = _t(w)
    sd[f"{key}.bias"] = _t(conv["bias"])


def _norm(tree, key, sd):
    norm = tree["InstanceNorm_0"]
    sd[f"{key}.weight"] = _t(norm["scale"])
    sd[f"{key}.bias"] = _t(norm["bias"])


def _pre_act(tree, prefix, sd, stats=None, conv2=_conv):
    _norm(tree["norm1"], f"{prefix}.model.0", sd)
    _conv(tree["conv1"], f"{prefix}.model.2", sd, _sub(stats, "conv1"))
    _norm(tree["norm2"], f"{prefix}.model.3", sd)
    conv2(tree["conv2"], f"{prefix}.model.5", sd, _sub(stats, "conv2"))


def _resblock(tree, prefix, sd, stats=None):
    _pre_act(tree, prefix, sd, stats)
    if "shortcut" in tree:
        _conv(tree["shortcut"], f"{prefix}.shortcut.0", sd,
              _sub(stats, "shortcut"))


def _resblock_decoder(tree, prefix, sd, stats=None):
    _pre_act(tree, prefix, sd, stats, conv2=_conv_transpose)
    _conv_transpose(tree["shortcut"], f"{prefix}.shortcut.0", sd,
                    _sub(stats, "shortcut"))


def _jump(tree, prefix, sd, stats=None):
    _conv(tree["conv1"], f"{prefix}.conv1", sd, _sub(stats, "conv1"))
    for key in [k for k in sd if k.startswith(f"{prefix}.conv1.")]:
        sd[key.replace(".conv1.", ".model.2.", 1)] = sd[key]


def _attn(tree, prefix, sd):
    w1 = np.asarray(tree["w1"])
    k2, c2, d = w1.shape
    k = math.isqrt(k2)
    key = f"{prefix}.fully_connect_layer"
    sd[f"{key}.0.weight"] = _t(w1.reshape(k, k, c2, d).transpose(3, 2, 0, 1))
    sd[f"{key}.0.bias"] = _t(tree["b1"])
    sd[f"{key}.2.weight"] = _t(np.asarray(tree["w2"]).T[:, :, None, None])
    sd[f"{key}.2.bias"] = _t(tree["b2"])


def _flow_net(fn, s_fn, sd, flow_layers, attn_layer, prefix="flow_net"):
    """PoseFlowNet, FaceFlowNet or ShapeNetFlowNet params (and spectral
    stats) -> `{prefix}.*` keys."""
    _pre_act(fn["block0"], f"{prefix}.block0", sd, _sub(s_fn, "block0"))
    for i in range(flow_layers - 1):
        _pre_act(fn[f"encoder{i}"], f"{prefix}.encoder{i}", sd,
                 _sub(s_fn, f"encoder{i}"))
    if "cat" in fn:  # ShapeNetFlowNet's bottleneck fusion
        _resblock(fn["cat"]["block0"], f"{prefix}.cat.model.0", sd,
                  _sub(_sub(s_fn, "cat"), "block0"))
    for i in range(flow_layers - min(attn_layer)):
        _resblock_decoder(fn[f"decoder{i}"], f"{prefix}.decoder{i}", sd,
                          _sub(s_fn, f"decoder{i}"))
        _jump(fn[f"jump{i}"], f"{prefix}.jump{i}", sd, _sub(s_fn, f"jump{i}"))
        if flow_layers - i - 1 in attn_layer:
            _conv(fn[f"output{i}"], f"{prefix}.output{i}", sd)
            _conv(fn[f"mask{i}"], f"{prefix}.mask{i}.0", sd)


def _target_decoder(tg, s_tg, sd, layers, attn_layer, num_blocks):
    """The target net's decoder levels and output head -> `target.*`."""
    for i in range(layers):
        if layers - i in attn_layer:
            for stream in ("", "_p", "_r"):  # FaceTargetNet: _p and _r
                if f"attn{stream}{i}" in tg:
                    _attn(tg[f"attn{stream}{i}"], f"target.attn{stream}{i}",
                          sd)
        dec = _sub(s_tg, f"decoder{i}")
        if num_blocks > 1:
            res = _sub(s_tg, f"decoder{i}_res")
            for b in range(num_blocks - 1):
                _resblock(tg[f"decoder{i}_res"][f"block{b}"],
                          f"target.decoder{i}.0.model.{b}", sd,
                          _sub(res, f"block{b}"))
            _resblock_decoder(tg[f"decoder{i}"], f"target.decoder{i}.1", sd,
                              dec)
        else:
            _resblock_decoder(tg[f"decoder{i}"], f"target.decoder{i}.0", sd,
                              dec)
    _jump(tg["outconv"], "target.outconv", sd, _sub(s_tg, "outconv"))


def _encoder(tree, stats, prefix, layers, sd):
    """`block0` and `encoder{i}` EncoderBlocks -> `{prefix}.*`."""
    _pre_act(tree["block0"], f"{prefix}.block0", sd, _sub(stats, "block0"))
    for i in range(layers - 1):
        _pre_act(tree[f"encoder{i}"], f"{prefix}.encoder{i}", sd,
                 _sub(stats, f"encoder{i}"))


def _generator(params, stats, layers, attn_layer, num_blocks, flow_layers,
               target_input, sources=("source",), flow_nets=("flow_net",)):
    """Source nets, flow nets and target net -> the generator's keys;
    `target_input(tg, s_tg, sd)` writes the target net's input stage."""
    sd: Dict[str, torch.Tensor] = {}
    stats = stats or {}
    for name in sources:
        _encoder(params[name], stats.get(name), name, layers, sd)
    for name in flow_nets:
        _flow_net(params[name], stats.get(name), sd, flow_layers, attn_layer,
                  name)
    tg, s_tg = params["target"], stats.get("target")
    target_input(tg, s_tg, sd)
    _target_decoder(tg, s_tg, sd, layers, attn_layer, num_blocks)
    return sd


def _pose_encoder(layers):
    def target_input(tg, s_tg, sd):
        _encoder(tg, s_tg, "target", layers, sd)

    return target_input


def pose_generator_state_dict(params: Dict[str, Any], layers: int = 3,
                              attn_layer=(2, 3), num_blocks: int = 2,
                              flow_layers: int = 5,
                              batch_stats: Dict[str, Any] | None = None
                              ) -> Dict[str, torch.Tensor]:
    """gfla_tpu PoseGenerator params -> original-keyed torch state dict.
    With the `batch_stats` of a spectral-norm generator (`use_spect`), its
    block convs get the spectral keys and their stored u."""
    return _generator(params, batch_stats, layers, attn_layer, num_blocks,
                      flow_layers, _pose_encoder(layers))


def face_generator_state_dict(params: Dict[str, Any], layers: int = 3,
                              attn_layer=(2, 3), num_blocks: int = 2,
                              flow_layers: int = 5,
                              batch_stats: Dict[str, Any] | None = None
                              ) -> Dict[str, torch.Tensor]:
    """gfla_tpu FaceGenerator params (and spectral stats) -> the port's
    FaceGenerator state dict (gfla_tpu/convert/torch_mapping.py:332-345
    inverted)."""
    return _generator(params, batch_stats, layers, attn_layer, num_blocks,
                      flow_layers, _pose_encoder(layers),
                      ("source_previous", "source_reference"))


def dance_generator_state_dict(params: Dict[str, Any], layers: int = 3,
                               attn_layer=(2, 3), num_blocks: int = 2,
                               flow_layers: int = 5,
                               batch_stats: Dict[str, Any] | None = None
                               ) -> Dict[str, torch.Tensor]:
    """gfla_tpu DanceGenerator params (and spectral stats) -> the port's
    DanceGenerator state dict (torch_mapping.py:348-363 inverted)."""
    return _generator(params, batch_stats, layers, attn_layer, num_blocks,
                      flow_layers, _pose_encoder(layers),
                      ("source_previous", "source_reference"),
                      ("flow_net_previous", "flow_net_reference"))


def shapenet_generator_state_dict(params: Dict[str, Any], layers: int = 3,
                                  attn_layer=(2,), num_blocks: int = 2,
                                  flow_layers: int = 5,
                                  batch_stats: Dict[str, Any] | None = None
                                  ) -> Dict[str, torch.Tensor]:
    """gfla_tpu ShapeNetGenerator params (and spectral stats) ->
    original-keyed torch state dict (gfla_tpu/convert/torch_mapping.py:
    406-420 inverted)."""

    def code_seed(tg, s_tg, sd):
        for name in ("block0", "block1"):
            _resblock_decoder(tg[name], f"target.{name}", sd,
                              _sub(s_tg, name))

    return _generator(params, batch_stats, layers, attn_layer, num_blocks,
                      flow_layers, code_seed)


def poseflownet_state_dict(params: Dict[str, Any], attn_layer=(2, 3),
                           flow_layers: int = 5,
                           batch_stats: Dict[str, Any] | None = None
                           ) -> Dict[str, torch.Tensor]:
    """gfla_tpu PoseFlowNetGenerator params -> the stage-1 state dict, keyed
    `flow_net.*` as PoseGenerator.flow_net's keys are. The same function
    takes ShapeNetFlowNetGenerator's params (shapenetflow_state_dict)."""
    sd: Dict[str, torch.Tensor] = {}
    _flow_net(params["flow_net"], (batch_stats or {}).get("flow_net"), sd,
              flow_layers, attn_layer)
    return sd


def shapenetflow_state_dict(params: Dict[str, Any], attn_layer=(2,),
                            flow_layers: int = 5,
                            batch_stats: Dict[str, Any] | None = None
                            ) -> Dict[str, torch.Tensor]:
    """gfla_tpu ShapeNetFlowNetGenerator params -> the stage-1 state dict,
    keyed `flow_net.*` as ShapeNetGenerator.flow_net's keys are."""
    return poseflownet_state_dict(params, attn_layer, flow_layers,
                                  batch_stats)


def res_discriminator_state_dict(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any],
                                 layers: int = 4) -> Dict[str, torch.Tensor]:
    """gfla_tpu ResDiscriminator (spectral norm, norm 'none') params and
    batch_stats -> original-keyed torch state dict (discriminator.py:20-39:
    model.1 conv 3x3, model.3 conv 4x4, shortcut.1 conv 1x1, conv)."""
    sd: Dict[str, torch.Tensor] = {}
    for block in ["block0"] + [f"encoder{i}" for i in range(layers - 1)]:
        for ours, theirs in (("conv1", "model.1"), ("conv2", "model.3"),
                             ("shortcut", "shortcut.1")):
            _conv(params[block][ours], f"{block}.{theirs}", sd,
                  batch_stats[block][ours])
    _conv(params["conv"], "conv", sd, batch_stats["conv"])
    return sd


def temporal_discriminator_state_dict(params: Dict[str, Any],
                                      batch_stats: Dict[str, Any],
                                      layers: int = 4
                                      ) -> Dict[str, torch.Tensor]:
    """gfla_tpu TemporalDiscriminator (spectral norm) params and batch_stats
    -> the port's state dict: `block0`, `block1` (ResBlock3DEncoders),
    then `encoder{i}` and `conv` as res_discriminator_state_dict's."""
    sd = res_discriminator_state_dict(
        {k: v for k, v in params.items() if k != "block1"},
        batch_stats, layers - 1)
    for ours, theirs in (("conv1", "model.1"), ("conv2", "model.3"),
                         ("shortcut", "shortcut.1")):
        _conv(params["block1"][ours], f"block1.{theirs}", sd,
              batch_stats["block1"][ours])
    return sd


def vgg19_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """gfla_tpu VGG19 params ({'conv1_1': {kernel, bias}, ...}, or the
    `{'params': ...}` variables) -> the port's VGG19 state dict."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name, conv in params.items():
        sd[f"{name}.weight"] = _t(np.asarray(conv["kernel"]).transpose(
            3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(conv["bias"])
    return sd


def kp_generator_state_dict(params: Dict[str, Any],
                            layers: int = 4) -> Dict[str, torch.Tensor]:
    """gfla_tpu's KPInput2DGenerator params -> the state dict of the port's
    (and the original's) KPInput2DGenerator; the inverse of
    torch_mapping.convert_kp_generator."""
    kp = params["kp_input"]
    p = "kp_input"
    sd: Dict[str, torch.Tensor] = {}

    def conv(name, key):
        sd[f"{p}.{key}.weight"] = _t(
            np.asarray(kp[name]["kernel"]).transpose(2, 1, 0))
        if "bias" in kp[name]:
            sd[f"{p}.{key}.bias"] = _t(kp[name]["bias"])

    def dense(tree, key):
        sd[f"{key}.weight"] = _t(np.asarray(tree["kernel"]).T)
        sd[f"{key}.bias"] = _t(tree["bias"])

    conv("expand_conv", "expand_conv")
    ln = kp["expand_ln"]
    sd[f"{p}.expand_ln.weight"] = _t(np.asarray(ln["scale"]).reshape(-1, 1))
    sd[f"{p}.expand_ln.bias"] = _t(np.asarray(ln["bias"]).reshape(-1, 1))
    for j in range(2 * (layers - 1)):
        conv(f"conv_{j}", f"layers_conv.{j}")
        ln = kp[f"ln_{j}"]
        dense(ln["mlp_shared"], f"{p}.layers_ln.{j}.mlp_shared.0")
        dense(ln["mlp_gamma"], f"{p}.layers_ln.{j}.mlp_gamma")
        dense(ln["mlp_beta"], f"{p}.layers_ln.{j}.mlp_beta")
    conv("shrink", "shrink")
    for i in (1, 2, 3):
        conv(f"feature_conv_{i}", f"feature_conv_{i}")
    return sd


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)
    return out


def inception_state_dict(variables: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """gfla_tpu's InceptionV3Features variables ({'params', 'batch_stats'})
    -> the port's InceptionV3Features state dict, BatchNorm's
    num_batches_tracked aside (load with strict=False)."""
    from gfla_tpu_torch.metrics.inception import (InceptionV3Features,
                                                  state_dict_from_flat)

    flat: Dict[str, Any] = {}
    for collection in ("params", "batch_stats"):
        _flatten(variables[collection], collection, flat)
    return state_dict_from_flat(flat, InceptionV3Features().state_dict())


def lpips_state_dict(variables: Dict[str, Any],
                     lins) -> Dict[str, torch.Tensor]:
    """gfla_tpu's AlexNetFeatures variables ({'params': {'conv{i}': {kernel,
    bias}}}) and its five linear weights -> the port's LPIPSNet state
    dict."""
    from gfla_tpu_torch.metrics.lpips import state_dict_from_flat

    params = variables.get("params", variables)
    flat = {f"lin{i}": np.asarray(lin) for i, lin in enumerate(lins)}
    for name, conv in params.items():
        flat[f"{name}_kernel"] = np.asarray(conv["kernel"])
        flat[f"{name}_bias"] = np.asarray(conv["bias"])
    return state_dict_from_flat(flat)
