"""gfla_tpu pose-generator parameters -> the port's state dict.

The exact inverse of gfla_tpu.convert.torch_mapping.convert_pose_generator
(and its helpers, torch_mapping.py:40-157,253-329) for the instance-norm pose
generator: it takes gfla_tpu's params tree, as nested dicts of numpy arrays,
and returns a state dict keyed like the original GFLA `latest_net_G.pth`,
which loads into `gfla_tpu_torch.models.generators.PoseGenerator` with
`strict=True`.

* conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
* transposed-conv kernel (kh, kw, I, O), spatially flipped -> weight
  (I, O, kh, kw), flipped back
* InstanceNorm_0 {scale, bias} -> {weight, bias}
* attention w1 (k*k, 2C, D) -> (D, 2C, k, k); w2 (D, k*k) -> (k*k, D, 1, 1)
* Jump/Output `conv1` also under its Sequential alias `model.2`
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _conv(tree, key, sd):
    conv = tree["Conv_0"]
    sd[f"{key}.weight"] = _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        sd[f"{key}.bias"] = _t(conv["bias"])


def _conv_transpose(tree, key, sd):
    conv = tree["ConvTranspose_0"]
    kernel = np.asarray(conv["kernel"]).transpose(2, 3, 0, 1)
    sd[f"{key}.weight"] = _t(kernel[:, :, ::-1, ::-1])
    sd[f"{key}.bias"] = _t(conv["bias"])


def _norm(tree, key, sd):
    norm = tree["InstanceNorm_0"]
    sd[f"{key}.weight"] = _t(norm["scale"])
    sd[f"{key}.bias"] = _t(norm["bias"])


def _pre_act(tree, prefix, sd, conv2=_conv):
    _norm(tree["norm1"], f"{prefix}.model.0", sd)
    _conv(tree["conv1"], f"{prefix}.model.2", sd)
    _norm(tree["norm2"], f"{prefix}.model.3", sd)
    conv2(tree["conv2"], f"{prefix}.model.5", sd)


def _resblock(tree, prefix, sd):
    _pre_act(tree, prefix, sd)
    if "shortcut" in tree:
        _conv(tree["shortcut"], f"{prefix}.shortcut.0", sd)


def _resblock_decoder(tree, prefix, sd):
    _pre_act(tree, prefix, sd, conv2=_conv_transpose)
    _conv_transpose(tree["shortcut"], f"{prefix}.shortcut.0", sd)


def _jump(tree, prefix, sd):
    _conv(tree["conv1"], f"{prefix}.conv1", sd)
    for suffix in ("weight", "bias"):
        sd[f"{prefix}.model.2.{suffix}"] = sd[f"{prefix}.conv1.{suffix}"]


def _attn(tree, prefix, sd):
    w1 = np.asarray(tree["w1"])
    k2, c2, d = w1.shape
    k = math.isqrt(k2)
    key = f"{prefix}.fully_connect_layer"
    sd[f"{key}.0.weight"] = _t(w1.reshape(k, k, c2, d).transpose(3, 2, 0, 1))
    sd[f"{key}.0.bias"] = _t(tree["b1"])
    sd[f"{key}.2.weight"] = _t(np.asarray(tree["w2"]).T[:, :, None, None])
    sd[f"{key}.2.bias"] = _t(tree["b2"])


def pose_generator_state_dict(params: Dict[str, Any], layers: int = 3,
                              attn_layer=(2, 3), num_blocks: int = 2,
                              flow_layers: int = 5) -> Dict[str, torch.Tensor]:
    """gfla_tpu PoseGenerator params -> original-keyed torch state dict."""
    sd: Dict[str, torch.Tensor] = {}
    src = params["source"]
    _pre_act(src["block0"], "source.block0", sd)
    for i in range(layers - 1):
        _pre_act(src[f"encoder{i}"], f"source.encoder{i}", sd)

    fn = params["flow_net"]
    _pre_act(fn["block0"], "flow_net.block0", sd)
    for i in range(flow_layers - 1):
        _pre_act(fn[f"encoder{i}"], f"flow_net.encoder{i}", sd)
    for i in range(flow_layers - min(attn_layer)):
        _resblock_decoder(fn[f"decoder{i}"], f"flow_net.decoder{i}", sd)
        _jump(fn[f"jump{i}"], f"flow_net.jump{i}", sd)
        if flow_layers - i - 1 in attn_layer:
            _conv(fn[f"output{i}"], f"flow_net.output{i}", sd)
            _conv(fn[f"mask{i}"], f"flow_net.mask{i}.0", sd)

    tg = params["target"]
    _pre_act(tg["block0"], "target.block0", sd)
    for i in range(layers - 1):
        _pre_act(tg[f"encoder{i}"], f"target.encoder{i}", sd)
    for i in range(layers):
        if layers - i in attn_layer:
            _attn(tg[f"attn{i}"], f"target.attn{i}", sd)
        if num_blocks > 1:
            for b in range(num_blocks - 1):
                _resblock(tg[f"decoder{i}_res"][f"block{b}"],
                          f"target.decoder{i}.0.model.{b}", sd)
            _resblock_decoder(tg[f"decoder{i}"], f"target.decoder{i}.1", sd)
        else:
            _resblock_decoder(tg[f"decoder{i}"], f"target.decoder{i}.0", sd)
    _jump(tg["outconv"], "target.outconv", sd)
    return sd
