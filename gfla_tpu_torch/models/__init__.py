"""Network registry (counterpart of gfla_tpu/models/__init__.py): the pose
and ShapeNet generators and their stage-1 flow heads, the recurrent face and
dance generators, the keypoint head's Motion Extraction Net, and the
residual, temporal and patch discriminators."""

from __future__ import annotations

from typing import Any, Dict

from gfla_tpu_torch.models.discriminators import (
    PatchDiscriminator,
    ResDiscriminator,
    TemporalDiscriminator,
)
from gfla_tpu_torch.models.generators import (
    DanceGenerator,
    FaceGenerator,
    PoseFlowNetGenerator,
    PoseGenerator,
    ShapeNetFlowNetGenerator,
    ShapeNetGenerator,
)
from gfla_tpu_torch.models.keypoint_net import KPInput2DGenerator

GENERATORS: Dict[str, Any] = {"pose": PoseGenerator,
                               "poseflownet": PoseFlowNetGenerator,
                               "shapenet": ShapeNetGenerator,
                               "shapenetflow": ShapeNetFlowNetGenerator,
                               "face": FaceGenerator,
                               "dance": DanceGenerator,
                               "kpinput2d": KPInput2DGenerator}
DISCRIMINATORS: Dict[str, Any] = {"res": ResDiscriminator,
                                  "patch": PatchDiscriminator,
                                  "temporal": TemporalDiscriminator}


def define_g(name: str, **kwargs):
    """Instantiate a generator by registry name (reference define_g)."""
    if name not in GENERATORS:
        raise KeyError(f"unknown generator '{name}'; have {sorted(GENERATORS)}")
    return GENERATORS[name](**kwargs)


def define_d(name: str, **kwargs):
    """Instantiate a discriminator by registry name (reference define_d)."""
    if name not in DISCRIMINATORS:
        raise KeyError(f"unknown discriminator '{name}'; have "
                       f"{sorted(DISCRIMINATORS)}")
    return DISCRIMINATORS[name](**kwargs)
