"""Data for the port (counterpart of gfla_tpu/data/__init__.py:25-53): the
file-backed DeepFashion and Market-1501 pose datasets, the synthetic paired
dataset, the ShapeNet HDF5 store, the dance (iPER, FashionVideo) and face
(FaceForensics) video datasets and the synthetic clips of the animation
heads, the keypoint head's Human3.6M NPZ pairs and AlphaPose JSON
sequences, gfla_tpu's batch order on torch's DataLoader, and the registry that
`--dataset_mode` reads. JPEG decoding, the warp-resize and the heatmaps run
on the task's device (tasks/pose.py and tasks/animation.py
`prepare_batch`), as do ShapeNet's resize and one-hot labels and the face
frames' Canny background."""

from __future__ import annotations

from gfla_tpu_torch.data.animation_data import (
    DanceDataset,
    FaceDataset,
    SyntheticVideoDataset,
)
from gfla_tpu_torch.data.keypoint_data import (
    KeypointDataset,
    KeypointTestDataset,
)
from gfla_tpu_torch.data.loader import collate, infinite, make_loader
from gfla_tpu_torch.data.paired_dataset import FashionDataset, MarketDataset
from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.data.shapenet_data import ShapeNetDataset
from gfla_tpu_torch.data.synthetic import SyntheticPoseDataset

DATASETS = {"fashion": FashionDataset, "market": MarketDataset,
            "synthetic": SyntheticPoseDataset, "shapenet": ShapeNetDataset,
            "dance": DanceDataset, "face": FaceDataset,
            "synthetic_video": SyntheticVideoDataset,
            "keypoint": KeypointDataset, "keypointtest": KeypointTestDataset}


def get_dataset_class(name: str):
    if name not in DATASETS:
        raise KeyError(f"unknown dataset_mode '{name}'; the port has "
                       f"{sorted(DATASETS)}")
    return DATASETS[name]


__all__ = ["DATASETS", "DanceDataset", "FaceDataset", "FashionDataset",
           "KeypointDataset", "KeypointTestDataset", "MarketDataset",
           "ShapeNetDataset", "SyntheticPoseDataset", "SyntheticVideoDataset",
           "collate",
           "encode_heatmaps", "get_dataset_class", "infinite", "make_loader"]
