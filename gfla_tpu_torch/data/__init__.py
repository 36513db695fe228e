"""Data for the port: the synthetic paired dataset, a serial batch loader
for testing, an endless shuffled one for training, and on-device heatmap
encoding. The file-backed fashion and market datasets are not ported yet."""

from __future__ import annotations

from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.data.synthetic import (
    SyntheticPoseDataset,
    iterate_batches,
    train_batches,
)

DATASETS = {"synthetic": SyntheticPoseDataset}


def get_dataset_class(name: str):
    if name not in DATASETS:
        raise KeyError(f"unknown dataset_mode '{name}'; the port has "
                       f"{sorted(DATASETS)}")
    return DATASETS[name]


__all__ = ["DATASETS", "SyntheticPoseDataset", "encode_heatmaps",
           "get_dataset_class", "iterate_batches", "train_batches"]
